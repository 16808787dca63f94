"""Inverse-dynamics partials: the container, the finite-difference partials
and the dispatch on ``gradients_method`` (counterpart of
``idto_tpu/optimizer/partials.py``; the exact partials are
``soa/partials.py``).

The finite differences are batch-native: every perturbed coordinate of
every step's (q_{t-1}, q_t, q_{t+1}) triplet is one more instance on the
SoA instance axis, so one ``step_tau`` call evaluates a stencil point for
all coordinates of all steps of all scenarios.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from idto_tpu_torch.soa import contact as soa_contact
from idto_tpu_torch.soa import kinematics as soa_kin


class IdPartials(NamedTuple):
    """d tau_t / d q_{t-1}, d q_t, d q_{t+1}: (..., T, nv, nq) each;
    dtau_dqm[..., 0, :, :] is identically zero (q_{-1} does not exist)."""

    dtau_dqm: torch.Tensor
    dtau_dqt: torch.Tensor
    dtau_dqp: torch.Tensor


# Step-size exponent and stencil (offsets in steps, weights) of each order:
# forward differences, 2nd- and 4th-order central differences.
_FD_POW = {1: 0.5, 2: 1.0 / 3.0, 4: 0.2}
_STENCIL = {
    1: ((1.0, 1.0), (0.0, -1.0)),
    2: ((1.0, 1.0), (-1.0, -1.0)),
    4: ((2.0, -1.0), (1.0, 8.0), (-1.0, -8.0), (-2.0, 1.0)),
}
_DENOM = {1: 1.0, 2: 2.0, 4: 12.0}


def _fd_steps(x, eps_pow):
    """Perturbation sizes eps^pow * max(1, |x|), made exactly
    representable: (x + h) - x.  eps^pow is taken in x's dtype."""
    npdt = np.float32 if x.dtype == torch.float32 else np.float64
    scale = float(np.finfo(npdt).eps ** npdt(eps_pow))
    h = scale * torch.clamp_min(torch.abs(x), 1.0)
    return (x + h) - x


def id_partials_fd(model, prob, contact, qs, order: int = 1,
                   halo=False) -> IdPartials:
    """IdPartials of a batch qs (B, T+1, nq) by finite differences of
    ``step_tau`` (order 1, 2 or 4), with the boundary convention of
    ``soa/partials.py``: (B, T, nv, nq) each, dtau_dqm[:, 0] = 0.  With
    ``halo``, the steps of a slice of the horizon
    (``soa/partials.py::step_triplets``)."""
    from idto_tpu_torch.soa.partials import step_triplets

    B, nq = qs.shape[0], qs.shape[2]
    T = qs.shape[1] - (2 if halo else 1)
    nv = model.nv
    n = B * T
    dt = prob.dt

    # Triplets on a flat (b, t) instance axis; q_{t-1} at t = 0 is a dummy
    # copy of q_0 (its tau uses v_init and its dqm block is zero).
    qm, qt, qp, is_t0 = step_triplets(qs, halo)
    trip = torch.stack([qm, qt, qp])  # (3 slots, nq, n)
    h = _fd_steps(trip, _FD_POW[order])
    v_init = prob.v_init.to(qs.dtype).reshape(-1, nv)[:, None, :].expand(
        B, T, nv).reshape(n, nv).T

    # onehot[a, i, s, j] = 1 where slot s, coordinate j is the perturbed
    # argument a, coordinate i.
    eye3 = torch.eye(3, dtype=qs.dtype, device=qs.device)
    eyeq = torch.eye(nq, dtype=qs.dtype, device=qs.device)
    onehot = eye3[:, None, :, None, None] * eyeq[None, :, None, :, None]
    t0 = is_t0.repeat(3 * nq)
    vi = v_init.repeat(1, 3 * nq)

    def tau_at(offset):
        """tau at every triplet with its perturbation scaled by ``offset``
        (x + offset h e_i, as the reference forms it): (nv, 3, nq, n)."""
        x = trip + offset * onehot * h  # (a, i, s, j, n)
        Qm, Qt, Qp = (x[:, :, s].permute(2, 0, 1, 3).reshape(nq, -1)
                      for s in range(3))
        v_t = torch.where(t0[None, :], vi,
                          soa_kin.qdot_to_v(model, Qt, (Qt - Qm) / dt))
        v_p = soa_kin.qdot_to_v(model, Qp, (Qp - Qt) / dt)
        a = (v_p - v_t) / dt
        tau = soa_contact.step_tau(model, contact, Qp, v_p, a)
        return tau.reshape(nv, 3, nq, n)

    # Summed in the reference's order: -f(2h) + 8 f(h) - 8 f(-h) + f(-2h).
    acc = None
    for offset, weight in _STENCIL[order]:
        f = tau_at(offset)
        term = f if weight == 1.0 else (-f if weight == -1.0 else weight * f)
        acc = term if acc is None else acc + term
    J = acc / (_DENOM[order] * h)  # (nv, 3, nq, n)

    def unflat(x):
        # (nv, nq, n) -> (B, T, nv, nq)
        return x.reshape(nv, nq, B, T).permute(2, 3, 0, 1)

    dqm = torch.where(is_t0[None, None, :], torch.zeros_like(J[:, 0]),
                      J[:, 0])
    return IdPartials(unflat(dqm), unflat(J[:, 1]), unflat(J[:, 2]))


def id_partials_for(model, prob, params, qs, halo=False) -> IdPartials:
    """The partials ``params.gradients_method`` asks for, for a batch qs
    (B, T+1, nq), or with ``halo`` for the steps of a slice of the horizon
    (``soa/partials.py::step_triplets``)."""
    from idto_tpu_torch.optimizer.problem import GradientsMethod
    from idto_tpu_torch.soa import partials as soa_partials

    order = {
        GradientsMethod.FORWARD_DIFFERENCES: 1,
        GradientsMethod.CENTRAL_DIFFERENCES: 2,
        GradientsMethod.CENTRAL_DIFFERENCES4: 4,
    }.get(params.gradients_method)
    if order is None:
        return soa_partials.id_partials_batched(model, prob, params.contact,
                                                qs, halo=halo)
    return id_partials_fd(model, prob, params.contact, qs, order=order,
                          halo=halo)


def nplus_stack(model, qs):
    """N^+ at every knot: qs (B, T+1, nq) -> (B, T+1, nv, nq)."""
    from idto_tpu_torch.soa import partials as soa_partials

    return soa_partials.nplus_stack_batched(model, qs)
