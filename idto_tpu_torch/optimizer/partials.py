"""Inverse-dynamics partials: the container, the exact partials of one
problem, the finite-difference partials and the dispatch on
``gradients_method`` (counterpart of ``idto_tpu/optimizer/partials.py``;
the batch-native exact partials are ``soa/partials.py``).

tau_t depends on its configuration triplet through
    v_t     = N^+(q_t)   (q_t   - q_{t-1}) / dt      (v_0 = v_init, const)
    v_{t+1} = N^+(q_{t+1})(q_{t+1} - q_t) / dt
    a_t     = (v_{t+1} - v_t) / dt
    tau_t   = ID(q_{t+1}, v_{t+1}, a_t, contact(q_{t+1}, v_{t+1})),
so the partials are three (T, nv, nq) block diagonals.

``id_partials`` is the per-problem (AoS) route: ``torch.func.jacfwd`` of
the AoS ``step_tau``, vmapped over the horizon.  The finite differences
are batch-native: every perturbed coordinate of every step's triplet is one
more instance on the SoA instance axis, so one ``step_tau`` call evaluates
a stencil point for all coordinates of all steps of all scenarios.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from idto_tpu_torch.models.kinematics import nplus_matrix, qdot_to_v
from idto_tpu_torch.optimizer.trajectory_aos import step_tau
from idto_tpu_torch.soa import contact as soa_contact
from idto_tpu_torch.soa import kinematics as soa_kin


class IdPartials(NamedTuple):
    """d tau_t / d q_{t-1}, d q_t, d q_{t+1}: (..., T, nv, nq) each;
    dtau_dqm[..., 0, :, :] is identically zero (q_{-1} does not exist)."""

    dtau_dqm: torch.Tensor
    dtau_dqt: torch.Tensor
    dtau_dqp: torch.Tensor


def _stack_steps(first, mid, num_steps):
    """(dqm, dqt, dqp) over the horizon from step 0's (dqt, dqp) and the
    vmapped steps 1..T-1; dqm at t = 0 is zero (q_{-1} does not exist)."""
    d0t, d0p = first
    if num_steps == 1:
        return IdPartials(torch.zeros_like(d0t)[None], d0t[None], d0p[None])
    dm, dt_, dp = mid
    return IdPartials(torch.cat([torch.zeros_like(dm[:1]), dm]),
                      torch.cat([d0t[None], dt_]), torch.cat([d0p[None], dp]))


def id_partials(model, prob, contact, q) -> IdPartials:
    """Exact partials of one problem, q (T+1, nq), by the explicit chain
    rule: (T, nv, nq) each.

    Forward mode through the kinematics covers only the nq tangents of
    q_{t+1} at fixed (v, a); the v- and a-dependence is differentiated
    with FK-free tangents (ID is linear in a, body velocities are linear
    in v), and the q_t / q_{t-1} blocks assemble from M = dID/da and
    Cv = dID/dv.  With the velocity map w(q) = N^+(q) applied to a
    finite difference,
      dtau/dq_{t+1} = Gq + (Cv + M/dt) Vp_p
      dtau/dq_t     = (Cv + M/dt) Vp_t - (M/dt) Vt_t
      dtau/dq_{t-1} =              (M/dt) N^+(q_t)/dt
    where Gq = dID/dq_{t+1} at fixed (v, a), Vp_p = d v_{t+1}/d q_{t+1},
    Vp_t = -N^+(q_{t+1})/dt and Vt_t = d v_t/d q_t (the N^+ product-rule
    terms are nonzero only for quaternion blocks)."""
    dt = prob.dt
    v_init = prob.v_init.to(q.dtype)

    def step_blocks(qt, qp, v_t):
        """(M, Cv, Gq, Vp_p, N^+(q_{t+1})) at one step; v_t is constant
        with respect to this step's derivatives."""
        v_p = qdot_to_v(model, qp, (qp - qt) / dt)
        a_t = (v_p - v_t) / dt
        Gq = jacfwd(lambda qq: step_tau(model, contact, qq, v_p, a_t))(qp)
        Cv, M = jacfwd(lambda vv, aa: step_tau(model, contact, qp, vv, aa),
                       argnums=(0, 1))(v_p, a_t)
        Vp_p = jacfwd(lambda qq: qdot_to_v(model, qq, (qq - qt) / dt))(qp)
        return M, Cv, Gq, Vp_p, nplus_matrix(model, qp)

    def parts_mid(qm, qt, qp):
        v_t = qdot_to_v(model, qt, (qt - qm) / dt)
        M, Cv, Gq, Vp_p, Npp = step_blocks(qt, qp, v_t)
        Vt_t = jacfwd(lambda qq: qdot_to_v(model, qq, (qq - qm) / dt))(qt)
        CvM = Cv + M / dt
        return ((M / dt) @ (nplus_matrix(model, qt) / dt),
                CvM @ (-Npp / dt) - (M / dt) @ Vt_t,
                Gq + CvM @ Vp_p)

    def parts_first(qt, qp):
        M, Cv, Gq, Vp_p, Npp = step_blocks(qt, qp, v_init)
        CvM = Cv + M / dt
        return CvM @ (-Npp / dt), Gq + CvM @ Vp_p  # v_0 = v_init: constant

    mid = (vmap(parts_mid)(q[:-2], q[1:-1], q[2:])
           if prob.num_steps > 1 else None)
    return _stack_steps(parts_first(q[0], q[1]), mid, prob.num_steps)


def id_partials_full_jacfwd(model, prob, contact, q) -> IdPartials:
    """Exact partials of one problem by one ``jacfwd`` over the whole
    (q_{t-1}, q_t, q_{t+1}) triplet (3 nq tangents through the kinematics):
    the oracle of ``id_partials``."""
    dt = prob.dt
    v_init = prob.v_init.to(q.dtype)

    def tau_mid(qm, qt, qp):
        v_t = qdot_to_v(model, qt, (qt - qm) / dt)
        v_p = qdot_to_v(model, qp, (qp - qt) / dt)
        return step_tau(model, contact, qp, v_p, (v_p - v_t) / dt)

    def tau_first(qt, qp):
        v_p = qdot_to_v(model, qp, (qp - qt) / dt)
        return step_tau(model, contact, qp, v_p, (v_p - v_init) / dt)

    mid = (vmap(jacfwd(tau_mid, argnums=(0, 1, 2)))(q[:-2], q[1:-1], q[2:])
           if prob.num_steps > 1 else None)
    return _stack_steps(jacfwd(tau_first, argnums=(0, 1))(q[0], q[1]), mid,
                        prob.num_steps)


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
    """The partials ``params.gradients_method`` asks for.  For a batch qs
    (B, T+1, nq) the batch-native ones, or with ``halo`` those of the steps
    of a slice of the horizon (``soa/partials.py::step_triplets``); for one
    problem's q (T+1, nq) the per-problem route: ``id_partials``, or the
    finite differences of that one problem."""
    from idto_tpu_torch.optimizer.problem import GradientsMethod
    from idto_tpu_torch.soa import partials as soa_partials

    order = {
        GradientsMethod.FORWARD_DIFFERENCES: 1,
        GradientsMethod.CENTRAL_DIFFERENCES: 2,
        GradientsMethod.CENTRAL_DIFFERENCES4: 4,
    }.get(params.gradients_method)
    if qs.ndim == 2:
        if order is None:
            return id_partials(model, prob, params.contact, qs)
        return IdPartials(*(x[0] for x in id_partials_fd(
            model, prob, params.contact, qs[None], order=order)))
    if order is None:
        return soa_partials.id_partials_batched(model, prob, params.contact,
                                                qs, halo=halo)
    return id_partials_fd(model, prob, params.contact, qs, order=order,
                          halo=halo)


def nplus_stack(model, qs):
    """N^+ at every knot: qs (B, T+1, nq) -> (B, T+1, nv, nq), or one
    problem's q (T+1, nq) -> (T+1, nv, nq) on the per-problem route."""
    from idto_tpu_torch.soa import partials as soa_partials

    if qs.ndim == 2:
        return vmap(lambda qq: nplus_matrix(model, qq))(qs)
    return soa_partials.nplus_stack_batched(model, qs)
