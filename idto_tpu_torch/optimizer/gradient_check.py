"""Finite-difference gradient diagnostics (counterpart of
``idto_tpu/optimizer/gradient_check.py``): forward and central (2nd and
4th order) differences of the cost, independent oracles for the solver's
assembled gradient.

q is one trajectory (T+1, nq).  Every perturbed trajectory of a stencil
point is one scenario of a single batched cost evaluation.  It runs
eagerly, also on the card (a debug path; the JAX package jits it): no
captured region of ``utils/graphs.py`` (queued in ``ROADMAP.md``).
"""
from __future__ import annotations

import torch

from idto_tpu_torch.optimizer import trajectory
from idto_tpu_torch.optimizer.hessian import gradient_from_partials
from idto_tpu_torch.optimizer.partials import _fd_steps
from idto_tpu_torch.soa import partials as soa_partials
from idto_tpu_torch.soa import rollout


def _costs_at(model, prob, params, q, h, offset):
    """L(q + offset h_i e_i) for every variable i: ((T+1) nq,)."""
    n = q.numel()
    eye = torch.eye(n, dtype=q.dtype, device=q.device)
    qs = q.reshape(1, n) + offset * eye * h.reshape(1, n)
    return trajectory.cost(model, prob, params.contact,
                           qs.reshape((n,) + tuple(q.shape)))


def _zero_first(g):
    return torch.cat([torch.zeros_like(g[:1]), g[1:]])


def fd_gradient(model, prob, params, q):
    """Forward-difference dL/dq, (T+1, nq), q_0 block zeroed."""
    h = _fd_steps(q, 0.5)
    L0 = trajectory.cost(model, prob, params.contact, q)
    g = (_costs_at(model, prob, params, q, h, 1.0) - L0) / h.reshape(-1)
    return _zero_first(g.reshape(q.shape))


def cd_gradient(model, prob, params, q, order: int = 2):
    """Central-difference dL/dq of order 2 or 4, q_0 block zeroed."""
    h = _fd_steps(q, 1.0 / 3.0 if order == 2 else 1.0 / 5.0)

    def at(offset):
        return _costs_at(model, prob, params, q, h, offset)

    hf = h.reshape(-1)
    if order == 2:
        g = (at(1.0) - at(-1.0)) / (2.0 * hf)
    else:
        g = (-at(2.0) + 8.0 * at(1.0) - 8.0 * at(-1.0) + at(-2.0)) / (
            12.0 * hf)
    return _zero_first(g.reshape(q.shape))


def analytic_gradient(model, prob, params, q):
    """The solver's gradient, assembled from the exact partials."""
    qs = q[None]
    contact = params.contact
    tau, v = rollout.generalized_forces(model, prob, contact, qs)
    parts = soa_partials.id_partials_batched(model, prob, contact, qs)
    nplus = soa_partials.nplus_stack_batched(model, qs)
    return gradient_from_partials(model, prob, parts, nplus, qs, v, tau)[0]
