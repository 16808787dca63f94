"""Research-debug dumps in the reference's column layouts (counterpart of
``idto_tpu/optimizer/debug_dump.py``):

  * the per-iteration quadratic-model CSV ``quadratic_data.csv``;
  * the linesearch residual sweep over alpha in [-0.2, 1.2];
  * the Hessian condition numbers (print_debug_data).

The solve loop keeps no per-iteration host record, so the dumps replay the
solve as repeated one-iteration warm-started solves (trajectory and trust
radius carried; the adaptive scale factors re-derived).  q is one
trajectory (T+1, nq); debug only, speed does not matter here.  Its own
evaluations run eagerly, also on the card (the JAX package jits them; see
``ROADMAP.md``); the solves it calls replay their captured graphs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from idto_tpu_torch.models.model import Model
from idto_tpu_torch.ops import penta
from idto_tpu_torch.optimizer import trajectory
from idto_tpu_torch.optimizer.hessian import (
    gauss_newton_hessian,
    gradient_from_partials,
)
from idto_tpu_torch.optimizer.partials import id_partials_for, nplus_stack
from idto_tpu_torch.optimizer.problem import ProblemDefinition, SolverParameters
from idto_tpu_torch.optimizer.solver import (
    WarmStart,
    _scale_factors_from_diag,
    solve_from_warm_start,
)
from idto_tpu_torch.soa import rollout
from idto_tpu_torch.soa.kinematics import normalize_quaternions


class IterRecord(NamedTuple):
    k: int
    q: np.ndarray          # (T+1, nq) iterate at the START of iteration k
    Delta: float
    cost: float
    g: np.ndarray          # (T+1, nq) unscaled gradient
    H_dense: np.ndarray    # (n, n) unscaled GN Hessian, dense
    Hs_dense: np.ndarray   # (n, n) scaled GN Hessian, dense
    dq: np.ndarray         # (T+1, nq) dogleg step attempted this iteration
    dqH: np.ndarray        # (T+1, nq) full (unscaled-coordinates) Newton step


def _np(x):
    return x.detach().cpu().numpy()


def _physics(model, prob, params, qs):
    """(cost, gradient, partials, nplus) of a batch qs (B, T+1, nq)."""
    contact = params.contact
    tau, v = rollout.generalized_forces(model, prob, contact, qs)
    cost = rollout.cost(model, prob, contact, qs, tau=tau, v=v)
    parts = id_partials_for(model, prob, params, qs)
    nplus = nplus_stack(model, qs)
    g = gradient_from_partials(model, prob, parts, nplus, qs, v, tau)
    return cost, g, parts, nplus


def replay_iterations(
    model: Model,
    prob: ProblemDefinition,
    params: SolverParameters,
    q_guess,
    n_iters: int,
):
    """Yield an IterRecord per solver iteration (see module docstring)."""
    params1 = params.replace(
        max_iterations=1, check_convergence=False, verbose=False,
        record_iteration_times=False,
    )
    q = q_guess
    Delta = torch.as_tensor(params.Delta0, dtype=q.dtype, device=q.device)
    D_prev = torch.ones_like(q)[None]
    for k in range(n_iters):
        cost, g, parts, nplus = _physics(model, prob, params, q[None])
        H = gauss_newton_hessian(model, prob, parts, nplus)
        Hd = penta.to_dense(H)
        if params.scaling:
            D = _scale_factors_from_diag(
                penta.extract_diagonal(H), params.scaling_method, D_prev
            )
            Df = D.reshape(1, -1)
            Hs = Df[:, :, None] * Hd * Df[:, None, :]
            D_prev = D
        else:
            Hs = Hd
        _, _, warm = solve_from_warm_start(
            model, prob, params1,
            WarmStart(q=q, Delta=Delta, dq=torch.zeros_like(q),
                      dqH=torch.zeros_like(q)))
        yield IterRecord(
            k=k, q=_np(q), Delta=float(Delta), cost=float(cost[0]),
            g=_np(g[0]), H_dense=_np(Hd[0]), Hs_dense=_np(Hs[0]),
            dq=_np(warm.dq), dqH=_np(warm.dqH),
        )
        q, Delta = warm.q, warm.Delta


def save_quadratic_csv(
    model, prob, params, q_guess, path: str, n_iters: int | None = None
) -> None:
    """Per-iteration quadratic-model data, column for column the
    reference's quadratic_data.csv: iter, q1, q2, dq1, dq2, Delta, cost,
    g1, g2, H11, H12, H21, H22, g_norm, H_norm -- (q1, q2) the first two
    dofs of block t=1, the H block the corresponding 2x2 of the dense
    Hessian, H_norm the Frobenius norm of the literal block(2,2,2,2) as in
    the reference."""
    if model.nq < 2:
        raise ValueError(
            "quadratic data dump needs nq >= 2 (first two dofs of q_1), "
            f"got nq={model.nq}"
        )
    nq = model.nq
    n_iters = n_iters if n_iters is not None else params.max_iterations
    rows = []
    for r in replay_iterations(model, prob, params, q_guess, n_iters):
        rows.append(
            [
                r.k,
                r.q[1, 0], r.q[1, 1],
                r.dq[1, 0], r.dq[1, 1],
                r.Delta, r.cost,
                r.g[1, 0], r.g[1, 1],
                r.H_dense[nq, nq], r.H_dense[nq, nq + 1],
                r.H_dense[nq + 1, nq], r.H_dense[nq + 1, nq + 1],
                np.linalg.norm(r.g),
                np.linalg.norm(r.H_dense[2:4, 2:4]),
            ]
        )
    header = (
        "iter, q1, q2, dq1, dq2, Delta, cost , g1, g2, H11, H12, H21, "
        "H22, g_norm, H_norm"
    )
    np.savetxt(
        path, np.asarray(rows, dtype=np.float64), delimiter=", ",
        header=header, comments="",
    )


def save_linesearch_residual_csv(
    model, prob, params, q, dq, path: str
) -> None:
    """Linesearch residual sweep: columns alpha, cost, gradient, dq,
    L_prime, with alpha in [-0.2, 1.2] step 0.01; cost = L(q + alpha dq) -
    L(q), gradient = ||g(q + alpha dq)||, dq = ||dq||, L_prime =
    g(q + alpha dq) . dq.  All alphas are one batch."""
    alphas = np.arange(-0.2, 1.2 + 1e-9, 0.01)
    a = torch.as_tensor(alphas, dtype=q.dtype, device=q.device)
    q_a = q[None] + a[:, None, None] * dq[None]
    if params.normalize_quaternions:
        q_a = normalize_quaternions(model, q_a)
    costs, g, _, _ = _physics(model, prob, params, q_a)
    gnorms = torch.sqrt(torch.sum(g * g, dim=(1, 2)))
    lprime = torch.sum(g * dq[None], dim=(1, 2))
    cost_ref = float(trajectory.cost(model, prob, params.contact, q))
    dq_norm = float(torch.linalg.vector_norm(dq))
    data = np.stack(
        [
            alphas,
            _np(costs) - cost_ref,
            _np(gnorms),
            np.full_like(alphas, dq_norm),
            _np(lprime),
        ],
        axis=1,
    )
    np.savetxt(
        path, data, delimiter=", ",
        header="alpha, cost, gradient, dq, L_prime ", comments="",
    )


def print_condition_numbers(r: IterRecord) -> None:
    """1-norm condition numbers of the dense Hessian and the scaled one
    (print_debug_data)."""
    cond = np.linalg.cond(r.H_dense, 1)
    cond_scaled = np.linalg.cond(r.Hs_dense, 1)
    print(f"condition_number = {cond:.6g}")
    print(f"condition_number_scaled = {cond_scaled:.6g}")
