"""Gauss-Newton trust-region step: results, statistics, the linear-algebra
tail of one iteration and the dogleg (counterpart of
``idto_tpu/optimizer/solver.py``).

The port runs batch-native only: every function here takes a leading
scenario axis B and works per scenario.  The loop itself is
``optimizer/batched.py``.  Equality constraints (zero generalized force on
the unactuated DoFs) are solved as in the JAX package: the multipliers come
from the Schur complement J~ H~^-1 J~^T, whose n_h + 1 solves with H~ are
one call of the linear solver.  The dense and exact Hessian paths and the
linesearch solver are not ported yet.
"""
from __future__ import annotations

import enum
from typing import Any, NamedTuple

import torch

from idto_tpu_torch.ops import cr_kernel, cyclic_reduction, penta
from idto_tpu_torch.optimizer.hessian import (
    gauss_newton_hessian,
    gradient_from_partials,
)
from idto_tpu_torch.optimizer.problem import (
    LinearSolverType,
    ScalingMethod,
    SolverParameters,
)
from idto_tpu_torch.utils.consts import index
from idto_tpu_torch.utils.structs import tensor_dataclass


class SolverFlag(enum.IntEnum):
    SUCCESS = 0
    LINESEARCH_MAX_ITERS = 1
    FACTORIZATION_FAILED = 2
    MAX_ITERATIONS = 3


class ConvergenceReason(enum.IntEnum):
    """Bitmask."""

    NO_CRITERIA = 0
    COST_REDUCTION = 1
    GRADIENT = 2
    STATE_CHANGE = 4


@tensor_dataclass
class Solution:
    q: Any = None  # (B, T+1, nq)
    v: Any = None  # (B, T+1, nv)
    tau: Any = None  # (B, T, nv)


@tensor_dataclass
class Stats:
    """Per-iteration statistics, (B, max_iterations) rows; entries past
    ``num_iters`` are NaN (floats) or zero (ints)."""

    num_iters: Any = None
    cost: Any = None
    delta: Any = None
    rho: Any = None
    q_norm: Any = None
    dq_norm: Any = None
    dqH_norm: Any = None
    grad_norm: Any = None
    dL_dq: Any = None
    h_norm: Any = None
    merit: Any = None
    time: Any = None
    ls_iters: Any = None
    alpha: Any = None
    solver_flag: Any = None
    convergence_reason: Any = None


@tensor_dataclass
class WarmStart:
    """Carry between re-solves: the trajectory, the trust radius, and the
    last accepted dogleg step and Newton step (physical coordinates)."""

    q: Any = None
    Delta: Any = None
    dq: Any = None
    dqH: Any = None


class _Prepared(NamedTuple):
    """Quantities valid at the current iterate, each with a leading B."""

    cost: Any
    merit: Any
    D: Any  # (B, T+1, nq) scale factors
    g_merit: Any  # scaled merit gradient
    H: Any  # PentaBands, scaled
    factor: Any  # what _lin_solve takes for H
    p_newton: Any  # -H~^{-1} g~ (scaled coordinates)
    p_cauchy: Any  # -(g~^T g~ / g~^T H~ g~) g~
    h: Any  # (B, n_h) constraint violations ((B, 0) without constraints)
    lam: Any  # (B, n_h) Lagrange multipliers
    fact_ok: Any  # (B,) factorization succeeded and the step is finite
    solve_ok: Any  # (B,) Newton solve met the residual acceptance
    gs: Any  # scaled cost gradient D g
    Js: Any  # (B, n_h, T+1, nq) scaled constraint Jacobian J D, or None


class _LoopState(NamedTuple):
    k: Any
    q: Any
    Delta: Any
    prev_cost: Any
    reason: Any
    done: Any
    failed: Any  # factorization failure latch
    D: Any  # previous scale factors (adaptive scaling carry)
    dq_last: Any
    dqH_last: Any
    stats: Stats


def containment_rtol(dtype) -> float:
    """Relative-residual bound for accepting a Newton step.  A backward
    stable banded solve has rel_res ~ eps * cond(H~); healthy float32
    solves on the scaled cheetah Hessians reach 1e-3..1e-1, so float32
    contains only catastrophes (>= 0.25); float64 has ~9 more digits."""
    return 0.25 if dtype == torch.float32 else 1e-6


def _bsum(x):
    """Per-scenario sum: (B, ...) -> (B,)."""
    return torch.sum(x.flatten(1), dim=1)


def _bnorm(x):
    return torch.sqrt(_bsum(x * x))


def _ball(x):
    return torch.all(x.flatten(1), dim=1)


def _bcast(s, x):
    """(B,) -> broadcastable against (B, ...)."""
    return s.reshape(s.shape + (1,) * (x.ndim - 1))


def _scale_factors_from_diag(diag, method: ScalingMethod, D_prev):
    """D from the Hessian diagonal; adaptive variants take the running
    minimum against the previous iteration's D (seeded with ones)."""
    safe = torch.clamp_min(diag, 1e-30)
    if method in (ScalingMethod.SQRT, ScalingMethod.ADAPTIVE_SQRT):
        d = 1.0 / torch.sqrt(safe)
    else:
        d = 1.0 / torch.sqrt(torch.sqrt(safe))
    if method in (ScalingMethod.ADAPTIVE_SQRT,
                  ScalingMethod.ADAPTIVE_DOUBLE_SQRT):
        return torch.minimum(D_prev, d)
    return torch.clamp_max(d, 1.0)


def _use_cr(params: SolverParameters) -> bool:
    if params.linear_solver == LinearSolverType.CYCLIC_REDUCTION:
        return True
    if params.linear_solver == LinearSolverType.PENTA_LU:
        return False
    raise NotImplementedError(f"linear solver {params.linear_solver}")


# Packed super-rows (counted as the next power of two) up to which
# ``cr_use_pallas=True`` runs the whole reduction in the fused kernel; the
# hybrid's level-wise part reduces a longer system down to this many.
FUSED_MAX_ROWS = 64


def _hybrid_tail_rows(params: SolverParameters, n_rows: int) -> int:
    """Rows left to the fused kernel by ``cyclic_reduction.factorize`` for
    a system of ``n_rows`` block rows: 0 means the fused kernel takes the
    whole system (no level-wise part), 1 level-wise throughout."""
    if params.cr_use_pallas is None:
        return 0
    if params.cr_use_pallas is False:
        return 1
    m = (n_rows + 1) // 2
    mpow = 1 << max(m - 1, 0).bit_length()
    return 0 if mpow <= FUSED_MAX_ROWS else FUSED_MAX_ROWS


def _sparse_factorize(params, Hs):
    """What ``_lin_solve`` takes for H.  The fused cyclic reduction does
    factorization and solve in one launch, so its 'factor' is the band matrix
    itself; level-wise cyclic reduction (with or without the kernel's tail)
    and Thomas factor once for all solves of the iteration."""
    if not _use_cr(params):
        return penta.factorize(Hs)
    tail_rows = _hybrid_tail_rows(params, Hs.n)
    if tail_rows == 0:
        return Hs
    return cyclic_reduction.factorize(Hs, tail_rows=tail_rows)


def _lin_solve_many(factor, rhs_stack):
    """Solve H X = rhs for a stack (B, R, n, k) of right-hand sides with
    the factor of ``_sparse_factorize``: one launch of the fused kernel for
    all R columns, or one application of the stored factorization."""
    if isinstance(factor, penta.PentaBands):
        return cr_kernel.solve_many(factor, rhs_stack)
    if isinstance(factor, cyclic_reduction.CRFactorization):
        return cyclic_reduction.solve_factorized(factor, rhs_stack)
    return penta.solve_factorized_many(factor, rhs_stack)


def _lin_solve(factor, rhs):
    """Solve H x = rhs, rhs (B, n, k)."""
    return _lin_solve_many(factor, rhs[:, None])[:, 0]


def _constraint_jacobian_dense(model, prob, parts, unact):
    """J = dh/dq as a dense (B, T*n_un, T+1, nq) tensor.  h stacks
    tau_t[unactuated] for t = 0..T-1; its rows are rows of the tri-diagonal
    dtau/dq blocks.  q_0 is not a decision variable: its column block is
    zero."""
    T = prob.num_steps
    nq = model.nq
    n_un = len(unact)
    dm, dt_, dp = (X[:, :, index(unact, X.device), :] for X in parts)
    J = torch.zeros((dm.shape[0], T, n_un, T + 1, nq), dtype=dm.dtype,
                    device=dm.device)
    # Block (t, s) of J is dtau_t/dq_s: the diagonals s = t - 1, t, t + 1.
    J.diagonal(-1, 1, 3).copy_(dm[:, 1:].permute(0, 2, 3, 1))
    J.diagonal(0, 1, 3).copy_(dt_.permute(0, 2, 3, 1))
    J.diagonal(1, 1, 3).copy_(dp.permute(0, 2, 3, 1))
    J[:, :, :, 0] = 0.0
    return J.reshape(-1, T * n_un, T + 1, nq)


def _newton_tail(cost, D, Hs, gs, h, Js, factor, fact_ok) -> _Prepared:
    """From the scaled system and a factor of it: the multipliers and the
    merit (with constraints), the Newton step with its per-scenario
    containment, and the Cauchy step."""
    dtype = gs.dtype
    if Js is not None:
        # Lagrange multipliers: (J~ H~^-1 J~^T) lam = h - J~ H~^-1 g~.  All
        # n_h + 1 solves share one factorization (one launch of the fused
        # kernel).
        sols = _lin_solve_many(factor, torch.cat([gs[:, None], Js], dim=1))
        Hinv_g, Hinv_JT = sols[:, 0], sols[:, 1:]
        S = torch.einsum("banq,bcnq->bac", Js, Hinv_JT)
        rhs = h - torch.einsum("banq,bnq->ba", Js, Hinv_g)
        lam = torch.linalg.solve_ex(S, rhs[..., None],
                                    check_errors=False).result[..., 0]
        g_merit = gs + torch.einsum("banq,ba->bnq", Js, lam)
        merit = cost + _bsum(h * lam)
    else:
        lam = h
        g_merit = gs
        merit = cost

    p_newton = -_lin_solve(factor, g_merit)
    Hg = penta.matvec(Hs, g_merit)
    gg = _bsum(g_merit * g_merit)
    gHg = _bsum(g_merit * Hg)
    p_cauchy = -_bcast(gg / torch.clamp_min(gHg, 1e-300), g_merit) * g_merit

    # Per-scenario containment: accept the Newton step only if its residual
    # is small relative to the gradient, else take the (always descent)
    # Cauchy step and report the degradation through solve_ok.
    res = penta.matvec(Hs, p_newton) + g_merit
    tiny = torch.finfo(dtype).tiny
    rel_res = torch.sqrt(_bsum(res * res)) / torch.sqrt(
        torch.clamp_min(gg, tiny)
    )
    solve_ok = _ball(torch.isfinite(p_newton)) & (
        rel_res < containment_rtol(dtype)
    )
    p_newton = torch.where(_bcast(solve_ok, p_newton), p_newton, p_cauchy)
    fact_ok = fact_ok & _ball(torch.isfinite(p_newton))

    return _Prepared(
        cost=cost, merit=merit, D=D, g_merit=g_merit, H=Hs, factor=factor,
        p_newton=p_newton, p_cauchy=p_cauchy, h=h, lam=lam, fact_ok=fact_ok,
        solve_ok=solve_ok, gs=gs, Js=Js,
    )


def _factor_status(factor, B, device):
    """(B,) the factor's blocks are finite.  A singular block gives inf/nan
    in the Thomas and level-wise factors; the fused cyclic reduction has no
    separate factor, so only the step's finiteness reports it."""
    if isinstance(factor, penta.PentaBands):
        return torch.ones(B, dtype=torch.bool, device=device)
    if isinstance(factor, cyclic_reduction.CRFactorization):
        return cyclic_reduction.factorization_status(factor)
    return penta.factorization_status(factor)


def _prepare_from_physics(
    model, prob, params: SolverParameters, q, D_prev, cost, v, tau, parts,
    nplus,
) -> _Prepared:
    """Gradient and Hessian assembly, scaling, factorization, the
    constraint Schur solve, the Newton solve with its per-scenario
    containment, and the Cauchy step, from already evaluated physics (the
    banded branch of the JAX package)."""
    B = q.shape[0]
    g = gradient_from_partials(model, prob, parts, nplus, q, v, tau)
    H = gauss_newton_hessian(model, prob, parts, nplus)
    if params.scaling:
        D = _scale_factors_from_diag(
            penta.extract_diagonal(H), params.scaling_method, D_prev
        )
        Hs = penta.scale_by_diagonal(H, D)
        gs = D * g
    else:
        D = torch.ones_like(g)
        Hs = H
        gs = g
    factor = _sparse_factorize(params, Hs)

    unact = model.unactuated_vdofs
    if params.equality_constraints and prob.num_steps * len(unact) > 0:
        h = tau[:, :, index(unact, tau.device)].reshape(B, -1)
        Js = _constraint_jacobian_dense(model, prob, parts, unact) \
            * D[:, None]  # J~ = J D
    else:
        h = torch.zeros((B, 0), dtype=q.dtype, device=q.device)
        Js = None
    return _newton_tail(cost, D, Hs, gs, h, Js, factor,
                        _factor_status(factor, B, q.device))


def _dogleg(prep: _Prepared, Delta):
    """Dogleg step per scenario; Delta (B,).  Returns (dq_scaled, dq,
    boundary_active): dq_scaled in the scaled coordinates of the quadratic
    model, dq = D * dq_scaled the physical update."""
    x = prep.p_newton
    Dl = _bcast(Delta, x)
    pU = prep.p_cauchy / Dl  # Delta-normalized
    pH = prep.p_newton / Dl
    pU_norm = _bnorm(pU)
    pH_norm = _bnorm(pH)

    # Candidate 1: the first leg hits the boundary.
    dq1 = _bcast(Delta / torch.clamp_min(pU_norm, 1e-300), x) * pU
    # Candidate 2: the full Newton step inside the region.
    dq2 = pH * Dl
    # Candidate 3: second leg meets the boundary.
    diff = pH - pU
    a = _bsum(diff * diff)
    b = 2.0 * _bsum(pU * diff)
    c = _bsum(pU * pU) - 1.0
    a_safe = torch.clamp_min(a, 1e-300)
    det = torch.clamp_min((b / a_safe) ** 2 - 4.0 * (c / a_safe), 0.0)
    s_quad = (-(b / a_safe) + torch.sqrt(det)) / 2.0
    s_lin = -c / torch.where(b == 0, torch.ones_like(b), b)
    s = torch.where(a < torch.finfo(Delta.dtype).eps, s_lin, s_quad)
    dq3 = (pU + _bcast(s, x) * diff) * Dl

    first_leg = pU_norm >= 1.0
    newton_inside = pH_norm <= 1.0
    dq_scaled = torch.where(
        _bcast(first_leg, x), dq1,
        torch.where(_bcast(newton_inside, x), dq2, dq3),
    )
    boundary_active = first_leg | ~newton_inside
    return dq_scaled, prep.D * dq_scaled, boundary_active
