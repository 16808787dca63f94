"""Gauss-Newton trust-region step: results, statistics, the linear-algebra
tail of one iteration, the dogleg, the verbose table, the single-problem
``solve`` and the per-problem reference loop ``solve_trust_region``
(counterpart of ``idto_tpu/optimizer/solver.py``).

Every function of the linear-algebra tail takes a leading scenario axis B
and works per scenario.  The batch-native loop is ``optimizer/batched.py``;
``solve`` and ``solve_from_warm_start`` are B=1 calls of it.
``solve_trust_region`` is the per-problem loop: its physics is the AoS
pipeline (``optimizer/trajectory_aos.py``, ``optimizer/partials.py::
id_partials``), its linear algebra this module's tail with a leading axis
of one, and it is the reference the batch-native loop is held against
(``solve_batch(native=False)``).  Equality constraints (zero generalized
force on the unactuated DoFs) are solved as in the JAX package: the
multipliers come from the Schur complement J~ H~^-1 J~^T, whose n_h + 1
solves with H~ are one call of the linear solver.  ``DENSE_LDLT`` and
``exact_hessian`` route the linear algebra through a dense partial-pivot
LU (a library call, as in the JAX package, which computes it outside any
Pallas kernel).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, NamedTuple

import torch
from torch.func import grad, jvp, vmap

from idto_tpu_torch.models.kinematics import normalize_quaternions
from idto_tpu_torch.ops import cr_kernel, cyclic_reduction, penta
from idto_tpu_torch.optimizer import itimer, trajectory_aos
from idto_tpu_torch.optimizer.hessian import (
    gauss_newton_hessian,
    gradient_from_partials,
)
from idto_tpu_torch.optimizer.partials import (
    IdPartials,
    id_partials_for,
    nplus_stack,
)
from idto_tpu_torch.optimizer.problem import (
    LinearSolverType,
    ScalingMethod,
    SolverParameters,
)
from idto_tpu_torch.parallel import horizon as parallel_horizon
from idto_tpu_torch.soa import rollout
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
    H: Any  # PentaBands, scaled; (B, n, n) on the dense path
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


def _use_dense(params: SolverParameters) -> bool:
    """The linear algebra goes through a dense factorization: DENSE_LDLT,
    or the exact Hessian, which is not penta-diagonal."""
    return params.exact_hessian or (
        params.linear_solver == LinearSolverType.DENSE_LDLT
    )


def _use_cr(params: SolverParameters) -> bool:
    return (not _use_dense(params)) and (
        params.linear_solver == LinearSolverType.CYCLIC_REDUCTION
    )


class DenseFactor(NamedTuple):
    """Partial-pivot LU of a batch of dense (B, n, n) matrices: not
    Cholesky, since the exact Hessian can be indefinite away from a
    minimum.  A singular matrix gives finite factors with a zero pivot and
    an inf/nan step, which the step's finiteness check reports."""

    LU: Any
    pivots: Any


def _dense_factorize(Hd) -> DenseFactor:
    LU, pivots, _ = torch.linalg.lu_factor_ex(Hd, check_errors=False)
    return DenseFactor(LU, pivots)


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


def _sparse_factorize(params, Hs, horizon=None):
    """What ``_lin_solve`` takes for H.  The fused cyclic reduction does
    factorization and solve in one launch, so its 'factor' is the band matrix
    itself; level-wise cyclic reduction (with or without the kernel's tail)
    and Thomas factor once for all solves of the iteration.  With the
    horizon sharded (``horizon``, a ``parallel.horizon.HorizonSplit``),
    cyclic reduction is the distributed one of ``parallel/horizon.py``."""
    if not _use_cr(params):
        return penta.factorize(Hs)
    if horizon is not None:
        return horizon.factorize(Hs)
    tail_rows = _hybrid_tail_rows(params, Hs.n)
    if tail_rows == 0:
        return Hs
    return cyclic_reduction.factorize(Hs, tail_rows=tail_rows)


def _lin_solve_many(factor, rhs_stack):
    """Solve H X = rhs for a stack (B, R, n, k) of right-hand sides with
    the factor of ``_sparse_factorize`` or ``_dense_factorize``: one launch
    of the fused kernel for all R columns, or one application of the
    stored factorization."""
    if isinstance(factor, DenseFactor):
        B, R = rhs_stack.shape[:2]
        b = rhs_stack.reshape(B, R, -1).transpose(1, 2)
        x = torch.linalg.lu_solve(factor.LU, factor.pivots, b)
        return x.transpose(1, 2).reshape(rhs_stack.shape)
    if isinstance(factor, penta.PentaBands):
        return cr_kernel.solve_many(factor, rhs_stack)
    if isinstance(factor, cyclic_reduction.CRFactorization):
        return cyclic_reduction.solve_factorized(factor, rhs_stack)
    if isinstance(factor, parallel_horizon.ShardedCRFactor):
        return parallel_horizon.solve_factorized_sharded(factor, rhs_stack)
    return penta.solve_factorized_many(factor, rhs_stack)


def _lin_solve(factor, rhs):
    """Solve H x = rhs, rhs (B, n, k)."""
    return _lin_solve_many(factor, rhs[:, None])[:, 0]


def _lin_matvec(H, x):
    """H x per scenario, x (B, n, k); H bands or dense (B, n*k, n*k)."""
    if isinstance(H, torch.Tensor):
        return (H @ x.reshape(x.shape[0], -1, 1)).reshape(x.shape)
    return penta.matvec(H, x)


def _exact_hessian_dense(model, prob, params, q, cost=None):
    """Exact Hessian of the cost, dense (B, n, n), with the q_0 block
    pinned to the identity: forward mode over the reverse-mode gradient of
    the cost, one tangent per decision variable, all scenarios at once
    (their costs are independent, so a tangent that moves every scenario's
    variable j gives each scenario's column j).  ``cost`` maps (B, T+1,
    nq) to (B,): the SoA rollout's unless given."""
    B, Tp1, nq = q.shape
    n = Tp1 * nq
    if cost is None:
        def cost(x):
            return rollout.cost(model, prob, params.contact, x)

    def g(qf):
        return grad(lambda x: torch.sum(cost(x.reshape(B, Tp1, nq))))(qf)

    qf = q.reshape(B, n)
    eye = torch.eye(n, dtype=q.dtype, device=q.device)
    cols = vmap(lambda e: jvp(g, (qf,), (e.expand(B, n),))[1])(eye)
    Hd = cols.permute(1, 2, 0).clone()  # Hd[b, i, j] = d g_i / d q_j
    Hd[:, :nq, :] = 0.0
    Hd[:, :, :nq] = 0.0
    Hd[:, :nq, :nq] = torch.eye(nq, dtype=q.dtype, device=q.device)
    return Hd


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


def _newton_tail(cost, D, Hs, gs, h, Js, factor, fact_ok,
                 compare_dense=False) -> _Prepared:
    """From the scaled system and a factor of it: the multipliers and the
    merit (with constraints), the Newton step with its per-scenario
    containment, and the Cauchy step.  ``compare_dense`` re-solves the
    step densely and prints the relative difference, a line a scenario."""
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
    if compare_dense:
        Hd = penta.to_dense(Hs)
        x_dense = torch.linalg.solve(
            Hd, -g_merit.reshape(g_merit.shape[0], -1, 1)
        ).reshape(g_merit.shape)
        err = _bnorm(p_newton - x_dense) / torch.clamp_min(
            _bnorm(x_dense), torch.finfo(dtype).tiny)
        for e in err.tolist():  # host read: a debug option
            print(f"[debug] sparse vs. dense solve relative error: {e:.3e}")
    Hg = _lin_matvec(Hs, g_merit)
    gg = _bsum(g_merit * g_merit)
    gHg = _bsum(g_merit * Hg)
    p_cauchy = -_bcast(gg / torch.clamp_min(gHg, 1e-300), g_merit) * g_merit

    # Per-scenario containment: accept the Newton step only if its residual
    # is small relative to the gradient, else take the (always descent)
    # Cauchy step and report the degradation through solve_ok.
    res = _lin_matvec(Hs, p_newton) + g_merit
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
    separate factor and the dense LU keeps finite factors, so there only
    the step's finiteness reports it."""
    if isinstance(factor, (penta.PentaBands, DenseFactor)):
        return torch.ones(B, dtype=torch.bool, device=device)
    if isinstance(factor, cyclic_reduction.CRFactorization):
        return cyclic_reduction.factorization_status(factor)
    if isinstance(factor, parallel_horizon.ShardedCRFactor):
        return factor.ok
    return penta.factorization_status(factor)


def _scaled(H, g, params, D_prev, diag):
    """(D, D H D, D g) with D from the Hessian diagonal, or no scaling."""
    if not params.scaling:
        return torch.ones_like(g), H, g
    D = _scale_factors_from_diag(diag, params.scaling_method, D_prev)
    if isinstance(H, torch.Tensor):
        Df = D.reshape(D.shape[0], -1)
        return D, Df[:, :, None] * H * Df[:, None, :], D * g
    return D, penta.scale_by_diagonal(H, D), D * g


def _prepare_from_physics(
    model, prob, params: SolverParameters, q, D_prev, cost, v, tau, parts,
    nplus, horizon=None, cost_fn=None,
) -> _Prepared:
    """Gradient and Hessian assembly, scaling, factorization, the
    constraint Schur solve, the Newton solve with its per-scenario
    containment, and the Cauchy step, from already evaluated physics.
    ``horizon`` routes cyclic reduction through the distributed solve
    (``_sparse_factorize``); ``cost_fn`` is the cost the exact Hessian
    differentiates (``_exact_hessian_dense``)."""
    B = q.shape[0]
    g = gradient_from_partials(model, prob, parts, nplus, q, v, tau)
    if _use_dense(params):
        # The exact Hessian (testing), or the Gauss-Newton one densified.
        if params.exact_hessian:
            H = _exact_hessian_dense(model, prob, params, q, cost_fn)
        else:
            H = penta.to_dense(gauss_newton_hessian(model, prob, parts, nplus))
        diag = torch.diagonal(H, dim1=-2, dim2=-1).reshape(q.shape)
        D, Hs, gs = _scaled(H, g, params, D_prev, diag)
        factor = _dense_factorize(Hs)
    else:
        H = gauss_newton_hessian(model, prob, parts, nplus)
        D, Hs, gs = _scaled(H, g, params, D_prev, penta.extract_diagonal(H))
        factor = _sparse_factorize(params, Hs, horizon)

    unact = model.unactuated_vdofs
    if params.equality_constraints and prob.num_steps * len(unact) > 0:
        h = tau[:, :, index(unact, tau.device)].reshape(B, -1)
        Js = _constraint_jacobian_dense(model, prob, parts, unact) \
            * D[:, None]  # J~ = J D
    else:
        h = torch.zeros((B, 0), dtype=q.dtype, device=q.device)
        Js = None
    return _newton_tail(
        cost, D, Hs, gs, h, Js, factor, _factor_status(factor, B, q.device),
        compare_dense=(params.debug_compare_against_dense
                       and not _use_dense(params)),
    )


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


def _print_iter_row(k, cost, merit, Delta, rho, dq_norm, g_norm, h_norm,
                    header=True):
    """One row of the verbose table; with ``header`` the header is printed
    before rows 0, 50, 100, ..."""
    k = int(k)
    if header and k % 50 == 0:
        print(
            f"{'iter':>5} | {'cost':>12} | {'merit':>12} | {'Delta':>9} | "
            f"{'rho':>9} | {'||dq||':>9} | {'||g||':>9} | {'||h||':>9}"
        )
        print("-" * 94)
    print(
        f"{k:>5} | {float(cost):>12.6g} | {float(merit):>12.6g} | "
        f"{float(Delta):>9.3g} | {float(rho):>9.3g} | "
        f"{float(dq_norm):>9.3g} | {float(g_norm):>9.3g} | "
        f"{float(h_norm):>9.3g}"
    )


def unbatch(x):
    """The first scenario of a batched Solution, Stats or WarmStart."""
    return x.replace(**{
        f.name: getattr(x, f.name)[0] for f in dataclasses.fields(x)
        if isinstance(getattr(x, f.name), torch.Tensor)
    })


def solve(model, prob, params, q_guess):
    """Solve one problem from a fresh trust region (or by linesearch when
    ``params.method`` says so): prob unbatched, q_guess (T+1, nq).  A B=1
    call of the batched solve; returns unbatched (Solution, Stats,
    WarmStart)."""
    from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch

    out = solve_batch(model, broadcast_problem(prob, 1), params,
                      q_guess[None])
    return tuple(unbatch(x) for x in out)


def solve_from_warm_start(model, prob, params, warm: WarmStart):
    """Resume one problem's trust-region solve from ``warm`` (unbatched):
    its trajectory, whose q_0 must already be the measured state, and its
    trust radius."""
    from idto_tpu_torch.optimizer.batched import solve_trust_region_batched
    from idto_tpu_torch.parallel.batching import broadcast_problem

    out = solve_trust_region_batched(
        model, broadcast_problem(prob, 1), params, warm.q[None],
        Delta0=torch.as_tensor(warm.Delta, dtype=warm.q.dtype,
                               device=warm.q.device).reshape(1),
    )
    return tuple(unbatch(x) for x in out)


# -- the per-problem reference loop -------------------------------------------

# Stats rows the loop writes an entry of each iteration.
_ROWS = ("cost", "delta", "rho", "q_norm", "dq_norm", "dqH_norm",
         "grad_norm", "dL_dq", "h_norm", "merit")


def _prepare(model, prob, params, q, D_prev) -> _Prepared:
    """Everything the step needs at one problem's iterate q (T+1, nq), from
    the per-problem (AoS) physics; the tail runs with a leading axis of
    one (D_prev and every field of the result lead with it)."""
    contact = params.contact
    v = trajectory_aos.velocities(model, prob, q)
    tau = trajectory_aos.generalized_forces(model, prob, contact, q, v=v)
    cost = trajectory_aos.cost(model, prob, contact, q, tau=tau, v=v)
    parts = id_partials_for(model, prob, params, q)
    return _prepare_from_physics(
        model, prob, params, q[None], D_prev, cost[None], v[None], tau[None],
        IdPartials(*(x[None] for x in parts)), nplus_stack(model, q)[None],
        cost_fn=lambda x: trajectory_aos.cost(model, prob, contact,
                                              x[0])[None],
    )


def _merit_at(model, prob, params, q_try, lam):
    """(merit, cost) at one problem's trial point with frozen multipliers,
    phi = L + h^T lam, each (1,)."""
    contact = params.contact
    v = trajectory_aos.velocities(model, prob, q_try)
    tau = trajectory_aos.generalized_forces(model, prob, contact, q_try, v=v)
    cost = trajectory_aos.cost(model, prob, contact, q_try, tau=tau,
                               v=v)[None]
    if lam.shape[-1] > 0:
        h = tau[:, index(model.unactuated_vdofs, tau.device)].reshape(1, -1)
        return cost + _bsum(h * lam), cost
    return cost, cost


def solve_trust_region(model, prob, params, q_guess, Delta0=None):
    """The trust-region solve of one problem (prob unbatched, q_guess
    (T+1, nq)) on the per-problem (AoS) physics, from the trust radius
    ``Delta0`` (``params.Delta0`` when None).  Returns unbatched
    (Solution, Stats, WarmStart).

    ``params.method`` is not read: this is the trust region.  The loop
    reads one flag from the device an iteration (whether it is done), and
    the verbose table reads its row."""
    dtype, device = q_guess.dtype, q_guess.device
    K = params.max_iterations
    Delta = torch.as_tensor(params.Delta0 if Delta0 is None else Delta0,
                            dtype=dtype, device=device).reshape(1)
    eta = 0.0  # acceptance threshold
    eps_guard = 10 * torch.finfo(dtype).eps / prob.dt / prob.dt
    q = q_guess[None]
    D = torch.ones_like(q)
    # NaN sentinel: the cost-reduction test cannot fire on iteration 0.
    prev_cost = torch.full((1,), float("nan"), dtype=dtype, device=device)
    reason = torch.zeros(1, dtype=torch.int32, device=device)
    failed = torch.zeros(1, dtype=torch.bool, device=device)
    dq_last = dqH_last = torch.zeros_like(q)
    rows = {name: [] for name in _ROWS}
    if params.record_iteration_times:
        itimer.reset(device)
    k = 0
    while k < K:
        prep = _prepare(model, prob, params, q[0], D)
        dq_scaled, dq, boundary_active = _dogleg(prep, Delta)

        # ---- trust ratio ----
        q_try = q + dq
        if params.normalize_quaternions:
            q_try = normalize_quaternions(model, q_try)
        merit_try, cost_try = _merit_at(model, prob, params, q_try[0],
                                        prep.lam)
        predicted = -_bsum(prep.g_merit * dq_scaled) - 0.5 * _bsum(
            dq_scaled * _lin_matvec(prep.H, dq_scaled))
        actual = prep.merit - merit_try
        rho = torch.where((predicted < eps_guard) & (actual < eps_guard),
                          torch.full_like(actual, 0.5), actual / predicted)
        # A non-finite ratio rejects the step and shrinks the radius.
        rho = torch.where(torch.isfinite(rho), rho, torch.full_like(rho, -1.0))
        accept = (rho > eta) & prep.fact_ok

        dq_norm = _bnorm(dq)
        g_norm = _bnorm(prep.g_merit)
        for name, val in zip(_ROWS, (
                prep.cost, Delta, rho, _bnorm(q), dq_norm,
                _bnorm(prep.p_newton), g_norm,
                _bsum(prep.g_merit * dq_scaled) / prep.cost,
                _bnorm(prep.h), prep.merit)):
            rows[name].append(val)
        if params.record_iteration_times:
            itimer.mark()
        if params.verbose:
            _print_iter_row(k, prep.cost, prep.merit, Delta, rho, dq_norm,
                            g_norm, _bnorm(prep.h))

        # ---- convergence (accepted steps only) ----
        reason = torch.zeros_like(reason)
        if params.check_convergence:
            tol = params.tolerances
            cost_new = torch.where(accept, cost_try, prep.cost)
            crit_cost = torch.abs(prev_cost - cost_new) < (
                tol.abs_cost_reduction + tol.rel_cost_reduction * cost_new)
            crit_grad = torch.abs(_bsum(prep.g_merit * dq_scaled)) < (
                tol.abs_gradient_along_dq
                + tol.rel_gradient_along_dq * prep.cost)
            crit_state = dq_norm < (
                tol.abs_state_change + tol.rel_state_change * _bnorm(q))
            bits = sum(
                crit.to(torch.int32) * int(flag) for crit, flag in (
                    (crit_cost, ConvergenceReason.COST_REDUCTION),
                    (crit_grad, ConvergenceReason.GRADIENT),
                    (crit_state, ConvergenceReason.STATE_CHANGE)))
            reason = torch.where(accept, bits, reason)
        done = (reason > 0) | ~prep.fact_ok

        # ---- trust region update ----
        Delta_new = torch.where(
            rho < 0.25, Delta * 0.25,
            torch.where((rho > 0.75) & boundary_active,
                        torch.clamp_max(2.0 * Delta, params.Delta_max),
                        Delta))
        Delta = torch.where(done, Delta, Delta_new)
        prev_cost = torch.where(accept, cost_try, prep.cost)
        q = torch.where(_bcast(accept, q), q_try, q)
        # Degraded-but-contained Newton solves latch into the same
        # FACTORIZATION_FAILED report as hard failures.
        failed = failed | ~prep.fact_ok | ~prep.solve_ok
        D, dq_last, dqH_last = prep.D, dq, prep.D * prep.p_newton
        k += 1
        if bool(done):  # host sync once per iteration
            break

    q = q[0]
    v = trajectory_aos.velocities(model, prob, q)
    tau = trajectory_aos.generalized_forces(model, prob, params.contact, q,
                                            v=v)
    nan = torch.full((K,), float("nan"), dtype=dtype, device=device)

    def row(name):
        return torch.cat([torch.cat(rows[name]), nan[k:]]) if k else nan

    def i32(x):
        return torch.as_tensor(int(x), dtype=torch.int32, device=device)

    flag = torch.where(
        failed[0], i32(SolverFlag.FACTORIZATION_FAILED),
        torch.where((reason[0] > 0) | (k < K), i32(SolverFlag.SUCCESS),
                    i32(SolverFlag.MAX_ITERATIONS)))
    stats = Stats(
        num_iters=i32(k), **{name: row(name) for name in _ROWS},
        time=nan, alpha=nan,
        ls_iters=torch.zeros(K, dtype=torch.int32, device=device),
        solver_flag=flag, convergence_reason=reason[0],
    )
    if params.record_iteration_times:
        stats = itimer.attach(stats)
    return (Solution(q=q, v=v, tau=tau), stats,
            WarmStart(q=q, Delta=Delta[0], dq=dq_last[0], dqH=dqH_last[0]))
