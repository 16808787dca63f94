"""Full-Newton + linesearch solver (counterpart of
``idto_tpu/optimizer/linesearch.py``): Armijo and backtracking.

Each iteration takes the full Gauss-Newton step dq = -H^{-1} g_merit on the
*unscaled* Hessian (scaling belongs to the trust-region method) and
searches along it.  With equality constraints, g_merit = g + J^T lambda with
the Schur multipliers, and backtracking measures the exact-l1 merit
L + mu |h|_1, mu = 1e3.  The linear solver is the Thomas sweep, whatever
``linear_solver`` says, as in the JAX package; this path launches no
kernel.

Batch-first: every scenario searches along its own step.  A search step
evaluates the cost of the whole batch, and scenarios whose search ended
keep their values under a mask (the rule JAX applies to a vmapped
``while_loop``).

On CUDA tensors the loop replays captured CUDA graphs (``utils/graphs.py``),
as the JAX package compiles it whole: ``ls.start``; each iteration
``ls.prepare`` (cost, merit gradient, Newton step, the search's constants,
its ``early`` mask and its evaluation at alpha = 1), ``ls.search`` replayed
once a chunk of :data:`SEARCH_CHUNK` masked search steps, and
``ls.advance`` (q, the statistics, the warm-start fields, whether any
scenario goes on); ``ls.finish``.  The JAX package's ``while_loop`` decides
each search step on the device; the PyTorch this port runs on has no
conditional node for a CUDA graph, so the host reads one flag a chunk
(whether any scenario still searches) and one an iteration, none after the
last.  A chunk's steps past the end of every search change nothing (the
mask keeps the carry), so the result is the eager loop's, bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from idto_tpu_torch.ops import penta
from idto_tpu_torch.optimizer import itimer, trajectory
from idto_tpu_torch.optimizer.hessian import gauss_newton_hessian
from idto_tpu_torch.optimizer.partials import id_partials_for, nplus_stack
from idto_tpu_torch.optimizer.problem import LinesearchMethod, SolverParameters
from idto_tpu_torch.optimizer.solver import (
    Solution,
    SolverFlag,
    Stats,
    WarmStart,
    _bcast,
    _bnorm,
    _bsum,
    _constraint_jacobian_dense,
)
from idto_tpu_torch.soa import rollout
from idto_tpu_torch.soa.kinematics import normalize_quaternions
from idto_tpu_torch.utils import graphs, linalg
from idto_tpu_torch.utils.consts import index
from idto_tpu_torch.utils.profiler import instrument

_C_ARMIJO = 1e-4
_RHO = 0.8
_MU_L1 = 1e3


def _constraint_l1(model, prob, contact, qs, mu):
    """mu |h(q)|_1 per scenario (zeros when mu is 0)."""
    if mu == 0.0:
        return torch.zeros(qs.shape[0], dtype=qs.dtype, device=qs.device)
    tau = trajectory.generalized_forces(model, prob, contact, qs)
    h = tau[:, :, index(model.unactuated_vdofs, tau.device)]
    return mu * torch.sum(torch.abs(h), dim=(1, 2))


# Masked search steps in one replay of ``ls.search``: the host reads one
# flag a chunk.  A larger chunk reads the host less often and evaluates up
# to chunk - 1 costs past the end of the longest search.  Measured on the
# Armijo cheetah at B=1 (14-15 evaluations a search) on an H100: chunks 1
# and 2 tie, 4, 8 and 16 spend ~10 ms more device time an iteration on
# costs past the end (scripts/bench_torch_linesearch.py, PERF.md §5).
SEARCH_CHUNK = 2


def _backtracks(params) -> bool:
    return params.linesearch_method == LinesearchMethod.BACKTRACKING


def _merit_at(model, prob, params, qs, dq, alpha, mu):
    """What the search measures at q + alpha dq, per scenario: the cost
    (Armijo), or the cost plus mu |h|_1 (backtracking)."""
    contact = params.contact
    q_try = qs + _bcast(alpha, qs) * dq
    if params.normalize_quaternions:
        q_try = normalize_quaternions(model, q_try)
    with instrument("physics.trial"):
        cost = trajectory.cost(model, prob, contact, q_try)
        if _backtracks(params):
            return cost + _constraint_l1(model, prob, contact, q_try, mu)
        return cost


def _search_start(model, prob, params, qs, dq, L, g, mu):
    """A search's constants (L_ref, L'), its ``early`` mask (the step is
    taken whole, no search counted) and its first carry, with the
    evaluation at alpha = 1.  Armijo: L_ref = L, the carry (alpha,
    iterations, merit).  Backtracking: L_ref = L + mu |h|_1, L' less mu
    |h|_1, the carry (alpha, iterations, merit, the merit before, Armijo's
    condition met)."""
    eps = torch.finfo(qs.dtype).eps
    if _backtracks(params):
        habs = _constraint_l1(model, prob, params.contact, qs, mu)
        L_ref = L + habs
        L_prime = _bsum(g * dq) - habs
        threshold = eps ** 0.5
    else:
        L_ref, L_prime = L, _bsum(g * dq)
        threshold = 10 * eps / prob.dt / prob.dt
    early = torch.abs(L_prime) / torch.abs(L_ref) <= threshold
    a0 = torch.ones_like(L)
    i0 = torch.zeros(L.shape, dtype=torch.int32, device=L.device)
    L1 = _merit_at(model, prob, params, qs, dq, a0, mu)
    if _backtracks(params):
        return (L_ref, L_prime), early, (a0, i0, L1, L1,
                                         torch.zeros_like(early))
    return (L_ref, L_prime), early, (a0, i0, L1)


def _searching(params, consts, c, max_ls):
    """The scenarios whose search goes on.  Armijo: until L(q + a dq) <=
    L + c a L'.  Backtracking: past Armijo's condition until the merit
    rises (a local minimum along the ray)."""
    L_ref, L_prime = consts
    if _backtracks(params):
        going = ~(c[4] & (c[2] > c[3]))
    else:
        going = c[2] > L_ref + _C_ARMIJO * c[0] * L_prime
    return going & (c[1] < max_ls)


def _search_step(model, prob, params, qs, dq, consts, c, mu):
    """One step of every scenario's search: alpha times rho, evaluated
    (the caller keeps the scenarios whose search has ended)."""
    L_ref, L_prime = consts
    alpha = c[0] * _RHO
    L_new = _merit_at(model, prob, params, qs, dq, alpha, mu)
    if _backtracks(params):
        met = c[4] | (L_new <= L_ref + _C_ARMIJO * alpha * L_prime)
        return alpha, c[1] + 1, L_new, c[2], met
    return alpha, c[1] + 1, L_new


def _search_chunk(model, prob, params, qs, dq, consts, carry, mu, max_ls,
                  steps):
    """``steps`` masked search steps; returns (the carry, whether any
    scenario still searches)."""
    for _ in range(steps):
        active = _searching(params, consts, carry, max_ls)
        new = _search_step(model, prob, params, qs, dq, consts, carry, mu)
        carry = tuple(torch.where(active, n, o) for n, o in zip(new, carry))
    return carry, torch.any(_searching(params, consts, carry, max_ls))


def _search_result(params, early, c):
    """(alpha, iterations) of a finished search.  Armijo counts the
    evaluation at alpha = 1; backtracking accepts the step one rho back."""
    alpha, iters = c[0], c[1]
    if _backtracks(params):
        alpha = alpha / _RHO
    else:
        iters = iters + 1
    alpha = torch.where(early, torch.ones_like(alpha), alpha)
    iters = torch.where(early, torch.zeros_like(iters), iters)
    return alpha, iters


def _prepare(model, prob, params, qs, use_constraints):
    """(cost, merit gradient, full Newton step) at qs, unscaled, with the
    Thomas solver."""
    contact = params.contact
    with instrument("physics.cost"):
        cost = trajectory.cost(model, prob, contact, qs)
        g = trajectory.gradient(model, prob, contact, qs)
    with instrument("physics.partials"):
        parts = id_partials_for(model, prob, params, qs)
        nplus = nplus_stack(model, qs)
    with instrument("linalg.assemble"):
        H = gauss_newton_hessian(model, prob, parts, nplus)
    with instrument("linalg.factor"):
        factor = penta.factorize(H)
    if use_constraints:
        # Merit gradient g + J^T lambda with the trust region's Schur
        # multipliers, here on the unscaled Hessian.
        with instrument("linalg.constraints"):
            unact = model.unactuated_vdofs
            tau = trajectory.generalized_forces(model, prob, contact, qs)
            h = tau[:, :, index(unact, tau.device)].reshape(qs.shape[0], -1)
            J = _constraint_jacobian_dense(model, prob, parts, unact)
            Hinv_JT = penta.solve_factorized_many(factor, J)
            S = torch.einsum("banq,bcnq->bac", J, Hinv_JT)
            Hinv_g = penta.solve_factorized(factor, g)
            lam = linalg.solve(
                S, (h - torch.einsum("banq,bnq->ba", J, Hinv_g))[..., None]
            )[..., 0]
            g = g + torch.einsum("banq,ba->bnq", J, lam)
    with instrument("linalg.newton"):
        return cost, g, -penta.solve_factorized(factor, g)


class _State(NamedTuple):
    """The linesearch loop's carry (leading B)."""

    k: torch.Tensor  # iterations taken
    q: torch.Tensor
    failed: torch.Tensor  # a search used up its iterations
    dq_last: torch.Tensor
    dqH_last: torch.Tensor
    stats: Stats


def _start(params, q_guesses):
    from idto_tpu_torch.optimizer.batched import _empty_stats

    B = q_guesses.shape[0]
    dtype, device = q_guesses.dtype, q_guesses.device
    return _State(
        k=torch.zeros(B, dtype=torch.int32, device=device),
        q=q_guesses,
        failed=torch.zeros(B, dtype=torch.bool, device=device),
        dq_last=torch.zeros_like(q_guesses),
        dqH_last=torch.zeros_like(q_guesses),
        stats=_empty_stats(B, params.max_iterations, dtype, device),
    )


def _prepare_iteration(model, probs, params, s, use_constraints, mu):
    """The scenarios still iterating, the cost, merit gradient and Newton
    step at s.q, and the search's start (``_search_start``)."""
    active = (s.k < params.max_iterations) & ~s.failed
    cost, g, dq = _prepare(model, probs, params, s.q, use_constraints)
    return (active, cost, g, dq,
            *_search_start(model, probs, params, s.q, dq, cost, g, mu))


def _advance(model, params, s, active, cost, g, dq, early, carry):
    """The step of the finished search, the statistics and the warm-start
    fields, masked to the active scenarios.  Returns (the next state,
    whether any scenario goes on)."""
    K = params.max_iterations
    q = s.q
    alpha, ls_iters = _search_result(params, early, carry)
    q_new = q + _bcast(alpha, q) * dq
    if params.normalize_quaternions:
        q_new = normalize_quaternions(model, q_new)

    iters = torch.arange(K, device=q.device)
    onehot = (iters[None, :] == s.k[:, None]) & active[:, None]

    def put(arr, val):
        return torch.where(onehot, val[:, None].to(arr.dtype), arr)

    dq_norm = _bnorm(dq)
    st = s.stats.replace(
        cost=put(s.stats.cost, cost),
        dq_norm=put(s.stats.dq_norm, dq_norm),
        dqH_norm=put(s.stats.dqH_norm, dq_norm),
        grad_norm=put(s.stats.grad_norm, _bnorm(g)),
        q_norm=put(s.stats.q_norm, _bnorm(q)),
        dL_dq=put(s.stats.dL_dq, _bsum(g * dq) / cost),
        alpha=put(s.stats.alpha, alpha),
        ls_iters=put(s.stats.ls_iters, ls_iters),
        merit=put(s.stats.merit, cost),
    )
    act = _bcast(active, q)
    failed = torch.where(active, ls_iters >= params.max_linesearch_iterations,
                         s.failed)
    k = s.k + active.to(torch.int32)
    new = _State(
        k=k,
        q=torch.where(act, q_new, q),
        failed=failed,
        dq_last=torch.where(act, _bcast(alpha, dq) * dq, s.dq_last),
        dqH_last=torch.where(act, dq, s.dqH_last),
        stats=st,
    )
    return new, torch.any((k < K) & ~failed)


def _finish(model, probs, params, s):
    """(Solution, Stats, WarmStart) of the final state."""
    B = s.q.shape[0]
    with instrument("physics.forces"):
        tau, v = rollout.generalized_forces(model, probs, params.contact,
                                            s.q)
    flag = torch.where(
        s.failed,
        torch.full_like(s.k, int(SolverFlag.LINESEARCH_MAX_ITERS)),
        torch.full_like(s.k, int(SolverFlag.SUCCESS)),
    )
    stats = s.stats.replace(num_iters=s.k, solver_flag=flag,
                            convergence_reason=torch.zeros_like(s.k))
    return (
        Solution(q=s.q, v=v, tau=tau),
        stats,
        WarmStart(q=s.q, Delta=torch.full((B,), params.Delta0,
                                          dtype=s.q.dtype, device=s.q.device),
                  dq=s.dq_last, dqH=s.dqH_last),
    )


def solve_linesearch(model, probs, params: SolverParameters, q_guesses):
    """Linesearch solve of a batch (probs tensors lead with B or are
    shared; q_guesses (B, T+1, nq)).  Returns batched (Solution, Stats,
    WarmStart) with the trust region's conventions: rho, delta and h_norm
    stay NaN, dqH_norm is dq_norm, ``alpha`` and ``ls_iters`` are filled,
    and the flag is LINESEARCH_MAX_ITERS where a search used up its
    iterations.

    On CUDA tensors every part is a captured region (see the module's
    docstring); the first call of a key pays the captures.  The host reads
    one flag a search chunk and one an iteration; the iteration timer
    marks between replays.  The start hands its static copy of ``probs``
    to the later regions, and each region its outputs to the next: only
    the search's carry (after a chunk) and the state (after an iteration)
    are copied back into static inputs."""
    from idto_tpu_torch.optimizer.batched import check_supported

    check_supported(model)
    K = params.max_iterations
    max_ls = params.max_linesearch_iterations
    use_constraints = bool(params.equality_constraints
                           and model.unactuated_vdofs)
    mu = _MU_L1 if (use_constraints and _backtracks(params)) else 0.0
    chunk = SEARCH_CHUNK
    chunks = -(-max_ls // chunk)  # max_ls masked steps end every search

    def region(name, fn, *args, clone=False):
        return graphs.run(name, fn, args, model=model, key=(params, chunk),
                          clone=clone)

    probs, s = region("ls.start", lambda p, qg: (p, _start(params, qg)),
                      probs, q_guesses)
    if params.record_iteration_times:
        itimer.reset(q_guesses.device)
    for it in range(K):
        s, active, cost, g, dq, consts, early, carry = region(
            "ls.prepare",
            lambda p, st: (st, *_prepare_iteration(model, p, params, st,
                                                   use_constraints, mu)),
            probs, s)
        for c in range(chunks):
            carry, searching = region(
                "ls.search",
                lambda p, q, d, k, cr: _search_chunk(
                    model, p, params, q, d, k, cr, mu, max_ls, chunk),
                probs, s.q, dq, consts, carry)
            # Host read once a chunk, none after the last.
            if c + 1 == chunks:
                break
            with instrument("ls.read_chunk"):
                if not bool(searching):
                    break
        s, more = region(
            "ls.advance",
            lambda st, a, co, gg, d, e, cr: _advance(model, params, st, a,
                                                     co, gg, d, e, cr),
            s, active, cost, g, dq, early, carry)
        if params.record_iteration_times:
            itimer.mark()
        # Host read once an iteration, none after the last.
        if it + 1 == K:
            break
        with instrument("ls.read_more"):
            if not bool(more):
                break
    sol, stats, warm = region(
        "ls.finish", lambda p, st: _finish(model, p, params, st), probs, s,
        clone=True)
    if params.record_iteration_times:
        stats = itimer.attach(stats)
    return sol, stats, warm
