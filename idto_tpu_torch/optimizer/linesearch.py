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
``while_loop``); the loop reads one flag from the device a step.  It runs
eagerly, also on the card: the JAX package jits it, but a host read
decides each search step, so it is not one of the captured regions of
``utils/graphs.py`` (queued in ``ROADMAP.md``).
"""
from __future__ import annotations

import torch

from idto_tpu_torch.ops import penta
from idto_tpu_torch.optimizer import itimer, trajectory
from idto_tpu_torch.optimizer.hessian import gauss_newton_hessian
from idto_tpu_torch.optimizer.partials import id_partials_for, nplus_stack
from idto_tpu_torch.optimizer.problem import LinesearchMethod, SolverParameters
from idto_tpu_torch.optimizer.solver import (
    Solution,
    SolverFlag,
    WarmStart,
    _bcast,
    _bnorm,
    _bsum,
    _constraint_jacobian_dense,
)
from idto_tpu_torch.soa import rollout
from idto_tpu_torch.soa.kinematics import normalize_quaternions
from idto_tpu_torch.utils import linalg
from idto_tpu_torch.utils.consts import index

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


def _search(fn, init, cond, body, max_ls):
    """Masked ``while cond: body`` per scenario; ``init`` and the carry are
    tuples of (B,) tensors, ``fn(alpha)`` the batch's merit."""
    carry = init
    while True:
        active = cond(carry) & (carry[1] < max_ls)
        if not bool(torch.any(active)):  # one host read a search step
            return carry
        new = body(carry, fn)
        carry = tuple(torch.where(active, n, o) for n, o in zip(new, carry))


def _armijo(model, prob, params, qs, dq, L, g, max_ls):
    """Start at alpha = 1 and multiply by rho until L(q + a dq) <= L +
    c a L'.  Returns (alpha, iterations), the evaluation at alpha = 1
    counted."""
    dt = prob.dt
    L_prime = _bsum(g * dq)
    threshold = 10 * torch.finfo(qs.dtype).eps / dt / dt
    early = torch.abs(L_prime) / torch.abs(L) <= threshold

    def cost_at(alpha):
        q_try = qs + _bcast(alpha, qs) * dq
        if params.normalize_quaternions:
            q_try = normalize_quaternions(model, q_try)
        return trajectory.cost(model, prob, params.contact, q_try)

    def cond(c):
        alpha, _, L_new = c
        return L_new > L + _C_ARMIJO * alpha * L_prime

    def body(c, fn):
        alpha, i, _ = c
        alpha = alpha * _RHO
        return alpha, i + 1, fn(alpha)

    a0 = torch.ones_like(L)
    i0 = torch.zeros(L.shape, dtype=torch.int32, device=L.device)
    alpha, iters, _ = _search(cost_at, (a0, i0, cost_at(a0)), cond, body,
                              max_ls)
    iters = iters + 1
    alpha = torch.where(early, torch.ones_like(alpha), alpha)
    iters = torch.where(early, torch.zeros_like(iters), iters)
    return alpha, iters


def _backtracking(model, prob, params, qs, dq, L, g, max_ls, mu):
    """Backtrack past Armijo until the merit rises: a local minimum along
    the ray; the exact-l1 merit when mu > 0.  Returns (alpha, iterations);
    the accepted step is one rho back."""
    contact = params.contact
    habs = _constraint_l1(model, prob, contact, qs, mu)
    L_tot = L + habs
    L_prime = _bsum(g * dq) - habs
    threshold = torch.finfo(qs.dtype).eps ** 0.5
    early = torch.abs(L_prime) / torch.abs(L_tot) <= threshold

    def merit_at(alpha):
        q_try = qs + _bcast(alpha, qs) * dq
        if params.normalize_quaternions:
            q_try = normalize_quaternions(model, q_try)
        return trajectory.cost(model, prob, contact, q_try) + _constraint_l1(
            model, prob, contact, q_try, mu)

    def cond(c):
        _, _, L_new, L_old, armijo_met = c
        return ~(armijo_met & (L_new > L_old))

    def body(c, fn):
        alpha, i, L_new, _, armijo_met = c
        L_old = L_new
        alpha = alpha * _RHO
        L_new = fn(alpha)
        armijo_met = armijo_met | (
            L_new <= L_tot + _C_ARMIJO * alpha * L_prime)
        return alpha, i + 1, L_new, L_old, armijo_met

    a0 = torch.ones_like(L)
    i0 = torch.zeros(L.shape, dtype=torch.int32, device=L.device)
    L1 = merit_at(a0)
    alpha, iters, _, _, _ = _search(
        merit_at, (a0, i0, L1, L1, torch.zeros_like(early)), cond, body,
        max_ls)
    alpha = alpha / _RHO
    alpha = torch.where(early, torch.ones_like(alpha), alpha)
    iters = torch.where(early, torch.zeros_like(iters), iters)
    return alpha, iters


def _prepare(model, prob, params, qs, use_constraints):
    """(cost, merit gradient, full Newton step) at qs, unscaled, with the
    Thomas solver."""
    contact = params.contact
    cost = trajectory.cost(model, prob, contact, qs)
    g = trajectory.gradient(model, prob, contact, qs)
    parts = id_partials_for(model, prob, params, qs)
    H = gauss_newton_hessian(model, prob, parts, nplus_stack(model, qs))
    factor = penta.factorize(H)
    if use_constraints:
        # Merit gradient g + J^T lambda with the trust region's Schur
        # multipliers, here on the unscaled Hessian.
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
    return cost, g, -penta.solve_factorized(factor, g)


def solve_linesearch(model, probs, params: SolverParameters, q_guesses):
    """Linesearch solve of a batch (probs tensors lead with B or are
    shared; q_guesses (B, T+1, nq)).  Returns batched (Solution, Stats,
    WarmStart) with the trust region's conventions: rho, delta and h_norm
    stay NaN, dqH_norm is dq_norm, ``alpha`` and ``ls_iters`` are filled,
    and the flag is LINESEARCH_MAX_ITERS where a search used up its
    iterations."""
    from idto_tpu_torch.optimizer.batched import _empty_stats, check_supported

    B = q_guesses.shape[0]
    check_supported(model)
    dtype, device = q_guesses.dtype, q_guesses.device
    K = params.max_iterations
    max_ls = params.max_linesearch_iterations
    use_constraints = bool(params.equality_constraints
                           and model.unactuated_vdofs)
    mu = _MU_L1 if (use_constraints and params.linesearch_method
                    == LinesearchMethod.BACKTRACKING) else 0.0
    iters = torch.arange(K, device=device)

    q = q_guesses
    k = torch.zeros(B, dtype=torch.int32, device=device)
    failed = torch.zeros(B, dtype=torch.bool, device=device)
    dq_last = torch.zeros_like(q)
    dqH_last = torch.zeros_like(q)
    st = _empty_stats(B, K, dtype, device)
    if params.record_iteration_times:
        itimer.reset(device)
    while True:
        active = (k < K) & ~failed
        if not bool(torch.any(active)):  # host sync once per iteration
            break
        cost, g, dq = _prepare(model, probs, params, q, use_constraints)
        if params.linesearch_method == LinesearchMethod.BACKTRACKING:
            alpha, ls_iters = _backtracking(model, probs, params, q, dq, cost,
                                            g, max_ls, mu)
        else:
            alpha, ls_iters = _armijo(model, probs, params, q, dq, cost, g,
                                      max_ls)
        q_new = q + _bcast(alpha, q) * dq
        if params.normalize_quaternions:
            q_new = normalize_quaternions(model, q_new)

        onehot = (iters[None, :] == k[:, None]) & active[:, None]

        def put(arr, val):
            return torch.where(onehot, val[:, None].to(arr.dtype), arr)

        dq_norm = _bnorm(dq)
        st = st.replace(
            cost=put(st.cost, cost),
            dq_norm=put(st.dq_norm, dq_norm),
            dqH_norm=put(st.dqH_norm, dq_norm),
            grad_norm=put(st.grad_norm, _bnorm(g)),
            q_norm=put(st.q_norm, _bnorm(q)),
            dL_dq=put(st.dL_dq, _bsum(g * dq) / cost),
            alpha=put(st.alpha, alpha),
            ls_iters=put(st.ls_iters, ls_iters),
            merit=put(st.merit, cost),
        )
        if params.record_iteration_times:
            itimer.mark()
        act = _bcast(active, q)
        q = torch.where(act, q_new, q)
        dq_last = torch.where(act, _bcast(alpha, dq) * dq, dq_last)
        dqH_last = torch.where(act, dq, dqH_last)
        failed = torch.where(active, ls_iters >= max_ls, failed)
        k = k + active.to(torch.int32)

    tau, v = rollout.generalized_forces(model, probs, params.contact, q)
    flag = torch.where(
        failed,
        torch.full_like(k, int(SolverFlag.LINESEARCH_MAX_ITERS)),
        torch.full_like(k, int(SolverFlag.SUCCESS)),
    )
    stats = st.replace(num_iters=k, solver_flag=flag,
                       convergence_reason=torch.zeros_like(k))
    if params.record_iteration_times:
        stats = itimer.attach(stats)
    return (
        Solution(q=q, v=v, tau=tau),
        stats,
        WarmStart(q=q, Delta=torch.full((B,), params.Delta0, dtype=dtype,
                                        device=device),
                  dq=dq_last, dqH=dqH_last),
    )
