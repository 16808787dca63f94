"""Batch-native trust-region solve (counterpart of
``idto_tpu/optimizer/batched.py``).

All physics -- rollouts, cost, the dtau/dq partials -- runs through the SoA
pipeline over one flat (scenarios x steps) instance axis, and the linear
algebra tail works on a leading scenario axis.  Each scenario carries its
own trust radius and accept/reject path; finished scenarios are frozen by
masking every carry update with their own continue-predicate, the rule
JAX applies to a vmapped while_loop.

The loop is a Python ``while``: its ``any(active)`` test reads one flag
from the device per iteration (a host sync).  The degraded-solve rescue
branches on the host too.  Every solver option of the JAX package is
honoured: finite-difference partials, the dense and exact-Hessian solves,
the dense cross-check, the verbose table (one row a scenario an iteration,
in scenario order, as the JAX package's vmapped table prints them) and the
iteration timer (each scenario's ``stats.time`` row holds the times of the
batch iterations it ran); the linesearch method is
``optimizer/linesearch.py``.
"""
from __future__ import annotations

import torch

from idto_tpu_torch.models.model import Model
from idto_tpu_torch.ops import penta
from idto_tpu_torch.optimizer import itimer
from idto_tpu_torch.optimizer.partials import id_partials_for, nplus_stack
from idto_tpu_torch.optimizer.problem import (
    ProblemDefinition,
    SolverParameters,
)
from idto_tpu_torch.optimizer.solver import (
    ConvergenceReason,
    Solution,
    SolverFlag,
    Stats,
    WarmStart,
    _bcast,
    _bnorm,
    _bsum,
    _dogleg,
    _lin_matvec,
    _LoopState,
    _newton_tail,
    _prepare_from_physics,
    _print_iter_row,
    _use_cr,
)
from idto_tpu_torch.soa import contact as soa_contact
from idto_tpu_torch.soa import rollout
from idto_tpu_torch.soa.kinematics import normalize_quaternions
from idto_tpu_torch.utils.consts import index


def check_supported(model: Model):
    """Raise for a model with a contact pair that has no SoA kernel (only a
    halfspace against a halfspace, where the JAX package raises too)."""
    if not soa_contact.supports_soa(model):
        raise NotImplementedError(
            "a contact pair of this model has no SoA kernel in the port"
        )


def print_rows(active, k, cost, merit, Delta, rho, dq_norm, g_norm, h_norm):
    """The verbose table's rows of one batch iteration: one row for each
    active scenario, in scenario order (one host read for the batch).  The
    header comes before the first row of iterations 0, 50, 100, ..., once
    for the batch."""
    cols = torch.stack([x.to(torch.float64) for x in (
        k, cost, merit, Delta, rho, dq_norm, g_norm, h_norm)], dim=1)
    rows = cols[active].cpu().tolist()
    for i, r in enumerate(rows):
        _print_iter_row(int(r[0]), *r[1:], header=i == 0)


def _mask(active, new, old):
    """Per-scenario select over a carry NamedTuple / Stats (leading B)."""

    def sel(n, o):
        return torch.where(_bcast(active, n), n, o)

    fields = {}
    for name, n in new._asdict().items():
        o = getattr(old, name)
        if isinstance(n, Stats):
            fields[name] = Stats(**{
                f: sel(getattr(n, f), getattr(o, f))
                for f in Stats.__dataclass_fields__
            })
        else:
            fields[name] = sel(n, o)
    return type(new)(**fields)


def _empty_stats(B, max_iters, dtype, device):
    def nan():
        return torch.full((B, max_iters), float("nan"), dtype=dtype,
                          device=device)

    def zi(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return Stats(
        num_iters=zi(B), cost=nan(), delta=nan(), rho=nan(), q_norm=nan(),
        dq_norm=nan(), dqH_norm=nan(), grad_norm=nan(), dL_dq=nan(),
        h_norm=nan(), merit=nan(), time=nan(), alpha=nan(),
        ls_iters=zi(B, max_iters), solver_flag=zi(B),
        convergence_reason=zi(B),
    )


# Scenarios whose cyclic-reduction Newton step failed the residual
# acceptance and went to the Thomas rescue, since import (or since reset by
# the caller).
rescued = 0


def _forces(model, probs, params, qs, horizon):
    """(tau, v) of the whole horizon; with ``horizon`` (a
    ``parallel.horizon.HorizonSplit``) each rank evaluates its own steps and
    gathers the rest."""
    if horizon is not None:
        return horizon.forces(model, probs, params.contact, qs)
    return rollout.generalized_forces(model, probs, params.contact, qs)


def _prepare_batched(model, probs, params, qs, D_prev, horizon=None):
    if horizon is not None:
        tau, v, parts, nplus = horizon.physics(model, probs, params, qs)
    else:
        tau, v = rollout.generalized_forces(model, probs, params.contact, qs)
        parts = id_partials_for(model, probs, params, qs)
        nplus = nplus_stack(model, qs)
    cost = rollout.cost(model, probs, params.contact, qs, tau=tau, v=v)
    return _prepare_from_physics(
        model, probs, params, qs, D_prev, cost, v, tau, parts, nplus,
        horizon=horizon,
    )


def _merit_at_batched(model, probs, params, q_try, lam, horizon=None):
    """(merit, cost) at q_try with frozen multipliers, whole batch:
    phi = L + h^T lam_k."""
    contact = params.contact
    tau, v = _forces(model, probs, params, q_try, horizon)
    cost = rollout.cost(model, probs, contact, q_try, tau=tau, v=v)
    if lam.shape[-1] > 0:
        unact = model.unactuated_vdofs
        h = tau[:, :, index(unact, tau.device)].reshape(tau.shape[0], -1)
        return cost + _bsum(h * lam), cost
    return cost, cost


def _rescue_degraded_solves(params: SolverParameters, prep):
    """Second-chance Thomas solve for scenarios whose cyclic-reduction
    Newton step failed the residual acceptance.  The whole tail is solved
    again from a Thomas factor of the same scaled Hessian: under equality
    constraints that is the multipliers, the merit and the merit gradient
    as well as the step, since all of them came from the degraded solve
    (the JAX package re-solves the step alone and reports the scenario
    healthy).  Scenarios whose re-solve passes the acceptance take every one
    of these from it and get solve_ok back; the rest keep the Cauchy
    fallback."""
    if not _use_cr(params):
        return prep  # Thomas is already the primary solver
    # Host sync: the batch-level branch reads one flag from the device.
    if not bool(torch.any(~prep.solve_ok)):
        return prep
    global rescued
    rescued += int((~prep.solve_ok).sum())
    factor = penta.factorize(prep.H)
    alt = _newton_tail(
        prep.cost, prep.D, prep.H, prep.gs, prep.h, prep.Js, factor,
        penta.factorization_status(factor),
    )
    use_t = ~prep.solve_ok & alt.solve_ok

    def pick(name):
        new, old = getattr(alt, name), getattr(prep, name)
        return torch.where(_bcast(use_t, new), new, old)

    return prep._replace(
        solve_ok=prep.solve_ok | use_t,
        **{name: pick(name) for name in
           ("p_newton", "p_cauchy", "g_merit", "merit", "lam")},
    )


def solve_trust_region_batched(
    model: Model,
    probs: ProblemDefinition,
    params: SolverParameters,
    q_guesses,
    Delta0=None,
    horizon=None,
):
    """Batched trust-region solve: ``probs`` tensors lead with the scenario
    axis (or are shared), q_guesses is (B, T+1, nq).  Returns batched
    (Solution, Stats, WarmStart).

    ``horizon`` (a ``parallel.horizon.HorizonSplit``) shards the horizon
    over a process group: each rank evaluates the physics of its own steps,
    and cyclic reduction runs distributed.  Every rank then holds the same
    gathered values and takes the same host decisions."""
    B = q_guesses.shape[0]
    check_supported(model)
    dtype, device = q_guesses.dtype, q_guesses.device
    K = params.max_iterations
    Delta = torch.as_tensor(
        params.Delta0 if Delta0 is None else Delta0, dtype=dtype,
        device=device,
    ).expand(B).clone()
    eta = 0.0  # acceptance threshold
    eps_guard = 10 * torch.finfo(dtype).eps / probs.dt / probs.dt
    iters = torch.arange(K, device=device)

    def body(s: _LoopState, active) -> _LoopState:
        prep = _prepare_batched(model, probs, params, s.q, s.D, horizon)
        prep = _rescue_degraded_solves(params, prep)
        dq_scaled, dq, boundary_active = _dogleg(prep, s.Delta)

        # ---- trust ratio ----
        q_try = s.q + dq
        if params.normalize_quaternions:
            q_try = normalize_quaternions(model, q_try)
        merit_try, cost_try = _merit_at_batched(
            model, probs, params, q_try, prep.lam, horizon
        )
        Hdq = _lin_matvec(prep.H, dq_scaled)
        predicted = -_bsum(prep.g_merit * dq_scaled) - 0.5 * _bsum(
            dq_scaled * Hdq
        )
        actual = prep.merit - merit_try
        rho = torch.where(
            (predicted < eps_guard) & (actual < eps_guard),
            torch.full_like(actual, 0.5),
            actual / predicted,
        )
        # A non-finite trust ratio (degenerate trial point, 0/0) rejects the
        # step and shrinks the radius instead of writing NaN into stats.
        rho = torch.where(torch.isfinite(rho), rho, torch.full_like(rho, -1.0))
        accept = (rho > eta) & prep.fact_ok
        q_new = torch.where(_bcast(accept, s.q), q_try, s.q)

        # ---- statistics: one-hot row write at each scenario's own k ----
        dq_norm = _bnorm(dq)
        onehot = iters[None, :] == s.k[:, None]  # (B, K)

        def put(arr, val):
            return torch.where(onehot, val[:, None].to(arr.dtype), arr)

        st = s.stats
        st = st.replace(
            cost=put(st.cost, prep.cost),
            delta=put(st.delta, s.Delta),
            rho=put(st.rho, rho),
            q_norm=put(st.q_norm, _bnorm(s.q)),
            dq_norm=put(st.dq_norm, dq_norm),
            dqH_norm=put(st.dqH_norm, _bnorm(prep.p_newton)),
            grad_norm=put(st.grad_norm, _bnorm(prep.g_merit)),
            dL_dq=put(st.dL_dq, _bsum(prep.g_merit * dq_scaled) / prep.cost),
            h_norm=put(st.h_norm, _bnorm(prep.h)),
            merit=put(st.merit, prep.merit),
        )
        if params.record_iteration_times:
            itimer.mark()
        if params.verbose:
            print_rows(active, s.k, prep.cost, prep.merit, s.Delta, rho,
                       dq_norm, _bnorm(prep.g_merit), _bnorm(prep.h))

        # ---- convergence (accepted steps only) ----
        reason = torch.zeros_like(s.reason)
        if params.check_convergence:
            tol = params.tolerances
            cost_new = torch.where(accept, cost_try, prep.cost)
            crit_cost = torch.abs(s.prev_cost - cost_new) < (
                tol.abs_cost_reduction + tol.rel_cost_reduction * cost_new
            )
            crit_grad = torch.abs(_bsum(prep.g_merit * dq_scaled)) < (
                tol.abs_gradient_along_dq
                + tol.rel_gradient_along_dq * prep.cost
            )
            crit_state = dq_norm < (
                tol.abs_state_change + tol.rel_state_change * _bnorm(s.q)
            )
            bits = (
                crit_cost.to(torch.int32) * int(ConvergenceReason.COST_REDUCTION)
                + crit_grad.to(torch.int32) * int(ConvergenceReason.GRADIENT)
                + crit_state.to(torch.int32)
                * int(ConvergenceReason.STATE_CHANGE)
            )
            reason = torch.where(accept, bits, reason)
        done = (reason > 0) | ~prep.fact_ok

        # ---- trust region update ----
        Delta_new = torch.where(
            rho < 0.25,
            s.Delta * 0.25,
            torch.where(
                (rho > 0.75) & boundary_active,
                torch.clamp_max(2.0 * s.Delta, params.Delta_max),
                s.Delta,
            ),
        )
        Delta_new = torch.where(done, s.Delta, Delta_new)

        return _LoopState(
            k=s.k + 1,
            q=q_new,
            Delta=Delta_new,
            prev_cost=torch.where(accept, cost_try, prep.cost),
            reason=reason,
            done=done,
            # Degraded-but-contained Newton solves latch into the same
            # FACTORIZATION_FAILED report as hard failures.
            failed=s.failed | ~prep.fact_ok | ~prep.solve_ok,
            D=prep.D,
            dq_last=dq,
            dqH_last=prep.D * prep.p_newton,
            stats=st,
        )

    s = _LoopState(
        k=torch.zeros(B, dtype=torch.int32, device=device),
        q=q_guesses,
        Delta=Delta,
        # NaN sentinel: the cost-reduction test cannot fire on iteration 0.
        prev_cost=torch.full((B,), float("nan"), dtype=dtype, device=device),
        reason=torch.zeros(B, dtype=torch.int32, device=device),
        done=torch.zeros(B, dtype=torch.bool, device=device),
        failed=torch.zeros(B, dtype=torch.bool, device=device),
        D=torch.ones_like(q_guesses),
        dq_last=torch.zeros_like(q_guesses),
        dqH_last=torch.zeros_like(q_guesses),
        stats=_empty_stats(B, K, dtype, device),
    )
    if params.record_iteration_times:
        itimer.reset(device)
    while True:
        active = (s.k < K) & ~s.done
        if not bool(torch.any(active)):  # host sync once per iteration
            break
        s = _mask(active, body(s, active), s)

    tau, v = _forces(model, probs, params, s.q, horizon)

    def fl(f):
        return torch.full((B,), int(f), dtype=torch.int32, device=device)

    flag = torch.where(
        s.failed,
        fl(SolverFlag.FACTORIZATION_FAILED),
        torch.where(
            s.reason > 0,
            fl(SolverFlag.SUCCESS),
            torch.where(s.k >= K, fl(SolverFlag.MAX_ITERATIONS),
                        fl(SolverFlag.SUCCESS)),
        ),
    )
    stats = s.stats.replace(
        num_iters=s.k, solver_flag=flag, convergence_reason=s.reason
    )
    if params.record_iteration_times:
        stats = itimer.attach(stats)
    return (
        Solution(q=s.q, v=v, tau=tau),
        stats,
        WarmStart(q=s.q, Delta=s.Delta, dq=s.dq_last, dqH=s.dqH_last),
    )
