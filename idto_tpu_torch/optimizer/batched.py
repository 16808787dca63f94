"""Batch-native trust-region solve (counterpart of
``idto_tpu/optimizer/batched.py``).

All physics -- rollouts, cost, the dtau/dq partials -- runs through the SoA
pipeline over one flat (scenarios x steps) instance axis, and the linear
algebra tail works on a leading scenario axis.  Each scenario carries its
own trust radius and accept/reject path; finished scenarios are frozen by
masking every carry update with their own continue-predicate, the rule
JAX applies to a vmapped while_loop.

The loop is a Python ``for`` over at most ``max_iterations`` iterations:
after each but the last it reads one flag from the device (whether any
scenario is still active), and under cyclic reduction the degraded-solve
rescue branches on the host too.  On CUDA tensors each iteration is the
replay of two captured CUDA graphs (``utils/graphs.py``), as the JAX
package runs its loop inside one compiled program.  Every solver option of
the JAX package is honoured: finite-difference partials, the dense and exact-Hessian solves,
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
    compares_dense,
    print_dense_compare,
)
from idto_tpu_torch.soa import contact as soa_contact
from idto_tpu_torch.soa import rollout
from idto_tpu_torch.soa.kinematics import normalize_quaternions
from idto_tpu_torch.utils import graphs
from idto_tpu_torch.utils.consts import index
from idto_tpu_torch.utils.profiler import instrument


def can_solve_batched_native(model: Model, params: SolverParameters) -> bool:
    """The batch-native loop serves this configuration: every contact pair
    of the model has an SoA kernel (all but a halfspace against a
    halfspace).  ``params`` does not enter.  The JAX package's predicate
    also sends linesearch, finite-difference partials, the dense and
    exact-Hessian solves, verbose and the iteration timer to
    ``vmap(solve_trust_region)``; the port's batched loop serves each of
    those itself."""
    del params
    return soa_contact.supports_soa(model)


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
    with instrument("physics.forces"):
        if horizon is not None:
            tau, v, parts, nplus = horizon.physics(model, probs, params, qs)
        else:
            tau, v = rollout.generalized_forces(model, probs, params.contact,
                                                qs)
    if horizon is None:
        with instrument("physics.partials"):
            parts = id_partials_for(model, probs, params, qs)
            nplus = nplus_stack(model, qs)
    with instrument("physics.cost"):
        cost = rollout.cost(model, probs, params.contact, qs, tau=tau, v=v)
    return _prepare_from_physics(
        model, probs, params, qs, D_prev, cost, v, tau, parts, nplus,
        horizon=horizon,
    )


def _merit_at_batched(model, probs, params, q_try, lam, horizon=None):
    """(merit, cost) at q_try with frozen multipliers, whole batch:
    phi = L + h^T lam_k."""
    contact = params.contact
    with instrument("physics.trial"):
        tau, v = _forces(model, probs, params, q_try, horizon)
        cost = rollout.cost(model, probs, contact, q_try, tau=tau, v=v)
        if lam.shape[-1] > 0:
            unact = model.unactuated_vdofs
            h = tau[:, :, index(unact, tau.device)].reshape(tau.shape[0], -1)
            return cost + _bsum(h * lam), cost
        return cost, cost


def _rescue(prep):
    """Second-chance Thomas solve for scenarios whose cyclic-reduction
    Newton step failed the residual acceptance.  The whole tail is solved
    again from a Thomas factor of the same scaled Hessian: under equality
    constraints that is the multipliers, the merit and the merit gradient
    as well as the step, since all of them came from the degraded solve
    (the JAX package re-solves the step alone and reports the scenario
    healthy).  Scenarios whose re-solve passes the acceptance take every one
    of these from it and get solve_ok back; the rest keep the Cauchy
    fallback."""
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


def _rescue_degraded_solves(params: SolverParameters, prep, n_failed=None,
                            region=None):
    """``prep`` with the Thomas rescue (``_rescue``) of the scenarios whose
    cyclic-reduction Newton step failed the residual acceptance; ``prep``
    itself when the primary solver is Thomas or no solve failed.  The
    branch is the host's: it reads the count of failed solves
    (``n_failed``, a device scalar; counted from ``prep`` when None) and
    adds it to ``rescued``.  ``region`` runs the rescue (a captured region
    of the loop), else it runs directly."""
    if not _use_cr(params):
        return prep  # Thomas is already the primary solver
    if n_failed is None:
        n_failed = (~prep.solve_ok).sum()
    with instrument("solve.read_failed"):
        n = int(n_failed)  # host read: the rescue's branch
    if not n:
        return prep
    global rescued
    rescued += n
    if region is None:
        return _rescue(prep)
    return region("solve.rescue", _rescue, prep)


def _start(params, q_guesses, Delta0):
    """The loop's first state: Delta0 (a tensor) or ``params.Delta0``."""
    B = q_guesses.shape[0]
    dtype, device = q_guesses.dtype, q_guesses.device
    if Delta0 is None:
        Delta = torch.full((B,), params.Delta0, dtype=dtype, device=device)
    else:
        Delta = Delta0.to(dtype).expand(B).clone()
    return _LoopState(
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
        stats=_empty_stats(B, params.max_iterations, dtype, device),
    )


def _prepare_iteration(model, probs, params, s, horizon):
    """The first half of an iteration: (everything the step needs at s.q,
    which scenarios are still active, how many Newton solves failed the
    acceptance)."""
    active = (s.k < params.max_iterations) & ~s.done
    prep = _prepare_batched(model, probs, params, s.q, s.D, horizon)
    return prep._replace(factor=None), active, (~prep.solve_ok).sum()


def _advance(model, probs, params, s, active, prep, horizon):
    """The second half of an iteration: dogleg, trust ratio, statistics,
    convergence and the radius update, masked to the active scenarios.
    Returns (the next state, whether any scenario stays active, the verbose
    table's columns or None)."""
    K = params.max_iterations
    eta = 0.0  # acceptance threshold
    eps_guard = 10 * torch.finfo(s.q.dtype).eps / probs.dt / probs.dt
    with instrument("linalg.dogleg"):
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
    onehot = torch.arange(K, device=s.q.device)[None, :] == s.k[:, None]

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
    rows = None
    if params.verbose:
        rows = (active, s.k, prep.cost, prep.merit, s.Delta, rho, dq_norm,
                _bnorm(prep.g_merit), _bnorm(prep.h))

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

    new = _mask(active, _LoopState(
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
    ), s)
    return new, torch.any((new.k < K) & ~new.done), rows


def _finish(model, probs, params, s, horizon):
    """(Solution, Stats, WarmStart) of the final state."""
    B, K = s.q.shape[0], params.max_iterations
    device = s.q.device
    with instrument("physics.forces"):
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
    return (
        Solution(q=s.q, v=v, tau=tau),
        stats,
        WarmStart(q=s.q, Delta=s.Delta, dq=s.dq_last, dqH=s.dqH_last),
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
    (Solution, Stats, WarmStart).  ``Delta0`` (a tensor, () or (B,), or a
    number) replaces ``params.Delta0``.

    On CUDA tensors each part is a captured region (``utils/graphs.py``):
    the start, the two halves of each iteration, the closing forces.  The
    host counts the iterations and reads one flag from the device after
    each but the last (whether any scenario is still active): an
    ``mpc_iters: 1`` replan with Thomas reads nothing.  Between the halves
    the host prints the dense cross-check when it is asked for, and under
    cyclic reduction it reads the count of Newton solves that failed the
    acceptance (and runs the Thomas rescue, a third region, when there are
    any).  The verbose table and the iteration timer act between replays.
    The start hands its static copy of ``probs`` to the later regions, and
    the first half hands on its state, so that neither is copied again
    within a call.

    ``horizon`` (a ``parallel.horizon.HorizonSplit``) shards the horizon
    over a process group: each rank evaluates the physics of its own steps,
    and cyclic reduction runs distributed.  Every rank then holds the same
    gathered values and takes the same host decisions.  The regions hold
    the collectives, and the split is part of their keys.  On an NCCL group
    every rank captures and replays the same regions, as the JAX package
    partitions its one compiled loop; on a gloo group (CPU ranks, or ranks
    that share a card) the route follows the backend and the regions run
    directly on CUDA tensors, since gloo cannot be captured
    (``graphs.direct_runs`` counts them)."""
    check_supported(model)
    K = params.max_iterations
    if Delta0 is not None and not isinstance(Delta0, torch.Tensor):
        Delta0 = torch.full((), float(Delta0), dtype=q_guesses.dtype,
                            device=q_guesses.device)
    group = None if horizon is None else horizon.ax.group

    def region(name, fn, *args, clone=False):
        return graphs.run(name, fn, args, model=model, key=(params, horizon),
                          clone=clone, group=group)

    probs, s = region(
        "solve.start", lambda p, qg, d: (p, _start(params, qg, d)),
        probs, q_guesses, Delta0)
    compare = compares_dense(params)
    if params.record_iteration_times:
        itimer.reset(q_guesses.device)
    for it in range(K):
        s, prep, active, n_failed = region(
            "solve.prepare",
            lambda p, st: (st, *_prepare_iteration(model, p, params, st,
                                                   horizon)),
            probs, s)
        if compare:
            print_dense_compare(prep.H, prep.g_merit, prep.p_raw)
        prep = _rescue_degraded_solves(params, prep, n_failed, region)
        s, more, rows = region(
            "solve.advance",
            lambda p, st, a, pr: _advance(model, p, params, st, a, pr,
                                          horizon),
            probs, s, active, prep)
        if params.record_iteration_times:
            itimer.mark()
        if params.verbose:
            print_rows(*rows)
        # Host read once an iteration, none after the last.
        if it + 1 == K:
            break
        with instrument("solve.read_more"):
            if not bool(more):
                break
    sol, stats, warm = region(
        "solve.finish",
        lambda p, st: _finish(model, p, params, st, horizon),
        probs, s, clone=True)
    if params.record_iteration_times:
        stats = itimer.attach(stats)
    return sol, stats, warm
