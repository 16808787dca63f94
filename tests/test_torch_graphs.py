"""The port's captured regions (``idto_tpu_torch/utils/graphs.py``) on the
CPU, where no CUDA graph exists.

(a) Capture safety: each region of the main path -- the loop's start, both
halves of its body under Thomas and under cyclic reduction, the Thomas
rescue, the hopper's constrained body, the body under finite-difference
partials, the closing forces, the MPC regions around the solve and a
simulator segment -- runs again after its warm-up under a dispatch mode
that fails on every op that reads a device value on the host
(``_local_scalar_dense``, ``nonzero``, ``is_nonzero``), and makes no new
constant: on the card any of these would break the capture.

(b) The static-buffer plumbing, through the CPU stand-in of a graph (the
recorded callable re-run on the same static buffers): solves, chained
replans and a segment equal the direct route bitwise; a result kept from
one call is not overwritten by the next; a new model object, shape or
parameter captures anew; ``ResetInitialConditions`` reaches the replay.

(c) Launch accounting: the launches a capture records are added at each
replay, and the warm-up's go to ``graphs.warmup_launches``.

(d) Keys and entry points: a sharded and an unsharded solve of the same
shapes capture apart (the horizon split is in the key), a tensor passed in
two slots gets a buffer each, and the linesearch's entry points share its
regions.
"""
import contextlib
import io
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from idto_tpu_torch.api import TrajectoryOptimizer
from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.mpc import controller as mpc
from idto_tpu_torch.mpc.simulator import simulate_segment
from idto_tpu_torch.optimizer import batched
from idto_tpu_torch.optimizer.problem import (
    GradientsMethod,
    LinearSolverType,
)
from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch
from idto_tpu_torch.utils import consts, graphs

# One intra-op thread: several test workers share the cores.
torch.set_num_threads(1)

CR = LinearSolverType.CYCLIC_REDUCTION
_HOST_READS = {torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
               torch.ops.aten.is_nonzero}


class _NoHostReads(TorchDispatchMode):
    """Fails on each op that would wait for the device and copy a value to
    the host (on the card: a synchronization, illegal in a capture)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in _HOST_READS:
            raise AssertionError(f"host read inside a region: {func}")
        return func(*args, **(kwargs or {}))


@pytest.fixture
def stand_in():
    graphs.reset()
    with graphs.stand_in():
        yield
    graphs.reset()


def _small(name, T, B=1, seed=0, **more):
    """(model, config, problem, problems (B), params, guesses (B)) of an
    example cut to T steps, each scenario's start moved by 0.01 N(0, 1)."""
    model, cfg, prob, params, q_guess = load_example(name, device="cpu")
    prob = prob.replace(num_steps=T, q_nom=prob.q_nom[: T + 1],
                        v_nom=prob.v_nom[: T + 1])
    dq = torch.as_tensor(
        0.01 * np.random.default_rng(seed).standard_normal((B, model.nq)))
    probs = broadcast_problem(prob, B)
    probs = probs.replace(q_init=probs.q_init + dq)
    return (model, cfg, prob, probs, params.replace(**more),
            q_guess[None, : T + 1] + dq[:, None])


def _strict_rerun(run):
    """``run()`` once (each region warms up and is recorded), then again
    with every region's re-run under ``_NoHostReads``; returns the names of
    the regions that ran so and the second run's result.  No constant may
    be made in the second run."""
    run()
    ran = set()
    for entry in graphs._entries.values():
        def strict(call=entry.graph, name=entry.name):
            ran.add(name)
            with _NoHostReads():
                return call()
        entry.graph = strict
    misses = consts.misses
    out = run()
    assert consts.misses == misses, "a constant was made after the warm-up"
    return ran, out


def _assert_same(a, b):
    """Every tensor of two results equal, NaN where NaN."""
    la, lb = [], []
    graphs._flatten(a, la)
    graphs._flatten(b, lb)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def _solve_case(name, T, B, iters, **more):
    model, _, _, probs, params, qg = _small(name, T, B, max_iterations=iters,
                                            **more)

    def run():
        with contextlib.redirect_stdout(io.StringIO()):
            return solve_batch(model, probs, params, qg)
    return run


def _replan_case(name, T, velocity=False):
    model, cfg, prob, _, params, qg = _small(name, T)
    probs = broadcast_problem(prob, 1)
    mpc_params = mpc.make_mpc_params(params, 1)
    x0 = torch.cat([prob.q_init, prob.v_init])[None]
    with graphs.eager():
        carry, _ = mpc.mpc_initialize(model, probs, params.replace(
            max_iterations=1), qg)
    rel = np.zeros(model.nq)
    if cfg.q_nom_relative_to_q_init is not None:
        rel = np.asarray(cfg.q_nom_relative_to_q_init, dtype=np.float64)
    t = torch.tensor(0.016, dtype=torch.float64)
    cmd = torch.tensor([0.3, 0.0, 0.2], dtype=torch.float64)

    def run():
        if velocity:
            return mpc.mpc_step_velocity_command(model, probs, mpc_params,
                                                 carry, x0, t, cmd)
        return mpc.mpc_step(model, probs, mpc_params, rel, carry, x0, t)
    return run


def _segment_case(name, T, substeps):
    model, cfg, prob, _, params, qg = _small(name, T)
    with graphs.eager():
        carry, _ = mpc.mpc_initialize(model, broadcast_problem(prob, 1),
                                      params.replace(max_iterations=1), qg)
    Kp = torch.as_tensor(np.asarray(cfg.Kp, dtype=np.float64))
    Kd = torch.as_tensor(np.asarray(cfg.Kd, dtype=np.float64))
    q, v = prob.q_init[None], prob.v_init[None]
    t = torch.tensor(0.01, dtype=torch.float64)

    def run():
        return simulate_segment(model, params.contact, cfg.sim_time_step,
                                substeps, carry.stored, Kp, Kd, q, v, t,
                                cfg.feed_forward)
    return run


_SAFETY_CASES = {
    # name: (make run, regions that must have run under the strict mode)
    "pendulum_thomas": (lambda: _solve_case("pendulum", 4, 2, 2),
                        {"solve.start", "solve.prepare", "solve.advance",
                         "solve.finish"}),
    "cheetah_cr": (lambda: _solve_case("mini_cheetah", 2, 2, 2,
                                       linear_solver=CR),
                   {"solve.prepare", "solve.advance", "solve.finish"}),
    "hopper_constraints_thomas": (lambda: _solve_case("hopper", 4, 2, 2),
                                  {"solve.prepare", "solve.advance"}),
    "hopper_constraints_cr": (lambda: _solve_case("hopper", 4, 2, 2,
                                                  linear_solver=CR),
                              {"solve.prepare", "solve.advance"}),
    "spinner_fd": (lambda: _solve_case(
        "spinner", 4, 2, 2,
        gradients_method=GradientsMethod.FORWARD_DIFFERENCES),
        {"solve.prepare", "solve.advance"}),
    "spinner_cd_verbose_compare": (lambda: _solve_case(
        "spinner", 3, 2, 2,
        gradients_method=GradientsMethod.CENTRAL_DIFFERENCES, verbose=True,
        debug_compare_against_dense=True),
        {"solve.prepare", "solve.advance"}),
    "pendulum_dense": (lambda: _solve_case(
        "pendulum", 3, 2, 2, linear_solver=LinearSolverType.DENSE_LDLT),
        {"solve.prepare", "solve.advance"}),
    "punyo_capsules": (lambda: _solve_case("punyo", 2, 1, 1),
                       {"solve.prepare", "solve.advance", "solve.finish"}),
    "hopper_replan": (lambda: _replan_case("hopper", 4),
                      {"mpc.replan_start", "solve.start", "solve.prepare",
                       "solve.advance", "solve.finish", "mpc.store"}),
    "cheetah_velocity_command": (lambda: _replan_case("mini_cheetah", 2,
                                                      velocity=True),
                                 {"mpc.replan_start", "solve.prepare",
                                  "solve.advance", "mpc.store"}),
    "hopper_segment": (lambda: _segment_case("hopper", 4, 3),
                       {"sim.segment"}),
}


@pytest.mark.parametrize("case", sorted(_SAFETY_CASES))
def test_regions_read_nothing_on_the_host(stand_in, case):
    make, regions = _SAFETY_CASES[case]
    ran, _ = _strict_rerun(make())
    assert regions <= ran, f"{case}: {regions - ran} did not run"


def test_rescue_region_reads_nothing_on_the_host(stand_in):
    """The Thomas rescue of a cyclic-reduction iteration whose Newton solve
    failed the acceptance in one scenario."""
    model, _, _, probs, params, qg = _small("hopper", 4, 2,
                                            linear_solver=CR)
    s = batched._start(params, qg, None)
    prep, _, _ = batched._prepare_iteration(model, probs, params, s, None)
    prep = prep._replace(solve_ok=torch.tensor([False, True]))
    before = batched.rescued

    def run():
        return batched._rescue_degraded_solves(
            params, prep, None,
            lambda name, fn, *a: graphs.run(name, fn, a, model=model))

    ran, fixed = _strict_rerun(run)
    assert ran == {"solve.rescue"}
    assert batched.rescued == before + 2
    assert fixed.solve_ok.tolist() == [True, True]
    _assert_same(fixed, batched._rescue(prep))


@pytest.mark.parametrize("solver", ["thomas", "cr"])
def test_solve_batch_through_the_stand_in_is_the_direct_solve(stand_in,
                                                              solver):
    """Three iterations of the constrained hopper at B=2: the stand-in's
    replays against the direct call, bitwise; the results are fresh
    tensors, not static buffers."""
    more = {"linear_solver": CR} if solver == "cr" else {}
    run = _solve_case("hopper", 3, 2, 3, **more)
    got = run()
    assert graphs.captures > 0
    with graphs.eager():
        want = run()
    _assert_same(got, want)
    leaves = []
    graphs._flatten(got, leaves)
    assert not any(graphs._is_owned(t) for t in leaves)
    assert int(got[1].num_iters[0]) == 3


def test_chained_replans_through_the_stand_in(stand_in):
    """Initialize and two chained replans on the hopper against the direct
    chain, bitwise; the solution kept from the first replan is unchanged
    by the second."""
    model, cfg, prob, _, params, qg = _small("hopper", 4)
    probs = broadcast_problem(prob, 1)
    mpc_params = mpc.make_mpc_params(params, cfg.mpc_iters)
    rel = np.asarray(cfg.q_nom_relative_to_q_init, dtype=np.float64)

    def chain():
        carry, sol0 = mpc.mpc_initialize(model, probs, params.replace(
            max_iterations=1), qg)
        x0 = torch.cat([prob.q_init, prob.v_init])[None]
        out = [sol0]
        for k in range(2):
            carry, sol = mpc.mpc_step(model, probs, mpc_params, rel, carry,
                                      x0 + 0.01 * (k + 1),
                                      torch.tensor(0.05 * (k + 1),
                                                   dtype=torch.float64))
            out.append(sol)
            if k == 0:
                kept = sol.q.clone()
        return carry, out, kept

    carry, sols, kept = chain()
    assert torch.equal(sols[1].q, kept)
    with graphs.eager():
        want = chain()
    _assert_same((carry, sols), want[:2])


def test_segment_through_the_stand_in(stand_in):
    run = _segment_case("hopper", 4, 5)
    got = run()
    again = run()
    with graphs.eager():
        want = run()
    _assert_same(got, want)
    _assert_same(again, want)


def test_a_new_model_shape_or_parameter_captures_anew(stand_in):
    model, _, prob, probs, params, qg = _small("pendulum", 3, 2,
                                               max_iterations=1)

    def captures_of(*args):
        n = graphs.captures
        solve_batch(*args)
        return graphs.captures - n

    # start, the iteration's two halves, finish
    assert captures_of(model, probs, params, qg) == 4
    assert captures_of(model, probs, params, qg) == 0
    assert captures_of(model, probs, params.replace(max_iterations=1),
                       qg.clone()) == 0
    other = load_example("pendulum", device="cpu")[0]
    assert captures_of(other, probs, params, qg) == 4
    probs3 = broadcast_problem(prob, 3)
    assert captures_of(model, probs3, params, qg[:1].expand(3, -1, -1)) == 4
    assert captures_of(model, probs, params.replace(Delta0=0.2), qg) == 4


def test_reset_initial_conditions_reaches_the_replay(stand_in):
    model, _, prob, _, params, qg = _small("spinner", 4, max_iterations=2)
    opt = TrajectoryOptimizer(model, prob, params)
    first, _ = opt.Solve(qg[0])
    q0 = prob.q_init + 0.05
    v0 = prob.v_init - 0.1
    opt.ResetInitialConditions(q0, v0)
    guess = qg[0].clone()
    guess[0] = q0
    got, stats = opt.Solve(guess)
    with graphs.eager():
        fresh = TrajectoryOptimizer(model, prob.replace(q_init=q0,
                                                        v_init=v0), params)
        want, want_stats = fresh.Solve(guess)
    _assert_same((got, stats), (want, want_stats))
    assert not torch.equal(first.q, got.q)
    assert torch.equal(got.v[0], v0)


def test_launches_recorded_at_the_capture_are_added_at_each_replay(stand_in):
    kernel = types.SimpleNamespace(launches=0)
    graphs.register_counter(kernel, "launches")

    def fn(x):
        kernel.launches += 2  # two launches of a counted kernel
        return x * 2.0

    try:
        x = torch.ones(3, dtype=torch.float64)
        warm = graphs.warmup_launches
        for _ in range(4):
            assert torch.equal(graphs.run("two_launches", fn, (x,)), 2 * x)
        assert kernel.launches == 8  # 4 replays, 2 each
        assert graphs.warmup_launches == warm + 2
        assert graphs.captures == 1 and graphs.replays == 4
    finally:
        graphs._counters.remove((kernel, "launches"))


def test_static_buffers_keep_layouts_and_chains_take_no_copy(stand_in):
    """An expanded input stays expanded (stride 0) and keeps its alignment;
    an output of one region is the next region's static input as it is."""
    base = torch.arange(6, dtype=torch.float64)
    x = base[1:4].expand(2, 3)
    buf = graphs._buffer(x)
    assert buf.stride() == x.stride() == (0, 1)
    assert graphs._meta(buf) == graphs._meta(x)
    graphs._copy(buf, x)
    assert torch.equal(buf, x)

    y = graphs.run("double", lambda a: a * 2.0, (x,), clone=False)
    assert graphs._is_owned(y)
    z = graphs.run("add_one", lambda a: a + 1.0, (y,))
    entry = next(e for e in graphs._entries.values() if e.name == "add_one")
    assert entry.inputs[0] is y
    assert torch.equal(z, 2.0 * x + 1.0) and not graphs._is_owned(z)
    # A new value of the chain's head reaches the tail through the adopted
    # buffer.
    x1 = (base + 1.0)[1:4].expand(2, 3)
    y2 = graphs.run("double", lambda a: a * 2.0, (x1,), clone=False)
    assert y2 is y
    assert torch.equal(graphs.run("add_one", lambda a: a + 1.0, (y2,)),
                       2.0 * x1 + 1.0)
    # A region that passes an expanded input through hands out its static
    # buffer; a region that adopted it takes a new value of the same layout
    # into it.
    p = graphs.run("pass", lambda a: a, (x,), clone=False)
    assert p.stride() == (0, 1) and graphs._is_owned(p)
    assert torch.equal(graphs.run("neg", lambda a: -a, (p,)), -x)
    assert torch.equal(graphs.run("neg", lambda a: -a, (x1,)), -x1)


def test_cpu_tensors_and_the_eager_block_run_directly():
    graphs.reset()
    model, _, _, probs, params, qg = _small("pendulum", 3, 1,
                                            max_iterations=1)
    solve_batch(model, probs, params, qg)
    assert not graphs._entries
    with graphs.stand_in(), graphs.eager():
        solve_batch(model, probs, params, qg)
    assert not graphs._entries


def test_the_solve_copies_its_problem_once_a_call(stand_in):
    """The start's static copy of the problems is every later region's
    input, and the second half of an iteration reads the state where the
    first half read it: neither is copied again within a call."""
    model, _, _, probs, params, qg = _small("pendulum", 3, 2,
                                            max_iterations=2)
    solve_batch(model, probs, params, qg)
    entry = {e.name: e for e in graphs._entries.values()}
    leaves: list = []
    graphs._flatten(probs, leaves)
    n_probs = len(leaves)
    start_probs = entry["solve.start"].inputs[:n_probs]
    for name in ("solve.prepare", "solve.advance", "solve.finish"):
        got = entry[name].inputs[:n_probs]
        assert all(a is b for a, b in zip(got, start_probs)), name
    # prepare's inputs: (probs, state); advance's: (probs, state, ...)
    state = entry["solve.prepare"].inputs[n_probs:]
    after = entry["solve.advance"].inputs[n_probs:n_probs + len(state)]
    assert all(a is b for a, b in zip(after, state))


def test_a_tensor_in_two_slots_gets_a_buffer_each(stand_in):
    """A region's output passed in two argument slots is adopted in the
    first; the second gets a buffer of its own, so that a later call may
    pass two different values there."""
    x = torch.arange(3, dtype=torch.float64)
    y = graphs.run("twice", lambda a: a * 2.0, (x,), clone=False)

    def diff(a, b):
        return a - b

    assert torch.equal(graphs.run("diff", diff, (y, y)), torch.zeros(3))
    entry = next(e for e in graphs._entries.values() if e.name == "diff")
    assert entry.inputs[0] is y and entry.inputs[1] is not y
    z = y + 1.0
    assert torch.equal(graphs.run("diff", diff, (z, y)), torch.ones(3))


def test_a_sharded_and_an_unsharded_solve_capture_apart(stand_in):
    """The horizon split is part of the keys: the pendulum sharded over a
    group of one and unsharded, at the same shapes and parameters, capture
    under different keys; a new split of the same group, rank and knots
    replays the first one's graphs.  The sharded regions read nothing on
    the host."""
    import torch.distributed as dist

    from idto_tpu_torch.parallel.horizon import HorizonSplit
    from idto_tpu_torch.parallel.multihost import AxisGroup

    model, _, prob, probs, params, qg = _small(
        "pendulum", 3, 1, max_iterations=1, linear_solver=CR)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        ax = AxisGroup(dist.group.WORLD, 1, 0)

        def captures_of(horizon):
            n = graphs.captures
            batched.solve_trust_region_batched(model, probs, params, qg,
                                               horizon=horizon)
            return graphs.captures - n

        assert captures_of(HorizonSplit(ax, prob.num_steps)) == 4
        assert captures_of(None) == 4
        assert captures_of(HorizonSplit(ax, prob.num_steps)) == 0
        assert captures_of(None) == 0
        splits = {k[2][1] for k in graphs._entries}
        assert len(splits) == 2 and None in splits
        # The sharded regions, collectives and all, read nothing on the
        # host.
        ran, _ = _strict_rerun(lambda: batched.solve_trust_region_batched(
            model, probs, params, qg,
            horizon=HorizonSplit(ax, prob.num_steps)))
        assert {"solve.prepare", "solve.advance"} <= ran
    finally:
        dist.destroy_process_group()


def test_linesearch_entry_points_share_the_captured_regions(stand_in):
    """``TrajectoryOptimizer.Solve`` with ``method: linesearch`` captures
    the linesearch's regions in its first call; ``solver.solve`` and
    ``solve_batch`` of the same problem replay them, capturing nothing;
    ``SolveFromWarmStart`` resumes the trust region, as in the JAX
    package, on regions of its own."""
    from idto_tpu_torch.api import WarmStart
    from idto_tpu_torch.optimizer import solver
    from idto_tpu_torch.optimizer.problem import SolverMethod

    model, _, prob, probs, params, qg = _small(
        "pendulum", 6, 1, max_iterations=2, method=SolverMethod.LINESEARCH)
    opt = TrajectoryOptimizer(model, prob, params)
    sol, _ = opt.Solve(qg[0])
    names = {e.name for e in graphs._entries.values()}
    assert names == {"ls.start", "ls.prepare", "ls.search", "ls.advance",
                     "ls.finish"}
    n = graphs.captures
    again = solver.solve(model, prob, params, qg[0])[0]
    batch = solve_batch(model, probs, params, qg)[0]
    assert graphs.captures == n
    assert torch.equal(again.q, sol.q) and torch.equal(batch.q[0], sol.q)
    opt.SolveFromWarmStart(WarmStart(sol.q, params.Delta0))
    names = {e.name for e in graphs._entries.values()}
    assert {"solve.start", "solve.prepare", "solve.advance"} <= names
