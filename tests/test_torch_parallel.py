"""The port's parallel layer (``idto_tpu_torch/parallel/``) on
``torch.distributed`` with gloo on the CPU, against the JAX package's goldens
(``scripts/make_torch_goldens.py horizon sharded``: JAX on its eight
virtual CPU devices) and against the port's own unsharded solves.

One ``torch.multiprocessing`` start of four ranks in a module-scoped fixture
runs every check that needs a group and returns each rank's results; the
tests assert on those.  Meshes of the four ranks give every axis size:
``make_global_mesh(sp)`` has horizon groups of ``sp`` consecutive ranks and
a scenario axis of 4 / sp.  This file imports no JAX, so the ranks do not
either.  The horizon-sharded pendulum runs ten iterations (JAX's own test
runs 25): a port iteration costs ~0.2 s of one CPU thread, most of it
``torch.func`` overhead, and the file keeps to ~35 s.  The same run takes
the horizon-sharded pendulum through the CPU stand-in of its captured
regions (``utils/graphs.py``; collectives inside) at P=2 and P=4, bitwise
against the direct route, and has one rank drop its graphs so that the
two ranks of a group disagree on a region: both must raise.

Tolerances: the random SPD systems 1e-9 relative against JAX's
``solve_sharded`` on a mesh of the same size, as tests/test_horizon.py holds
sharded against unsharded; q and ``mean_cost`` of the horizon-sharded
pendulum and of the sharded batches 1e-8, as tests/test_horizon.py and
tests/test_parallel.py hold them; the port's sharded solves against its own
unsharded ones 1e-10 (the same arithmetic in another grouping).  The
cheetah at T=7 is held to 1e-10 against the level-wise route
(``cr_use_pallas=False``, the same block inverses) and to 1e-7 against the
default route: its Hessian is ill-conditioned, and the fused route's
Gauss-Jordan inverses part from LU by 1.7e-8 on q after one iteration
(measured on this CPU).
"""
import datetime
import os
import pickle

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from idto_tpu_torch.parallel import batching, horizon, multihost

# One intra-op thread, in this process and in every rank.
torch.set_num_threads(1)

_GOLDENS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens")
WORLD = 4
# Seconds the four ranks may take together (about 25 s alone).
DEADLINE = 240
SYSTEM_RTOL = 1e-9
SOLVE_RTOL = 1e-8
SELF_RTOL = 1e-10
CHEETAH_FUSED_RTOL = 1e-7
CHEETAH_T = 7
PENDULUM_T = 31
PENDULUM_ITERS = 10


def _golden(name):
    return np.load(os.path.join(_GOLDENS, f"torch_{name}.npz"))


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _bands(g, tag):
    from idto_tpu_torch.ops.penta import PentaBands

    return PentaBands(**{f: torch.as_tensor(g[tag + f])[None]
                         for f in "ABCDE"})


def _pendulum_model():
    """tests/test_dynamics.py::make_pendulum in the port."""
    from idto_tpu_torch.models.model import JointType, ModelBuilder

    b = ModelBuilder()
    b.add_link("arm", "world", JointType.REVOLUTE, joint_name="theta",
               axis=(0.0, 1.0, 0.0), damping=0.1, mass=1.0,
               com=(0.0, 0.0, -0.5), inertia=np.zeros((3, 3)))
    b.add_actuator("theta")
    return b.finalize(device="cpu")


def _pendulum_problem(T):
    """tests/test_optimizer.py::pendulum_problem in the port."""
    from idto_tpu_torch.optimizer.problem import ProblemDefinition

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64))

    return ProblemDefinition(
        num_steps=T, dt=0.05, q_init=t([0.1]), v_init=t([0.0]),
        q_nom=t(np.full((T + 1, 1), np.pi)), v_nom=t(np.zeros((T + 1, 1))),
        Qq=t([1.0]), Qv=t([0.1]), R=t([0.01]), Qf_q=t([1000.0]),
        Qf_v=t([1.0]))


def _final_cost_mean(stats):
    iters = np.maximum(np.asarray(stats.num_iters) - 1, 0)
    cost = np.asarray(stats.cost)
    return cost[np.arange(cost.shape[0]), iters].mean()


def _pendulum_tr():
    """tests/test_horizon.py's pendulum at T=31 with cyclic reduction:
    (model, problem, params, q guess)."""
    from idto_tpu_torch.optimizer.problem import (
        LinearSolverType,
        SolverParameters,
        linear_interp_nominal,
    )

    params = SolverParameters(
        max_iterations=PENDULUM_ITERS, scaling=True,
        equality_constraints=False,
        linear_solver=LinearSolverType.CYCLIC_REDUCTION)
    return (_pendulum_model(), _pendulum_problem(PENDULUM_T), params,
            torch.as_tensor(linear_interp_nominal([0.1], [0.1], PENDULUM_T)))


def _pendulum_batch():
    from idto_tpu_torch.optimizer.problem import SolverParameters

    g = _golden("sharded_pendulum")
    probs = batching.broadcast_problem(_pendulum_problem(8), 8).replace(
        q_nom=torch.as_tensor(g["q_nom"]))
    params = SolverParameters(max_iterations=10, equality_constraints=False)
    return probs, params, torch.as_tensor(g["q_guess"])


def _cheetah():
    from idto_tpu_torch.examples.registry import load_example
    from idto_tpu_torch.optimizer.problem import LinearSolverType

    model, _, prob, params, qg = load_example("mini_cheetah", device="cpu")
    T = CHEETAH_T
    prob = prob.replace(num_steps=T, q_nom=prob.q_nom[:T + 1],
                        v_nom=prob.v_nom[:T + 1])
    params = params.replace(
        max_iterations=1, linear_solver=LinearSolverType.CYCLIC_REDUCTION)
    return model, prob, params, qg[:T + 1]


def _horizon_sharded(problem, mesh, out, tag):
    """solve_trust_region_horizon_sharded of ``problem`` on ``mesh``; the
    instance counts of its step_tau calls go to out[tag + "_instances"]."""
    from idto_tpu_torch.soa import contact

    record = []
    original = contact.step_tau

    def counted(model, params, q, v, a):
        record.append(int(q.shape[-1]))
        return original(model, params, q, v, a)

    contact.step_tau = counted
    try:
        result = horizon.solve_trust_region_horizon_sharded(*problem, mesh)
    finally:
        contact.step_tau = original
    out[tag + "_instances"] = sorted(set(record))
    return result


def _checks(rank):
    """Every check of one rank: a dict of named numbers.  The two horizon
    groups of two work apart while they can: ranks 0 and 1 solve the
    pendulum on theirs, ranks 2 and 3 the cheetah on theirs, then each rank
    one of the unsharded solves (the cheetah by the fused and by the
    level-wise route, the pendulum, the batch); all share those through the
    default group."""
    import torch.distributed as dist

    from idto_tpu_torch.examples.registry import load_example
    from idto_tpu_torch.ops import cyclic_reduction
    from idto_tpu_torch.optimizer.problem import (
        LinearSolverType,
        linear_interp_nominal,
    )
    from idto_tpu_torch.optimizer.solver import solve

    out = {"world": dist.get_world_size()}
    meshes = {sp: multihost.make_global_mesh(sp=sp, device="cpu")
              for sp in (1, 2, 4)}
    out["horizon_groups"] = {
        sp: multihost.axis_group(m, "horizon").index for sp, m in
        meshes.items()}
    try:
        multihost.make_global_mesh(sp=3, device="cpu")
        out["sp3"] = "accepted"
    except ValueError as e:
        out["sp3"] = str(e)

    # -- solve_sharded on the random SPD systems ---------------------------
    g = _golden("horizon_systems")
    for n, k in ((33, 4), (64, 2), (100, 5), (161, 3)):
        tag = f"n{n}_k{k}_"
        H, b = _bands(g, tag), torch.as_tensor(g[tag + "b"])[None]
        x_un = cyclic_reduction.solve(H, b)
        for P in (1, 2, 4):
            x = horizon.solve_sharded(H, b, meshes[P])[0]
            out[f"sys_{n}_{k}_P{P}_vs_jax"] = _rel(x, g[tag + f"x_P{P}"])
            out[f"sys_{n}_{k}_P{P}_vs_port"] = _rel(x, x_un[0])
            # Two right-hand sides at once, the second the first doubled.
            x2 = horizon.solve_sharded(
                H, torch.stack([b, 2 * b], dim=1), meshes[P])
            out[f"sys_{n}_{k}_P{P}_R2"] = max(
                _rel(x2[0, 0], x_un[0]), _rel(x2[0, 1], 2 * x_un[0]))

    # -- the groups of two apart, then the unsharded solves ----------------
    pendulum, cheetah = _pendulum_tr(), _cheetah()
    mine = {}
    if rank < 2:
        mine["pendulum_P2"] = _horizon_sharded(pendulum, meshes[2], out,
                                               "pendulum_P2")[:2]
    else:
        mine["cheetah_P2_q"] = _horizon_sharded(cheetah, meshes[2], out,
                                                "cheetah")[0].q
    model, prob, params, qg = cheetah
    if rank == 0:
        mine["cheetah_fused_q"] = solve(model, prob, params, qg)[0].q
    if rank == 1:
        mine["cheetah_levels_q"] = solve(
            model, prob, params.replace(cr_use_pallas=False), qg)[0].q
    if rank == 2:
        mine["pendulum_P1"] = solve(*pendulum)[:2]
    if rank == 3:
        probs, params, qgs = _pendulum_batch()
        sol, stats, _ = batching.solve_batch(_pendulum_model(), probs,
                                             params, qgs)
        mine["batch_q"] = sol.q
        mine["batch_mean_cost"] = _final_cost_mean(stats)
    shared = [None] * WORLD
    dist.all_gather_object(shared, mine)
    ref = {k: v for part in shared for k, v in part.items()}

    # -- the horizon-sharded trust region on the pendulum ------------------
    # On an axis of one rank it is the unsharded solve.
    g = _golden("horizon_pendulum")
    results = {1: ref["pendulum_P1"], 2: ref["pendulum_P2"],
               4: _horizon_sharded(pendulum, meshes[4], out,
                                   "pendulum_P4")[:2]}
    un_sol, un_stats = results[1]
    for P, (sol, stats) in results.items():
        iters = int(stats.num_iters)
        out[f"pendulum_P{P}_vs_jax"] = max(
            _rel(sol.q, g[f"P{P}_q"]),
            _rel(stats.cost[:iters], g[f"P{P}_cost"][:iters]))
        out[f"pendulum_P{P}_iters"] = (iters, int(g[f"P{P}_num_iters"]))
        out[f"pendulum_P{P}_vs_port"] = max(
            _rel(sol.q, un_sol.q), _rel(stats.cost, un_stats.cost))

    # The same solves through the stand-in of their captured regions
    # (``utils/graphs.py``): a first call captures, a second replays; each
    # equals the direct route bitwise.  Then a rank that dropped its graphs
    # captures where its partner replays: both raise, naming the region.
    from idto_tpu_torch.utils import graphs

    def same(a, b):
        la, lb = [], []
        graphs._flatten(a, la)
        graphs._flatten(b, lb)
        return len(la) == len(lb) and all(
            torch.equal(torch.nan_to_num(x, 7.0), torch.nan_to_num(y, 7.0))
            for x, y in zip(la, lb))

    for P in (2, 4):
        if P == 2 and rank >= 2:
            continue  # ranks 2 and 3 solved the cheetah on their group
        graphs.reset()
        with graphs.stand_in():
            got = [horizon.solve_trust_region_horizon_sharded(
                *pendulum, meshes[P])[:2] for _ in range(2)]
        out[f"pendulum_P{P}_stand_in"] = (
            [same(g, results[P]) for g in got], graphs.captures,
            graphs.replays)
    if rank < 2:
        one = pendulum[:2] + (pendulum[2].replace(max_iterations=1),
                              pendulum[3])
        graphs.reset()
        with graphs.stand_in():
            horizon.solve_trust_region_horizon_sharded(*one, meshes[2])
            if rank == 1:
                graphs.reset()
            try:
                horizon.solve_trust_region_horizon_sharded(*one, meshes[2])
                out["disagreement"] = None
            except RuntimeError as e:
                out["disagreement"] = str(e)
    graphs.reset()

    # One knot a rank: the last rank owns knot T alone and evaluates no step
    # (Thomas: two super-rows are too few for four ranks' cyclic reduction).
    model, _, params, _ = pendulum
    short = (model, _pendulum_problem(3), params.replace(
        max_iterations=2, linear_solver=LinearSolverType.PENTA_LU),
        torch.as_tensor(linear_interp_nominal([0.1], [0.1], 3)))
    sol = _horizon_sharded(short, meshes[4], out, "short")[0]
    out["short_vs_port"] = _rel(sol.q, solve(*short)[0].q)

    # -- the scenario-sharded pendulum batch -------------------------------
    g = _golden("sharded_pendulum")
    probs, params, qgs = _pendulum_batch()
    for sp in (1, 2):  # scenario axes of 4 and 2 ranks
        sol, stats, warm, mean_cost = batching.solve_batch_sharded(
            pendulum[0], probs, params, qgs, meshes[sp])
        S = WORLD // sp
        out[f"batch_S{S}_vs_jax"] = _rel(sol.q, g["q"])
        out[f"batch_S{S}_mean_cost_vs_jax"] = _rel(mean_cost,
                                                   g["mean_cost"])
        out[f"batch_S{S}_vs_port"] = max(
            _rel(sol.q, ref["batch_q"]), _rel(warm.q, ref["batch_q"]),
            _rel(mean_cost, ref["batch_mean_cost"]))
        out[f"batch_S{S}_shapes"] = (
            tuple(sol.q.shape), tuple(stats.cost.shape),
            tuple(warm.Delta.shape))

    # -- solve_batch_global on the spinner: each rank's local scenarios ----
    g = _golden("sharded_spinner")
    model_s, _, prob_s, params_s, q_guess = load_example(
        "spinner", test_mode=True, device="cpu")
    dq, B = g["dq"], 8
    rows = multihost.scenario_sharding(meshes[1]).rows(B)
    local = batching.broadcast_problem(prob_s, rows.stop - rows.start)
    local = local.replace(q_init=local.q_init + torch.as_tensor(dq[rows]))
    qg_local = q_guess.numpy()[None] + dq[rows][:, None, :]
    sol, stats, _, mean_cost = multihost.solve_batch_global(
        model_s, local, params_s, qg_local, meshes[1])
    out["global_vs_jax"] = _rel(sol.q, g["q"])
    out["global_mean_cost_vs_jax"] = _rel(mean_cost, g["mean_cost"])
    out["global_rows"] = (rows.start, rows.stop, tuple(sol.q.shape))

    # -- the cheetah at full width, T=7, one iteration, P=2 ----------------
    if rank >= 2:
        q = mine["cheetah_P2_q"]
        out["cheetah_vs_levelwise"] = _rel(q, ref["cheetah_levels_q"])
        out["cheetah_vs_fused"] = _rel(q, ref["cheetah_fused_q"])
        out["cheetah_finite"] = bool(torch.isfinite(q).all())
    return out


def _rank_main(rank, rendezvous, results):
    torch.set_num_threads(1)
    import torch.distributed as dist

    multihost.initialize(rendezvous, WORLD, rank, device="cpu")
    try:
        out = _checks(rank)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(results, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results, from one start of four gloo ranks."""
    d = tmp_path_factory.mktemp("parallel")
    ctx = mp.start_processes(_rank_main,
                             args=(f"file://{d}/rv", str(d)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=DEADLINE)
    try:
        while not ctx.join(timeout=5):
            if datetime.datetime.now() > deadline:
                raise TimeoutError(f"the ranks ran past {DEADLINE} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    assert not any(p.is_alive() for p in ctx.processes)
    out = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize("rank", range(WORLD))
def test_mesh_layout_horizon_innermost(ranks, rank):
    """Horizon groups are consecutive ranks: rank r sits at r % sp."""
    out = ranks[rank]
    assert out["world"] == WORLD
    assert out["horizon_groups"] == {1: 0, 2: rank % 2, 4: rank}
    assert "not divisible by sp=3" in out["sp3"]


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("n,k", [(33, 4), (64, 2), (100, 5), (161, 3)])
def test_solve_sharded_matches_jax(ranks, n, k, P):
    for out in ranks:
        assert out[f"sys_{n}_{k}_P{P}_vs_jax"] <= SYSTEM_RTOL
        assert out[f"sys_{n}_{k}_P{P}_vs_port"] <= SELF_RTOL
        assert out[f"sys_{n}_{k}_P{P}_R2"] <= SELF_RTOL


@pytest.mark.parametrize("P", [1, 2, 4])
def test_horizon_sharded_pendulum_matches_jax(ranks, P):
    """q and the cost history to 1e-8 of JAX's horizon-sharded solve on a
    mesh of P, and to 1e-10 of the port's unsharded solve (which the
    horizon-sharded solve is on an axis of one rank)."""
    for out in ranks:
        assert out[f"pendulum_P{P}_vs_jax"] <= SOLVE_RTOL
        iters, jax_iters = out[f"pendulum_P{P}_iters"]
        assert iters == jax_iters == PENDULUM_ITERS
        assert out[f"pendulum_P{P}_vs_port"] <= SELF_RTOL


@pytest.mark.parametrize("P", [2, 4])
def test_horizon_sharded_pendulum_through_the_stand_in(ranks, P):
    """The horizon-sharded pendulum through the CPU stand-in of its captured
    regions, collectives inside: the first call (captures) and the second
    (replays only) equal the direct route bitwise on every rank of the
    group; the split is in the keys, so no region is captured twice."""
    for out in ranks[:P]:
        same, captures, replays = out[f"pendulum_P{P}_stand_in"]
        assert same == [True, True]
        # start, the iteration's two halves, finish; one replay each call
        # of a region after its capture
        assert captures == 4
        assert replays == 2 * (2 + 2 * PENDULUM_ITERS)


@pytest.mark.parametrize("rank", [0, 1])
def test_ranks_whose_regions_disagree_raise(ranks, rank):
    """Rank 1 dropped its graphs: it captures the start where rank 0
    replays it, and both raise with the region's name instead of pairing
    their collectives wrongly."""
    msg = ranks[rank]["disagreement"]
    assert msg is not None
    assert "'solve.start'" in msg
    assert "solve.start (capture)" in msg and "solve.start (replay)" in msg


@pytest.mark.parametrize("P", [2, 4])
def test_horizon_split_evaluates_each_rank_share(ranks, P):
    """Each rank's physics sees its own steps only, about B * T / P
    instances (B=1): the 32 knots of T=31 in shares of 32 / P, the last
    rank's share one step short (knot T starts no step).  Ranks 0 and 1
    solved the pendulum on their horizon group of two."""
    knots = (PENDULUM_T + 1) // P
    for rank, out in enumerate(ranks[:P if P == 2 else WORLD]):
        steps = knots - 1 if rank % P == P - 1 else knots
        assert out[f"pendulum_P{P}_instances"] == [steps]


@pytest.mark.parametrize("rank", range(WORLD))
def test_horizon_split_one_knot_a_rank(ranks, rank):
    """T=3 over four ranks: a step each for ranks 0-2, none for rank 3,
    which owns knot T alone; the solve matches the unsharded one."""
    out = ranks[rank]
    assert out["short_instances"] == ([] if rank == WORLD - 1 else [1])
    assert out["short_vs_port"] <= SELF_RTOL


@pytest.mark.parametrize("S", [2, 4])
def test_solve_batch_sharded_matches_jax(ranks, S):
    """tests/test_parallel.py's batch on scenario axes of 2 and 4 ranks
    (horizon groups of 2 and 1): the whole batch on every rank, q and the
    psum'd mean cost as JAX's on eight devices, and as the port's
    unsharded ``solve_batch``."""
    for out in ranks:
        assert out[f"batch_S{S}_vs_jax"] <= SOLVE_RTOL
        assert out[f"batch_S{S}_mean_cost_vs_jax"] <= SOLVE_RTOL
        assert out[f"batch_S{S}_vs_port"] <= SELF_RTOL
        assert out[f"batch_S{S}_shapes"] == ((8, 9, 1), (8, 10), (8,))


@pytest.mark.parametrize("rank", range(WORLD))
def test_solve_batch_global_from_local_scenarios(ranks, rank):
    """Each rank passes its two scenarios of the spinner; every rank gets
    the batch of eight solved, as JAX's ``solve_batch_global``."""
    out = ranks[rank]
    assert out["global_rows"] == (2 * rank, 2 * rank + 2, (8, 41, 3))
    assert out["global_vs_jax"] <= SOLVE_RTOL
    assert out["global_mean_cost_vs_jax"] <= SOLVE_RTOL


@pytest.mark.parametrize("rank", [2, 3])
def test_horizon_sharded_cheetah_at_full_width(ranks, rank):
    """mini_cheetah (nq=19), T=7, one iteration on the horizon group of
    ranks 2 and 3: each evaluates 4 or 3 steps (8 knots in shares of 4)."""
    out = ranks[rank]
    assert out["cheetah_finite"]
    assert out["cheetah_instances"] == [4 if rank % 2 == 0 else 3]
    assert out["cheetah_vs_levelwise"] <= SELF_RTOL
    assert out["cheetah_vs_fused"] <= CHEETAH_FUSED_RTOL


# -- plain tests: no process group ---------------------------------------


def test_initialize_single_process_noop(monkeypatch):
    import torch.distributed as dist

    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize(device="cpu") is False
    assert not dist.is_initialized()


def test_initialize_needs_a_rank(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="needs an address"):
        multihost.initialize("localhost:1", num_processes=2, device="cpu")


@pytest.mark.parametrize("device,backend,want", [
    ("cuda", None, "nccl"), ("cpu", None, "gloo"), ("cuda", "gloo", "gloo"),
    ("cpu", "nccl", ValueError), ("cuda", "mpi", ValueError)])
def test_backend_follows_the_device(device, backend, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            multihost.backend_for(device, backend)
    else:
        assert multihost.backend_for(device, backend) == want


@pytest.mark.parametrize("world,sp,local,shape", [
    (4, 3, 4, None), (4, 2, 4, (2, 2)), (8, 4, 2, (2, 4)), (8, 4, 3, None),
    (4, 1, 4, (4, 1))])
def test_mesh_shape_rule(world, sp, local, shape):
    """sp divides the world and nests in a host's ranks or spans hosts."""
    if shape is None:
        with pytest.raises(ValueError):
            multihost.mesh_shape(world, sp, local)
    else:
        assert multihost.mesh_shape(world, sp, local) == shape


class _StubMesh:
    """Just enough of a DeviceMesh for the checks made before any
    collective."""

    mesh_dim_names = ("horizon",)

    def get_group(self, dim):
        return None

    def size(self, dim):
        return 2

    def get_local_rank(self, dim):
        return 0


def test_horizon_that_does_not_divide_is_rejected():
    model = _pendulum_model()
    prob = _pendulum_problem(7)  # 8 knots divide 2 ranks
    bad = _pendulum_problem(8)   # 9 do not
    from idto_tpu_torch.optimizer.problem import SolverParameters

    with pytest.raises(ValueError, match=r"horizon knots \(9\) must divide "
                                         r"the mesh \(2\); pad T"):
        horizon.solve_trust_region_horizon_sharded(
            model, bad, SolverParameters(), torch.zeros(9, 1), _StubMesh())
    split = horizon.HorizonSplit(multihost.axis_group(_StubMesh(), "horizon"),
                                 prob.num_steps)
    assert (split.k0, split.k1, split.lo, split.hi) == (0, 4, 0, 4)


def test_batch_that_does_not_divide_is_rejected():
    ax = multihost.AxisGroup(None, 4, 1)
    assert ax.rows(8) == slice(2, 4)
    with pytest.raises(ValueError, match="does not divide"):
        ax.rows(6)


@pytest.mark.parametrize("method", ["autodiff", "forward_differences",
                                    "central_differences",
                                    "central_differences4"])
def test_halo_slice_matches_the_whole_horizon(method):
    """A rank's share of the physics (steps lo..hi-1 from the knots
    lo-1..hi) is that slice of the whole horizon's: the spinner (contact)
    at T=6, steps 2..4, through each partials route."""
    from idto_tpu_torch.examples.registry import load_example
    from idto_tpu_torch.optimizer.partials import id_partials_for
    from idto_tpu_torch.optimizer.problem import GradientsMethod
    from idto_tpu_torch.soa import rollout

    model, _, prob, params, q_guess = load_example("spinner", device="cpu")
    T, lo, hi = 6, 2, 5
    prob = prob.replace(num_steps=T, q_nom=prob.q_nom[:T + 1],
                        v_nom=prob.v_nom[:T + 1])
    params = params.replace(gradients_method=GradientsMethod(method))
    rng = np.random.default_rng(7)
    q = (q_guess[:T + 1] + 0.05 * torch.as_tensor(
        rng.standard_normal((T + 1, model.nq))))[None]
    tau, v = rollout.generalized_forces(model, prob, params.contact, q)
    tau_h, v_h = rollout.generalized_forces(
        model, prob, params.contact, q[:, lo - 1:hi + 1], halo=True)
    assert _rel(tau_h, tau[:, lo:hi]) <= SELF_RTOL
    assert _rel(v_h, v[:, lo:hi + 1]) <= SELF_RTOL
    whole = id_partials_for(model, prob, params, q)
    share = id_partials_for(model, prob, params, q[:, lo - 1:hi + 1],
                            halo=True)
    for part, ref in zip(share, whole):
        assert part.shape == ref[:, lo:hi].shape
        assert _rel(part, ref[:, lo:hi]) <= SELF_RTOL
