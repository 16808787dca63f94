"""Tests of the port that need an NVIDIA GPU: the CUDA cyclic-reduction
kernel against its plain PyTorch version (one and many right-hand sides, the
hybrid's tail), and the cheetah slice, the constrained hopper solve, the
cheetah replan chain, the six manipulation examples and the spinner's closed
loop on the card against the JAX package's golden solves; the capsule pair
kernels and a simulator step on the card against the CPU; ``solve_sharded``
on an NCCL group of one; ``bench_torch.run`` at a small size against the
JAX bench step's golden; the captured route against the eager one (the
batch-native solve, the replan and the segment; the linesearch solve and
the horizon-sharded loop on an NCCL group of one, both bitwise).  Without
a card they skip.

This file imports neither JAX nor ``idto_tpu``, so it also runs where JAX is
not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances (those of chip_smoke.py): float64 1e-9 relative (the kernel and the plain version differ
only in summation order, ~1e-15 on these systems); float32 5e-4, the bound
chip_smoke.py holds the kernel to; the slice 1e-8, as
tests/test_torch_slice.py holds the CPU run.
"""
import os

import numpy as np
import pytest
import torch

from chip_smoke import FLEET
from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.ops import cr_kernel
from idto_tpu_torch.ops import penta
from idto_tpu_torch.optimizer.problem import LinearSolverType
from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch

# One intra-op thread: these tensors are tiny, and several test workers with
# a thread pool each oversubscribe the cores (a solve is then 5-10x slower).
torch.set_num_threads(1)

_GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens", "torch_slice_cheetah.npz")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _random_spd_penta(B, n, k, rng):
    """B random SPD block penta systems P P^T + 0.1 I with block lower
    bidiagonal-by-two P: (bands (B, n, k, k) each, dense (B, nk, nk))."""
    dense = []
    for _ in range(B):
        P = np.zeros((n * k, n * k))
        for i in range(n):
            for j in range(max(0, i - 2), i + 1):
                blk = rng.standard_normal((k, k))
                if i == j:
                    blk += 3 * np.sqrt(k) * np.eye(k)
                P[i * k:(i + 1) * k, j * k:(j + 1) * k] = blk
        dense.append(P @ P.T + 0.1 * np.eye(n * k))
    dense = np.stack(dense)
    blocks = dense.reshape(B, n, k, n, k).transpose(0, 1, 3, 2, 4)
    bands = {}
    for name, off in zip("ABCDE", (-2, -1, 0, 1, 2)):
        X = np.zeros((B, n, k, k))
        for i in range(n):
            if 0 <= i + off < n:
                X[:, i] = blocks[:, i, i + off]
        bands[name] = X
    return bands, dense


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 5e-4)])
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("n,k", [
    (21, 19),   # the cheetah shape: register tiles of 38
    (161, 19),  # T = 160: 81 super-rows, 7 levels
    (21, 5),    # blocks of 10: the kernel's run-time-K engine
])
def test_cr_kernel_matches_plain_on_card(cuda, n, k, R, dtype, tol):
    rng = np.random.default_rng(9)
    B = 4
    bands, dense = _random_spd_penta(B, n, k, rng)
    b = rng.standard_normal((B, R, n, k))
    x_dense = np.stack([
        np.linalg.solve(dense[s], b[s].reshape(R, -1).T).T.reshape(R, n, k)
        for s in range(B)
    ])
    H = penta.PentaBands(**{f: torch.as_tensor(X, dtype=dtype, device=cuda)
                            for f, X in bands.items()})
    rhs = torch.as_tensor(b, dtype=dtype, device=cuda)
    before = cr_kernel.launches
    x = cr_kernel.solve_many(H, rhs)
    torch.cuda.synchronize()
    assert cr_kernel.launches == before + 1
    assert x.dtype == dtype and x.shape == (B, R, n, k)
    assert _rel(x.cpu(), cr_kernel.solve_many_reference(H, rhs).cpu()) < tol
    assert _rel(x.cpu(), x_dense) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("team", [1, 2, 5])
def test_cr_kernel_launch_shapes_agree(cuda, team):
    """One warp a system, two warps a system and a whole block a system
    give what the default launch gives, and rows past ``rows``, L of the
    first row and U of the last are neither read nor solved."""
    rng = np.random.default_rng(11)
    B, R, n, k = 7, 2, 21, 19
    bands, _ = _random_spd_penta(B, n, k, rng)
    H = penta.PentaBands(**{f: torch.as_tensor(X, device=cuda)
                            for f, X in bands.items()})
    rhs = torch.as_tensor(rng.standard_normal((B, R, n, k)), device=cuda)
    L, C, U, b = cr_kernel._pack(H, rhs)
    x = cr_kernel.solve_tridiag_kernel(L, C, U, b)
    x_alt = cr_kernel.solve_tridiag_kernel(L, C, U, b, team=team)
    assert _rel(x_alt.cpu(), x.cpu()) < 1e-12
    m = C.shape[1]
    # Three more rows of NaNs behind the real ones, and NaNs in the two
    # blocks that multiply nothing.
    L, U = L.clone(), U.clone()
    L[:, 0] = float("nan")
    U[:, m - 1] = float("nan")
    Lp, Cp, Up = (torch.cat([X, torch.full_like(X[:, :3], float("nan"))], 1)
                  for X in (L, C, U))
    bp = torch.cat([b, torch.full_like(b[:, :, :3], float("nan"))], 2)
    x_rows = cr_kernel.solve_tridiag_kernel(Lp, Cp, Up, bp, rows=m, team=team)
    torch.cuda.synchronize()
    assert torch.equal(x_rows[:, :, :m], x_alt)
    assert not x_rows[:, :, m:].any()


@pytest.mark.cuda
def test_entry_points_default_to_the_card(cuda):
    model, _, prob, _, q_guess = load_example("pendulum")
    assert q_guess.is_cuda and prob.q_init.is_cuda
    leaves = [v for v in vars(model).values() if isinstance(v, torch.Tensor)]
    assert leaves and all(v.is_cuda for v in leaves)


@pytest.mark.cuda
def test_cr_kernel_raises_on_what_it_does_not_take(cuda):
    L = torch.zeros((1, 2, 4, 4), dtype=torch.float64, device=cuda)
    b = torch.zeros((1, 1, 2, 4), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        cr_kernel.solve_tridiag_kernel(L, L, L, b.to(torch.float32))
    with pytest.raises(ValueError):
        cr_kernel.solve_tridiag_kernel(L, L, L.transpose(-1, -2), b)
    with pytest.raises(ValueError):
        cr_kernel.solve_tridiag_kernel(L, L, L, b.cpu())
    with pytest.raises(ValueError):
        cr_kernel.solve_tridiag_kernel(L, L, L, b, rows=3)
    big = torch.zeros((1, 1, 120, 120), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):  # three blocks exceed shared memory
        cr_kernel.solve_tridiag_kernel(big, big, big, big[:, :, 0])


@pytest.mark.cuda
def test_mini_cheetah_on_card_matches_golden(cuda):
    ref = np.load(_GOLDEN)
    iters = int(ref["max_iterations"])
    model, _, prob, params, _ = load_example("mini_cheetah", device=cuda)
    params = params.replace(max_iterations=iters,
                            linear_solver=LinearSolverType.CYCLIC_REDUCTION)
    q_guess = torch.as_tensor(ref["q_guess"], device=cuda)
    before = cr_kernel.launches
    sol, stats, _ = solve_batch(model, broadcast_problem(prob, q_guess.shape[0]),
                                params, q_guess)
    torch.cuda.synchronize()
    assert cr_kernel.launches >= before + iters
    assert _rel(sol.q.cpu(), ref["q"]) < 1e-8
    assert _rel(stats.cost.cpu(), ref["cost"]) < 1e-8
    assert np.abs(stats.rho.cpu().numpy() - ref["rho"]).max() < 1e-8
    np.testing.assert_array_equal(stats.solver_flag.cpu().numpy(),
                                  ref["solver_flag"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 5e-4)])
@pytest.mark.parametrize("n,k,R,B", [
    (41, 5, 121, 3),    # hopper: K = 10 (run-time-K engine), R = n_h + 1
    (41, 5, 121, 300),  # a batch past the card's SM count: smaller teams
    (41, 3, 41, 3),     # spinner: K = 6 (register tiles)
    (41, 6, 121, 3),    # airhockey: K = 12
    (21, 19, 7, 3),     # register tiles of 38 with several right-hand sides
    (41, 14, 241, 2),   # kuka, jaco: K = 28, R = 6 T + 1
    (41, 21, 241, 2),   # dual_jaco's size, punyo: K = 42
    (41, 23, 241, 8),   # allegro_hand: K = 46, four warps a block
    (11, 14, 61, 2),    # jaco_ball: T = 10, six super-rows
    # the Newton-step launches of the same examples, at the fleet's batch
    (41, 14, 1, 8),
    (41, 21, 1, 8),
    (41, 23, 1, 8),
    (11, 14, 1, 8),
    (21, 21, 1, 8),     # dual_jaco's only launch: T = 20, K = 42
    (41, 14, 1, 1),     # jaco's closed loop
    (41, 5, 1, 1),      # the hopper's closed loop
])
def test_cr_kernel_many_right_hand_sides_on_card(cuda, n, k, R, B, dtype, tol):
    """The launches of the constrained examples: the Schur solve's R =
    n_h + 1 right-hand sides in one call, and the Newton step's one, against
    the plain version and a dense solve."""
    rng = np.random.default_rng(13)
    bands, dense = _random_spd_penta(min(B, 3), n, k, rng)
    reps = -(-B // 3)
    H = penta.PentaBands(**{
        f: torch.as_tensor(np.tile(X, (reps, 1, 1, 1))[:B], dtype=dtype,
                           device=cuda) for f, X in bands.items()})
    b = rng.standard_normal((B, R, n, k))
    rhs = torch.as_tensor(b, dtype=dtype, device=cuda)
    before = cr_kernel.launches
    x = cr_kernel.solve_many(H, rhs)
    torch.cuda.synchronize()
    assert cr_kernel.launches == before + 1
    assert _rel(x.cpu(), cr_kernel.solve_many_reference(H, rhs).cpu()) < tol
    for s in (0, B - 1):
        x_dense = np.linalg.solve(dense[s % 3], b[s].reshape(R, -1).T).T
        assert _rel(x[s].cpu().reshape(R, -1), x_dense) < tol


@pytest.mark.cuda
def test_hybrid_tail_runs_the_kernel_on_card(cuda):
    """factorize(tail_rows=64) + solve_factorized on T = 640 (321
    super-rows): level-wise down to 40 rows, one kernel launch for the
    tail, against the fused kernel and the level-wise solve."""
    from idto_tpu_torch.ops import cyclic_reduction

    rng = np.random.default_rng(17)
    B, R, n, k = 2, 2, 641, 4
    bands, _ = _random_spd_penta(B, n, k, rng)
    H = penta.PentaBands(**{f: torch.as_tensor(X, device=cuda)
                            for f, X in bands.items()})
    rhs = torch.as_tensor(rng.standard_normal((B, R, n, k)), device=cuda)
    F = cyclic_reduction.factorize(H, tail_rows=64)
    assert F.tail_LCU[1].shape[1] == 40
    before = cr_kernel.launches
    x = cyclic_reduction.solve_factorized(F, rhs)
    torch.cuda.synchronize()
    assert cr_kernel.launches == before + 1
    x_fused = cr_kernel.solve_many(H, rhs)
    x_levels = cyclic_reduction.solve(H, rhs)
    assert cr_kernel.launches == before + 2  # level-wise launches nothing
    assert _rel(x.cpu(), x_fused.cpu()) < 1e-9
    assert _rel(x.cpu(), x_levels.cpu()) < 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("cr_use_pallas,per_iteration", [(None, 2), (False, 0)])
def test_constrained_hopper_on_card_matches_golden(cuda, cr_use_pallas,
                                                   per_iteration):
    """The hopper at its YAML settings through cyclic reduction: two kernel
    launches an iteration on the fused route (the R = 121 Schur solve and
    the Newton step), none on the level-wise route; tolerances of
    tests/test_torch_constraints.py."""
    ref = np.load(os.path.join(os.path.dirname(_GOLDEN),
                               "torch_constraints_hopper.npz"))
    iters = int(ref["max_iterations"])
    model, _, prob, params, _ = load_example("hopper", device=cuda)
    params = params.replace(
        max_iterations=iters, cr_use_pallas=cr_use_pallas,
        linear_solver=LinearSolverType.CYCLIC_REDUCTION)
    q_guess = torch.as_tensor(ref["q_guess"], device=cuda)
    before = cr_kernel.launches
    sol, stats, _ = solve_batch(model, broadcast_problem(prob, q_guess.shape[0]),
                                params, q_guess)
    torch.cuda.synchronize()
    assert cr_kernel.launches == before + per_iteration * iters
    np.testing.assert_allclose(sol.q.cpu().numpy(), ref["q"], rtol=1e-7,
                               atol=1e-9)
    for key in ("cost", "h_norm", "merit"):
        np.testing.assert_allclose(getattr(stats, key).cpu().numpy(),
                                   ref[key], rtol=1e-6, err_msg=key)


@pytest.mark.cuda
def test_cheetah_replan_on_card_matches_golden(cuda):
    """mpc_initialize and two replans through the kernel (one launch each)
    against the JAX package's golden chain, which went through Thomas: two
    float64 solvers differ by ~4e-7 on these replans' q (measured on the CPU
    between the kernel's plain version and Thomas), so 5e-6."""
    from idto_tpu_torch.mpc import controller as mpc

    ref = np.load(os.path.join(os.path.dirname(_GOLDEN),
                               "torch_mpc_cheetah.npz"))
    model, cfg, prob, params, q_guess = load_example("mini_cheetah",
                                                     device=cuda)
    params = params.replace(max_iterations=1, check_convergence=False,
                            linear_solver=LinearSolverType.CYCLIC_REDUCTION)
    mpc_params = mpc.make_mpc_params(params, 1)
    rel = np.asarray(cfg.q_nom_relative_to_q_init)
    probs = broadcast_problem(prob, 1)
    carry, _ = mpc.mpc_initialize(model, probs, params, q_guess[None])
    x0 = torch.as_tensor(ref["x0"], device=cuda)[None]
    for i, t in enumerate(ref["times"]):
        before = cr_kernel.launches
        carry, sol = mpc.mpc_step(model, probs, mpc_params, rel, carry, x0,
                                  float(t))
        torch.cuda.synchronize()
        assert cr_kernel.launches == before + 1
        assert _rel(sol.q[0].cpu(), ref[f"q_{i}"]) < 5e-6
        assert _rel(carry.Delta[0].cpu(), ref[f"Delta_{i}"]) < 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("name", FLEET)
def test_fleet_example_on_card_stays_near_golden(cuda, name):
    """Two iterations of a manipulation example through the kernel (two
    launches an iteration under equality constraints, one without) against
    the JAX package's Thomas golden, at the loose tolerances of
    tests/test_torch_fleet.py."""
    ref = np.load(os.path.join(os.path.dirname(_GOLDEN),
                               f"torch_fleet_{name}.npz"))
    iters = int(ref["max_iterations"])
    model, _, prob, params, _ = load_example(name, device=cuda)
    params = params.replace(max_iterations=iters,
                            linear_solver=LinearSolverType.CYCLIC_REDUCTION)
    qg = torch.as_tensor(ref["q_guess"], device=cuda)
    before = cr_kernel.launches
    sol, stats, _ = solve_batch(model, broadcast_problem(prob, qg.shape[0]),
                                params, qg)
    torch.cuda.synchronize()
    constrained = params.equality_constraints
    assert cr_kernel.launches == before + (2 if constrained else 1) * iters
    tol = 2e-2 if constrained else 1e-6
    assert _rel(sol.q.cpu(), ref["q"]) < tol
    assert _rel(stats.cost.cpu(), ref["cost"]) < tol


@pytest.mark.cuda
def test_capsule_pairs_and_sim_step_on_card_match_cpu(cuda):
    """punyo's contact wrenches (capsule search included) and one simulator
    step on the card against the same calls on the CPU: the same float64
    expressions, so 1e-9."""
    from idto_tpu_torch.mpc import simulator
    from idto_tpu_torch.soa import contact

    model, _, prob, params, q_guess = load_example("punyo", device="cpu")
    rng = np.random.default_rng(3)
    q = (q_guess[::8] + 0.05 * torch.as_tensor(
        rng.standard_normal(tuple(q_guess[::8].shape))))
    v = 0.3 * torch.as_tensor(rng.standard_normal((q.shape[0], model.nv)))
    u = torch.zeros((q.shape[0], model.nu), dtype=q.dtype)
    model_d = model.to(device=cuda)
    for w_c, w_d in zip(
            contact.contact_wrenches(model, q.T, v.T, params.contact),
            contact.contact_wrenches(model_d, q.T.to(cuda), v.T.to(cuda),
                                     params.contact)):
        assert _rel(w_d.cpu(), w_c) < 1e-9
    want = simulator.sim_step(model, params.contact, 1e-3, q, v, u)
    got = simulator.sim_step(model_d, params.contact, 1e-3, q.to(cuda),
                             v.to(cuda), u.to(cuda))
    for x_d, x_c in zip(got, want):
        assert _rel(x_d.cpu(), x_c) < 1e-9


@pytest.mark.cuda
def test_spinner_closed_loop_on_card_matches_golden(cuda):
    """``run_mpc`` on the card (cyclic reduction: two launches a replan)
    against the JAX package's golden loop, which went through Thomas."""
    import dataclasses

    from idto_tpu_torch.mpc import runner

    ref = np.load(os.path.join(os.path.dirname(_GOLDEN),
                               "torch_closed_loop_spinner.npz"))
    replans, init_iters = int(ref["replans"]), int(ref["init_iters"])
    model, cfg, prob, params, q_guess = load_example("spinner", device=cuda)
    params = params.replace(max_iterations=init_iters,
                            linear_solver=LinearSolverType.CYCLIC_REDUCTION)
    cfg = dataclasses.replace(
        cfg, sim_time=(replans + 0.5) / cfg.controller_frequency)
    before = cr_kernel.launches
    res = runner.run_mpc(model, cfg, prob, params, q_guess)
    assert cr_kernel.launches == before + 2 * (init_iters + replans)
    for key in ("q_log", "v_log", "u_log"):
        assert _rel(getattr(res, key), ref[key]) < 1e-5, key


@pytest.mark.cuda
def test_jaco_closed_loop_on_card_overflows_where_the_golden_does(cuda):
    """``run_mpc`` on jaco with the stiffer simulation contact of
    ``load_sim_plant`` (cyclic reduction: K = 28, two launches a replan).
    The loop is unstable in both packages: its first six substeps against
    the JAX package's golden, each relative to its own largest entry, and
    the substep where the state stops being finite (chip_smoke.py says why
    no later substep can be held)."""
    import dataclasses

    import chip_smoke
    from idto_tpu_torch.examples.registry import load_sim_plant
    from idto_tpu_torch.mpc import runner

    ref = np.load(os.path.join(os.path.dirname(_GOLDEN),
                               "torch_closed_loop_jaco.npz"))
    replans, init_iters = int(ref["replans"]), int(ref["init_iters"])
    model, cfg, prob, params, q_guess = load_example("jaco", device=cuda)
    params = params.replace(max_iterations=init_iters,
                            linear_solver=LinearSolverType.CYCLIC_REDUCTION)
    cfg = dataclasses.replace(
        cfg, sim_time=(replans + 0.5) / cfg.controller_frequency)
    sim_model, sim_contact = load_sim_plant("jaco", params, device=cuda)
    assert sim_contact.stiffness == 10.0 * params.contact.stiffness
    before = cr_kernel.launches
    res = runner.run_mpc(model, cfg, prob, params, q_guess,
                         sim_model=sim_model, sim_contact=sim_contact)
    assert cr_kernel.launches == before + 2 * (init_iters + replans)
    assert chip_smoke.first_nonfinite(res) == int(ref["first_nonfinite"])
    held = chip_smoke.UNSTABLE_LOOP_HELD
    for key in ("q_log", "v_log", "u_log"):
        x, y = getattr(res, key)[:held], ref[key][:held]
        err = np.abs(x - y).max(axis=1) / np.abs(y).max(axis=1)
        assert err.max() < chip_smoke.UNSTABLE_LOOP_RTOL, (key, err)


# -- the solver options, the object API and the velocity command ------------


@pytest.mark.cuda
def test_api_on_card_matches_golden(cuda):
    """``TrajectoryOptimizer.Solve`` and ``SolveFromWarmStart`` on the card
    through the kernel (one launch an iteration) against the JAX package's
    golden; cyclic reduction against its Thomas: 1e-8, as the slice."""
    from idto_tpu_torch.api import TrajectoryOptimizer

    ref = np.load(os.path.join(os.path.dirname(_GOLDEN),
                               "torch_api_pendulum.npz"))
    iters = 4
    model, _, prob, params, q_guess = load_example("pendulum", device=cuda)
    opt = TrajectoryOptimizer(model, prob, params.replace(
        max_iterations=iters,
        linear_solver=LinearSolverType.CYCLIC_REDUCTION))
    before = cr_kernel.launches
    sol, stats = opt.Solve(q_guess)
    ws = opt.CreateWarmStart(q_guess)
    sol_w, _ = opt.SolveFromWarmStart(ws)
    torch.cuda.synchronize()
    assert cr_kernel.launches == before + 2 * iters
    assert sol.q.device.type == "cuda" and ws.q.device.type == "cuda"
    assert _rel(sol.q.cpu(), ref["q"]) < 1e-8
    assert _rel(sol_w.q.cpu(), ref["warm_solve_q"]) < 1e-8
    assert _rel(ws.dqH, ref["ws_dqH"]) < 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pendulum", "hopper"])
def test_linesearch_on_card_matches_golden(cuda, name):
    """The linesearch on the card (Thomas, no launch) against the JAX
    package's golden at tests/test_torch_linesearch.py's tolerances."""
    from idto_tpu_torch.optimizer import solver
    from idto_tpu_torch.optimizer.problem import (
        LinesearchMethod,
        SolverMethod,
    )

    method, iters = {"pendulum": ("armijo", 6),
                     "hopper": ("backtracking", 3)}[name]
    ref = np.load(os.path.join(os.path.dirname(_GOLDEN),
                               f"torch_linesearch_{name}.npz"))
    model, _, prob, params, q_guess = load_example(name, device=cuda)
    before = cr_kernel.launches
    sol, stats, _ = solver.solve(model, prob, params.replace(
        method=SolverMethod.LINESEARCH,
        linesearch_method=LinesearchMethod(method), max_iterations=iters),
        q_guess)
    assert cr_kernel.launches == before
    assert int(stats.num_iters) == int(ref["num_iters"])
    assert np.array_equal(stats.ls_iters.cpu().numpy(), ref["ls_iters"])
    assert _rel(sol.q.cpu(), ref["q"]) < (1e-9 if name == "pendulum"
                                          else 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("tag", ["dense", "exact"])
def test_dense_solves_on_card_match_golden(cuda, tag):
    """The dense LU path (Gauss-Newton and exact Hessian) on the card
    against the JAX package's golden: no launch, 1e-9."""
    from idto_tpu_torch.optimizer import solver

    ref = np.load(os.path.join(os.path.dirname(_GOLDEN),
                               "torch_dense_pendulum.npz"))
    model, _, prob, params, q_guess = load_example("pendulum", device=cuda)
    more = (dict(linear_solver=LinearSolverType.DENSE_LDLT) if tag == "dense"
            else dict(exact_hessian=True))
    before = cr_kernel.launches
    sol, stats, _ = solver.solve(model, prob, params.replace(
        max_iterations=4, **more), q_guess)
    assert cr_kernel.launches == before
    assert _rel(sol.q.cpu(), ref[f"{tag}_q"]) < 1e-9
    assert _rel(stats.cost.cpu(), ref[f"{tag}_cost"]) < 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("order", [1, 2, 4])
def test_fd_partials_on_card_match_cpu(cuda, order):
    """The batch-native finite differences on the card against the CPU
    run, at the tolerances the CPU run is held to JAX's."""
    from idto_tpu_torch.optimizer.partials import id_partials_fd

    model, _, prob, params, q_guess = load_example("spinner", device="cpu")
    T = 4
    prob = prob.replace(num_steps=T, q_nom=prob.q_nom[: T + 1],
                        v_nom=prob.v_nom[: T + 1])
    rng = np.random.default_rng(0)
    qs = q_guess[None, : T + 1].repeat(3, 1, 1) + 0.02 * torch.as_tensor(
        rng.standard_normal((3, T + 1, model.nq)))
    want = id_partials_fd(model, prob, params.contact, qs, order=order)
    got = id_partials_fd(model.to(device=cuda), prob.to(device=cuda),
                         params.contact, qs.to(cuda), order=order)
    for x_d, x_c in zip(got, want):
        assert _rel(x_d.cpu(), x_c) < {1: 1e-6, 2: 1e-9, 4: 1e-11}[order]


@pytest.mark.cuda
def test_diagnostics_on_card(cuda, capsys):
    """verbose, the dense cross-check and the iteration timer (CUDA
    events) through the kernel: a row, a compare line and a positive time
    an iteration."""
    from idto_tpu_torch.optimizer import solver

    model, _, prob, params, q_guess = load_example("pendulum", device=cuda)
    iters = 3
    before = cr_kernel.launches
    _, stats, _ = solver.solve(model, prob, params.replace(
        max_iterations=iters, verbose=True, debug_compare_against_dense=True,
        record_iteration_times=True,
        linear_solver=LinearSolverType.CYCLIC_REDUCTION), q_guess)
    assert cr_kernel.launches == before + iters
    out = capsys.readouterr().out.splitlines()
    errs = [float(ln.split(":")[1]) for ln in out
            if ln.startswith("[debug] sparse vs. dense")]
    assert len(errs) == iters and max(errs) < 1e-8
    t = stats.time.cpu().numpy()
    assert (t[:iters] > 0).all() and np.isnan(t[iters:]).all()


@pytest.mark.cuda
def test_velocity_command_chain_on_card_matches_golden(cuda):
    """mpc_initialize and two velocity-command replans through the kernel
    (one launch each) against the JAX package's golden chain, which went
    through Thomas: 5e-6, as the fixed-nominal chain above."""
    from idto_tpu_torch.mpc import controller as mpc

    ref = np.load(os.path.join(os.path.dirname(_GOLDEN),
                               "torch_velocity_cheetah.npz"))
    chain = ((0.0, (0.3, 0.0, 0.0)), (1.0 / 60.0, (0.2, 0.1, 0.5)))
    model, _, prob, params, q_guess = load_example("mini_cheetah",
                                                   device=cuda)
    params = params.replace(max_iterations=1, check_convergence=False,
                            linear_solver=LinearSolverType.CYCLIC_REDUCTION)
    mpc_params = mpc.make_mpc_params(params, 1)
    probs = broadcast_problem(prob, 1)
    carry, _ = mpc.mpc_initialize(model, probs, params, q_guess[None])
    x0 = torch.as_tensor(ref["x0"], device=cuda)[None]
    for i, (t, cmd) in enumerate(chain):
        before = cr_kernel.launches
        carry, sol = mpc.mpc_step_velocity_command(
            model, probs, mpc_params, carry, x0, t,
            torch.tensor(cmd, dtype=torch.float64, device=cuda))
        torch.cuda.synchronize()
        assert cr_kernel.launches == before + 1
        assert _rel(sol.q[0].cpu(), ref[f"q_{i}"]) < 5e-6
        assert _rel(carry.q_nom[0].cpu(), ref[f"q_nom_{i}"]) < 1e-12


@pytest.mark.cuda
def test_timing_helpers_on_card(cuda):
    from idto_tpu_torch.utils import timing

    x = torch.ones(256, 256, dtype=torch.float64, device=cuda)
    assert timing.time_fn(lambda a: a @ a, [(x,)], reps=3) > 0.0
    assert timing.time_throughput(lambda a: a @ a, [(x,)], calls=3) > 0.0


@pytest.mark.cuda
def test_solve_sharded_world_size_one_on_nccl(cuda):
    """``solve_sharded`` on an NCCL group of one (the port's default
    backend for the card) against a dense solve, and one NCCL all_gather
    through the mesh's axis."""
    import torch.distributed as dist

    from idto_tpu_torch.parallel import multihost
    from idto_tpu_torch.parallel.batching import make_mesh
    from idto_tpu_torch.parallel.horizon import solve_sharded

    rng = np.random.default_rng(161)
    bands, dense = _random_spd_penta(2, 41, 3, rng)
    H = penta.PentaBands(**{name: torch.as_tensor(x, device=cuda)
                            for name, x in bands.items()})
    b = rng.standard_normal((2, 41, 3))
    mesh = make_mesh(axis="horizon", device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        x = solve_sharded(H, torch.as_tensor(b, device=cuda), mesh)
        gathered = multihost.axis_group(mesh, "horizon").gather(x)
    finally:
        dist.destroy_process_group()
    xd = np.linalg.solve(dense, b.reshape(2, -1, 1)).reshape(b.shape)
    assert _rel(x.cpu(), xd) < 1e-9
    assert torch.equal(gathered, x)


@pytest.mark.cuda
def test_bench_on_card_matches_golden(cuda):
    """``bench_torch.run`` at batches 1 and 2, one timed call, on the card:
    with Thomas, the B=2 chain's q against the JAX ``bench.py`` step's
    (goldens/torch_bench_cheetah.npz) and no kernel launch; with cyclic
    reduction, one launch a solve (two calls at each batch, the counted
    call, ``mpc_initialize``, the warm replan and one replan) and q within
    1e-6 of the golden (cyclic reduction against Thomas on the cheetah's
    ill-conditioned iterates: 7.5e-8 on the CPU, 1.2e-7 card against CPU
    in chip_smoke.py's bench phase)."""
    import bench_torch

    ref = np.load(os.path.join(os.path.dirname(_GOLDEN),
                               "torch_bench_cheetah.npz"))
    for solver, tol, launches in (("penta_lu", 1e-8, 0),
                                  ("cyclic_reduction", 1e-6, 8)):
        result, last_q = bench_torch.run(solver, "float64", "cuda", 0,
                                         (1, 2), 1, 1)
        assert result["cr_kernel_launches"] == launches
        assert result["newton_share_batch2"] == 1.0
        assert result["peak_gib_batch2"] > 0
        assert _rel(last_q[2].cpu(), ref["q2"]) < tol


def _graph_route(name, what, B, device):
    """A callable of the main path on the card (a 2-iteration solve with
    the YAML's solver or with cyclic reduction, a replan after a
    1-iteration initialization, or a simulated segment of five substeps)
    at the example's YAML size, B scenarios or robots."""
    from idto_tpu_torch.mpc import controller as mpc
    from idto_tpu_torch.mpc.simulator import simulate_segment
    from idto_tpu_torch.utils import graphs

    model, cfg, prob, params, q_guess = load_example(name, device=device)
    dq = torch.as_tensor(
        0.01 * np.random.default_rng(B).standard_normal((B, model.nq)),
        device=device)
    probs = broadcast_problem(prob, B)
    probs = probs.replace(q_init=probs.q_init + dq)
    qg = q_guess[None] + dq[:, None]
    if what in ("solve", "solve_cr"):
        p2 = params.replace(max_iterations=2)
        if what == "solve_cr":
            p2 = p2.replace(linear_solver=LinearSolverType.CYCLIC_REDUCTION)
        return lambda: solve_batch(model, probs, p2, qg)
    with graphs.eager():
        carry, _ = mpc.mpc_initialize(model, probs, params.replace(
            max_iterations=1), qg)
    x0 = torch.cat([probs.q_init, probs.v_init.expand(B, -1)], dim=1)
    t = torch.full((), 0.016, dtype=qg.dtype, device=device)
    if what == "replan":
        rel = np.asarray(cfg.q_nom_relative_to_q_init
                         if cfg.q_nom_relative_to_q_init is not None
                         else [0.0] * model.nq, dtype=np.float64)
        mp = mpc.make_mpc_params(params, 1)
        return lambda: mpc.mpc_step(model, probs, mp, rel, carry, x0, t)
    Kp = torch.as_tensor(np.asarray(cfg.Kp, dtype=np.float64), device=device)
    Kd = torch.as_tensor(np.asarray(cfg.Kd, dtype=np.float64), device=device)
    q, v = x0[:, :model.nq], x0[:, model.nq:]
    return lambda: simulate_segment(model, params.contact, cfg.sim_time_step,
                                    5, carry.stored, Kp, Kd, q, v, t,
                                    cfg.feed_forward)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["solve", "solve_cr", "replan", "segment"])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("name", ["pendulum", "spinner", "mini_cheetah"])
def test_captured_route_equals_eager_on_card(cuda, name, B, what):
    """The replayed graphs against the same calls made eagerly: every
    tensor of the result within 1e-12 relative (bitwise expected: a replay
    runs the captured kernels on inputs of the same layout), at the first
    call (capture) and at a second (replay)."""
    from idto_tpu_torch.utils import graphs

    graphs.reset()
    run = _graph_route(name, what, B, cuda)
    with graphs.eager():
        want = run()
    first = run()
    second = run()
    assert graphs.captures > 0 and graphs.replays > graphs.captures
    for got in (first, second):
        lg, lw = [], []
        graphs._flatten(got, lg)
        graphs._flatten(want, lw)
        assert len(lg) == len(lw)
        for x, y in zip(lg, lw):
            x, y = x.cpu(), y.cpu()
            fin = torch.isfinite(y)
            assert torch.equal(torch.isfinite(x), fin)
            if fin.any() and x.is_floating_point():
                assert _rel(x[fin], y[fin]) <= 1e-12
            elif fin.any():
                assert torch.equal(x, y)
    graphs.reset()


@pytest.mark.cuda
def test_a_capture_that_meets_a_host_read_raises(cuda):
    """A region that reads a device value on the host cannot be captured:
    the call raises with the region's name, and nothing runs eagerly in
    its place."""
    from idto_tpu_torch.utils import graphs

    graphs.reset()
    x = torch.ones(4, dtype=torch.float64, device=cuda)
    with pytest.raises(RuntimeError, match="host_read"):
        graphs.run("host_read", lambda a: a * float(a.sum()), (x,))
    assert not graphs._entries
    graphs.reset()


def _same_bits(got, want):
    """Every tensor of two results equal, NaN where NaN: a difference of
    0.0."""
    from idto_tpu_torch.utils import graphs

    lg, lw = [], []
    graphs._flatten(got, lg)
    graphs._flatten(want, lw)
    assert len(lg) == len(lw)
    for x, y in zip(lg, lw):
        assert torch.equal(torch.nan_to_num(x.cpu(), 7.0),
                           torch.nan_to_num(y.cpu(), 7.0))


@pytest.mark.cuda
@pytest.mark.parametrize("name,method", [("mini_cheetah", "armijo"),
                                         ("hopper", "backtracking")])
def test_captured_linesearch_equals_eager_on_card(cuda, name, method):
    """The linesearch solve (two iterations at the example's YAML size, the
    hopper with its equality constraints) replayed from captured graphs
    against the same call made eagerly: a difference of 0.0 in every
    tensor, at the first call (capture) and at a second (replay); no
    cyclic-reduction launch (the linesearch solves by Thomas)."""
    from idto_tpu_torch.optimizer.problem import (
        LinesearchMethod,
        SolverMethod,
    )
    from idto_tpu_torch.utils import graphs

    graphs.reset()
    model, _, prob, params, q_guess = load_example(name, device=cuda)
    p = params.replace(method=SolverMethod.LINESEARCH,
                       linesearch_method=LinesearchMethod(method),
                       max_iterations=2)
    probs = broadcast_problem(prob, 1)

    def run():
        return solve_batch(model, probs, p, q_guess[None])

    with graphs.eager():
        want = run()
    cr_kernel.launches = 0
    for _ in range(2):
        _same_bits(run(), want)
    names = {e.name for e in graphs._entries.values()}
    assert {"ls.prepare", "ls.search", "ls.advance"} <= names
    assert graphs.replays > graphs.captures and cr_kernel.launches == 0
    graphs.reset()


@pytest.mark.cuda
def test_captured_horizon_loop_world_one_on_nccl(cuda):
    """The horizon-sharded trust region on an NCCL group of one, the
    cheetah at T=15 with cyclic reduction, two iterations: through an
    explicit split its regions hold the collectives (distributed cyclic
    reduction, no kernel launch), and the replays equal the eager loop
    with a difference of 0.0; through ``solve_trust_region_horizon_sharded``
    (no split on an axis of one) the replays launch the kernel once an
    iteration."""
    import dataclasses

    import torch.distributed as dist

    from idto_tpu_torch.examples import config
    from idto_tpu_torch.optimizer.batched import solve_trust_region_batched
    from idto_tpu_torch.parallel import horizon, multihost
    from idto_tpu_torch.parallel.batching import make_mesh
    from idto_tpu_torch.utils import graphs

    model, cfg, _, params, _ = load_example("mini_cheetah", device=cuda)
    cfg = dataclasses.replace(cfg, num_steps=15)
    prob = config.build_problem(cfg, model, dtype=torch.float64, device=cuda)
    qg = config.build_initial_guess(cfg, dtype=torch.float64, device=cuda)
    params = params.replace(linear_solver=LinearSolverType.CYCLIC_REDUCTION,
                            check_convergence=False, max_iterations=2)
    graphs.reset()
    mesh = make_mesh(axis="horizon", device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        split = horizon.HorizonSplit(multihost.axis_group(mesh, "horizon"),
                                     prob.num_steps)

        def sharded():
            return solve_trust_region_batched(
                model, broadcast_problem(prob, 1), params, qg[None],
                horizon=split)

        with graphs.eager():
            want = sharded()
        cr_kernel.launches = 0
        for _ in range(2):
            _same_bits(sharded(), want)
        assert cr_kernel.launches == 0 and not graphs.direct_runs
        assert graphs.replays > graphs.captures > 0
        got = horizon.solve_trust_region_horizon_sharded(model, prob, params,
                                                         qg, mesh)
        cr_kernel.launches = 0
        again = horizon.solve_trust_region_horizon_sharded(model, prob,
                                                           params, qg, mesh)
        assert cr_kernel.launches == 2
        _same_bits(again, got)
    finally:
        graphs.reset()  # the graphs hold the group's collectives
        dist.destroy_process_group()


def _device_ops_by_launch(prof, tmp_path):
    """[kernels, copies and fills each cudaGraphLaunch ran] of a profiled
    stretch, in launch order, from its Chrome trace."""
    import json

    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    got = {e["args"]["correlation"]: 0 for e in events
           if e.get("cat") == "cuda_runtime"
           and e.get("name") == "cudaGraphLaunch"}
    for e in events:
        c = e.get("args", {}).get("correlation")
        if c in got and e.get("cat") in ("kernel", "gpu_memcpy",
                                         "gpu_memset"):
            got[c] += 1
    return [got[c] for c in sorted(got)]


@pytest.mark.cuda
def test_span_stamps_replay_and_count_the_captured_kernels(cuda, tmp_path):
    """The device stamps of ``utils/profiler.py`` inside captured graphs: a
    replay of a region with one named span stamps four records in order;
    each graph of a replan (the pendulum at T=4) holds, by the count made
    at its capture, as many device operations as the profiler records for
    one replay of it (kernels, and copies and fills, most of which the
    card runs as kernels); and the resolution of ``%globaltimer`` (the
    smallest step between stamps), printed."""
    import math

    from idto_tpu_torch.mpc import controller as mpc
    from idto_tpu_torch.utils import graphs, profiler

    graphs.reset()
    x = torch.randn(64, 64, dtype=torch.float64, device=cuda)

    def fn(a):
        with profiler.instrument("inner"):
            b = torch.sin(a @ a) + 1.0
        return b * 2.0

    graphs.run("stamps", fn, (x,))  # warm-up, capture, replay
    before = profiler.device_records(cuda)[0]
    for _ in range(50):
        graphs.run("stamps", fn, (x,))
    count, records = profiler.device_records(cuda)
    assert count - before == 4 * 50
    ivs = profiler.intervals(records[-200:])
    assert [profiler.sites[s].name for s, *_ in ivs[:2]] == ["stamps",
                                                             "inner"]
    assert all(t1 > t0 for _, _, t0, t1, _ in ivs)
    ts = np.sort(records[-200:, 1] - records[-200, 1])
    steps = np.diff(ts)
    print(f"%globaltimer: smallest step {int(steps[steps > 0].min())} ns "
          f"(values multiples of {math.gcd(*ts.tolist())} ns)")
    # A reset empties the ring in place: the graph stamps the same memory.
    held = profiler._rings[profiler._device(cuda)]
    profiler.reset()
    graphs.run("stamps", fn, (x,))
    assert profiler._rings[profiler._device(cuda)] is held
    assert profiler.device_records(cuda)[0] == 4

    graphs.reset()
    model, cfg, prob, params, q_guess = load_example("pendulum", device=cuda)
    T = 4
    prob = prob.replace(num_steps=T, q_nom=prob.q_nom[: T + 1],
                        v_nom=prob.v_nom[: T + 1])
    probs = broadcast_problem(prob, 1)
    carry, _ = mpc.mpc_initialize(model, probs, params.replace(
        max_iterations=1), q_guess[None, : T + 1])
    x0 = torch.cat([prob.q_init, prob.v_init])[None]
    t = torch.full((), 0.05, dtype=torch.float64, device=cuda)
    mpc.mpc_step(model, probs, mpc.make_mpc_params(params, 1),
                 np.zeros(model.nq), carry, x0, t)
    torch.cuda.synchronize()
    entries = [e for e in graphs._entries.values()
               if isinstance(e.graph, torch.cuda.CUDAGraph)]
    assert len(entries) >= 6
    before = profiler.device_records(cuda)[0]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for e in entries:
            e.graph.replay()
        torch.cuda.synchronize()
    traced = _device_ops_by_launch(prof, tmp_path)
    count, records = profiler.device_records(cuda)
    top = [profiler.sites[s] for s, *_ in
           profiler.intervals(records[len(records) - (count - before):])
           if profiler.sites[s].parent == -1]
    assert [s.name for s in top] == [e.name for e in entries]
    assert all(s.kernels is not None for s in top)
    captured = [s.kernels + 2 for s in top]  # and the region's stamps
    print(f"device operations a graph, capture / profiler: {captured} / "
          f"{traced}")
    assert traced == captured
    graphs.reset()
