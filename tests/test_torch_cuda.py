"""Tests of the port that need an NVIDIA GPU: the CUDA cyclic-reduction
kernel against its plain PyTorch version, and the cheetah slice on the card
against the JAX package's golden solve.  Without a card they skip.

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

from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.ops import cr_kernel
from idto_tpu_torch.ops import penta
from idto_tpu_torch.optimizer.problem import LinearSolverType
from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch

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
