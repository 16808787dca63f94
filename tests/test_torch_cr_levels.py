"""Level-wise block cyclic reduction of the port
(``idto_tpu_torch/ops/cyclic_reduction.py``: factorize, solve_factorized,
factorization_status, solve, and the hybrid with the fused kernel's tail)
against ``idto_tpu.ops.cyclic_reduction`` and a dense solve, on the same
seeded systems.

The port reduces the real super-rows only, the JAX package a system padded
with identity rows to a power of two: the same arithmetic on the real rows,
with block inverses from LU on both sides, so x agrees to 1e-9 relative on
these well-conditioned float64 systems (condition ~1e3..1e5; measured
~1e-13).  The hybrid's tail runs the Pallas kernel in interpret mode on the
JAX side and the kernel's plain version here (CPU tensors).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idto_tpu.ops import cyclic_reduction as jcr
from idto_tpu.ops import penta as jpenta
from idto_tpu_torch.ops import cr_kernel
from idto_tpu_torch.ops import cyclic_reduction as tcr
from idto_tpu_torch.ops import penta as tpenta
from tests.test_penta import random_spd_penta

# One intra-op thread: these tensors are tiny, and several test workers with
# a thread pool each oversubscribe the cores (a solve is then 5-10x slower).
torch.set_num_threads(1)

RTOL = 1e-9


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _torch_bands(Hs, dtype=torch.float64):
    """List of JAX PentaBands -> batched torch PentaBands."""
    return tpenta.PentaBands(**{
        f: torch.as_tensor(np.stack([np.asarray(getattr(H, f)) for H in Hs]),
                           dtype=dtype)
        for f in "ABCDE"
    })


def _systems(n, k, B, seed):
    rng = np.random.default_rng(seed)
    Hs, denses = zip(*(random_spd_penta(n, k, rng) for _ in range(B)))
    return list(Hs), np.stack(denses), rng


@pytest.mark.parametrize("n,k", [(1, 2), (2, 3), (3, 2), (5, 2), (8, 3),
                                 (21, 5), (22, 3), (41, 3), (64, 2)])
def test_solve_matches_jax_and_dense(n, k):
    B = 2
    Hs, dense, rng = _systems(n, k, B, n * 7 + k)
    b = rng.standard_normal((B, n, k))
    x = tcr.solve(_torch_bands(Hs), torch.as_tensor(b)).numpy()
    x_jax = np.stack([np.asarray(jcr.solve(H, jnp.asarray(bi)))
                      for H, bi in zip(Hs, b)])
    x_dense = np.linalg.solve(dense, b.reshape(B, -1, 1)).reshape(B, n, k)
    assert _rel(x, x_jax) < RTOL
    assert _rel(x, x_dense) < RTOL


def test_one_factorization_many_right_hand_sides():
    """One factorize, then a stack of right-hand sides in one call (the
    equality-constraint Schur solve) and single ones."""
    n, k, B, R = 21, 4, 3, 7
    Hs, dense, rng = _systems(n, k, B, 0)
    F = tcr.factorize(_torch_bands(Hs))
    assert tcr.factorization_status(F).tolist() == [True] * B
    b = rng.standard_normal((B, R, n, k))
    x = tcr.solve_factorized(F, torch.as_tensor(b))
    assert x.shape == (B, R, n, k)
    x_dense = np.linalg.solve(
        dense, b.reshape(B, R, -1).transpose(0, 2, 1)
    ).transpose(0, 2, 1).reshape(B, R, n, k)
    assert _rel(x.numpy(), x_dense) < RTOL
    for r in range(2):
        xr = tcr.solve_factorized(F, torch.as_tensor(b[:, r]))
        assert _rel(xr.numpy(), x[:, r].numpy()) < 1e-13  # summation order
    Fj = jcr.factorize(Hs[1])
    xj = jcr.solve_factorized(Fj, jnp.asarray(b[1, 3]))
    assert _rel(x[1, 3].numpy(), xj) < RTOL


@pytest.mark.parametrize("n,tail_rows", [(16, 2), (16, 4), (15, 4), (13, 2),
                                         (11, 8), (16, 16)])
def test_hybrid_tail_matches_jax_and_dense(n, tail_rows):
    """8 super-rows (7 for n=13, 6 for n=11), level-wise down to
    ``tail_rows`` and the fused kernel on the tail: against the JAX
    package's hybrid (its Pallas kernel in interpret mode), the port's pure
    level-wise solve, the port's fused solve and a dense solve."""
    k, B, R = 3, 2, 3
    Hs, dense, rng = _systems(n, k, B, 100 + n + tail_rows)
    Ht = _torch_bands(Hs)
    b = rng.standard_normal((B, R, n, k))
    F = tcr.factorize(Ht, tail_rows=tail_rows)
    assert F.C_final_inv is None and F.tail_LCU is not None
    m = (n + 1) // 2
    assert F.tail_LCU[1].shape[1] == m >> len(F.levels)
    assert tcr.factorization_status(F).tolist() == [True] * B
    before = cr_kernel.launches
    x = tcr.solve_factorized(F, torch.as_tensor(b))
    assert cr_kernel.launches == before  # CPU tensors: the plain version
    x_levels = tcr.solve_factorized(tcr.factorize(Ht), torch.as_tensor(b))
    x_fused = cr_kernel.solve_many(Ht, torch.as_tensor(b))
    x_dense = np.linalg.solve(
        dense, b.reshape(B, R, -1).transpose(0, 2, 1)
    ).transpose(0, 2, 1).reshape(B, R, n, k)
    assert _rel(x.numpy(), x_dense) < RTOL
    assert _rel(x.numpy(), x_levels.numpy()) < RTOL
    assert _rel(x.numpy(), x_fused.numpy()) < RTOL
    Fj = jcr.factorize(Hs[0], tail_rows=tail_rows)
    assert Fj.tail_LCU is not None
    xj = jcr.solve_factorized(Fj, jnp.asarray(b[0, 1]))
    assert _rel(x[0, 1].numpy(), xj) < RTOL


def test_tail_rows_must_be_a_power_of_two():
    Hs, _, _ = _systems(8, 2, 1, 3)
    with pytest.raises(ValueError):
        tcr.factorize(_torch_bands(Hs), tail_rows=3)


def _scaled_system(cond_target, dtype, n=10, k=3, seed=7):
    """The condition sweep's systems of tests/test_cyclic_reduction.py."""
    rng = np.random.default_rng(seed)
    N = n * k
    H0, _ = random_spd_penta(n, k, rng)
    H0 = jax.tree.map(lambda x: x.astype(dtype), H0)
    scale = np.power(cond_target, np.linspace(0, 0.5, N))
    H = jpenta.scale_by_diagonal(H0, jnp.asarray(scale.reshape(n, k),
                                                 dtype=dtype))
    dense = np.asarray(jpenta.to_dense(H), dtype=np.float64)
    x_true = rng.standard_normal(N)
    return H, dense, x_true, dense @ x_true


def _relerr(x, x_true):
    x = np.asarray(x, dtype=np.float64).ravel()
    return np.linalg.norm(x - x_true) / np.linalg.norm(x_true)


@pytest.mark.parametrize("dtype,cond_target", [
    (np.float64, 1e2), (np.float64, 1e6), (np.float64, 1e10),
    (np.float64, 1e14), (np.float32, 1e1), (np.float32, 1e2),
    (np.float32, 1e3), (np.float32, 1e4),
])
def test_condition_sweep(dtype, cond_target):
    """Relative error against the true solution degrades gracefully
    (~cond * eps), the bound of the JAX package's sweep."""
    n, k = 10, 3
    H, dense, x_true, b = _scaled_system(cond_target, dtype)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    x = tcr.solve(_torch_bands([H], tdtype),
                  torch.as_tensor(b.reshape(1, n, k), dtype=tdtype))
    eps = np.finfo(dtype).eps
    cond = np.linalg.cond(dense)
    assert _relerr(x.numpy(), x_true) < max(100 * eps,
                                            100 * cond * eps * n * k)


@pytest.mark.parametrize("cond_target", [1e16, 1e18, 1e20])
def test_condition_sweep_f64_to_1e20(cond_target):
    """Past 1/eps every solver loses all digits; the solve must stay finite
    and its error comparable to a dense float64 solve's."""
    n, k = 10, 3
    H, dense, x_true, b = _scaled_system(cond_target, np.float64)
    x = tcr.solve(_torch_bands([H]), torch.as_tensor(b.reshape(1, n, k)))
    assert bool(torch.isfinite(x).all())
    err_dense = _relerr(np.linalg.solve(dense, b), x_true)
    assert _relerr(x.numpy(), x_true) <= max(1e3 * err_dense, 1e-9)


def test_singular_block_is_reported_per_system():
    """A singular diagonal block is reported, for its system only, as the
    JAX package reports it."""
    n, k = 6, 2
    Hs, _, _ = _systems(n, k, 1, 5)
    good = _torch_bands(Hs)
    zero = torch.zeros_like(good.C)
    bad = tpenta.PentaBands(A=zero, B=zero, C=zero, D=zero, E=zero)
    both = tpenta.PentaBands(**{
        f: torch.cat([getattr(good, f), getattr(bad, f)]) for f in "ABCDE"})
    F = tcr.factorize(both)
    assert tcr.factorization_status(F).tolist() == [True, False]
    jzero = jnp.zeros((n, k, k))
    Fj = jcr.factorize(jpenta.PentaBands(A=jzero, B=jzero, C=jzero, D=jzero,
                                         E=jzero))
    assert not bool(jcr.factorization_status(Fj))
