"""The port's linear algebra against the JAX package, on the same seeded
inputs: gradient and Gauss-Newton Hessian assembly, scaling, the Thomas
solve, and the cyclic-reduction kernel's plain version against the Pallas
kernel run in interpret mode (as tests/test_cr_pallas.py runs it) and a
dense oracle.

Tolerances: 1e-12 relative where both sides evaluate the same float64
expressions (only summation order differs); 1e-10 for float64 solves
against a dense LU (the random SPD systems have condition ~1e3..1e5);
5e-5 for float32 solves, the bound tests/test_cr_pallas.py holds the
Pallas kernel to.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idto_tpu.ops import cr_pallas
from idto_tpu.ops import penta as jpenta
from idto_tpu.optimizer import hessian as jhess
from idto_tpu.optimizer import solver as jsolver
from idto_tpu.optimizer.partials import IdPartials as JIdPartials
from idto_tpu.optimizer.problem import ProblemDefinition as JProblem
from idto_tpu.optimizer.problem import ScalingMethod as JScaling
from idto_tpu_torch.ops import cr_kernel
from idto_tpu_torch.ops import penta as tpenta
from idto_tpu_torch.optimizer import hessian as thess
from idto_tpu_torch.optimizer import solver as tsolver
from idto_tpu_torch.optimizer.partials import IdPartials
from idto_tpu_torch.optimizer.problem import ProblemDefinition, ScalingMethod
from tests.test_penta import random_spd_penta

# One intra-op thread: these tensors are tiny, and several test workers with
# a thread pool each oversubscribe the cores (a solve is then 5-10x slower).
torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _bands_np(H):
    return {f: np.asarray(getattr(H, f)) for f in "ABCDE"}


def _torch_bands(Hs):
    """List of JAX PentaBands -> batched torch PentaBands."""
    return tpenta.PentaBands(**{
        f: torch.as_tensor(np.stack([np.asarray(getattr(H, f)) for H in Hs]))
        for f in "ABCDE"
    })


def _random_problem(rng, B, T, nq):
    """Per-scenario weights and nominal trajectories (nq == nv)."""
    w = {k: rng.uniform(0.1, 2.0, (B, nq)) for k in
         ("Qq", "Qv", "R", "Qf_q", "Qf_v")}
    arrays = dict(
        q_init=rng.standard_normal((B, nq)), v_init=rng.standard_normal((B, nq)),
        q_nom=rng.standard_normal((B, T + 1, nq)),
        v_nom=rng.standard_normal((B, T + 1, nq)), **w,
    )
    return arrays


def test_gradient_and_hessian_match_jax():
    rng = np.random.default_rng(0)
    B, T, nq = 2, 6, 3
    arr = _random_problem(rng, B, T, nq)
    parts = [rng.standard_normal((B, T, nq, nq)) for _ in range(3)]
    parts[0][:, 0] = 0.0
    nplus = rng.standard_normal((B, T + 1, nq, nq))
    q = rng.standard_normal((B, T + 1, nq))
    v = rng.standard_normal((B, T + 1, nq))
    tau = rng.standard_normal((B, T, nq))
    model = SimpleNamespace(nq=nq)

    tprob = ProblemDefinition(num_steps=T, dt=0.05,
                              **{k: _t(x) for k, x in arr.items()})
    tparts = IdPartials(*(_t(p) for p in parts))
    g_t = thess.gradient_from_partials(model, tprob, tparts, _t(nplus), _t(q),
                                       _t(v), _t(tau))
    H_t = thess.gauss_newton_hessian(model, tprob, tparts, _t(nplus))
    for b in range(B):
        jprob = JProblem(num_steps=T, dt=0.05,
                         **{k: jnp.asarray(x[b]) for k, x in arr.items()})
        jparts = JIdPartials(*(jnp.asarray(p[b]) for p in parts))
        g_j = jhess.gradient_from_partials(
            model, jprob, jparts, jnp.asarray(nplus[b]), jnp.asarray(q[b]),
            jnp.asarray(v[b]), jnp.asarray(tau[b]),
        )
        H_j = jhess.gauss_newton_hessian(model, jprob, jparts,
                                         jnp.asarray(nplus[b]))
        assert _rel(g_t[b], g_j) < 1e-12
        for f in "ABCDE":
            assert _rel(getattr(H_t, f)[b], getattr(H_j, f)) < 1e-12, f


@pytest.mark.parametrize("method", list(ScalingMethod))
def test_scaling_and_matvec_match_jax(method):
    rng = np.random.default_rng(1)
    n, k = 7, 4
    Hj, _ = random_spd_penta(n, k, rng)
    D_prev = rng.uniform(0.1, 1.0, (n, k))
    x = rng.standard_normal((n, k))
    Ht = _torch_bands([Hj])

    diag_t = tpenta.extract_diagonal(Ht)
    diag_j = jpenta.extract_diagonal(Hj)
    assert _rel(diag_t[0], diag_j) == 0.0
    D_t = tsolver._scale_factors_from_diag(diag_t, method, _t(D_prev)[None])
    D_j = jsolver._scale_factors_from_diag(
        diag_j, JScaling(method.value), jnp.asarray(D_prev)
    )
    assert _rel(D_t[0], D_j) < 1e-15
    Hs_t = tpenta.scale_by_diagonal(Ht, D_t)
    Hs_j = jpenta.scale_by_diagonal(Hj, D_j)
    for f in "ABCDE":
        assert _rel(getattr(Hs_t, f)[0], getattr(Hs_j, f)) < 1e-15
    assert _rel(tpenta.matvec(Hs_t, _t(x)[None])[0],
                jpenta.matvec(Hs_j, jnp.asarray(x))) < 1e-12


@pytest.mark.parametrize("n,k", [(4, 2), (21, 5)])
def test_thomas_matches_jax_and_dense(n, k):
    rng = np.random.default_rng(n + k)
    Hj, dense = random_spd_penta(n, k, rng)
    b = rng.standard_normal((n, k))
    x_t = tpenta.solve(_torch_bands([Hj]), _t(b)[None])[0]
    x_j = jpenta.solve(Hj, jnp.asarray(b))
    x_d = np.linalg.solve(dense, b.ravel()).reshape(n, k)
    assert _rel(x_t, x_j) < 1e-12
    assert _rel(x_t, x_d) < 1e-10
    F = tpenta.factorize(_torch_bands([Hj]))
    assert bool(tpenta.factorization_status(F).all())
    # A singular block is reported, not raised.
    Hsing = tpenta.PentaBands(**{f: getattr(F, "Cp") * 0 for f in "ABCDE"})
    assert not bool(
        tpenta.factorization_status(tpenta.factorize(Hsing)).any()
    )


def _pad_to_power_of_two(L, C, U, b):
    """The system with identity rows appended up to the next power of two
    of its row count: the form the TPU kernel reduces."""
    Bn, R, m, K = b.shape
    padn = (1 << max(m - 1, 0).bit_length()) - m
    if padn == 0:
        return L, C, U, b
    zero = torch.zeros((Bn, padn, K, K), dtype=C.dtype)
    eye = torch.eye(K, dtype=C.dtype).expand(Bn, padn, K, K)
    return (torch.cat([L, zero], dim=1), torch.cat([C, eye], dim=1),
            torch.cat([U, zero], dim=1),
            torch.cat([b, torch.zeros((Bn, R, padn, K), dtype=b.dtype)], dim=2))


def _cr_case(n, k, dtype, seed, R=3):
    rng = np.random.default_rng(seed)
    Hj, dense = random_spd_penta(n, k, rng)
    b = rng.standard_normal((R, n, k))
    xd = np.stack([np.linalg.solve(dense, b[r].ravel()).reshape(n, k)
                   for r in range(R)])
    Ht = _torch_bands([Hj]).to(dtype=dtype)
    return Hj, Ht, b, xd


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 5e-5)])
@pytest.mark.parametrize("n,k", [(1, 2), (3, 2), (8, 3), (21, 5)])
def test_cr_reference_matches_pallas_and_dense(n, k, dtype, tol):
    Hj, Ht, b, xd = _cr_case(n, k, dtype, seed=n * 7 + k)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    Hjd = jax.tree.map(lambda x: x.astype(jdt), Hj)
    x_pl = cr_pallas.solve_many(Hjd, jnp.asarray(b, dtype=jdt), interpret=True)
    x_ref = cr_kernel.solve_many_reference(Ht, torch.as_tensor(b, dtype=dtype)[None])
    assert x_ref.dtype == dtype and x_ref.shape == (1, 3, n, k)
    assert _rel(x_ref[0], xd) < tol
    assert _rel(x_ref[0], x_pl) < tol


def test_cr_reference_cheetah_shape_f64():
    """The cheetah system: n = T+1 = 21 block rows of k = nq = 19."""
    Hj, Ht, b, xd = _cr_case(21, 19, torch.float64, seed=5, R=1)
    x_pl = cr_pallas.solve_many(Hj, jnp.asarray(b), interpret=True)
    x_ref = cr_kernel.solve_many_reference(Ht, torch.as_tensor(b)[None])
    assert _rel(x_ref[0], xd) < 1e-10
    assert _rel(x_ref[0], x_pl) < 1e-10


@pytest.mark.parametrize("n,k,R", [(21, 19, 1), (21, 5, 3), (16, 4, 2),
                                   (8, 3, 1), (2, 2, 1), (161, 2, 1)])
def test_cr_reference_real_rows_equal_padded_form(n, k, R):
    """The plain version on the m real rows, on the same rows inside arrays
    padded to a power of two (``rows=m``), and on the padded system as the
    TPU kernel reduces it, against each other and the Pallas kernel in
    interpret mode.  n = 16 and n = 8 give m equal to its power of two."""
    Hj, Ht, b, xd = _cr_case(n, k, torch.float64, seed=3 * n + k, R=R)
    L, C, U, bb = cr_kernel._pack(Ht, torch.as_tensor(b)[None])
    m = C.shape[1]
    assert m == (n + 1) // 2 and all(X.is_contiguous() for X in (L, C, U, bb))
    x_real = cr_kernel.solve_tridiag_reference(L, C, U, bb)
    Lp, Cp, Up, bp = _pad_to_power_of_two(L, C, U, bb)
    mpow = Cp.shape[1]
    assert mpow & (mpow - 1) == 0 and m <= mpow < 2 * max(m, 1)
    x_padded = cr_kernel.solve_tridiag_reference(Lp, Cp, Up, bp)
    x_rows = cr_kernel.solve_tridiag_reference(Lp, Cp, Up, bp, rows=m)
    assert x_padded.shape == x_rows.shape == (1, R, mpow, 2 * k)
    assert _rel(x_real, x_padded[:, :, :m]) < 1e-12
    assert torch.equal(x_rows[:, :, :m], x_real)
    assert not x_rows[:, :, m:].any() and not x_padded[:, :, m:].any()
    x = cr_kernel._unpack(x_real, n, k)[0]
    assert _rel(x, xd) < 1e-10
    if n <= 21:
        x_pl = cr_pallas.solve_many(Hj, jnp.asarray(b), interpret=True)
        assert _rel(x, x_pl) < 1e-12


def test_cr_wrapper_takes_plain_path_on_cpu():
    _, Ht, b, xd = _cr_case(8, 3, torch.float64, seed=2)
    Hb = tpenta.PentaBands(**{f: getattr(Ht, f).expand(2, -1, -1, -1)
                              for f in "ABCDE"})
    rhs = torch.as_tensor(b).expand(2, -1, -1, -1)
    before = cr_kernel.launches
    x = cr_kernel.solve_many(Hb, rhs)
    assert cr_kernel.launches == before
    assert torch.equal(x, cr_kernel.solve_many_reference(Hb, rhs))
    assert _rel(x[1], xd) < 1e-10


def test_cr_wrapper_rejects_what_the_kernel_does_not_take():
    _, Ht, b, _ = _cr_case(8, 3, torch.float64, seed=3)
    rhs = torch.as_tensor(b)[None]
    with pytest.raises(ValueError):
        cr_kernel.solve_many(Ht, rhs[0])  # missing batch axis
    with pytest.raises(ValueError):
        cr_kernel.solve_many(Ht, rhs.to(torch.float32))  # mixed dtypes
    with pytest.raises(ValueError):
        cr_kernel.solve_many(Ht.to(dtype=torch.float16),
                             rhs.to(torch.float16))
    with pytest.raises(ValueError):
        cr_kernel.solve_many(Ht, rhs[:, :, :5])  # rows do not match
    L, C, U, bb = cr_kernel._pack(Ht, rhs)
    with pytest.raises(ValueError):
        cr_kernel.solve_tridiag_kernel(L, C, U, bb)  # CPU tensors
    with pytest.raises(ValueError):
        cr_kernel._check_tridiag(L[:, :3], C[:, :3], U[:, :3], bb[:, :, :3])
    with pytest.raises(ValueError):
        cr_kernel._check_tridiag(L[:, :3].contiguous(), C, U, bb)  # row counts
    for rows in (0, 5):  # the system has 4 super-rows
        with pytest.raises(ValueError):
            cr_kernel.solve_tridiag_reference(L, C, U, bb, rows=rows)

