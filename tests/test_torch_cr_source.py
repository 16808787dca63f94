"""The CUDA kernel's own source, run on the CPU.

There is no CUDA compiler and no card where these tests run, so
``idto_tpu_torch/csrc/cr_solve.cu`` is compiled here for the host: under
``tests/cr_solve_host_shim.h`` every CUDA thread of a block is a host thread,
``__syncwarp()`` and the team barriers are real barriers, and the tensor-core
product is spelled out from the fragment layout the kernel states.  What is
held against the plain PyTorch version is therefore the kernel's indexing,
task split, scratch layout and synchronisation -- not nvcc's code, which
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` check on the card.

Tolerances: float64 1e-12 (the same arithmetic in another summation order on
well-conditioned blocks); float32 1e-4.
"""
import ctypes
import os
import shutil
import subprocess

import pytest
import torch

from idto_tpu_torch.ops import cr_kernel

# One intra-op thread: these tensors are tiny, and several test workers with
# a thread pool each oversubscribe the cores (a solve is then 5-10x slower).
torch.set_num_threads(1)

_TESTS = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(os.path.dirname(_TESTS), "idto_tpu_torch", "csrc")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 host compiler")
    out = tmp_path_factory.mktemp("cr_solve_host") / "libcr_solve_host.so"
    cmd = [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
           "-x", "c++", "-I", _TESTS, "-I", _CSRC, "-o", str(out),
           os.path.join(_TESTS, "cr_solve_host.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out))
    lib.host_work_elems.argtypes = [ctypes.c_int] * 3
    lib.host_work_elems.restype = ctypes.c_size_t
    for fn in (lib.host_solve_f64, lib.host_solve_f32):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
        fn.restype = ctypes.c_int
    return lib


def _system(B, m, K, R, dtype, seed):
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    L, U, G = randn(B, m, K, K), randn(B, m, K, K), randn(B, m, K, K)
    C = G @ G.transpose(-1, -2) + 12 * K * torch.eye(K, dtype=torch.float64)
    b = randn(B, R, m, K)
    return [X.to(dtype).contiguous() for X in (L, C, U, b)]


def _host_solve(lib, L, C, U, b, rows, warps, team, vecs=0):
    """``vecs``: right-hand sides a warp's vector space holds at a time in
    the back substitution (0: the least the launcher ever gives, one)."""
    B, R, m, K = b.shape
    x = torch.full_like(b, float("nan"))
    work = torch.full((B * lib.host_work_elems(rows, K, R),), float("nan"),
                      dtype=b.dtype)
    fn = lib.host_solve_f64 if b.dtype == torch.float64 else lib.host_solve_f32
    rc = fn(L.data_ptr(), C.data_ptr(), U.data_ptr(), b.data_ptr(),
            x.data_ptr(), work.data_ptr(), B, m, rows, K, R, warps, team, vecs)
    assert rc == 0
    return x


# (B, m, rows, K, R, dtype, warps, team)
_CASES = [
    # the cheetah's 11 super-rows of 38: a block, two warps, one warp a system
    (3, 11, 11, 38, 1, torch.float64, 5, 5),
    (3, 11, 11, 38, 1, torch.float64, 4, 2),
    (7, 11, 11, 38, 2, torch.float64, 5, 1),
    # identity rows past ``rows`` are not read (they hold what _system made)
    (1, 16, 11, 38, 3, torch.float64, 5, 5),
    (1, 9, 8, 7, 2, torch.float64, 3, 3),
    # the run-time-K engine: block sizes without a register-tile engine
    (3, 11, 11, 12, 2, torch.float64, 4, 1),
    (3, 13, 13, 10, 1, torch.float64, 4, 2),
    (1, 3, 3, 7, 2, torch.float64, 8, 4),
    # the other register-tile sizes; one and two rows; many levels
    (2, 7, 7, 6, 3, torch.float64, 8, 8),
    (5, 5, 5, 2, 1, torch.float64, 6, 2),
    (1, 1, 1, 38, 1, torch.float64, 5, 5),
    (1, 2, 2, 38, 1, torch.float64, 2, 2),
    (2, 81, 81, 6, 1, torch.float64, 8, 8),
    # float32: FMA products in the tile engine, and the run-time-K engine
    (3, 11, 11, 38, 1, torch.float32, 8, 4),
    (2, 6, 6, 10, 1, torch.float32, 8, 1),
]


@pytest.mark.parametrize("B,m,rows,K,R,dtype,warps,team", _CASES)
def test_kernel_source_matches_plain_version(host_lib, B, m, rows, K, R,
                                             dtype, warps, team):
    L, C, U, b = _system(B, m, K, R, dtype, seed=m * 100 + K)
    x = _host_solve(host_lib, L, C, U, b, rows, warps, team)
    x_plain = cr_kernel.solve_tridiag_reference(L, C, U, b, rows=rows)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    assert bool(torch.isfinite(x).all())
    assert float((x - x_plain).abs().max() / x_plain.abs().max()) < tol
    assert not x[:, :, rows:].any()


# The equality-constraint Schur solve: R = n_h + 1 right-hand sides in one
# launch.  (B, rows, K, R, dtype, warps, team, vecs): the hopper (K=10,
# run-time-K engine), the spinner (K=6, register tiles) and the airhockey
# shape (K=12), with vector space for one right-hand side at a time, for a
# few (R is no multiple of it) and for all of them.
_MANY_RHS_CASES = [
    (2, 21, 10, 121, torch.float64, 4, 2, 0),
    (2, 21, 10, 121, torch.float64, 8, 4, 34),
    (1, 21, 10, 121, torch.float64, 4, 4, 121),
    (3, 21, 10, 121, torch.float32, 8, 1, 68),
    (2, 21, 6, 41, torch.float64, 8, 2, 0),
    (2, 21, 6, 41, torch.float64, 8, 8, 41),
    (2, 21, 6, 41, torch.float32, 4, 4, 7),
    (1, 21, 12, 121, torch.float64, 6, 3, 28),
    (1, 11, 38, 5, torch.float64, 5, 5, 3),
]


@pytest.mark.parametrize("B,rows,K,R,dtype,warps,team,vecs", _MANY_RHS_CASES)
def test_kernel_source_with_many_right_hand_sides(host_lib, B, rows, K, R,
                                                  dtype, warps, team, vecs):
    L, C, U, b = _system(B, rows, K, R, dtype, seed=rows * 100 + K + R)
    x = _host_solve(host_lib, L, C, U, b, rows, warps, team, vecs)
    x_plain = cr_kernel.solve_tridiag_reference(L, C, U, b)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    assert bool(torch.isfinite(x).all())
    assert float((x - x_plain).abs().max() / x_plain.abs().max()) < tol


@pytest.mark.parametrize("rows,K,team", [(11, 38, 5), (11, 38, 1),
                                         (6, 10, 2), (1, 6, 1)])
def test_kernel_source_skips_the_blocks_that_multiply_nothing(host_lib, rows,
                                                              K, team):
    """L of the first row and U of the last are not part of a
    block-tridiagonal system: the kernel solves the same x with NaNs there."""
    L, C, U, b = _system(2, rows, K, 2, torch.float64, seed=rows + K)
    L[:, 0] = 0.0
    U[:, rows - 1] = 0.0
    x_plain = cr_kernel.solve_tridiag_reference(L, C, U, b)
    L[:, 0] = float("nan")
    U[:, rows - 1] = float("nan")
    x = _host_solve(host_lib, L, C, U, b, rows, 5, team)
    assert bool(torch.isfinite(x).all())
    assert float((x - x_plain).abs().max() / x_plain.abs().max()) < 1e-12


def test_scratch_size_matches_the_levels(host_lib):
    """Reduced bands for the rows of levels 1.., one inverse a row, reduced
    right-hand sides: the cheetah keeps 5 + 2 + 1 reduced rows."""
    K, R = 38, 3
    assert host_lib.host_work_elems(11, K, R) == (
        (3 * 8 + 11) * K * K + R * 8 * K)
    assert host_lib.host_work_elems(1, K, R) == K * K
