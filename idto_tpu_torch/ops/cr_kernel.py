"""Fused block cyclic-reduction solve of penta-diagonal systems: the
hand-written CUDA kernel ``csrc/cr_solve.cu`` and its plain PyTorch
version (counterpart of ``idto_tpu/ops/cr_pallas.py``).

``solve_many(H, rhs)`` packs each penta-diagonal system into a
block-tridiagonal one of m = ceil(n/2) super-rows 2k wide
(``ops/cyclic_reduction``), runs the reduction for all R right-hand sides
and unpacks; ``solve_tridiag`` takes a system that is block-tridiagonal
already (the tail of the hybrid level-wise reduction).  On a CUDA tensor
they launch the kernel -- one team of warps per system (a whole block down
to a single warp, by the batch), one warp per block task, one launch per
call whatever R -- and on a CPU tensor they run
``solve_tridiag_reference``, the same math in plain PyTorch.  Any other
device, dtype or shape raises; there is no fallback.

The reduction is the one of a system padded with identity rows to a power
of two, as the TPU kernel pads it, but no pad row is ever made: both
versions take ``rows``, the count of real block rows, and treat the rows
past it as identity rows without reading them.  An identity row reduces to
an identity row, so level l holds ``rows >> l`` real rows, and the padded
and the unpadded forms do the same arithmetic on them.

Block sizes K with a register-tile instantiation in the kernel (2, 6 and
38: the registered examples) take it; any other K takes the kernel's
run-time-K engine.

The kernel library is compiled from the package's sources with ``nvcc``
at first use into ``build/idto_tpu_torch/`` at the repository root and
loaded with ``ctypes``.  ``launches`` counts kernel launches.  Inside a
CUDA graph (``utils/graphs.py``) the wrapper runs once, at the capture,
and launches nothing then: each replay of the graph adds the launches its
capture recorded.  The kernel takes PyTorch's current stream (the capture
stream while a graph is captured), and its output and scratch come from
``torch.empty`` (the graph's memory pool).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile

import torch

from idto_tpu_torch.ops.cyclic_reduction import _pack_rhs, _pack_super_tridiag
from idto_tpu_torch.ops.penta import PentaBands
from idto_tpu_torch.utils import graphs

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "cr_solve.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "idto_tpu_torch")

# Dynamic shared memory a block may use on sm_90 (227 KB).
_MAX_SMEM = 232448

launches = 0  # kernel launches since import (or since reset by the caller)
_lib = None
graphs.register_counter(sys.modules[__name__], "launches")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA cyclic-reduction kernel "
                           "cannot be built")
    return path


def build(source: str = _SOURCE) -> str:
    """Compile a CUDA source of the package (default ``csrc/cr_solve.cu``)
    for sm_90a into BUILD_DIR (keyed by the source's name and hash) and
    return the library path.  Raises if nvcc fails."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = os.path.splitext(os.path.basename(source))[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if os.path.exists(out):
        return out
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", tmp, source,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    build.ptxas_log = proc.stderr
    return out


build.ptxas_log = ""


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr = [ctypes.c_void_p] * 6
        ints = [ctypes.c_int] * 6  # batch, m, rows, K, R, team
        for name in ("cr_solve_f64", "cr_solve_f32"):
            fn = getattr(lib, name)
            fn.argtypes = ptr + ints + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.cr_work_elems.argtypes = [ctypes.c_int] * 3
        lib.cr_work_elems.restype = ctypes.c_size_t
        lib.cr_has_tiles.argtypes = [ctypes.c_int]
        lib.cr_has_tiles.restype = ctypes.c_int
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Block-tridiagonal cyclic reduction: (L, C, U) (B, m, K, K), b (B, R, m, K),
# of which the first ``rows`` block rows are real and the rest count as
# identity rows.


def _gj_inverse(M):
    """Pivot-free Gauss-Jordan inverse of (..., K, K) SPD blocks, the
    elimination order of the kernel."""
    K = M.shape[-1]
    idx = torch.arange(K, device=M.device)
    for j in range(K):
        f = M[..., :, j]                       # (..., K) column j
        recip = 1.0 / M[..., j, j]             # (...,)
        r = M[..., j, :] * recip[..., None]    # row j scaled
        r = torch.where(idx == j, recip[..., None], r)
        M = M - f[..., :, None] * r[..., None, :]
        M = torch.where(idx[None, :] == j, (-f * recip[..., None])[..., None], M)
        M = torch.where(idx[:, None] == j, r[..., None, :], M)
    return M


def _bmv(A, x):
    """(B, h, K, K) @ (B, R, h, K) -> (B, R, h, K)."""
    return torch.einsum("bhij,brhj->brhi", A, x)


def _identity_below(X, fill):
    """The even rows below each odd row, (B, h, K, K) -> rows 1.. followed
    by the identity row's block (``fill``) under the last odd row."""
    return torch.cat([X[:, 1:], fill], dim=1)


def solve_tridiag_reference(L, C, U, b, rows=None):
    """Plain PyTorch version of the kernel's cyclic reduction.  Only the
    first ``rows`` (default: all) of the m block rows are read; x of the
    others is zero.  L of row 0 and U of row ``rows - 1`` multiply nothing
    (the kernel does not read them) but must be finite here."""
    Bn, R, m, K = b.shape
    rows = m if rows is None else rows
    if not 1 <= rows <= m:
        raise ValueError(f"rows={rows} outside 1..{m}")
    L, C, U, b = L[:, :rows], C[:, :rows], U[:, :rows], b[:, :, :rows]
    zblk = torch.zeros((Bn, 1, K, K), dtype=C.dtype, device=C.device)
    eye = torch.eye(K, dtype=C.dtype, device=C.device).expand(Bn, 1, K, K)
    zvec = torch.zeros((Bn, R, 1, K), dtype=b.dtype, device=b.device)
    levels = []
    while True:
        n_od = C.shape[1] // 2
        n_ev = C.shape[1] - n_od
        L_ev, L_od = L[:, 0::2], L[:, 1::2]
        C_ev, C_od = C[:, 0::2], C[:, 1::2]
        U_ev, U_od = U[:, 0::2], U[:, 1::2]
        b_ev, b_od = b[:, :, 0::2], b[:, :, 1::2]
        Cinv_ev = _gj_inverse(C_ev)
        levels.append((Cinv_ev, L_ev, U_ev, b_ev))
        if n_od == 0:
            break
        # Odd row 2j+1 sits between even rows j and j+1; when the level has
        # as many odd rows as even ones, the last odd row has an identity
        # row below it.
        if n_ev == n_od:
            Cinv_below = _identity_below(Cinv_ev, eye)
            L_below = _identity_below(L_ev, zblk)
            U_below = _identity_below(U_ev, zblk)
            b_below = torch.cat([b_ev[:, :, 1:], zvec], dim=2)
        else:
            Cinv_below, L_below, U_below = Cinv_ev[:, 1:], L_ev[:, 1:], U_ev[:, 1:]
            b_below = b_ev[:, :, 1:]
        alpha = L_od @ Cinv_ev[:, :n_od]
        beta = U_od @ Cinv_below
        L = -(alpha @ L_ev[:, :n_od])
        C = C_od - alpha @ U_ev[:, :n_od] - beta @ L_below
        U = -(beta @ U_below)
        b = b_od - _bmv(alpha, b_ev[:, :, :n_od]) - _bmv(beta, b_below)

    x = None  # the odd rows of the level at hand, solved one level up
    for (Cinv_ev, L_ev, U_ev, b_ev) in reversed(levels):
        n_ev = Cinv_ev.shape[1]
        if x is None:
            x = _bmv(Cinv_ev, b_ev)
            continue
        n_od = x.shape[2]
        x_above = torch.cat([zvec, x[:, :, :n_ev - 1]], dim=2)
        x_below = x if n_od == n_ev else torch.cat([x, zvec], dim=2)
        x_ev = _bmv(Cinv_ev, b_ev - _bmv(L_ev, x_above) - _bmv(U_ev, x_below))
        out = torch.empty((Bn, R, n_ev + n_od, K), dtype=x.dtype,
                          device=x.device)
        out[:, :, 0::2] = x_ev
        out[:, :, 1::2] = x
        x = out
    if rows < m:
        x = torch.cat([x, zvec.expand(Bn, R, m - rows, K)], dim=2)
    return x


def solve_tridiag_kernel(L, C, U, b, rows=None, team=0):
    """Launch ``csrc/cr_solve.cu`` on CUDA tensors; same contract as
    solve_tridiag_reference.  The kernel takes as many warps a block as fit
    in shared memory (at most 8) and picks how many of them share one system:
    all for a batch below the card's SM count, one for a batch that gives
    every warp of the card a system.  ``team`` (warps a system) is for tests
    only: it reaches each of these paths at a small batch."""
    global launches
    _check_tridiag(L, C, U, b)
    if not L.is_cuda:
        raise ValueError("solve_tridiag_kernel needs CUDA tensors")
    Bn, R, m, K = b.shape
    rows = m if rows is None else rows
    if not 1 <= rows <= m:
        raise ValueError(f"rows={rows} outside 1..{m}")
    for X in (L, C, U, b):
        if X.data_ptr() % 16:
            raise ValueError("L, C, U, b must be 16-byte aligned")
    lib = _load()
    if not lib.cr_has_tiles(K):
        # One warp's buffers of the run-time-K engine: three blocks, the
        # exchange space and the least right-hand-side vector space.
        smem = (3 * (K * K + (K * K) % 2) + 2 * K
                + ((3 * K + 3) & ~3)) * L.element_size()
        if smem > _MAX_SMEM:
            raise ValueError(f"block size K={K} needs {smem} B of shared "
                             f"memory a warp")
    x = torch.empty_like(b)
    work = torch.empty(
        Bn * lib.cr_work_elems(rows, K, R), dtype=L.dtype, device=L.device
    )
    fn = lib.cr_solve_f64 if L.dtype == torch.float64 else lib.cr_solve_f32
    # The kernel may still run after this returns and ``work`` is freed: the
    # caching allocator hands that memory out again only in stream order.
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream(L.device).cuda_stream
        err = fn(L.data_ptr(), C.data_ptr(), U.data_ptr(), b.data_ptr(),
                 x.data_ptr(), work.data_ptr(), Bn, m, rows, K, R, int(team),
                 stream)
    if err != 0:
        raise RuntimeError(f"cr_solve kernel launch failed: CUDA error {err}")
    launches += 1
    return x


def solve_tridiag(L, C, U, b, rows=None):
    """The fused reduction of (L, C, U) (B, m, K, K), b (B, R, m, K): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if b.device.type == "cpu":
        _check_tridiag(L, C, U, b)
        return solve_tridiag_reference(L, C, U, b, rows)
    if not b.is_cuda:
        raise ValueError(f"no cyclic-reduction solve for device {b.device}")
    return solve_tridiag_kernel(L, C, U, b, rows)


def _check_tridiag(L, C, U, b):
    if b.ndim != 4:
        raise ValueError(f"b must be (B, R, m, K), got {tuple(b.shape)}")
    Bn, R, m, K = b.shape
    for name, X in (("L", L), ("C", C), ("U", U)):
        if tuple(X.shape) != (Bn, m, K, K):
            raise ValueError(f"{name} must be {(Bn, m, K, K)}, got "
                             f"{tuple(X.shape)}")
    if Bn < 1 or R < 1 or m < 1 or K < 1:
        raise ValueError("empty batch, right-hand side, row or block")
    for X in (L, C, U, b):
        if X.dtype not in (torch.float32, torch.float64) or X.dtype != b.dtype:
            raise ValueError("L, C, U, b must share dtype float32 or float64")
        if X.device != b.device:
            raise ValueError("L, C, U, b must be on one device")
        if not X.is_contiguous():
            raise ValueError("L, C, U, b must be contiguous")


# ---------------------------------------------------------------------------
# Penta-diagonal entry points.


def _pack(H: PentaBands, rhs):
    """(L, C, U, b) of the m = ceil(n/2) real super-rows, all contiguous."""
    if rhs.ndim != 4 or H.C.ndim != 4:
        raise ValueError("expected bands (B, n, k, k) and rhs (B, R, n, k)")
    Bn, R, n, k = rhs.shape
    if tuple(H.C.shape) != (Bn, n, k, k):
        raise ValueError(f"bands {tuple(H.C.shape)} do not match rhs "
                         f"{tuple(rhs.shape)}")
    L, C, U = _pack_super_tridiag(H)
    return L, C, U, _pack_rhs(rhs, C.shape[1])


def _unpack(x, n, k):
    Bn, R, m = x.shape[:3]
    return x.reshape(Bn, R, 2 * m, k)[:, :, :n]


def solve_many_reference(H: PentaBands, rhs):
    """Plain PyTorch solve of H X = rhs on any device: bands (B, n, k, k),
    rhs (B, R, n, k) -> (B, R, n, k)."""
    n, k = rhs.shape[-2], rhs.shape[-1]
    L, C, U, b = _pack(H, rhs)
    _check_tridiag(L, C, U, b)
    return _unpack(solve_tridiag_reference(L, C, U, b), n, k)


def solve_many(H: PentaBands, rhs):
    """Solve H X = rhs for bands (B, n, k, k) and rhs (B, R, n, k) in one
    fused cyclic reduction per system: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    n, k = rhs.shape[-2], rhs.shape[-1]
    return _unpack(solve_tridiag(*_pack(H, rhs)), n, k)
