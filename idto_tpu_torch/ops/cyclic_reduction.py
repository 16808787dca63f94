"""Block cyclic reduction of penta-diagonal systems, level by level
(counterpart of ``idto_tpu/ops/cyclic_reduction.py``; the fused one-launch
reduction is ``ops/cr_kernel.py``).

Pairing adjacent k-rows into 2k super-rows turns the SPD penta-diagonal
system into an SPD block-tridiagonal one of m = ceil(n/2) super-rows.
``factorize`` reduces the matrix once -- each level eliminates the even
super-rows with batched products and block inverses (``torch.matmul``,
``torch.linalg.solve``) -- and ``solve_factorized`` applies the stored
reduction to any number of right-hand sides with products only, so one
factorization serves the Newton step, the merit-gradient solve and every
equality-constraint column of an iteration.

With ``tail_rows`` > 1 (the hybrid) the level-wise reduction stops once the
system has shrunk to that many super-rows and the remaining block-tridiagonal
tail is solved by the fused kernel (``cr_kernel.solve_tridiag``: the CUDA
kernel on CUDA tensors, its plain version on CPU tensors), one launch for the
whole batch and all right-hand sides.

Every tensor leads with the batch axis.  The JAX package pads the system
with identity rows to a power of two; here only the real rows are reduced
(level l holds m >> l of them), which is the same arithmetic on the real
rows: an identity row reduces to an identity row and its x is zero.
"""
from __future__ import annotations

from typing import Any

import torch

from idto_tpu_torch.ops.penta import PentaBands
from idto_tpu_torch.utils.structs import tensor_dataclass


def _pack_super_tridiag(H: PentaBands):
    """(L, C, U) of shape (..., m, 2k, 2k), m = ceil(n/2), contiguous; an
    odd trailing row is padded with an identity diagonal block.  Row pair
    (2i, 2i+1) couples pair i-1 through bands A, B of row 2i and A of row
    2i+1, and pair i+1 through E of row 2i and D, E of row 2i+1.  Each band
    is written once into its quadrant of a zeroed result."""
    n, k = H.n, H.k
    m = (n + 1) // 2
    n_od = n // 2  # rows 2i+1 that exist
    shape = H.C.shape[:-3] + (m, 2 * k, 2 * k)
    L, C2, U = (torch.zeros(shape, dtype=H.C.dtype, device=H.C.device)
                for _ in range(3))

    def ev(X):
        return X[..., 0::2, :, :]

    def od(X):
        return X[..., 1::2, :, :]

    L[..., :k, :k] = ev(H.A)
    L[..., :k, k:] = ev(H.B)
    L[..., :n_od, k:, k:] = od(H.A)
    C2[..., :k, :k] = ev(H.C)
    C2[..., :k, k:] = ev(H.D)
    C2[..., :n_od, k:, :k] = od(H.B)
    C2[..., :n_od, k:, k:] = od(H.C)
    if n_od < m:
        C2[..., m - 1, k:, k:] = torch.eye(k, dtype=C2.dtype, device=C2.device)
    U[..., :k, :k] = ev(H.E)
    U[..., :n_od, k:, :k] = od(H.D)
    U[..., :n_od, k:, k:] = od(H.E)
    return L, C2, U


def _pack_rhs(b, m):
    """(..., n, k) -> (..., m, 2k) contiguous, zero padded to 2m rows."""
    n, k = b.shape[-2], b.shape[-1]
    if 2 * m == n:
        return b.contiguous().reshape(b.shape[:-2] + (m, 2 * k))
    out = torch.zeros(b.shape[:-2] + (2 * m, k), dtype=b.dtype,
                      device=b.device)
    out[..., :n, :] = b
    return out.reshape(b.shape[:-2] + (m, 2 * k))


@tensor_dataclass
class CRLevel:
    """One reduction level of a system with n_ev even and n_od odd real
    rows (n_ev - n_od is 0 or 1).  Even rows are eliminated; odd rows are
    kept and become the next level's rows."""

    Cinv_even: Any  # (B, n_ev, K, K) inverses of the eliminated blocks
    alpha: Any      # (B, n_od, K, K) L_odd @ Cinv(even row above)
    beta: Any       # (B, n_ev - 1, K, K) U_odd @ Cinv(even row below)
    L_even: Any     # (B, n_ev, K, K) kept for back substitution
    U_even: Any     # (B, n_ev, K, K)


@tensor_dataclass
class CRFactorization:
    levels: tuple = ()       # CRLevel, coarsest last
    C_final_inv: Any = None  # (B, 1, K, K); None when a kernel tail is kept
    tail_LCU: Any = None     # optional (Lt, Ct, Ut), each (B, mt, K, K)
    n: int = 0  # original block-row count
    k: int = 0  # original block size


def _inv(M):
    """Inverse of (..., K, K) blocks by partial-pivot LU; a singular block
    gives inf/nan instead of raising, which factorization_status reports."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand(
        M.shape)
    return torch.linalg.solve_ex(M, eye, check_errors=False).result


def _bmv(A, x):
    """(B, h, K, K) @ (B, R, h, K) -> (B, R, h, K)."""
    return torch.einsum("bhij,brhj->brhi", A, x)


def factorize(H: PentaBands, tail_rows: int = 1) -> CRFactorization:
    """Log-depth reduction of the matrix, bands (B, n, k, k).

    ``tail_rows`` (a power of two) counts rows of the system padded to a
    power of two, as the JAX package counts them: the reduction stops at the
    level whose padded size is ``tail_rows``, and that level's real rows are
    stored verbatim for the fused kernel.  ``tail_rows=1`` reduces down to
    one block."""
    if tail_rows < 1 or tail_rows & (tail_rows - 1):
        raise ValueError(f"tail_rows={tail_rows} is not a power of two")
    L, C, U = _pack_super_tridiag(H)
    m = C.shape[1]
    size = 1 << max(m - 1, 0).bit_length()
    levels = []
    while size > tail_rows and C.shape[1] > 1:
        n_od = C.shape[1] // 2
        L_ev, C_ev, U_ev = L[:, 0::2], C[:, 0::2], U[:, 0::2]
        L_od, C_od, U_od = L[:, 1::2], C[:, 1::2], U[:, 1::2]
        n_below = C_ev.shape[1] - 1  # odd rows with a real even row below
        Cinv_ev = _inv(C_ev)
        alpha = L_od @ Cinv_ev[:, :n_od]
        beta = U_od[:, :n_below] @ Cinv_ev[:, 1:]
        levels.append(CRLevel(Cinv_even=Cinv_ev, alpha=alpha, beta=beta,
                              L_even=L_ev, U_even=U_ev))
        # The row below the last odd row of an even-sized level is an
        # identity row: its terms vanish.
        L = -(alpha @ L_ev[:, :n_od])
        C = C_od - alpha @ U_ev[:, :n_od]
        C[:, :n_below] -= beta @ L_ev[:, 1:]
        U = torch.zeros_like(L)
        U[:, :n_below] = -(beta @ U_ev[:, 1:])
        size //= 2
    if size > 1 and tail_rows > 1:
        tail = tuple(X.contiguous() for X in (L, C, U))
        return CRFactorization(levels=tuple(levels), tail_LCU=tail,
                               n=H.n, k=H.k)
    return CRFactorization(levels=tuple(levels), C_final_inv=_inv(C),
                           n=H.n, k=H.k)


def factorization_status(F: CRFactorization):
    """Per-system flag (B,): every stored factor block is finite (a
    singular eliminated block gives inf/nan).  A singular block of the
    kernel's tail shows as a non-finite solve, which the solver's
    Newton-step finiteness check covers."""
    leaves = [x for lvl in F.levels
              for x in (lvl.Cinv_even, lvl.alpha, lvl.beta, lvl.L_even,
                        lvl.U_even)]
    leaves += [F.C_final_inv] if F.C_final_inv is not None else []
    leaves += list(F.tail_LCU) if F.tail_LCU is not None else []
    ok = None
    for x in leaves:
        fin = torch.isfinite(x).flatten(1).all(dim=1)
        ok = fin if ok is None else ok & fin
    return ok


def solve_factorized(F: CRFactorization, b):
    """Apply the stored reduction to right-hand sides b (B, n, k) or
    (B, R, n, k): products only, plus one fused-kernel solve of the tail
    when the factorization keeps one."""
    single = b.ndim == 3
    rhs = _pack_rhs(b[:, None] if single else b, (F.n + 1) // 2)
    Bn, R, _, K = rhs.shape
    zvec = torch.zeros((Bn, R, 1, K), dtype=rhs.dtype, device=rhs.device)

    # Downward pass: fold the even rows' rhs into the kept odd rows.
    b_evens = []
    for lvl in F.levels:
        b_ev, b_od = rhs[:, :, 0::2], rhs[:, :, 1::2]
        b_evens.append(b_ev)
        n_od, n_below = b_od.shape[2], lvl.beta.shape[1]
        below = _bmv(lvl.beta, b_ev[:, :, 1:])
        if n_below < n_od:
            below = torch.cat([below, zvec], dim=2)
        rhs = b_od - _bmv(lvl.alpha, b_ev[:, :, :n_od]) - below

    if F.tail_LCU is not None:
        from idto_tpu_torch.ops import cr_kernel

        x = cr_kernel.solve_tridiag(*F.tail_LCU, rhs.contiguous())
    else:
        x = _bmv(F.C_final_inv, rhs)

    # Upward pass: recover the eliminated even rows.  Even row 2j sits
    # between kept rows j - 1 (none for j = 0) and j (none past the last).
    for lvl, b_ev in zip(reversed(F.levels), reversed(b_evens)):
        n_ev, n_od = b_ev.shape[2], x.shape[2]
        x_above = torch.cat([zvec, x[:, :, :n_ev - 1]], dim=2)
        x_below = x if n_od == n_ev else torch.cat([x, zvec], dim=2)
        x_ev = _bmv(lvl.Cinv_even, b_ev - _bmv(lvl.L_even, x_above)
                    - _bmv(lvl.U_even, x_below))
        out = torch.empty((Bn, R, n_ev + n_od, K), dtype=x.dtype,
                          device=x.device)
        out[:, :, 0::2] = x_ev
        out[:, :, 1::2] = x
        x = out
    x = x.reshape(Bn, R, -1, F.k)[:, :, :F.n]
    return x[:, 0] if single else x


def solve(H: PentaBands, b):
    """One-shot solve H x = b (same interface as penta.solve)."""
    return solve_factorized(factorize(H), b)
