"""Block penta-diagonal matrices and the block Thomas solver (counterpart
of ``idto_tpu/ops/penta.py``).

Bands are dense ``(..., n, k, k)`` tensors with any leading batch axes.
Block row i holds [A_i, B_i, C_i, D_i, E_i] in columns i-2..i+2, zero
padded at the ends.  The Thomas sweep is a Python loop over block rows,
batched over the leading axes; it is the rescue solver of the batched
trust-region loop.
"""
from __future__ import annotations

from typing import Any

import torch

from idto_tpu_torch.utils import linalg
from idto_tpu_torch.utils.structs import tensor_dataclass


@tensor_dataclass
class PentaBands:
    A: Any  # (..., n, k, k) block at (i, i-2)
    B: Any  # (..., n, k, k) block at (i, i-1)
    C: Any  # (..., n, k, k) block at (i, i)
    D: Any  # (..., n, k, k) block at (i, i+1)
    E: Any  # (..., n, k, k) block at (i, i+2)

    @property
    def n(self):
        return self.C.shape[-3]

    @property
    def k(self):
        return self.C.shape[-1]


def _rows(x, lo, hi, axis):
    """Block rows lo..hi-1 along ``axis`` (empty when hi <= lo)."""
    return x.narrow(axis, lo, max(hi - lo, 0))


def _pad_rows(x, before, after, axis):
    """Zero block rows before/after along ``axis``."""
    parts = []
    if before:
        shape = list(x.shape)
        shape[axis] = before
        parts.append(torch.zeros(shape, dtype=x.dtype, device=x.device))
    parts.append(x)
    if after:
        shape = list(x.shape)
        shape[axis] = after
        parts.append(torch.zeros(shape, dtype=x.dtype, device=x.device))
    return torch.cat(parts, dim=axis)


def make_symmetric_from_lower(A, B, C):
    """Full bands from the lower bands: D_i = B_{i+1}^T, E_i = A_{i+2}^T,
    and C symmetrized from its lower triangle."""
    n = C.shape[-3]
    Csym = torch.tril(C) + torch.triu(torch.tril(C, -1).transpose(-1, -2), 1)
    D = _pad_rows(_rows(B, 1, n, -3).transpose(-1, -2), 0, 1, -3)
    E = _pad_rows(_rows(A, 2, n, -3).transpose(-1, -2), 0, 2, -3)
    return PentaBands(A=A, B=B, C=Csym, D=D, E=E)


def matvec(H: PentaBands, x):
    """y = H x for x of shape (..., n, k)."""
    n = x.shape[-2]
    xm1 = _pad_rows(_rows(x, 0, n - 1, -2), 1, 0, -2)
    xm2 = _pad_rows(_rows(x, 0, n - 2, -2), 2, 0, -2)
    xp1 = _pad_rows(_rows(x, 1, n, -2), 0, 1, -2)
    xp2 = _pad_rows(_rows(x, 2, n, -2), 0, 2, -2)

    def mv(M, y):
        return torch.einsum("...nij,...nj->...ni", M, y)

    return mv(H.A, xm2) + mv(H.B, xm1) + mv(H.C, x) + mv(H.D, xp1) + mv(H.E, xp2)


def extract_diagonal(H: PentaBands):
    """Scalar diagonal of H as an (..., n, k) tensor."""
    return torch.diagonal(H.C, dim1=-2, dim2=-1)


def scale_by_diagonal(H: PentaBands, d):
    """H -> diag(d) H diag(d) for d of shape (..., n, k)."""
    n = d.shape[-2]
    dm1 = _pad_rows(_rows(d, 0, n - 1, -2), 1, 0, -2)
    dm2 = _pad_rows(_rows(d, 0, n - 2, -2), 2, 0, -2)
    dp1 = _pad_rows(_rows(d, 1, n, -2), 0, 1, -2)
    dp2 = _pad_rows(_rows(d, 2, n, -2), 0, 2, -2)
    row = d[..., :, None]
    return PentaBands(
        A=row * H.A * dm2[..., None, :],
        B=row * H.B * dm1[..., None, :],
        C=row * H.C * d[..., None, :],
        D=row * H.D * dp1[..., None, :],
        E=row * H.E * dp2[..., None, :],
    )


def to_dense(H: PentaBands):
    """Dense (..., n*k, n*k) matrix (for tests and oracles)."""
    n, k = H.n, H.k
    batch = H.C.shape[:-3]
    M = torch.zeros(batch + (n, n, k, k), dtype=H.C.dtype, device=H.C.device)
    for i in range(n):
        for off, band in ((-2, H.A), (-1, H.B), (0, H.C), (1, H.D), (2, H.E)):
            j = i + off
            if 0 <= j < n:
                M[..., i, j, :, :] = band[..., i, :, :]
    return M.transpose(-3, -2).reshape(batch + (n * k, n * k))


@tensor_dataclass
class PentaFactorization:
    """Forward-eliminated factors of the block Thomas sweep."""

    L1: Any  # (..., n, k, k) multiplier of row i-1 subtracted from row i
    L2: Any  # (..., n, k, k) multiplier of row i-2
    Cp: Any  # (..., n, k, k) eliminated diagonal blocks
    Dp: Any  # (..., n, k, k) eliminated super-diagonal
    Ep: Any  # (..., n, k, k) (unchanged) second super-diagonal


def _solve(A, B):
    """A^{-1} B by partial-pivot LU; a singular A gives inf/nan instead of
    raising, which factorization_status reports."""
    return linalg.solve(A, B)


def factorize(H: PentaBands) -> PentaFactorization:
    """Block LU by the Thomas forward sweep, sequential over block rows."""
    k = H.k
    batch = H.C.shape[:-3]
    eye = torch.eye(k, dtype=H.C.dtype, device=H.C.device).expand(
        batch + (k, k)
    )
    zero = torch.zeros_like(eye)
    C1, D1, E1, C2, D2, E2 = eye, zero, zero, eye, zero, zero
    out = {"L1": [], "L2": [], "Cp": [], "Dp": [], "Ep": []}
    for i in range(H.n):
        A, B, C, D, E = (X[..., i, :, :] for X in (H.A, H.B, H.C, H.D, H.E))
        L2 = _solve(C2.transpose(-1, -2), A.transpose(-1, -2)).transpose(-1, -2)
        Bp = B - L2 @ D2
        L1 = _solve(C1.transpose(-1, -2), Bp.transpose(-1, -2)).transpose(-1, -2)
        Cp = C - L2 @ E2 - L1 @ D1
        Dp = D - L1 @ E1
        for name, val in (("L1", L1), ("L2", L2), ("Cp", Cp), ("Dp", Dp),
                          ("Ep", E)):
            out[name].append(val)
        C1, D1, E1, C2, D2, E2 = Cp, Dp, E, C1, D1, E1
    return PentaFactorization(
        **{name: torch.stack(v, dim=-3) for name, v in out.items()}
    )


def factorization_status(F: PentaFactorization):
    """Per-system flag (...,): every factor block is finite."""
    ok = None
    for x in (F.L1, F.L2, F.Cp, F.Dp):
        fin = torch.isfinite(x).flatten(-4).all(dim=-1)
        ok = fin if ok is None else ok & fin
    return ok


def _substitute(F: PentaFactorization, b):
    """Forward and back substitution with the right-hand sides as columns:
    b (..., n, k, R) -> x (..., n, k, R)."""
    n = b.shape[-3]
    zero = torch.zeros_like(b[..., 0, :, :])
    y1 = y2 = zero
    ys = []
    for i in range(n):
        y = b[..., i, :, :] - F.L1[..., i, :, :] @ y1 - F.L2[..., i, :, :] @ y2
        ys.append(y)
        y1, y2 = y, y1
    x1 = x2 = zero
    xs = [None] * n
    for i in reversed(range(n)):
        rhs = ys[i] - F.Dp[..., i, :, :] @ x1 - F.Ep[..., i, :, :] @ x2
        x = _solve(F.Cp[..., i, :, :], rhs)
        xs[i] = x
        x1, x2 = x, x1
    return torch.stack(xs, dim=-3)


def solve_factorized(F: PentaFactorization, b):
    """Solve H x = b given the factorization; b of shape (..., n, k)."""
    return _substitute(F, b[..., None])[..., 0]


def solve_factorized_many(F: PentaFactorization, b):
    """Solve H X = b for a stack of right-hand sides b (..., R, n, k); each
    block solve takes the R vectors as the columns of one matrix."""
    return _substitute(F, b.movedim(-3, -1)).movedim(-1, -3)


def solve(H: PentaBands, b):
    """One-shot solve H x = b (factorize + substitution)."""
    return solve_factorized(factorize(H), b)
