"""Penta-diagonal -> block-tridiagonal packing for cyclic reduction
(counterpart of ``idto_tpu/ops/cyclic_reduction.py:_pack_super_tridiag``
and ``_pack_rhs``; the reduction itself is ``ops/cr_kernel.py``).

Pairing adjacent k-rows into 2k super-rows turns the SPD penta-diagonal
system into an SPD block-tridiagonal one of m = ceil(n/2) super-rows.
"""
from __future__ import annotations

import torch

from idto_tpu_torch.ops.penta import PentaBands


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
