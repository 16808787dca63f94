"""Penta-diagonal -> block-tridiagonal packing for cyclic reduction
(counterpart of ``idto_tpu/ops/cyclic_reduction.py:_pack_super_tridiag``
and ``_pack_rhs``; the reduction itself is ``ops/cr_kernel.py``).

Pairing adjacent k-rows into 2k super-rows turns the SPD penta-diagonal
system into an SPD block-tridiagonal one of m = ceil(n/2) super-rows.
"""
from __future__ import annotations

import torch

from idto_tpu_torch.ops.penta import PentaBands


def _pad_block_rows(X, pad, diag):
    if pad == 0:
        return X
    k = X.shape[-1]
    shape = X.shape[:-3] + (pad, k, k)
    if diag:
        extra = torch.eye(k, dtype=X.dtype, device=X.device).expand(shape)
    else:
        extra = torch.zeros(shape, dtype=X.dtype, device=X.device)
    return torch.cat([X, extra], dim=-3)


def _pack_super_tridiag(H: PentaBands):
    """(L, C, U) of shape (..., m, 2k, 2k), m = ceil(n/2); an odd trailing
    row is padded with an identity diagonal block.  Row pair (2i, 2i+1)
    couples pair i-1 through bands A, B of row 2i and A of row 2i+1, and
    pair i+1 through E of row 2i and D, E of row 2i+1."""
    n, k = H.n, H.k
    m = (n + 1) // 2
    pad = 2 * m - n
    A = _pad_block_rows(H.A, pad, False)
    B = _pad_block_rows(H.B, pad, False)
    C = _pad_block_rows(H.C, pad, True)
    D = _pad_block_rows(H.D, pad, False)
    E = _pad_block_rows(H.E, pad, False)

    def ev(X):
        return X[..., 0::2, :, :]

    def od(X):
        return X[..., 1::2, :, :]

    z = torch.zeros_like(ev(A))

    def blk(tl, tr, bl, br):
        top = torch.cat([tl, tr], dim=-1)
        bot = torch.cat([bl, br], dim=-1)
        return torch.cat([top, bot], dim=-2)

    L = blk(ev(A), ev(B), z, od(A))
    C2 = blk(ev(C), ev(D), od(B), od(C))
    U = blk(ev(E), z, od(D), od(E))
    return L, C2, U


def _pack_rhs(b, m):
    """(..., n, k) -> (..., m, 2k), zero padded to 2m rows."""
    n, k = b.shape[-2], b.shape[-1]
    pad = 2 * m - n
    if pad:
        b = torch.cat(
            [b, torch.zeros(b.shape[:-2] + (pad, k), dtype=b.dtype,
                            device=b.device)],
            dim=-2,
        )
    return b.reshape(b.shape[:-2] + (m, 2 * k))
