"""The port's dense linear-algebra calls, on the card through cuSOLVER and
cuBLAS.

For a batch of more than 16 matrices larger than 16 x 16 -- the Thomas
blocks of the cheetah at B=256, its forward dynamics at 256 robots --
PyTorch's default choice is MAGMA's batched LU, and MAGMA's batched
routines synchronize the stream (``magma_dgetrs_batched`` refuses a
capturing stream): no CUDA graph can hold them.  The cuSOLVER route
(cuBLAS's batched getrf / getrs for a batch) can be captured.  Every call
below takes it on CUDA tensors, on the captured and on the eager route
alike, so that both run the same kernels.  On the CPU they are PyTorch's
(LAPACK).  None checks its result on the host: a singular matrix gives
inf / nan, which the callers test on the device.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _cusolver(x: torch.Tensor):
    if x.device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def solve(A, B):
    """A^{-1} B by partial-pivot LU, batched over leading axes."""
    with _cusolver(A):
        return torch.linalg.solve_ex(A, B, check_errors=False).result


def lu_factor(A):
    """(LU, pivots) of a partial-pivot LU."""
    with _cusolver(A):
        LU, pivots, _ = torch.linalg.lu_factor_ex(A, check_errors=False)
    return LU, pivots


def lu_solve(LU, pivots, B):
    """A^{-1} B from ``lu_factor``'s factors."""
    with _cusolver(LU):
        return torch.linalg.lu_solve(LU, pivots, B)
