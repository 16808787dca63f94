"""Component-leading 3x3 / 3-vector algebra (counterpart of
``idto_tpu/soa/mat3.py``).

Matrices are ``(3, 3, ...)`` and vectors ``(3, ...)`` with the instance
axes trailing; both operands of a product carry the same number of them
(size 1 where one is broadcast, e.g. ``R[..., None]``).  Each contraction
is one broadcast elementwise multiply and one sum over the contracted
component axis, never ``einsum``/``matmul``: a product of tiny matrices
batched over instances is memory-bound, and as a batched GEMM (what
``einsum`` lowers it to, after a layout copy of the strided operands)
cuBLAS spends a whole 32x64 tile on each 3x3.
"""
from __future__ import annotations

import torch


def mul(A, B):
    """A @ B."""
    return (A[:, :, None] * B[None]).sum(1)


def mul_t(A, B):
    """A @ B^T."""
    return (A[:, None] * B[None]).sum(2)


def t_mul(A, B):
    """A^T @ B."""
    return (A[:, :, None] * B[:, None]).sum(0)


def mv(A, v):
    """A @ v for (3, 3, ...) x (3, ...)."""
    return (A * v[None]).sum(1)


def tmv(A, v):
    """A^T @ v."""
    return (A * v[:, None]).sum(0)


def cross(a, b):
    """a x b for (3, ...) operands."""
    return torch.linalg.cross(a, b, dim=0)


def dot(a, b):
    """<a, b> over the leading component axis."""
    return torch.sum(a * b, dim=0)


def norm(a, eps=1e-12):
    """Guarded |a| over the leading component axis."""
    return torch.sqrt(dot(a, a) + eps)


def from_aos_mat(M):
    """(..., 3, 3) -> (3, 3, ...)."""
    return torch.movedim(M, (-2, -1), (0, 1))


def from_aos_vec(v):
    """(..., 3) -> (3, ...)."""
    return torch.movedim(v, -1, 0)


def transpose(A):
    """A^T for (3, 3, ...) matrices."""
    return torch.swapaxes(A, 0, 1)


def to_aos_mat(M):
    """(3, 3, ...) -> (..., 3, 3)."""
    return torch.movedim(M, (0, 1), (-2, -1))


def to_aos_vec(v):
    """(3, ...) -> (..., 3)."""
    return torch.movedim(v, 0, -1)
