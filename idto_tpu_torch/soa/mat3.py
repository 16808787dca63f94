"""Component-leading 3x3 / 3-vector algebra (counterpart of
``idto_tpu/soa/mat3.py``).

Matrices are ``(3, 3, ...)`` and vectors ``(3, ...)`` with the instance
axes trailing (broadcast like any elementwise op).  Each contraction is a
single ``einsum`` rather than the JAX package's 45 component multiply-adds:
under nested ``torch.func`` transforms every dispatched op costs a fixed
host overhead, so the op count, not the arithmetic, sets the time.
"""
from __future__ import annotations

import torch


def mul(A, B):
    """A @ B."""
    return torch.einsum("ik...,kj...->ij...", A, B)


def mul_t(A, B):
    """A @ B^T."""
    return torch.einsum("ik...,jk...->ij...", A, B)


def t_mul(A, B):
    """A^T @ B."""
    return torch.einsum("ki...,kj...->ij...", A, B)


def mv(A, v):
    """A @ v for (3, 3, ...) x (3, ...)."""
    return torch.einsum("ij...,j...->i...", A, v)


def tmv(A, v):
    """A^T @ v."""
    return torch.einsum("ji...,j...->i...", A, v)


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
