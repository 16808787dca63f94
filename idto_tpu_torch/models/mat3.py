"""3x3 matrix / 3-vector algebra with the components trailing (counterpart
of ``idto_tpu/models/mat3.py``), for the per-problem (AoS) pipeline.

Matrices are ``(..., 3, 3)`` and vectors ``(..., 3)``; every function
broadcasts over the leading axes.  The JAX package writes each contraction
as component multiply-adds to keep XLA:TPU away from tiny dots; here they
are PyTorch's own batched matmul and cross product, which ``torch.func``
transforms batch with one op each.
"""
from __future__ import annotations

import torch


def mul(A, B):
    """A @ B."""
    return A @ B


def mul_t(A, B):
    """A @ B^T."""
    return A @ B.mT


def t_mul(A, B):
    """A^T @ B."""
    return A.mT @ B


def mv(A, v):
    """A @ v for (..., 3, 3) x (..., 3)."""
    return (A @ v[..., None])[..., 0]


def tmv(A, v):
    """A^T @ v."""
    return (A.mT @ v[..., None])[..., 0]


def cross(a, b):
    """a x b for (..., 3) operands."""
    return torch.linalg.cross(a, b, dim=-1)


def dot(a, b):
    """<a, b> over the last axis."""
    return torch.sum(a * b, dim=-1)


def transpose(A):
    return A.mT
