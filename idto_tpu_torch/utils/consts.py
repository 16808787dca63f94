"""Constant tensors built once.

Index lists, masks and small tables that depend only on the model's static
topology are needed as device tensors by every physics call.  Making one
from host data is a blocking host-to-device copy, so each is made once per
(content, device, dtype) and reused.  The tensors are shared: callers must
not write to them.

A tensor made while a ``torch.func`` transform (jvp, vjp) is active comes
wrapped for that transform's level and must not outlive it; the cache keeps
the plain tensor underneath.
"""
from __future__ import annotations

import numpy as np
import torch

_CACHE: dict = {}


def const(array_like, device, dtype=None):
    """Tensor of ``array_like`` on ``device`` (numpy's dtype unless ``dtype``
    is given), cached by content."""
    a = np.ascontiguousarray(array_like)
    key = (a.dtype.str, a.shape, a.tobytes(), str(device), dtype)
    t = _CACHE.get(key)
    if t is None:
        t = torch.as_tensor(a, dtype=dtype, device=device)
        while torch._C._functorch.is_functorch_wrapped_tensor(t):
            t = torch._C._functorch.get_unwrapped(t)
        _CACHE[key] = t
    return t


def index(ix, device):
    """int64 index tensor of a Python sequence or array."""
    return const(np.asarray(ix, dtype=np.int64), device)
