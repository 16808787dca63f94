"""Constant tensors built once.

Index lists, masks and small tables that depend only on the model's static
topology are needed as device tensors by every physics call.  Making one
from host data is a blocking host-to-device copy, so each is made once per
(content, device, dtype) and reused.  The tensors are shared: callers must
not write to them.

A tensor made while a ``torch.func`` transform (jvp, vjp) is active comes
wrapped for that transform's level and must not outlive it; the cache keeps
the plain tensor underneath.

``misses`` counts the tensors made.  A miss while a CUDA graph is being
captured would be a pageable host-to-device copy, which a capture cannot
hold: it raises with the key (``utils/graphs.py`` warms every region up
before it captures it).
"""
from __future__ import annotations

import numpy as np
import torch

_CACHE: dict = {}
misses = 0  # tensors made since import


def const(array_like, device, dtype=None):
    """Tensor of ``array_like`` on ``device`` (numpy's dtype unless ``dtype``
    is given), cached by content."""
    a = np.ascontiguousarray(array_like)
    key = (a.dtype.str, a.shape, a.tobytes(), str(device), dtype)
    t = _CACHE.get(key)
    if t is None:
        global misses
        if (torch.device(device).type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(
                "constant-cache miss inside a CUDA graph capture: "
                f"{a.dtype} {a.shape} {a.tolist()} on {device}")
        misses += 1
        t = torch.as_tensor(a, dtype=dtype, device=device)
        while torch._C._functorch.is_functorch_wrapped_tensor(t):
            t = torch._C._functorch.get_unwrapped(t)
        _CACHE[key] = t
    return t


def index(ix, device):
    """int64 index tensor of a Python sequence or array."""
    return const(np.asarray(ix, dtype=np.int64), device)
