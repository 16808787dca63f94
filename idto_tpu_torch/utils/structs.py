"""Dataclass helper for structures of tensors.

The JAX package registers frozen dataclasses as pytrees; here they are
plain frozen dataclasses whose tensor fields move together with
``to(device, dtype)``.  Non-tensor fields (tuples, ints, enums) are static
Python attributes.
"""
from __future__ import annotations

import dataclasses
from typing import TypeVar

import torch

_T = TypeVar("_T")


def _move(x, device, dtype):
    if isinstance(x, torch.Tensor):
        if dtype is not None and x.is_floating_point():
            return x.to(device=device, dtype=dtype)
        return x.to(device=device)
    if dataclasses.is_dataclass(x) and hasattr(x, "to"):
        return x.to(device=device, dtype=dtype)
    return x


def tensor_dataclass(cls: type[_T]) -> type[_T]:
    """Frozen dataclass with ``replace(**updates)`` and ``to(device=None,
    dtype=None)``; ``dtype`` applies to floating tensors only."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def _replace(self, **updates):
        return dataclasses.replace(self, **updates)

    def _to(self, device=None, dtype=None):
        return dataclasses.replace(
            self,
            **{
                f.name: _move(getattr(self, f.name), device, dtype)
                for f in dataclasses.fields(self)
            },
        )

    cls.replace = _replace
    cls.to = _to
    return cls
