"""Checkpoint / resume for batch solve and MPC jobs (counterpart of
``idto_tpu/utils/checkpoint.py``).

A tree of tensors -- a WarmStart, an MpcCarry, batched solutions; any
nesting of the port's dataclasses, tuples, lists and dicts -- is saved as a
flat ``.npz`` with one ``leaf_%06d`` entry per tensor in tree order (fields
in declaration order, dict keys sorted), the JAX package's layout.
Non-tensor fields (step counts, enums, time steps) are not stored: restore
into a tree of the same structure (``like``).  The JAX package's orbax
branch has no counterpart.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any

import numpy as np
import torch


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _leaves(tree) -> list:
    if _is_leaf(tree):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in _leaves(item)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return []


def _rebuild(tree, it):
    """``tree`` with its leaves taken in order from the iterator ``it``."""
    if _is_leaf(tree):
        new = next(it)
        if isinstance(tree, torch.Tensor):
            return torch.as_tensor(new, dtype=tree.dtype, device=tree.device)
        return np.asarray(new, dtype=tree.dtype)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), it)
            for f in dataclasses.fields(tree) if f.init
        })
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(x, it) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, it) for x in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return tree


def save(path: str, tree: Any, step: int | None = None) -> str:
    """Save the tensors of ``tree`` to ``path`` (``.npz`` appended when
    missing; ``step`` is accepted for the JAX package's signature and has
    no effect on the flat file).  Returns the path written."""
    arrays = {
        f"leaf_{i:06d}": (x.detach().cpu().numpy()
                          if isinstance(x, torch.Tensor) else np.asarray(x))
        for i, x in enumerate(_leaves(tree))
    }
    out = path if path.endswith(".npz") else path + ".npz"
    np.savez(out, **arrays)
    return out


def restore(path: str, like: Any) -> Any:
    """The tree saved by :func:`save`, in the structure of ``like``, each
    tensor on ``like``'s device and in its dtype."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    n = len(_leaves(like))
    return _rebuild(like, iter(data[f"leaf_{i:06d}"] for i in range(n)))


class CheckpointManager:
    """Rolling checkpoints for long batch campaigns: keeps the latest
    ``max_to_keep`` steps under ``directory`` with a small JSON index."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._index_path = os.path.join(self.directory, "index.json")

    def _index(self) -> list[int]:
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                return json.load(f)
        return []

    def _write_index(self, steps: list[int]) -> None:
        with open(self._index_path, "w") as f:
            json.dump(steps, f)

    def save(self, step: int, tree: Any) -> str:
        path = save(os.path.join(self.directory, f"step_{step}"), tree)
        steps = sorted(set(self._index() + [step]))
        while len(steps) > self.max_to_keep:
            drop = steps.pop(0)
            for suffix in ("", ".npz"):
                p = os.path.join(self.directory, f"step_{drop}{suffix}")
                if os.path.isfile(p):
                    os.remove(p)
                elif os.path.isdir(p):
                    shutil.rmtree(p, ignore_errors=True)
        self._write_index(steps)
        return path

    def latest_step(self) -> int | None:
        steps = self._index()
        return steps[-1] if steps else None

    def restore_latest(self, like: Any) -> tuple[int, Any] | None:
        step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.directory, f"step_{step}")
        return step, restore(path, like)
