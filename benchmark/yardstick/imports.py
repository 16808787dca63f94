"""The check that nothing of JAX was loaded into the process.

Names are compared by their top-level part (before the first dot) as a
whole word: ``idto_tpu_torch`` is the port, ``idto_tpu`` is the JAX
package it begins with.
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "idto_tpu"})


def forbidden_modules(modules=None) -> list:
    """Sorted names of loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
