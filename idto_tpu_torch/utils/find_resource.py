"""Resource lookup (counterpart of ``idto_tpu/utils/find_resource.py``).

The port has no data files of its own: model files, meshes and YAML
configs are read by path from the JAX package's directory beside it
(without importing it).  ``find_resource`` maps ``idto_tpu/...`` paths, or
paths relative to that directory, to absolute filenames, whatever the
working directory.
"""
from __future__ import annotations

import os

_DATA_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "idto_tpu",
)


def find_resource(path: str) -> str:
    """Resolve a path like ``idto_tpu/assets/spinner_friction.urdf`` (or
    ``assets/spinner_friction.urdf``) to an absolute filename; raise
    FileNotFoundError if there is no such file."""
    rel = path[len("idto_tpu/"):] if path.startswith("idto_tpu/") else path
    full = os.path.join(_DATA_ROOT, rel)
    if not os.path.exists(full):
        raise FileNotFoundError(
            f"Resource '{path}' not found (looked at {full})")
    return full
