"""Mesh files -> collision geometry (counterpart of
``idto_tpu/models/mesh.py``; numpy only).

A mesh becomes either the convex hull of its vertices (GeomType.CONVEX,
the default) or a fitted bounding primitive (sphere, box or capsule of
least volume), as ``mesh_to_collision``'s mode says; the environment
variable ``IDTO_MESH_COLLISION`` sets the mode when the caller does not.

Formats: Wavefront OBJ (``v`` records) and STL (ascii and binary).
"""
from __future__ import annotations

import os
import struct

import numpy as np

from idto_tpu_torch.models.model import GeomType
from idto_tpu_torch.models.rotations import make_frame_from_z


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------
def load_obj_vertices(path) -> np.ndarray:
    """Vertex positions (n, 3) from a Wavefront OBJ file."""
    verts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    if not verts:
        raise ValueError(f"no vertices in OBJ file {path}")
    return np.asarray(verts, dtype=np.float64)


def load_stl_vertices(path) -> np.ndarray:
    """Vertex positions (n, 3) from an STL file (ascii or binary)."""
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        data = f.read()
    if head == b"solid" and b"facet" in data[:500]:
        verts = []
        for line in data.decode("ascii", errors="ignore").splitlines():
            parts = line.split()
            if len(parts) == 4 and parts[0] == "vertex":
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        if not verts:
            raise ValueError(f"no vertices in ascii STL {path}")
        return np.asarray(verts, dtype=np.float64)
    # Binary STL: 80-byte header, uint32 triangle count, 50 bytes/triangle.
    # Each 50-byte record: normal (3f), 3 vertices (9f), uint16 attr.  The
    # stride is not a multiple of 4 floats, so view the records as raw bytes
    # and reinterpret the 36-byte vertex slab per record.
    (ntri,) = struct.unpack_from("<I", data, 80)
    recs = np.frombuffer(data, dtype=np.uint8, count=ntri * 50, offset=84)
    recs = recs.reshape(ntri, 50)[:, 12:48]  # skip normal, drop attr
    out = recs.reshape(-1).view("<f4").astype(np.float64)
    return out.reshape(-1, 3)


def load_mesh_vertices(path) -> np.ndarray:
    p = str(path)
    if p.lower().endswith(".obj"):
        return load_obj_vertices(p)
    if p.lower().endswith(".stl"):
        return load_stl_vertices(p)
    raise ValueError(f"unsupported mesh format: {p}")


# ---------------------------------------------------------------------------
# Primitive fitting
# ---------------------------------------------------------------------------
def fit_sphere(verts: np.ndarray):
    """Ritter bounding sphere: (center (3,), radius)."""
    p0 = verts[0]
    p1 = verts[np.argmax(np.linalg.norm(verts - p0, axis=1))]
    p2 = verts[np.argmax(np.linalg.norm(verts - p1, axis=1))]
    c = 0.5 * (p1 + p2)
    r = 0.5 * np.linalg.norm(p2 - p1)
    # Grow toward the farthest uncovered vertex until all are inside; each
    # pass is a vectorized distance sweep and r is strictly increasing, so
    # this terminates (typically a handful of passes).
    while True:
        d = np.linalg.norm(verts - c, axis=1)
        i = int(np.argmax(d))
        if d[i] <= r + 1e-12 * max(r, 1.0):
            break
        r_new = 0.5 * (r + d[i])
        c = c + (verts[i] - c) * (r_new - r) / d[i]
        r = r_new
    return c, float(r)


def _pca_frame(verts: np.ndarray):
    """(R, center): columns of R are principal axes, largest-variance first."""
    center = verts.mean(axis=0)
    cov = np.cov((verts - center).T)
    w, V = np.linalg.eigh(cov)
    order = np.argsort(w)[::-1]
    R = V[:, order]
    if np.linalg.det(R) < 0:
        R[:, 2] = -R[:, 2]
    return R, center


def fit_box(verts: np.ndarray):
    """PCA-oriented bounding box: (R (3,3), center (3,), half_extents (3,))."""
    R, _ = _pca_frame(verts)
    local = verts @ R
    lo, hi = local.min(axis=0), local.max(axis=0)
    half = 0.5 * (hi - lo)
    center_local = 0.5 * (hi + lo)
    return R, R @ center_local, half


def fit_capsule(verts: np.ndarray):
    """Capsule about the principal axis: (R, center, radius, half_length).

    R maps capsule frame -> mesh frame with the capsule axis on local z
    (the convention of the capsule pair kernels).
    """
    A, _ = _pca_frame(verts)
    axis = A[:, 0]
    center = verts.mean(axis=0)
    rel = verts - center
    s = rel @ axis  # coordinate along axis
    radial = rel - np.outer(s, axis)
    rad_d = np.linalg.norm(radial, axis=1)
    radius = float(rad_d.max())
    mid = 0.5 * (s.max() + s.min())
    center = center + mid * axis
    # Smallest half-length such that every vertex is inside the capsule:
    # a point at (|s|, d) from the center/axis is covered by the end cap
    # iff |s| <= hl + sqrt(r^2 - d^2).
    slack = np.sqrt(np.maximum(radius**2 - rad_d**2, 0.0))
    half_len = float(max(np.max(np.abs(s - mid) - slack), 1e-9))
    R = make_frame_from_z(axis)
    return R, center, radius, half_len


def approximate_mesh(verts: np.ndarray, kind: str = "auto"):
    """Fit a bounding primitive; returns (GeomType, params, R, p).

    ``kind``: 'sphere' | 'box' | 'capsule' | 'auto' (minimum volume of the
    three -- elongated links (cheetah legs) pick capsules, squat bodies
    pick boxes, blobs pick spheres).
    """
    c_s, r_s = fit_sphere(verts)
    R_b, c_b, half = fit_box(verts)
    R_c, c_c, r_c, hl = fit_capsule(verts)
    fits = {
        "sphere": (
            4.0 / 3.0 * np.pi * r_s**3,
            (GeomType.SPHERE, [r_s], np.eye(3), c_s),
        ),
        "box": (
            8.0 * float(np.prod(half)),
            (GeomType.BOX, list(half), R_b, c_b),
        ),
        "capsule": (
            np.pi * r_c**2 * (2 * hl) + 4.0 / 3.0 * np.pi * r_c**3,
            (GeomType.CAPSULE, [r_c, hl], R_c, c_c),
        ),
    }
    if kind != "auto":
        return fits[kind][1]
    return min(fits.values(), key=lambda t: t[0])[1]


def mesh_to_primitive(path, scale=None, kind: str = "auto"):
    """Load a mesh file and fit a primitive: (GeomType, params, R, p)."""
    verts = load_mesh_vertices(path)
    if scale is not None:
        verts = verts * np.asarray(scale, dtype=np.float64)
    return approximate_mesh(verts, kind=kind)


# ---------------------------------------------------------------------------
# Convex hulls (mesh-fidelity collision)
# ---------------------------------------------------------------------------
def _fibonacci_directions(n: int) -> np.ndarray:
    """(n, 3) roughly-uniform unit directions (Fibonacci sphere)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + np.sqrt(5.0)) * i
    return np.stack(
        [
            np.sin(phi) * np.cos(theta),
            np.sin(phi) * np.sin(theta),
            np.cos(phi),
        ],
        axis=1,
    )


def convex_hull_vertices(verts: np.ndarray, max_verts: int = 64) -> np.ndarray:
    """Support-extreme subset of the convex hull of ``verts``.

    For 4 * max_verts roughly-uniform directions, keep the vertex that
    maximizes each direction's support -- every kept point is an exact
    hull vertex, and the hull of the subset is the tightest inner
    approximation whose support matches the mesh in those directions.
    Returns (m, 3) with 4 <= m <= max_verts (padded by the geometry layer,
    not here); degenerate/flat meshes keep whatever extremes exist.  The
    pair kernels that query it are in ``soa/convex.py``.
    """
    verts = np.asarray(verts, dtype=np.float64)
    dirs = _fibonacci_directions(4 * max_verts)
    idx = np.argmax(dirs @ verts.T, axis=1)
    uniq = np.unique(idx)
    hull = verts[uniq]
    if hull.shape[0] > max_verts:
        # Greedy farthest-point decimation keeps the most spread-out
        # support vertices (drops near-duplicates on dense hulls).
        keep = [int(np.argmax(np.linalg.norm(hull - hull.mean(0), axis=1)))]
        d = np.linalg.norm(hull - hull[keep[0]], axis=1)
        for _ in range(max_verts - 1):
            nxt = int(np.argmax(d))
            keep.append(nxt)
            d = np.minimum(d, np.linalg.norm(hull - hull[nxt], axis=1))
        hull = hull[np.asarray(keep)]
    return hull


def mesh_to_convex(path, scale=None, max_verts: int = 64):
    """Load a mesh and reduce it to a convex-hull collision geometry:
    (GeomType.CONVEX, verts (m, 3), R=I, p=0).  The vertices stay in the
    mesh file's frame (the URDF/SDF geometry pose applies on top)."""
    verts = load_mesh_vertices(path)
    if scale is not None:
        verts = verts * np.asarray(scale, dtype=np.float64)
    hull = convex_hull_vertices(verts, max_verts=max_verts)
    return GeomType.CONVEX, hull, np.eye(3), np.zeros(3)


def mesh_to_collision(path, scale=None, mode: str | None = None):
    """Mesh -> collision geometry: (GeomType, params or hull, R, p).

    mode 'convex' (default): the convex hull of the mesh vertices.  mode
    'primitive': the least-volume bounding primitive; 'sphere', 'box' or
    'capsule': that primitive.  ``IDTO_MESH_COLLISION`` gives the mode when
    ``mode`` is None.
    """
    mode = mode or os.environ.get("IDTO_MESH_COLLISION", "convex")
    if mode == "primitive":
        return mesh_to_primitive(path, scale=scale)
    if mode in ("sphere", "box", "capsule"):
        return mesh_to_primitive(path, scale=scale, kind=mode)
    if mode != "convex":
        raise ValueError(f"unknown mesh collision mode {mode!r}")
    return mesh_to_convex(path, scale=scale)
