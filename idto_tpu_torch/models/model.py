"""Multibody model: a kinematic tree with tensor parameters
(counterpart of ``idto_tpu/models/model.py``).

Static topology (joint types, parents, dof offsets, level schedule, pair
list) is plain Python tuples; numeric parameters are tensors.  Conventions
are the JAX package's: link ``i`` is the child of joint ``i``,
``joint_parents[i]`` is the parent link (-1 = world), joints are in
topological order; floating joints use ``q = [qw, qx, qy, qz, x, y, z]``
and ``v = [w_WB_W, v_WB_W]``.

Collision geometry: the primitives and CONVEX hulls of vertex sets
(``models/mesh.py`` reduces a mesh file to one).
"""
from __future__ import annotations

import enum
from typing import Any, Optional, Sequence

import numpy as np
import torch

from idto_tpu_torch.utils.structs import tensor_dataclass


class JointType(enum.IntEnum):
    FIXED = 0
    REVOLUTE = 1
    PRISMATIC = 2
    PLANAR = 3
    FLOATING = 4


JOINT_NQ = {
    JointType.FIXED: 0,
    JointType.REVOLUTE: 1,
    JointType.PRISMATIC: 1,
    JointType.PLANAR: 3,
    JointType.FLOATING: 7,
}
JOINT_NV = {
    JointType.FIXED: 0,
    JointType.REVOLUTE: 1,
    JointType.PRISMATIC: 1,
    JointType.PLANAR: 3,
    JointType.FLOATING: 6,
}


class GeomType(enum.IntEnum):
    SPHERE = 0
    BOX = 1
    CAPSULE = 2
    CYLINDER = 3
    HALFSPACE = 4  # plane through origin of geom frame, +z outward
    CONVEX = 5  # convex hull of a vertex set (CollisionGeoms.verts)


@tensor_dataclass
class CollisionGeoms:
    """Flat collision geometry table.  ``bodies`` holds the link index of
    each geometry (-1 = world); ``params`` packs up to 3 shape numbers
    (sphere [r], box half-extents, capsule/cylinder [r, half_len]);
    ``pairs`` is the static candidate pair list enumerated at build time.
    ``verts`` (ng, VMAX, 3) holds each CONVEX geometry's hull vertices in
    its geometry frame, padded by repeating its first vertex (which leaves
    the hull and every support value unchanged); rows of other geometries
    are zero, and ``verts`` is None when no geometry is CONVEX."""

    types: tuple = ()
    bodies: tuple = ()
    pairs: tuple = ()
    names: tuple = ()
    R: Any = None  # (ng, 3, 3) geom pose in body frame
    p: Any = None  # (ng, 3)
    params: Any = None  # (ng, 3)
    verts: Any = None  # (ng, VMAX, 3) or None

    @property
    def num_geoms(self) -> int:
        return len(self.types)


@tensor_dataclass
class Model:
    # ---- static topology ----
    joint_types: tuple = ()
    joint_parents: tuple = ()
    q_starts: tuple = ()
    v_starts: tuple = ()
    nq: int = 0
    nv: int = 0
    nu: int = 0
    joint_names: tuple = ()
    link_names: tuple = ()
    actuator_joints: tuple = ()  # joint index per actuator
    # levels[d] = joint indices at tree depth d (independent within a level).
    levels: tuple = ()
    # ((type, (j, ...)), ...): joints grouped by type for batched transforms.
    type_groups: tuple = ()

    # ---- numeric parameters ----
    R_pj: Any = None  # (nj, 3, 3) joint frame rotation in parent link frame
    p_pj: Any = None  # (nj, 3)    joint frame origin in parent link frame
    axis: Any = None  # (nj, 3)    joint axis in (aligned) joint frame
    damping: Any = None  # (nv,)
    mass: Any = None  # (nl,)
    com: Any = None  # (nl, 3)
    inertia: Any = None  # (nl, 3, 3) about com, link frame
    B: Any = None  # (nv, nu) actuation matrix
    gravity: Any = None  # (3,)
    grav_scale: Any = None  # (nl,) 1.0, or 0.0 for gravity-disabled links
    geoms: CollisionGeoms = None

    @property
    def num_joints(self) -> int:
        return len(self.joint_types)

    @property
    def num_links(self) -> int:
        return len(self.joint_types)

    def joint_nq(self, j: int) -> int:
        return JOINT_NQ[JointType(self.joint_types[j])]

    def joint_nv(self, j: int) -> int:
        return JOINT_NV[JointType(self.joint_types[j])]

    @property
    def unactuated_vdofs(self) -> tuple:
        """v-dof indices with no actuator."""
        actuated = {self.v_starts[j] for j in self.actuator_joints}
        return tuple(i for i in range(self.nv) if i not in actuated)


class ModelBuilder:
    """Programmatic model construction; ``finalize`` returns a Model."""

    def __init__(self, gravity: Sequence[float] = (0.0, 0.0, -9.81)):
        self._gravity = np.asarray(gravity, dtype=np.float64)
        self._joint_types: list[JointType] = []
        self._joint_parents: list[int] = []
        self._joint_names: list[str] = []
        self._link_names: list[str] = []
        self._R_pj: list[np.ndarray] = []
        self._p_pj: list[np.ndarray] = []
        self._axis: list[np.ndarray] = []
        self._damping: list[np.ndarray] = []  # per joint, length nv_j
        self._mass: list[float] = []
        self._com: list[np.ndarray] = []
        self._inertia: list[np.ndarray] = []
        self._actuators: list[int] = []
        self._grav_on: list[bool] = []
        self._geom_types: list[GeomType] = []
        self._geom_bodies: list[int] = []
        self._geom_R: list[np.ndarray] = []
        self._geom_p: list[np.ndarray] = []
        self._geom_params: list[np.ndarray] = []
        self._geom_verts: list[Optional[np.ndarray]] = []
        self._geom_names: list[str] = []
        self._pair_filter: list[tuple] = []

    def link_index(self, name: str) -> int:
        if name in ("world", "WorldBody"):
            return -1
        return self._link_names.index(name)

    def add_link(
        self,
        name: str,
        parent: str,
        joint_type: JointType,
        *,
        joint_name: Optional[str] = None,
        R_pj: Optional[np.ndarray] = None,
        p_pj: Optional[np.ndarray] = None,
        axis: Sequence[float] = (0.0, 0.0, 1.0),
        damping: float | Sequence[float] = 0.0,
        mass: float = 0.0,
        com: Sequence[float] = (0.0, 0.0, 0.0),
        inertia: Optional[np.ndarray] = None,
        gravity_enabled: bool = True,
    ) -> int:
        """Add a link connected to ``parent`` by a new joint; returns index."""
        parent_idx = self.link_index(parent)
        idx = len(self._link_names)
        if parent_idx >= idx:
            raise ValueError("links must be added in topological order")
        jt = JointType(joint_type)
        self._joint_types.append(jt)
        self._joint_parents.append(parent_idx)
        self._joint_names.append(joint_name or f"{name}_joint")
        self._link_names.append(name)
        self._R_pj.append(
            np.eye(3) if R_pj is None else np.asarray(R_pj, dtype=np.float64)
        )
        self._p_pj.append(
            np.zeros(3) if p_pj is None else np.asarray(p_pj, dtype=np.float64)
        )
        ax = np.asarray(axis, dtype=np.float64)
        n = np.linalg.norm(ax)
        self._axis.append(ax / n if n > 0 else ax)
        nv_j = JOINT_NV[jt]
        d = np.asarray(damping, dtype=np.float64)
        if d.ndim == 0:
            d = np.full(nv_j, float(d))
        if d.shape != (nv_j,):
            raise ValueError(f"damping must have {nv_j} entries")
        self._damping.append(d)
        self._mass.append(float(mass))
        self._com.append(np.asarray(com, dtype=np.float64))
        self._inertia.append(
            np.zeros((3, 3))
            if inertia is None
            else np.asarray(inertia, dtype=np.float64)
        )
        self._grav_on.append(bool(gravity_enabled))
        return idx

    def set_gravity(self, gravity) -> None:
        """Replace the gravity vector (allegro_hand's upside-down variant)."""
        self._gravity = np.asarray(gravity, dtype=np.float64)

    def set_gravity_enabled(self, link_name: str, enabled: bool) -> None:
        """Switch gravity on one link on or off (``grav_scale`` 1 or 0)."""
        self._grav_on[self.link_index(link_name)] = bool(enabled)

    def add_actuator(self, joint_name: str) -> None:
        self._actuators.append(self._joint_names.index(joint_name))

    def add_geometry(
        self,
        body: str,
        gtype: GeomType,
        params: Sequence[float] = (),
        *,
        R: Optional[np.ndarray] = None,
        p: Sequence[float] = (0.0, 0.0, 0.0),
        name: str = "",
        verts: Optional[np.ndarray] = None,
    ) -> int:
        """``verts`` (m, 3) is required for GeomType.CONVEX (the convex hull
        of the points, in the geometry frame) and ignored otherwise; the
        URDF and SDF parsers pass a hull in the ``params`` slot instead
        (``models/mesh.py::mesh_to_convex``'s return), which is read the
        same way."""
        idx = len(self._geom_types)
        gtype = GeomType(gtype)
        if gtype == GeomType.CONVEX:
            if verts is None:
                verts, params = params, ()
            verts = np.asarray(verts, dtype=np.float64)
            if verts.ndim != 2 or verts.shape[1] != 3:
                raise ValueError("CONVEX geometry requires verts (m, 3)")
        else:
            verts = None
        self._geom_types.append(gtype)
        self._geom_bodies.append(self.link_index(body))
        self._geom_R.append(np.eye(3) if R is None else np.asarray(R))
        self._geom_p.append(np.asarray(p, dtype=np.float64))
        prm = np.zeros(3)
        prm[: len(params)] = params
        self._geom_params.append(prm)
        self._geom_verts.append(verts)
        self._geom_names.append(name or f"geom_{idx}")
        return idx

    def exclude_collision(self, name_a: str, name_b: str) -> None:
        self._pair_filter.append((name_a, name_b))

    def finalize(self, dtype=torch.float64, device="cuda") -> Model:
        nj = len(self._joint_types)
        q_starts, v_starts = [], []
        nq = nv = 0
        for jt in self._joint_types:
            q_starts.append(nq)
            v_starts.append(nv)
            nq += JOINT_NQ[jt]
            nv += JOINT_NV[jt]
        nu = len(self._actuators)
        Bmat = np.zeros((nv, nu))
        for a, j in enumerate(self._actuators):
            if JOINT_NV[self._joint_types[j]] != 1:
                raise ValueError("only single-dof joints can be actuated")
            Bmat[v_starts[j], a] = 1.0
        damping = np.concatenate(self._damping) if nv else np.zeros(0)

        depth = [0] * nj
        for j, p in enumerate(self._joint_parents):
            depth[j] = 0 if p < 0 else depth[p] + 1
        levels = tuple(
            tuple(j for j in range(nj) if depth[j] == d)
            for d in range(max(depth, default=-1) + 1)
        )
        groups: dict = {}
        for j, jt in enumerate(self._joint_types):
            groups.setdefault(int(jt), []).append(j)
        type_groups = tuple((t, tuple(js)) for t, js in sorted(groups.items()))

        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        return Model(
            levels=levels,
            type_groups=type_groups,
            joint_types=tuple(int(jt) for jt in self._joint_types),
            joint_parents=tuple(self._joint_parents),
            q_starts=tuple(q_starts),
            v_starts=tuple(v_starts),
            nq=nq,
            nv=nv,
            nu=nu,
            joint_names=tuple(self._joint_names),
            link_names=tuple(self._link_names),
            actuator_joints=tuple(self._actuators),
            R_pj=t(np.stack(self._R_pj)),
            p_pj=t(np.stack(self._p_pj)),
            axis=t(np.stack(self._axis)),
            damping=t(damping),
            mass=t(self._mass),
            com=t(np.stack(self._com)),
            inertia=t(np.stack(self._inertia)),
            B=t(Bmat),
            gravity=t(self._gravity),
            grav_scale=t(np.asarray(self._grav_on, dtype=np.float64)),
            geoms=self._finalize_geoms(t),
        )

    def _finalize_geoms(self, t) -> CollisionGeoms:
        ng = len(self._geom_types)
        if ng == 0:
            return CollisionGeoms(
                R=t(np.zeros((0, 3, 3))), p=t(np.zeros((0, 3))),
                params=t(np.zeros((0, 3))),
            )
        filtered = set()
        for a, b in self._pair_filter:
            ia = self._geom_names.index(a)
            ib = self._geom_names.index(b)
            filtered.add((min(ia, ib), max(ia, ib)))
        pairs = tuple(
            (i, j)
            for i in range(ng)
            for j in range(i + 1, ng)
            # same body never collides with itself
            if self._geom_bodies[i] != self._geom_bodies[j]
            and (i, j) not in filtered
        )
        hulls = [v for v in self._geom_verts if v is not None]
        verts = None
        if hulls:
            stacked = np.zeros((ng, max(v.shape[0] for v in hulls), 3))
            for i, v in enumerate(self._geom_verts):
                if v is not None:
                    stacked[i, : v.shape[0]] = v
                    stacked[i, v.shape[0]:] = v[0]
            verts = t(stacked)
        return CollisionGeoms(
            types=tuple(int(g) for g in self._geom_types),
            bodies=tuple(self._geom_bodies),
            pairs=pairs,
            names=tuple(self._geom_names),
            R=t(np.stack(self._geom_R)),
            p=t(np.stack(self._geom_p)),
            params=t(np.stack(self._geom_params)),
            verts=verts,
        )
