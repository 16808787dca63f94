"""URDF parser -> :class:`ModelBuilder` (counterpart of
``idto_tpu/models/urdf.py``).

Supported: fixed / revolute / continuous / prismatic / planar / floating
joints (plus an implicit floating joint for root links, Drake's free-body
convention), inertials re-expressed in the link frame, collision geometry
(sphere, box, capsule, cylinder, and ``<mesh>`` files reduced by
``models/mesh.py::mesh_to_collision`` to a convex hull or a fitted
primitive), transmissions as actuators, and
``drake:collision_filter_group`` exclusions.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

from idto_tpu_torch.models.mesh import mesh_to_collision
from idto_tpu_torch.models.model import GeomType, JointType, ModelBuilder
from idto_tpu_torch.models.rotations import make_frame_from_z, rpy_to_rot_np

_JOINT_TYPES = {
    "fixed": JointType.FIXED,
    "revolute": JointType.REVOLUTE,
    "continuous": JointType.REVOLUTE,
    "prismatic": JointType.PRISMATIC,
    "planar": JointType.PLANAR,
    "floating": JointType.FLOATING,
}


def _floats(s: str) -> np.ndarray:
    return np.array([float(x) for x in s.replace(",", " ").split()])


def _origin(elem: Optional[ET.Element]):
    """(R, p) of an <origin xyz rpy> element (identity if None)."""
    if elem is None:
        return np.eye(3), np.zeros(3)
    xyz = _floats(elem.get("xyz", "0 0 0"))
    rpy = _floats(elem.get("rpy", "0 0 0"))
    return rpy_to_rot_np(rpy), xyz


def _parse_inertial(link: ET.Element):
    inertial = link.find("inertial")
    if inertial is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    R, com = _origin(inertial.find("origin"))
    mass_el = inertial.find("mass")
    mass = float(mass_el.get("value")) if mass_el is not None else 0.0
    in_el = inertial.find("inertia")
    if in_el is None:
        I = np.zeros((3, 3))
    else:
        g = {k: float(in_el.get(k, 0)) for k in
             ("ixx", "iyy", "izz", "ixy", "ixz", "iyz")}
        I = np.array([
            [g["ixx"], g["ixy"], g["ixz"]],
            [g["ixy"], g["iyy"], g["iyz"]],
            [g["ixz"], g["iyz"], g["izz"]],
        ])
    return mass, com, R @ I @ R.T


def _parse_geometry(geom_el: ET.Element, mesh_dir: Optional[str] = None):
    """(GeomType, params, R_extra, p_extra), or None for no geometry.

    R_extra/p_extra compose inside the collision origin: the identity for
    primitives, the fitted primitive's pose for a mesh.  A ``<mesh>``
    resolves against ``mesh_dir``; with no ``mesh_dir``, no filename or no
    such file it gives no geometry.  A CONVEX mesh carries its hull
    vertices in the params slot."""
    eye, zero = np.eye(3), np.zeros(3)
    for child in geom_el:
        tag = child.tag.rsplit("}", 1)[-1]
        if tag == "sphere":
            return GeomType.SPHERE, [float(child.get("radius"))], eye, zero
        if tag == "box":
            return GeomType.BOX, list(_floats(child.get("size")) / 2.0), \
                eye, zero
        if tag in ("capsule", "cylinder"):
            gt = GeomType.CAPSULE if tag == "capsule" else GeomType.CYLINDER
            return gt, [float(child.get("radius")),
                        float(child.get("length")) / 2.0], eye, zero
        if tag == "mesh":
            fname = child.get("filename")
            if mesh_dir is None or not fname:
                return None
            scale_attr = child.get("scale")
            scale = _floats(scale_attr) if scale_attr else None
            path = fname if os.path.isabs(fname) else os.path.join(
                mesh_dir, fname)
            if not os.path.exists(path):
                return None
            return mesh_to_collision(path, scale=scale)
    return None


def parse_urdf_string(
    text: str,
    builder: Optional[ModelBuilder] = None,
    *,
    floating_base: Optional[bool] = None,
    prefix: str = "",
    R_base=None,
    p_base=None,
    gravity_enabled: bool = True,
    mesh_dir: Optional[str] = None,
) -> ModelBuilder:
    """Parse URDF text into ``builder`` (a new ModelBuilder if None;
    ``.finalize()`` gives the Model).  ``mesh_dir`` resolves relative
    ``<mesh filename>`` references (``parse_urdf_file`` passes the file's
    directory); without it mesh collisions are skipped.

    ``floating_base=None`` gives root links without a joint to the world a
    floating joint; False welds them.  ``prefix`` goes before every link,
    joint and geometry name, so one file can be parsed twice into one
    builder (dual_jaco).  ``R_base``/``p_base`` pose the model's root in the
    world: they compose into the joints of links whose parent is the world.
    ``gravity_enabled=False`` switches gravity off on every link this call
    adds."""
    if "drake:" in text and "xmlns:drake" not in text:
        text = text.replace(
            "<robot", '<robot xmlns:drake="http://drake.mit.edu"', 1
        )
    root = ET.fromstring(text)
    builder = builder or ModelBuilder()
    R_base = np.eye(3) if R_base is None else np.asarray(R_base, float)
    p_base = np.zeros(3) if p_base is None else np.asarray(p_base, float)

    def pfx(name: str) -> str:
        return name if name == "world" else prefix + name

    links = {l.get("name"): l for l in root.findall("link")}
    joint_of_child = {
        j.find("child").get("link"): j for j in root.findall("joint")
    }

    # Topological order: repeatedly add links whose parent is placed.
    done: set[str] = {"world"}
    order: list[str] = []
    remaining = [name for name in links if name != "world"]
    while remaining:
        progress = False
        for name in list(remaining):
            j = joint_of_child.get(name)
            parent = j.find("parent").get("link") if j is not None else "world"
            if parent in done:
                order.append(name)
                done.add(name)
                remaining.remove(name)
                progress = True
        if not progress:
            raise ValueError(f"URDF kinematic loop or dangling links: {remaining}")

    for name in order:
        link_el = links[name]
        mass, com, I = _parse_inertial(link_el)
        j = joint_of_child.get(name)
        if j is None:
            jt = (
                JointType.FLOATING
                if (floating_base is None or floating_base)
                else JointType.FIXED
            )
            builder.add_link(
                pfx(name), "world", jt, joint_name=pfx(f"{name}_base"),
                R_pj=R_base, p_pj=p_base, mass=mass, com=com, inertia=I,
                gravity_enabled=gravity_enabled,
            )
        else:
            jt = _JOINT_TYPES[j.get("type")]
            R_pj, p_pj = _origin(j.find("origin"))
            if j.find("parent").get("link") == "world":
                R_pj = R_base @ R_pj
                p_pj = p_base + R_base @ p_pj
            axis_el = j.find("axis")
            axis = (
                _floats(axis_el.get("xyz"))
                if axis_el is not None
                else np.array([0.0, 0.0, 1.0])
            )
            dyn = j.find("dynamics")
            damping = float(dyn.get("damping", 0.0)) if dyn is not None else 0.0
            if jt == JointType.PLANAR:
                # Realign the joint frame so that z == axis (Drake behavior).
                R_pj = R_pj @ make_frame_from_z(axis / np.linalg.norm(axis))
                axis = np.array([0.0, 0.0, 1.0])
            builder.add_link(
                pfx(name), pfx(j.find("parent").get("link")), jt,
                joint_name=pfx(j.get("name")), R_pj=R_pj, p_pj=p_pj, axis=axis,
                damping=damping, mass=mass, com=com, inertia=I,
                gravity_enabled=gravity_enabled,
            )

        for ci, col in enumerate(link_el.findall("collision")):
            parsed = _parse_geometry(col.find("geometry"), mesh_dir)
            if parsed is None:
                continue
            gtype, params, R_g, p_g = parsed
            R, p = _origin(col.find("origin"))
            builder.add_geometry(
                pfx(name), gtype, params, R=R @ R_g, p=p + R @ p_g,
                name=pfx(col.get("name", f"{name}_collision_{ci}")),
            )

    for trans in root.findall("transmission"):
        jel = trans.find("joint")
        if jel is not None:
            jname = jel.get("name")
        else:
            act = trans.find("actuator")
            jname = act.get("name") if act is not None else None
        if jname is not None:
            builder.add_actuator(pfx(jname))

    # drake:collision_filter_group: exclude every geometry pair between the
    # member links of groups that ignore each other.
    groups: dict[str, list[str]] = {}
    ignores: list[tuple[str, str]] = []
    for g in root.iter():
        if g.tag.endswith("collision_filter_group"):
            gname = g.get("name")
            members = []
            for m in g:
                if m.tag.endswith("member"):
                    members.append(m.get("link"))
                if m.tag.endswith("ignored_collision_filter_group"):
                    ignores.append((gname, m.get("name")))
            groups[gname] = [pfx(m) for m in members]
    for ga, gb in ignores:
        for la in groups.get(ga, []):
            for lb in groups.get(gb, []):
                if la == lb:
                    continue
                for na in _geom_names_of_link(builder, la):
                    for nb in _geom_names_of_link(builder, lb):
                        builder.exclude_collision(na, nb)
    return builder


def _geom_names_of_link(builder: ModelBuilder, link: str) -> list[str]:
    try:
        idx = builder.link_index(link)
    except ValueError:
        return []
    return [
        n for n, b in zip(builder._geom_names, builder._geom_bodies)
        if b == idx
    ]


def parse_urdf_file(path, **kwargs) -> ModelBuilder:
    kwargs.setdefault("mesh_dir", os.path.dirname(os.path.abspath(
        os.fspath(path))))
    with open(os.fspath(path)) as f:
        return parse_urdf_string(f.read(), **kwargs)
