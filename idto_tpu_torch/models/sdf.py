"""SDF parser -> :class:`ModelBuilder` (counterpart of
``idto_tpu/models/sdf.py``).

The SDF 1.7 subset of the manipulation and humanoid models:

  * ``<link>`` poses in the model frame, with ``relative_to='<link>'``
    frame references (no explicit ``<frame>`` elements),
  * ``<joint>`` types: revolute, continuous, prismatic, fixed; the joint
    ``<pose>`` is relative to the *child* link frame (SDF convention,
    unlike URDF),
  * ``<axis><xyz>`` in the joint frame, or in the model frame with
    ``expressed_in="__model__"``,
  * actuators: a joint whose ``<axis><limit><effort>`` is nonzero or
    absent is actuated (Drake's SDF convention),
  * ``<inertial>`` with child-element mass and inertia (re-expressed from
    the inertial frame into the link frame),
  * collision geometries: sphere, box, capsule, cylinder, and ``<mesh>``
    through ``models/mesh.py::mesh_to_collision``,
  * ``drake:collision_filter_group`` exclusion groups.

Frames: SDF decouples the child-link frame from the joint frame (URDF
welds them).  Each jointed link's *canonical* frame is its joint frame J;
its inertial and collision data (authored in the child-link frame C) are
re-expressed by X_JC = inv(X_CJ), the URDF-style convention
:class:`ModelBuilder` speaks.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

from idto_tpu_torch.models.mesh import mesh_to_collision
from idto_tpu_torch.models.model import GeomType, JointType, ModelBuilder
from idto_tpu_torch.models.rotations import rpy_to_rot_np
from idto_tpu_torch.models.urdf import _geom_names_of_link, parse_urdf_file

_JOINT_TYPES = {
    "fixed": JointType.FIXED,
    "revolute": JointType.REVOLUTE,
    "continuous": JointType.REVOLUTE,
    "prismatic": JointType.PRISMATIC,
}


def _floats(s: str) -> np.ndarray:
    return np.array([float(x) for x in s.replace(",", " ").split()])


def _pose_of(elem: Optional[ET.Element]):
    """(R, p) from an SDF ``<pose>x y z roll pitch yaw</pose>`` element."""
    if elem is None or not (elem.text or "").strip():
        return np.eye(3), np.zeros(3)
    vals = _floats(elem.text)
    return rpy_to_rot_np(vals[3:6]), vals[0:3]


def _compose(Xa, Xb):
    Ra, pa = Xa
    Rb, pb = Xb
    return Ra @ Rb, pa + Ra @ pb


def _inv(X):
    R, p = X
    return R.T, -(R.T @ p)


def _text(parent: Optional[ET.Element], tag: str, default: str = "") -> str:
    if parent is None:
        return default
    el = parent.find(tag)
    return el.text.strip() if el is not None and el.text else default


def _parse_inertial(link_el: ET.Element):
    """(mass, com_in_link, I_in_link) from SDF child-element syntax."""
    inertial = link_el.find("inertial")
    if inertial is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    R_li, p_li = _pose_of(inertial.find("pose"))
    mass = float(_text(inertial, "mass", "0"))
    in_el = inertial.find("inertia")
    if in_el is None:
        I = np.zeros((3, 3))
    else:
        ixx = float(_text(in_el, "ixx", "0"))
        iyy = float(_text(in_el, "iyy", "0"))
        izz = float(_text(in_el, "izz", "0"))
        ixy = float(_text(in_el, "ixy", "0"))
        ixz = float(_text(in_el, "ixz", "0"))
        iyz = float(_text(in_el, "iyz", "0"))
        I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    return mass, p_li, R_li @ I @ R_li.T


def _parse_geometry(geom_el: Optional[ET.Element], mesh_dir=None):
    """(GeomType, params, R_extra, p_extra), or None for no geometry.

    A ``<mesh>`` resolves its ``<uri>`` against ``mesh_dir``; with no
    ``mesh_dir`` or no such file it gives no geometry."""
    if geom_el is None:
        return None
    eye, zero = np.eye(3), np.zeros(3)
    for child in geom_el:
        tag = child.tag.rsplit("}", 1)[-1]
        if tag == "sphere":
            return GeomType.SPHERE, [float(_text(child, "radius"))], eye, zero
        if tag == "box":
            size = _floats(_text(child, "size"))
            return GeomType.BOX, list(size / 2.0), eye, zero
        if tag == "capsule":
            return GeomType.CAPSULE, [
                float(_text(child, "radius")),
                float(_text(child, "length")) / 2.0,
            ], eye, zero
        if tag == "cylinder":
            return GeomType.CYLINDER, [
                float(_text(child, "radius")),
                float(_text(child, "length")) / 2.0,
            ], eye, zero
        if tag == "mesh":
            if mesh_dir is None:
                return None
            uri = _text(child, "uri")
            scale_txt = _text(child, "scale")
            scale = _floats(scale_txt) if scale_txt else None
            path = uri if os.path.isabs(uri) else os.path.join(mesh_dir, uri)
            if not os.path.exists(path):
                return None
            return mesh_to_collision(path, scale=scale)
    return None


def parse_sdf_string(
    text: str,
    builder: Optional[ModelBuilder] = None,
    *,
    floating_base: Optional[bool] = None,
    prefix: str = "",
    R_base=None,
    p_base=None,
    gravity_enabled: bool = True,
    mesh_dir=None,
) -> ModelBuilder:
    """Parse an SDF model into a ModelBuilder (``.finalize()`` -> Model).

    Keyword semantics match :func:`idto_tpu_torch.models.urdf.parse_urdf_string`:
    ``floating_base=None`` gives root links a free (floating) joint like
    Drake; ``False`` welds them to the world; ``R_base``/``p_base`` pose
    the model in the world (composed with the SDF ``<model><pose>``).
    """
    if "drake:" in text and "xmlns:drake" not in text:
        text = text.replace("<sdf", '<sdf xmlns:drake="http://drake.mit.edu"', 1)
    root = ET.fromstring(text)
    model_el = root.find("model") if root.tag.endswith("sdf") else root
    if model_el is None:
        raise ValueError("SDF file has no <model> element")
    builder = builder or ModelBuilder()

    X_WM = (
        np.eye(3) if R_base is None else np.asarray(R_base, float),
        np.zeros(3) if p_base is None else np.asarray(p_base, float),
    )
    X_WM = _compose(X_WM, _pose_of(model_el.find("pose")))

    def pfx(name: str) -> str:
        return name if name == "world" else prefix + name

    links = {l.get("name"): l for l in model_el.findall("link")}
    joints = list(model_el.findall("joint"))
    joint_of_child = {}
    for j in joints:
        joint_of_child[_text(j, "child")] = j

    # ---- resolve every link's model-frame pose (zero configuration) ----
    X_ML: dict[str, tuple] = {}

    def resolve(name: str, seen=()):
        if name in X_ML:
            return X_ML[name]
        if name in seen:
            raise ValueError(f"SDF pose relative_to cycle at {name!r}")
        el = links[name]
        pose_el = el.find("pose")
        X = _pose_of(pose_el)
        rel = pose_el.get("relative_to") if pose_el is not None else None
        if rel and rel not in ("__model__",):
            if rel not in links:
                raise ValueError(
                    f"unsupported SDF pose relative_to target {rel!r} on "
                    f"link {name!r} (only sibling link names and "
                    f"'__model__' are supported)"
                )
            X = _compose(resolve(rel, seen + (name,)), X)
        X_ML[name] = X
        return X

    for name in links:
        resolve(name)

    # ---- topological order over the joint graph ----
    done = {"world"}
    order: list[str] = []
    remaining = [n for n in links]
    while remaining:
        progress = False
        for name in list(remaining):
            j = joint_of_child.get(name)
            parent = _text(j, "parent", "world") if j is not None else "world"
            if parent in done:
                order.append(name)
                done.add(name)
                remaining.remove(name)
                progress = True
        if not progress:
            raise ValueError(f"SDF kinematic loop or dangling links: {remaining}")

    # World-frame pose of each link's *canonical* frame (see module doc).
    X_W_canon: dict[str, tuple] = {"world": (np.eye(3), np.zeros(3))}

    for name in order:
        link_el = links[name]
        mass, com_C, I_C = _parse_inertial(link_el)
        X_WC = _compose(X_WM, X_ML[name])  # child-link frame in world
        j = joint_of_child.get(name)

        if j is None:
            # Root link: free body (or welded if floating_base=False).
            jt = (
                JointType.FLOATING
                if (floating_base is None or floating_base)
                else JointType.FIXED
            )
            X_JC = (np.eye(3), np.zeros(3))  # canonical frame == link frame
            R_pj, p_pj = X_WC
            builder.add_link(
                pfx(name), "world", jt,
                joint_name=pfx(f"{name}_base"),
                R_pj=R_pj, p_pj=p_pj,
                mass=mass, com=com_C, inertia=I_C,
                gravity_enabled=gravity_enabled,
            )
            X_W_canon[name] = X_WC
        else:
            jtype_name = _text(j, "type") or j.get("type")
            if jtype_name not in _JOINT_TYPES:
                raise ValueError(
                    f"unsupported SDF joint type {jtype_name!r} on joint "
                    f"{j.get('name')!r} (supported: "
                    f"{sorted(_JOINT_TYPES)})"
                )
            jt = _JOINT_TYPES[jtype_name]
            # SDF: the joint <pose> is relative to the CHILD link frame.
            X_CJ = _pose_of(j.find("pose"))
            X_JC = _inv(X_CJ)
            X_WJ = _compose(X_WC, X_CJ)
            parent = _text(j, "parent", "world")
            if parent not in X_W_canon:
                raise ValueError(
                    f"SDF joint {j.get('name')!r} names parent {parent!r}, "
                    "which is not a parsed link (frame-name parents are not "
                    "supported)"
                )
            X_PJ = _compose(_inv(X_W_canon[parent]), X_WJ)
            axis_el = j.find("axis")
            xyz_el = axis_el.find("xyz") if axis_el is not None else None
            axis = _floats(xyz_el.text) if xyz_el is not None and xyz_el.text \
                else np.array([0.0, 0.0, 1.0])
            if xyz_el is not None and xyz_el.get("expressed_in") == "__model__":
                # Re-express the model-frame axis in the joint frame.
                R_WJ = X_WJ[0]
                R_WM = X_WM[0]
                axis = R_WJ.T @ (R_WM @ axis)
            dyn = axis_el.find("dynamics") if axis_el is not None else None
            damping = float(_text(dyn, "damping", "0"))
            # Re-express inertial data in the canonical (joint) frame.
            R_JC, p_JC = X_JC
            com_J = p_JC + R_JC @ com_C
            I_J = R_JC @ I_C @ R_JC.T
            builder.add_link(
                pfx(name), pfx(parent), jt,
                joint_name=pfx(j.get("name")),
                R_pj=X_PJ[0], p_pj=X_PJ[1],
                axis=axis, damping=damping,
                mass=mass, com=com_J, inertia=I_J,
                gravity_enabled=gravity_enabled,
            )
            X_W_canon[name] = X_WJ
            # Actuated iff the effort limit is nonzero (Drake convention).
            # The SDF spec default for an absent <limit><effort> is -1
            # (unlimited), which Drake maps to an actuated joint.
            limit = axis_el.find("limit") if axis_el is not None else None
            effort = float(_text(limit, "effort", "-1"))
            if jt != JointType.FIXED and effort != 0.0:
                builder.add_actuator(pfx(j.get("name")))

        # Collision geometry, re-expressed into the canonical frame.
        for ci, col in enumerate(link_el.findall("collision")):
            parsed = _parse_geometry(col.find("geometry"), mesh_dir)
            if parsed is None:
                continue
            gtype, params, R_g, p_g = parsed
            X_C_col = _pose_of(col.find("pose"))
            R, p = _compose(_compose(X_JC, X_C_col), (R_g, p_g))
            builder.add_geometry(
                pfx(name), gtype, params, R=R, p=p,
                name=pfx(col.get("name", f"{name}_collision_{ci}")),
            )

    # drake:collision_filter_group exclusion.
    groups: dict[str, list[str]] = {}
    ignores: list[tuple[str, str]] = []
    for g in model_el.iter():
        if g.tag.endswith("collision_filter_group"):
            gname = g.get("name")
            members = []
            for m in g:
                if m.tag.endswith("member"):
                    members.append(m.get("link") or (m.text or "").strip())
                if m.tag.endswith("ignored_collision_filter_group"):
                    ignores.append((gname, m.get("name") or (m.text or "").strip()))
            groups[gname] = members
    groups = {g: [pfx(m) for m in ms] for g, ms in groups.items()}
    for ga, gb in ignores:
        for la in groups.get(ga, []):
            for lb in groups.get(gb, []):
                if la == lb:
                    continue
                for na in _geom_names_of_link(builder, la):
                    for nb in _geom_names_of_link(builder, lb):
                        builder.exclude_collision(na, nb)
    return builder


def parse_sdf_file(path, **kwargs) -> ModelBuilder:
    kwargs.setdefault("mesh_dir", os.path.dirname(os.path.abspath(str(path))))
    with open(path) as f:
        return parse_sdf_string(f.read(), **kwargs)


def parse_model_file(path, **kwargs) -> ModelBuilder:
    """URDF or SDF by the file's extension (``.sdf``; anything else is
    read as URDF)."""
    p = str(path)
    if p.endswith(".sdf"):
        return parse_sdf_file(path, **kwargs)
    return parse_urdf_file(path, **kwargs)
