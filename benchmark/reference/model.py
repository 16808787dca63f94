"""The plain reference's multibody model, read from the configuration's
URDF copies and the bodies its file adds, with nothing taken from the
program.

Conventions (those of the IDTO examples): the links of each URDF in
topological order, each the child of one joint; a root link without a
joint to the world gets a floating joint with q = [qw, qx, qy, qz, x, y,
z] and v = [angular velocity in world, origin velocity in world];
``continuous`` is ``revolute``; a ``prismatic`` joint has one q, the
child's translation along the axis of the joint frame; a ``planar`` joint
has q = [x, y, theta] in a joint frame turned so that its z is the URDF
axis (the first two columns completed from the axis as Drake's
MakeFromOneUnitVector does); joint limits are not read; inertias are
re-expressed in the link frame about the centre of mass; collisions are
spheres, boxes and capsules (``capsule`` or ``drake:capsule``, its axis the
collision frame's z); transmissions name the actuated joints, in order.

``model.urdf`` is a path under the benchmark, or a list of instances
``{"path", "prefix", "rpy", "xyz"}`` read in turn into one model: the prefix goes before every link, joint and collision name;
rpy and xyz pose the instance in the world, composed into the joint of
each link whose parent is the world and into a floating root's frame;
actuators follow the instances in order, each in its file's
transmission order.  ``model.gravity_enabled`` (default true) is the
gravity scale, 1 or 0, of every link the URDFs add; the bodies of ``model.added`` (``free_sphere``, ``free_box``,
``ground_box``) always feel gravity.  Contact candidates are every pair
of collision geometries on different bodies, the world counting as one
body, in the order the geometries were read (each link's in turn, then
the added bodies'), as the program's ``ModelBuilder`` enumerates its
pairs.  Collision filters are not read: the one filter in these URDFs,
the mini cheetah's feet group, excludes no pair in the program either.
"""
from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

FIXED, REVOLUTE, PRISMATIC, PLANAR, FLOATING = 0, 1, 2, 3, 4
SPHERE, BOX, CAPSULE = 0, 1, 2
_JOINT = {"fixed": FIXED, "revolute": REVOLUTE, "continuous": REVOLUTE,
          "prismatic": PRISMATIC, "planar": PLANAR, "floating": FLOATING}
_NQ = {FIXED: 0, REVOLUTE: 1, PRISMATIC: 1, PLANAR: 3, FLOATING: 7}
_NV = {FIXED: 0, REVOLUTE: 1, PRISMATIC: 1, PLANAR: 3, FLOATING: 6}
BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rpy(r, p, y):
    """URDF roll-pitch-yaw: Rz(y) Ry(p) Rx(r)."""
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr]])


def frame_from_z(u):
    """An orthonormal frame [v, w, u] whose third column is the unit u."""
    u = u / np.linalg.norm(u)
    e = np.zeros(3)
    e[int(np.argmin(np.abs(u)))] = 1.0
    v = e - (e @ u) * u
    v = v / np.linalg.norm(v)
    return np.stack([v, np.cross(u, v), u], axis=1)


def _vec(text, default):
    return np.array([float(x) for x in (text or default).split()])


def _origin(el):
    if el is None:
        return np.eye(3), np.zeros(3)
    return rpy(*_vec(el.get("rpy"), "0 0 0")), _vec(el.get("xyz"), "0 0 0")


@dataclasses.dataclass
class RefModel:
    jtype: list
    parent: list
    q_start: list
    v_start: list
    nq: int
    nv: int
    R_pj: torch.Tensor
    p_pj: torch.Tensor
    axis: torch.Tensor
    damping: torch.Tensor
    mass: torch.Tensor
    com: torch.Tensor
    inertia: torch.Tensor
    B: torch.Tensor  # (nv, nu)
    gravity: torch.Tensor
    g_type: list
    g_body: list
    g_R: torch.Tensor
    g_p: torch.Tensor
    g_size: torch.Tensor  # sphere [r, 0, 0], box half-extents,
    #                       capsule [r, half length, 0]
    pairs: list
    unactuated: list
    grav_scale: torch.Tensor  # (nl,) 1 or 0
    link_names: list
    g_names: list

    @property
    def floating_q_starts(self):
        return [self.q_start[j] for j, t in enumerate(self.jtype)
                if t == FLOATING]


def _read(path):
    with open(os.path.join(BENCH_DIR, path)) as f:
        text = f.read()
    if "drake:" in text and "xmlns:drake" not in text:
        text = text.replace("<robot", '<robot xmlns:drake="drake"', 1)
    return ET.fromstring(text)


def _topological(links, joint_of):
    order, placed = [], {"world"}
    pending = [n for n in links if n != "world"]
    while pending:
        moved = False
        for name in list(pending):
            j = joint_of.get(name)
            par = j.find("parent").get("link") if j is not None else "world"
            if par in placed:
                order.append(name)
                placed.add(name)
                pending.remove(name)
                moved = True
        if not moved:
            raise ValueError(f"URDF links not reachable: {pending}")
    return order


def _inertial(el):
    inertial = el.find("inertial")
    if inertial is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    Ri, com = _origin(inertial.find("origin"))
    mass = float(inertial.find("mass").get("value"))
    i = inertial.find("inertia")
    g = {k: float(i.get(k, 0.0)) for k in
         ("ixx", "iyy", "izz", "ixy", "ixz", "iyz")}
    return mass, com, Ri @ np.array([[g["ixx"], g["ixy"], g["ixz"]],
                                     [g["ixy"], g["iyy"], g["iyz"]],
                                     [g["ixz"], g["iyz"], g["izz"]]]) @ Ri.T


def _shape(col):
    """(type, size) of a collision's geometry."""
    shape = list(col.find("geometry"))[0]
    tag = shape.tag.rsplit("}", 1)[-1]
    if tag == "sphere":
        return SPHERE, [float(shape.get("radius")), 0.0, 0.0]
    if tag == "box":
        return BOX, list(_vec(shape.get("size"), "") / 2.0)
    if tag == "capsule":
        return CAPSULE, [float(shape.get("radius")),
                         float(shape.get("length")) / 2.0, 0.0]
    raise ValueError(f"shape {tag} is not in the reference")


def build(config: dict, device, dtype) -> RefModel:
    """The model of a configuration file: its ``model.urdf`` instances and
    its ``model.added`` bodies."""
    spec = config["model"]
    instances = spec["urdf"]
    if isinstance(instances, str):
        instances = [{"path": instances}]

    index = {}
    J = dict(jtype=[], parent=[], R=[], p=[], axis=[], damping=[],
             mass=[], com=[], inertia=[], names=[], grav=[])
    G = dict(type=[], body=[], R=[], p=[], size=[], names=[])

    def add_link(name, jt, par, R, p, axis, damping, mass, com, inertia,
                 grav=1.0):
        index[name] = len(J["jtype"])
        J["names"].append(name)
        J["jtype"].append(jt)
        J["parent"].append(par)
        J["R"].append(R)
        J["p"].append(p)
        J["axis"].append(axis / np.linalg.norm(axis))
        J["damping"] += [damping] * _NV[jt]
        J["mass"].append(mass)
        J["com"].append(com)
        J["inertia"].append(inertia)
        J["grav"].append(grav)

    def add_geom(name, gt, body, R, p, size):
        G["names"].append(name)
        G["type"].append(gt)
        G["body"].append(body)
        G["R"].append(R)
        G["p"].append(p)
        G["size"].append(size)

    grav = float(spec.get("gravity_enabled", True))
    actuated = []
    for inst in instances:
        root = _read(inst["path"])
        pre = inst.get("prefix", "")
        posed = "rpy" in inst or "xyz" in inst
        R_base = rpy(*inst.get("rpy", [0.0, 0.0, 0.0]))
        p_base = np.asarray(inst.get("xyz", [0.0, 0.0, 0.0]), dtype=float)
        links = {el.get("name"): el for el in root.findall("link")}
        joint_of = {j.find("child").get("link"): j
                    for j in root.findall("joint")}
        order = _topological(links, joint_of)
        for name in order:
            el = links[name]
            mass, com, inertia = _inertial(el)
            j = joint_of.get(name)
            if j is None:
                add_link(pre + name, FLOATING, -1,
                         R_base if posed else np.eye(3),
                         p_base if posed else np.zeros(3),
                         np.array([0.0, 0.0, 1.0]), 0.0, mass, com, inertia,
                         grav)
            else:
                R, p = _origin(j.find("origin"))
                par = j.find("parent").get("link")
                if posed and par == "world":
                    R, p = R_base @ R, p_base + R_base @ p
                dyn = j.find("dynamics")
                jt = _JOINT[j.get("type")]
                axis = _vec(j.find("axis").get("xyz") if j.find("axis")
                            is not None else None, "0 0 1")
                if jt == PLANAR:
                    R, axis = R @ frame_from_z(axis), np.array([0.0, 0.0,
                                                                1.0])
                add_link(pre + name, jt,
                         -1 if par == "world" else index[pre + par], R, p,
                         axis,
                         float(dyn.get("damping", 0.0)) if dyn is not None
                         else 0.0, mass, com, inertia, grav)
            for ci, col in enumerate(el.findall("collision")):
                gt, size = _shape(col)
                R, p = _origin(col.find("origin"))
                add_geom(pre + col.get("name", f"{name}_collision_{ci}"), gt,
                         index[pre + name], R, p, size)
        joint_name = {joint_of[n].get("name"): pre + n for n in order
                      if n in joint_of}
        actuated += [index[joint_name[t.find("joint").get("name")]]
                     for t in root.findall("transmission")]

    for extra in spec.get("added", []):
        kind, name = extra["kind"], extra.get("name", "ground")
        if kind in ("free_sphere", "free_box"):
            m = extra["mass"]
            if kind == "free_sphere":
                r = extra["radius"]
                inertia, gt, size = (np.eye(3) * 0.4 * m * r * r, SPHERE,
                                     [r, 0.0, 0.0])
            else:
                hx, hy, hz = size = list(extra["half"])
                inertia, gt = np.diag([m / 3.0 * (hy ** 2 + hz ** 2),
                                       m / 3.0 * (hx ** 2 + hz ** 2),
                                       m / 3.0 * (hx ** 2 + hy ** 2)]), BOX
            add_link(name, FLOATING, -1, np.eye(3), np.zeros(3),
                     np.array([0.0, 0.0, 1.0]), 0.0, m, np.zeros(3), inertia)
            add_geom(f"{name}_collision", gt, len(J["jtype"]) - 1,
                     np.eye(3), np.zeros(3), size)
        elif kind == "ground_box":
            half = [extra["size"] / 2, extra["size"] / 2, extra["depth"] / 2]
            add_geom(name, BOX, -1, np.eye(3),
                     np.array([0.0, 0.0, extra["z_top"] - extra["depth"] / 2]),
                     half)
        else:
            raise ValueError(f"unknown added body {kind}")

    q_start, v_start, nq, nv = [], [], 0, 0
    for jt in J["jtype"]:
        q_start.append(nq)
        v_start.append(nv)
        nq += _NQ[jt]
        nv += _NV[jt]
    B = np.zeros((nv, len(actuated)))
    for a, j in enumerate(actuated):
        B[v_start[j], a] = 1.0
    act_v = {v_start[j] for j in actuated}
    ng = len(G["type"])
    pairs = [(a, b) for a in range(ng) for b in range(a + 1, ng)
             if G["body"][a] != G["body"][b]]

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               dtype=dtype, device=device)

    return RefModel(
        jtype=J["jtype"], parent=J["parent"], q_start=q_start,
        v_start=v_start, nq=nq, nv=nv, R_pj=t(J["R"]), p_pj=t(J["p"]),
        axis=t(J["axis"]), damping=t(J["damping"]), mass=t(J["mass"]),
        com=t(J["com"]), inertia=t(J["inertia"]), B=t(B),
        gravity=t(spec["gravity"]), g_type=G["type"], g_body=G["body"],
        g_R=t(G["R"]), g_p=t(G["p"]), g_size=t(G["size"]), pairs=pairs,
        unactuated=[i for i in range(nv) if i not in act_v],
        grav_scale=t(J["grav"]), link_names=J["names"], g_names=G["names"])
