"""The plain reference's multibody model, read from the configuration's
URDF copy and the bodies its file adds, with nothing taken from the
program.

Conventions (those of the IDTO examples): the links of the URDF in
topological order, each the child of one joint; a root link without a
joint to the world gets a floating joint with q = [qw, qx, qy, qz, x, y,
z] and v = [angular velocity in world, origin velocity in world];
``continuous`` is ``revolute``; a ``planar`` joint has q = [x, y, theta]
in a joint frame turned so that its z is the URDF axis (the first two
columns completed from the axis as Drake's MakeFromOneUnitVector does);
inertias are re-expressed in the link
frame about the centre of mass; transmissions name the actuated joints, in
order.  Contact candidates are every pair of collision geometries on
different bodies, the world counting as one body.
"""
from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

FIXED, REVOLUTE, PLANAR, FLOATING = 0, 1, 3, 4
SPHERE, BOX = 0, 1
_JOINT = {"fixed": FIXED, "revolute": REVOLUTE, "continuous": REVOLUTE,
          "planar": PLANAR, "floating": FLOATING}
_NQ = {FIXED: 0, REVOLUTE: 1, PLANAR: 3, FLOATING: 7}
_NV = {FIXED: 0, REVOLUTE: 1, PLANAR: 3, FLOATING: 6}
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
    g_size: torch.Tensor  # sphere [r, 0, 0], box half-extents
    pairs: list
    unactuated: list

    @property
    def floating_q_starts(self):
        return [self.q_start[j] for j, t in enumerate(self.jtype)
                if t == FLOATING]


def build(config: dict, device, dtype) -> RefModel:
    """The model of a configuration file: its ``model.urdf`` (a path
    under the benchmark) and its ``model.added`` bodies."""
    spec = config["model"]
    with open(os.path.join(BENCH_DIR, spec["urdf"])) as f:
        text = f.read()
    if "drake:" in text and "xmlns:drake" not in text:
        text = text.replace("<robot", '<robot xmlns:drake="drake"', 1)
    root = ET.fromstring(text)
    links = {el.get("name"): el for el in root.findall("link")}
    joint_of = {j.find("child").get("link"): j for j in root.findall("joint")}

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

    index = {}
    J = dict(jtype=[], parent=[], R=[], p=[], axis=[], damping=[],
             mass=[], com=[], inertia=[], names=[])
    G = dict(type=[], body=[], R=[], p=[], size=[])

    def add_link(name, jt, par, R, p, axis, damping, mass, com, inertia):
        index[name] = len(J["jtype"])
        J["jtype"].append(jt)
        J["parent"].append(par)
        J["R"].append(R)
        J["p"].append(p)
        J["axis"].append(axis / np.linalg.norm(axis))
        J["damping"] += [damping] * _NV[jt]
        J["mass"].append(mass)
        J["com"].append(com)
        J["inertia"].append(inertia)

    for name in order:
        el = links[name]
        inertial = el.find("inertial")
        mass, com, inertia = 0.0, np.zeros(3), np.zeros((3, 3))
        if inertial is not None:
            Ri, com = _origin(inertial.find("origin"))
            mass = float(inertial.find("mass").get("value"))
            i = inertial.find("inertia")
            g = {k: float(i.get(k, 0.0)) for k in
                 ("ixx", "iyy", "izz", "ixy", "ixz", "iyz")}
            inertia = Ri @ np.array([[g["ixx"], g["ixy"], g["ixz"]],
                                     [g["ixy"], g["iyy"], g["iyz"]],
                                     [g["ixz"], g["iyz"], g["izz"]]]) @ Ri.T
        j = joint_of.get(name)
        if j is None:
            add_link(name, FLOATING, -1, np.eye(3), np.zeros(3),
                     np.array([0.0, 0.0, 1.0]), 0.0, mass, com, inertia)
        else:
            R, p = _origin(j.find("origin"))
            par = j.find("parent").get("link")
            dyn = j.find("dynamics")
            jt = _JOINT[j.get("type")]
            axis = _vec(j.find("axis").get("xyz") if j.find("axis")
                        is not None else None, "0 0 1")
            if jt == PLANAR:
                R, axis = R @ frame_from_z(axis), np.array([0.0, 0.0, 1.0])
            add_link(name, jt, -1 if par == "world" else index[par], R, p,
                     axis,
                     float(dyn.get("damping", 0.0)) if dyn is not None
                     else 0.0, mass, com, inertia)
        for col in el.findall("collision"):
            shape = list(col.find("geometry"))[0]
            R, p = _origin(col.find("origin"))
            G["type"].append(SPHERE if shape.tag == "sphere" else BOX)
            G["body"].append(index[name])
            G["R"].append(R)
            G["p"].append(p)
            G["size"].append(
                [float(shape.get("radius")), 0.0, 0.0]
                if shape.tag == "sphere" else list(_vec(shape.get("size"),
                                                        "") / 2.0))
            if shape.tag not in ("sphere", "box"):
                raise ValueError(f"shape {shape.tag} is not in the "
                                 "reference")

    actuated = [index_of_joint
                for t in root.findall("transmission")
                for index_of_joint in [
                    next(i for i, n in enumerate(order)
                         if joint_of.get(n) is not None
                         and joint_of[n].get("name")
                         == t.find("joint").get("name"))]]

    for extra in spec.get("added", []):
        if extra["kind"] == "free_sphere":
            m, r = extra["mass"], extra["radius"]
            add_link(extra["name"], FLOATING, -1, np.eye(3), np.zeros(3),
                     np.array([0.0, 0.0, 1.0]), 0.0, m, np.zeros(3),
                     np.eye(3) * 0.4 * m * r * r)
            G["type"].append(SPHERE)
            G["body"].append(len(J["jtype"]) - 1)
            G["R"].append(np.eye(3))
            G["p"].append(np.zeros(3))
            G["size"].append([r, 0.0, 0.0])
        elif extra["kind"] == "ground_box":
            half = [extra["size"] / 2, extra["size"] / 2, extra["depth"] / 2]
            G["type"].append(BOX)
            G["body"].append(-1)
            G["R"].append(np.eye(3))
            G["p"].append(np.array([0.0, 0.0,
                                    extra["z_top"] - extra["depth"] / 2]))
            G["size"].append(half)
        else:
            raise ValueError(f"unknown added body {extra['kind']}")

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
        unactuated=[i for i in range(nv) if i not in act_v])
