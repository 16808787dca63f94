"""The smoothed compliant contact model: its parameters, and the contact
wrenches of one state (counterpart of ``idto_tpu/contact/force.py``; the
batch-native force law is ``soa/contact.py``).

  * normal force f_n = sigma k log(1 + exp(-phi / sigma)) (softplus),
  * Hunt-Crossley-like dissipation: 1 - s for s < 0, (s - 2)^2 / 4 for
    0 <= s < 2, 0 beyond, with s = v_n / dissipation_velocity,
  * regularized friction f_t = -mu f_n v_t / sqrt(vs^2 + |v_t|^2),
  * equal and opposite forces at the witness points' midpoint.

Every candidate pair is evaluated; pairs of one type pair are one
``torch.func.vmap`` of the pair's force.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from idto_tpu_torch.geometry.distance import signed_distance
from idto_tpu_torch.models import mat3
from idto_tpu_torch.models.kinematics import body_velocities
from idto_tpu_torch.models.model import GeomType, Model
from idto_tpu_torch.utils.consts import const, index


@dataclasses.dataclass(frozen=True)
class ContactParams:
    stiffness: float = 100.0  # k, N/m
    smoothing_factor: float = 0.01  # sigma, m
    dissipation_velocity: float = 0.1  # m/s
    stiction_velocity: float = 0.05  # vs, m/s
    friction_coefficient: float = 0.5  # mu


class ContactInfo(NamedTuple):
    phi: torch.Tensor  # (np,) signed distances
    normal: torch.Tensor  # (np, 3) A -> B unit normals, world
    p_contact: torch.Tensor  # (np, 3) contact midpoints, world
    force: torch.Tensor  # (np, 3) force on body B at the midpoint, world


def _group_pairs(geoms):
    """Candidate pairs grouped by (type_a, type_b), each group one batched
    distance evaluation."""
    groups = {}
    for (ia, ib) in geoms.pairs:
        groups.setdefault((geoms.types[ia], geoms.types[ib]), []).append(
            (ia, ib))
    return groups


def contact_wrenches(model: Model, q, v, params: ContactParams,
                     return_info: bool = False):
    """Contact wrenches of one state, q (nq,) and v (nv,): ((nl, 3)
    torques, (nl, 3) forces) about each body's origin, in world -- what
    ``inverse_dynamics`` takes -- and with ``return_info`` the pairs'
    ``ContactInfo``."""
    nl = model.num_links
    dtype, device = q.dtype, q.device
    geoms = model.geoms
    if geoms is None or not geoms.pairs:
        z = torch.zeros((nl, 3), dtype=dtype, device=device)
        empty = ContactInfo(z[:0, 0], z[:0], z[:0], z[:0])
        return ((z, z), empty) if return_info else (z, z)

    R_l, p_l, w_l, pd_l = body_velocities(model, q, v)
    # Geometry world poses: one gather and a batched compose.
    bodies = np.asarray(geoms.bodies)
    body_idx = index(np.maximum(bodies, 0), device)
    is_world = const(bodies < 0, device)[:, None]
    zero = torch.zeros((), dtype=dtype, device=device)
    eye = torch.eye(3, dtype=dtype, device=device)
    Rg_b = torch.where(is_world[:, :, None], eye, R_l[body_idx])
    pg_b = torch.where(is_world, zero, p_l[body_idx])
    Rg = mat3.mul(Rg_b, geoms.R.to(dtype))
    pg = pg_b + mat3.mv(Rg_b, geoms.p.to(dtype))
    # Point velocities of the geometry-owning links (world rows zeroed).
    w_g = torch.where(is_world, zero, w_l[body_idx])
    pd_g = torch.where(is_world, zero, pd_l[body_idx])
    pl_g = torch.where(is_world, zero, p_l[body_idx])

    k = params.stiffness
    sigma = params.smoothing_factor
    vd = params.dissipation_velocity
    vs = params.stiction_velocity
    mu = params.friction_coefficient

    all_phi, all_n, all_pc, all_f = [], [], [], []
    seg_ids, seg_torques, seg_forces = [], [], []
    for (ta, tb), pairs in _group_pairs(geoms).items():
        ia_np = np.array([p[0] for p in pairs])
        ib_np = np.array([p[1] for p in pairs])
        ia, ib = index(ia_np, device), index(ib_np, device)
        # A hull's "params" at the distance layer are its vertices.
        prms_a = (geoms.verts if ta == GeomType.CONVEX
                  else geoms.params)[ia].to(dtype)
        prms_b = (geoms.verts if tb == GeomType.CONVEX
                  else geoms.params)[ib].to(dtype)

        def pair_force(Ra, pa, prm_a, Rb, pb, prm_b, wa_body, pda_body,
                       pla_body, wb_body, pdb_body, plb_body, ta=ta, tb=tb):
            phi, nhat, wa, wb = signed_distance(ta, prm_a, Ra, pa,
                                                tb, prm_b, Rb, pb)
            p_c = 0.5 * (wa + wb)
            v_a = pda_body + mat3.cross(wa_body, p_c - pla_body)
            v_b = pdb_body + mat3.cross(wb_body, p_c - plb_body)
            v_rel = v_b - v_a
            vn = mat3.dot(nhat, v_rel)
            vt = v_rel - vn * nhat

            # Hunt-Crossley-like dissipation (piecewise C^1).
            s = vn / vd
            dissipation = torch.where(
                s < 0.0, 1.0 - s,
                torch.where(s < 2.0, (s - 2.0) ** 2 / 4.0, 0.0 * s))
            # Softplus normal force with the overflow guard (exponent >= 37
            # -> the linear limit -k phi).
            exponent = -phi / sigma
            fn_compliant = torch.where(
                exponent >= 37.0,
                -k * phi,
                sigma * k * torch.log1p(torch.exp(torch.clamp_max(
                    exponent, 37.0))),
            )
            fn = fn_compliant * dissipation
            # Regularized friction (algebraic sigmoid).
            that = -vt / torch.sqrt(vs * vs + mat3.dot(vt, vt))
            f_on_b = nhat * fn + mu * fn * that
            tq_b = mat3.cross(p_c - plb_body, f_on_b)
            tq_a = mat3.cross(p_c - pla_body, -f_on_b)
            return phi, nhat, p_c, f_on_b, tq_a, tq_b

        phi, nhat, p_c, f_on_b, tq_a, tq_b = vmap(pair_force)(
            Rg[ia], pg[ia], prms_a, Rg[ib], pg[ib], prms_b,
            w_g[ia], pd_g[ia], pl_g[ia], w_g[ib], pd_g[ib], pl_g[ib],
        )
        all_phi.append(phi)
        all_n.append(nhat)
        all_pc.append(p_c)
        all_f.append(f_on_b)
        # World (-1) rows go to a dump slot nl.
        seg_ids.append(np.concatenate([np.where(bodies[ia_np] < 0, nl,
                                                bodies[ia_np]),
                                       np.where(bodies[ib_np] < 0, nl,
                                                bodies[ib_np])]))
        seg_torques.append(torch.cat([tq_a, tq_b], dim=0))
        seg_forces.append(torch.cat([-f_on_b, f_on_b], dim=0))

    # Segment sums as one product with a static 0/1 matrix: deterministic,
    # where an atomic scatter on the card is not.
    ids = np.concatenate(seg_ids)
    S = np.zeros((nl + 1, len(ids)))
    S[ids, np.arange(len(ids))] = 1.0
    S = const(S[:nl], device, dtype)
    torques = S @ torch.cat(seg_torques, dim=0)
    forces = S @ torch.cat(seg_forces, dim=0)
    if not return_info:
        return torques, forces
    info = ContactInfo(torch.cat(all_phi), torch.cat(all_n, dim=0),
                       torch.cat(all_pc, dim=0), torch.cat(all_f, dim=0))
    return (torques, forces), info
