"""The plain reference's physics of one state: forward kinematics, the
velocity maps, inverse dynamics with every term, and the smoothed
compliant contact's wrenches.  q is (nq,), v and a (nv,); batch with
``torch.func.vmap``.

Inverse dynamics is written as the generalized force of the net body
wrenches:

    tau = J(q)^T [I wd + w x I w + r x m (a_com - s g); m (a_com - s g)]
          + D v - J(q)^T w_contact

with each link's gravity scale s (1, or 0 where gravity is off), each
body's world angular velocity w and origin velocity from a jvp
of the forward kinematics along qdot = N(q) v, its accelerations from a
second jvp along (qdot, a), and J^T from a vjp of the velocity map.

Contact, for each candidate pair: the signed distance phi, the normal
from A to B and the witness points, by the pair's shapes:

- sphere against sphere, box or capsule: the centre's nearest point of B
  (of a capsule: the nearest point of its axis segment, pushed out by the
  radius); inside a box, the face of the largest |p_i| - h_i, the first of
  equals;
- box against box: each box's 8 corners and 6 face centres against the
  other, and the closest points of each of the 12 x 12 edge pairs; the
  least phi wins, the first of equals;
- capsule against capsule: the closest points of the two axis segments
  (``_segments``: a clamped projection and one re-projection, exact for
  segments that are not parallel); for parallel axes (|d1|^2 |d2|^2 -
  (d1 . d2)^2 < 1e-12) it starts from A's first end (its centre less the
  half axis), so where parallel axes overlap the witnesses are the point
  of B's axis nearest that end and the point of A's axis nearest that;
- capsule against box: the box's distance along the axis segment, least
  at t* (``_capsule_vs_box``: bisection on the slope, then a Newton
  correction that makes t's derivative exact: of the slope outside the
  box, of the gap between two tied faces' depths where the axis runs
  inside it), then sphere against box at that point, with the falling
  face's normal at such a kink; where the minimiser is not unique, the one
  nearest the axis's second end.

Then f_n = sigma k log(1 + exp(-phi / sigma)) (the linear limit -k phi
where the exponent passes 37) times the dissipation factor (1 - s, or
(s - 2)^2 / 4 for 0 <= s < 2, or 0, with s = v_n / v_d), and friction
-mu f_n v_t / sqrt(v_s^2 + |v_t|^2), applied equal and opposite at the
witnesses' midpoint.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
from torch.func import jvp, vjp, vmap

from reference.model import (BOX, CAPSULE, FIXED, FLOATING, PLANAR,
                             PRISMATIC, REVOLUTE, SPHERE)

EPS = 1e-12


def quat_to_rot(quat):
    """R of a quaternion [w, x, y, z], not necessarily of unit length:
    I + s w [u]x + s (u u^T - |u|^2 I), s = 2 / |quat|^2."""
    w, u = quat[0], quat[1:]
    uu = torch.dot(u, u)
    # 2 as a tensor: a Python number over a tensor turns float32 into
    # float64 in the second derivative torch.func takes of it.
    s = torch.full_like(w, 2.0) / (w * w + uu)
    return (torch.eye(3, dtype=quat.dtype, device=quat.device) * (1 - s * uu)
            + s * (w * skew(u) + torch.outer(u, u)))


def skew(u):
    z = torch.zeros_like(u[0])
    return torch.stack([torch.stack([z, -u[2], u[1]]),
                        torch.stack([u[2], z, -u[0]]),
                        torch.stack([-u[1], u[0], z])])


def quat_rate(quat):
    """N_quat (4, 3): angular velocity in world -> quaternion rate."""
    w, x, y, z = quat
    return 0.5 * torch.stack([torch.stack([-x, -y, -z]),
                              torch.stack([w, z, -y]),
                              torch.stack([-z, w, x]),
                              torch.stack([y, -x, w])])


def rodrigues(axis, angle):
    K = skew(axis)
    return (torch.eye(3, dtype=axis.dtype, device=axis.device)
            + torch.sin(angle) * K + (1 - torch.cos(angle)) * (K @ K))


def forward_kinematics(m, q):
    """World rotation (nl, 3, 3) and origin (nl, 3) of every link."""
    Rs, ps = [], []
    for j, jt in enumerate(m.jtype):
        qs = m.q_start[j]
        if jt == FIXED:
            R_j, p_j = m.R_pj[j], m.p_pj[j]
        elif jt == REVOLUTE:
            R_j = m.R_pj[j] @ rodrigues(m.axis[j], q[qs])
            p_j = m.p_pj[j]
        elif jt == PRISMATIC:
            R_j = m.R_pj[j]
            p_j = m.p_pj[j] + m.R_pj[j] @ (m.axis[j] * q[qs])
        elif jt == PLANAR:
            z = torch.zeros_like(q[qs])
            R_j = m.R_pj[j] @ rodrigues(m.axis[j], q[qs + 2])
            p_j = m.p_pj[j] + m.R_pj[j] @ torch.stack([q[qs], q[qs + 1], z])
        elif jt == FLOATING:
            R_j = m.R_pj[j] @ quat_to_rot(q[qs:qs + 4])
            p_j = m.p_pj[j] + m.R_pj[j] @ q[qs + 4:qs + 7]
        else:
            raise ValueError(f"joint type {jt} is not in the reference")
        par = m.parent[j]
        if par < 0:
            Rs.append(R_j)
            ps.append(p_j)
        else:
            Rs.append(Rs[par] @ R_j)
            ps.append(ps[par] + Rs[par] @ p_j)
    return torch.stack(Rs), torch.stack(ps)


def v_to_qdot(m, q, v):
    out = []
    for j, jt in enumerate(m.jtype):
        qs, vs = m.q_start[j], m.v_start[j]
        if jt == FLOATING:
            out += [quat_rate(q[qs:qs + 4]) @ v[vs:vs + 3], v[vs + 3:vs + 6]]
        elif jt in (REVOLUTE, PRISMATIC, PLANAR):
            out.append(v[vs:vs + (3 if jt == PLANAR else 1)])
    return torch.cat(out)


def nplus(m, q):
    """N^+(q) (nv, nq): configuration differences -> velocities; 4 N^T on
    each quaternion block."""
    rows = torch.zeros((m.nv, m.nq), dtype=q.dtype, device=q.device)
    for j, jt in enumerate(m.jtype):
        qs, vs = m.q_start[j], m.v_start[j]
        if jt == FLOATING:
            rows = rows + torch.nn.functional.pad(
                4.0 * quat_rate(q[qs:qs + 4]).T,
                (qs, m.nq - qs - 4, vs, m.nv - vs - 3))
            eye = np.zeros((m.nv, m.nq))
            eye[vs + 3:vs + 6, qs + 4:qs + 7] = np.eye(3)
            rows = rows + torch.as_tensor(eye, dtype=q.dtype,
                                          device=q.device)
        elif jt in (REVOLUTE, PRISMATIC, PLANAR):
            e = np.zeros((m.nv, m.nq))
            for i in range(3 if jt == PLANAR else 1):
                e[vs + i, qs + i] = 1.0
            rows = rows + torch.as_tensor(e, dtype=q.dtype, device=q.device)
    return rows


def body_velocities(m, q, v):
    """(R, p, w, pdot) of every link, in world."""
    (R, p), (Rd, pd) = jvp(lambda x: forward_kinematics(m, x), (q,),
                           (v_to_qdot(m, q, v),))
    W = Rd @ R.mT
    w = 0.5 * torch.stack([W[:, 2, 1] - W[:, 1, 2], W[:, 0, 2] - W[:, 2, 0],
                           W[:, 1, 0] - W[:, 0, 1]], dim=-1)
    return R, p, w, pd


# -- signed distance ---------------------------------------------------------

def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1) + EPS)


def _point_box(p, half):
    """(phi, outward normal, closest point) of a box-frame point."""
    d = torch.abs(p) - half
    dmax = torch.amax(d)
    out_len = _norm(torch.clamp_min(d, 0.0))
    outside = dmax > 0
    phi = torch.where(outside, out_len, torch.clamp_max(dmax, 0.0))
    clamped = torch.minimum(torch.maximum(p, -half), half)
    face = (torch.arange(3, device=p.device) == torch.argmax(d)).to(p.dtype)
    pf = torch.sum(face * p)
    sign = torch.sign(torch.where(pf == 0, torch.ones_like(pf), pf))
    inside_pt = clamped * (1 - face) + face * sign * half
    closest = torch.where(outside, clamped, inside_pt)
    normal = torch.where(outside, (p - clamped) / out_len, face * sign)
    return phi, normal, closest


def _point_capsule(p, size):
    """(phi, outward normal, closest point) of a capsule-frame point: the
    nearest point of the axis segment, z in [-half length, half length],
    pushed out by the radius."""
    zero = torch.zeros_like(p[2])
    axis_pt = torch.stack([zero, zero, torch.minimum(torch.maximum(
        p[2], -size[1]), size[1])])
    dist = _norm(p - axis_pt)
    normal = (p - axis_pt) / dist
    return dist - size[0], normal, axis_pt + normal * size[0]


def _sphere_vs(tb, size_b, R_b, p_b, center, radius):
    """A sphere against a sphere, a box or a capsule B: (phi, A->B normal,
    witness on the sphere, witness on B), in world."""
    c = R_b.T @ (center - p_b)
    if tb == SPHERE:
        dist = _norm(c)
        phi_pt, n_l = dist - size_b[0], c / dist
        cl = n_l * size_b[0]
    elif tb == BOX:
        phi_pt, n_l, cl = _point_box(c, size_b)
    else:
        phi_pt, n_l, cl = _point_capsule(c, size_b)
    n = -(R_b @ n_l)
    return phi_pt - radius, n, center + n * radius, R_b @ cl + p_b


_CORNERS = np.concatenate([np.array(list(itertools.product([-1.0, 1.0],
                                                            repeat=3))),
                           np.eye(3), -np.eye(3)])


def _edges():
    out = []
    for k in range(3):
        o = [i for i in range(3) if i != k]
        for s1, s2 in itertools.product([-1.0, 1.0], repeat=2):
            lo, hi = np.zeros(3), np.zeros(3)
            lo[k], hi[k] = -1.0, 1.0
            lo[o[0]] = hi[o[0]] = s1
            lo[o[1]] = hi[o[1]] = s2
            out.append([lo, hi])
    return np.asarray(out)


_EDGES = _edges()


def _segments(p1, q1, p2, q2):
    d1, d2, r = q1 - p1, q2 - p2, p1 - p2
    a, e, b = d1 @ d1, d2 @ d2, d1 @ d2
    c, f = d1 @ r, d2 @ r
    den = a * e - b * b
    one = torch.ones_like(a)
    s = torch.clamp((b * f - c * e) / torch.where(den < EPS, one, den), 0, 1)
    t = torch.clamp((b * s + f) / torch.where(e < EPS, one, e), 0, 1)
    s = torch.clamp((b * t - c) / torch.where(a < EPS, one, a), 0, 1)
    return p1 + s * d1, p2 + t * d2


def _pick(phi, *fields):
    """The entries of phi (C,) and of each field (C, ...) at phi's first
    least value, by a one-hot sum (vmap takes no data-dependent index)."""
    hot = (torch.arange(phi.shape[0], device=phi.device)
           == torch.argmin(phi)).to(phi.dtype)
    return tuple(torch.tensordot(hot, x, dims=1) for x in (phi,) + fields)


def _box_vs_box(ha, R_a, p_a, hb, R_b, p_b):
    """Corners and face centres of each box against the other, and the
    closest pair of each of the 12 x 12 edges; the least phi wins."""
    cand = torch.as_tensor(_CORNERS, dtype=ha.dtype, device=ha.device)

    def against(pts, R, p, half, flip):
        def one(c):
            phi, n_l, cl = _point_box(R.T @ (c - p), half)
            n = R @ n_l
            return phi, (-n if flip else n), c, R @ cl + p
        return vmap(one)(pts)

    best = _pick(*against((cand * ha) @ R_a.T + p_a, R_b, p_b, hb, True))
    pb, nb, cb2, ca2 = against((cand * hb) @ R_b.T + p_b, R_a, p_a, ha, False)
    other = _pick(pb, nb, ca2, cb2)
    best = tuple(torch.where(other[0] < best[0], o, b)
                 for o, b in zip(other, best))
    edges = torch.as_tensor(_EDGES, dtype=ha.dtype, device=ha.device)
    ea = (edges * ha) @ R_a.T + p_a
    eb = (edges * hb) @ R_b.T + p_b

    def pair(sa, sb):
        x, y = _segments(sa[0], sa[1], sb[0], sb[1])
        d = _norm(x - y)
        return d, (y - x) / d, x, y

    pe, ne, xa, xb = vmap(lambda sa: vmap(lambda sb: pair(sa, sb))(eb))(ea)
    edge = _pick(*(t.reshape((144,) + t.shape[2:])
                   for t in (pe, ne, xa, xb)))
    return tuple(torch.where(edge[0] < best[0], e, b)
                 for e, b in zip(edge, best))


def _capsule_vs_capsule(sa, R_a, p_a, sb, R_b, p_b):
    """The closest points of the two axis segments, each pushed out by its
    capsule's radius."""
    ha, hb = R_a[:, 2] * sa[1], R_b[:, 2] * sb[1]
    x, y = _segments(p_a - ha, p_a + ha, p_b - hb, p_b + hb)
    d = _norm(y - x)
    n = (y - x) / d
    return d - sa[0] - sb[0], n, x + n * sa[0], y - n * sb[0]


BISECTIONS = 64  # halves [0, 1] past the spacing of doubles below 1


def _box_slope(p, d, half):
    """d/dt of the box distance of p + t d at t = 0 (the distance's
    gradient, the outward normal, along d), and where the point is outside
    the box the second derivative, else 0 (the distance is piecewise linear
    inside)."""
    phi, normal, _ = _point_box(p, half)
    slope = normal @ d
    out = torch.abs(p) - half
    active = (out > 0).to(p.dtype)
    curv = torch.where(torch.amax(out) > 0,
                       (torch.sum(active * d * d) - slope * slope) / phi,
                       torch.zeros_like(phi))
    return slope, curv


# The six faces of a box, each a signed axis, in a fixed order: +x, -x,
# +y, -y, +z, -z.  A point's depth below face f is FACES[f] . p - h_k.
_FACES = np.concatenate([np.eye(3), -np.eye(3)])[[0, 3, 1, 4, 2, 5]]
# Faces whose depths at the minimiser lie within TIE x the axis's length of
# the deepest's are tied there.  The bisection leaves t* within a few
# roundings of the kink, where tied depths differ by about 1e-17 m.
TIE = 1e-9


def _capsule_vs_box(sc, R_c, p_c, hb, R_b, p_b):
    """The capsule as the sphere of its radius at the point of its axis
    segment a + t (b - a) where the box's distance phi(t) is least.  phi is
    convex in t, so its slope rises: 64 bisections of [0, 1] on the slope's
    sign, on detached inputs, give t* = the largest t with phi'(t) <= 0, to
    rounding.  Then one Newton correction makes t's derivative exact (the
    implicit function theorem): t = t* - (g(t*) - sg(g(t*))) / sg(g'(t*)),
    whose value is t* and whose derivative is -(dg/dq) / g', where sg holds
    its argument's value with no derivative, and g is

    - outside the box, phi'(t) (phi is smooth there);
    - inside the box, where phi is the deepest of the six faces' depths,
      each linear in t, and t* a kink between them: the depth of the first
      tied face (``TIE``; in ``_FACES``' order) that rises along the axis
      less that of the first tied face that falls or stays level.  The
      normal and the box's witness are then the falling face's, the face
      on a's side of t*, whatever rounding makes the deepest at t*.  Where
      a face stays level (the axis parallel to it), t* is the end of the
      level stretch nearest b, and t follows that end.

    Where t* is an end of the segment, or phi''(t*) = 0 outside (the axis
    parallel to a face it projects inside: every t of a stretch is least,
    and t* is the one nearest b), t is held at t*, constant."""
    half = R_c[:, 2] * sc[1]
    a = R_b.T @ (p_c - half - p_b)  # the axis's ends in the box's frame
    d = R_b.T @ (2.0 * half)
    a0, d0, h0 = a.detach(), d.detach(), hb.detach()
    lo = torch.zeros_like(a0[0])
    hi = torch.ones_like(lo)
    for _ in range(BISECTIONS):
        mid = 0.5 * (lo + hi)
        rising = _box_slope(a0 + mid * d0, d0, h0)[0] > 0
        lo, hi = torch.where(rising, lo, mid), torch.where(rising, mid, hi)
    t0 = lo
    interior = (t0 > 0) & (t0 < 1)
    p0 = a0 + t0 * d0
    inside = torch.amax(torch.abs(p0) - h0) <= 0
    slope0, curv = _box_slope(p0, d0, h0)
    slope = _box_slope(a + t0 * d, d, hb)[0]
    smooth = interior & ~inside & (curv > 0)
    # Inside: the tied faces at t*, the first falling (or level) and the
    # first rising one.
    faces = torch.as_tensor(_FACES, dtype=a.dtype, device=a.device)
    depth0 = faces @ p0 - torch.abs(faces) @ h0
    rate0 = faces @ d0
    tie = TIE * torch.linalg.vector_norm(d0)
    tied = depth0 >= torch.amax(depth0) - tie
    falls, rises = tied & (rate0 <= tie), tied & (rate0 > tie)
    order = torch.arange(6, device=a.device)

    def first(mask):
        return (order == torch.argmax(mask.to(a.dtype))).to(a.dtype)

    fall, rise = first(falls), first(rises)
    kink = interior & inside & torch.any(falls) & torch.any(rises)
    gap = (rise - fall) @ (faces @ (a + t0 * d) - torch.abs(faces) @ hb)
    gap0 = (rise - fall) @ depth0
    one = torch.ones_like(curv)
    t = t0 - torch.where(
        smooth, (slope - slope0) / torch.where(smooth, curv, one),
        torch.where(kink, (gap - gap0) / torch.where(
            kink, (rise - fall) @ rate0, one), torch.zeros_like(curv)))
    center = p_c - half + t * (2.0 * half)
    out = _sphere_vs(BOX, hb, R_b, p_b, center, sc[0])
    # At a kink, the falling face's depth, normal and witness.
    face = fall @ faces
    c = R_b.T @ (center - p_b)
    on = torch.abs(face)
    n = -(R_b @ face)
    cl = torch.minimum(torch.maximum(c, -hb), hb) * (1 - on) + face * hb
    at_kink = (face @ c - on @ hb - sc[0], n, center + n * sc[0],
               R_b @ cl + p_b)
    return tuple(torch.where(kink, k, o) for k, o in zip(at_kink, out))


def signed_distance(ta, sa, R_a, p_a, tb, sb, R_b, p_b):
    if ta == SPHERE:
        return _sphere_vs(tb, sb, R_b, p_b, p_a, sa[0])
    if tb == SPHERE:
        phi, n, wa, wb = _sphere_vs(ta, sa, R_a, p_a, p_b, sb[0])
        return phi, -n, wb, wa
    if ta == BOX and tb == BOX:
        return _box_vs_box(sa, R_a, p_a, sb, R_b, p_b)
    if ta == CAPSULE and tb == CAPSULE:
        return _capsule_vs_capsule(sa, R_a, p_a, sb, R_b, p_b)
    if ta == CAPSULE and tb == BOX:
        return _capsule_vs_box(sa, R_a, p_a, sb, R_b, p_b)
    if ta == BOX and tb == CAPSULE:
        phi, n, wa, wb = _capsule_vs_box(sb, R_b, p_b, sa, R_a, p_a)
        return phi, -n, wb, wa
    raise ValueError(f"pair ({ta}, {tb}) is not in the reference")


# -- contact and dynamics ----------------------------------------------------

def contact_wrenches(m, contact, q, v):
    """Torques and forces (nl, 3) about each link origin, in world."""
    R_l, p_l, w_l, pd_l = body_velocities(m, q, v)
    nl = len(m.jtype)
    zero3 = torch.zeros(3, dtype=q.dtype, device=q.device)
    torques = [zero3] * nl
    forces = [zero3] * nl
    k, sigma = contact["stiffness"], contact["smoothing_factor"]
    vd, vs = contact["dissipation_velocity"], contact["stiction_velocity"]
    mu = contact["friction_coefficient"]

    def pose(g):
        b = m.g_body[g]
        if b < 0:
            return m.g_R[g], m.g_p[g], zero3, zero3, zero3
        return (R_l[b] @ m.g_R[g], p_l[b] + R_l[b] @ m.g_p[g], w_l[b],
                pd_l[b], p_l[b])

    for a, b in m.pairs:
        Ra, pa, wa, va, oa = pose(a)
        Rb, pb, wb, vb, ob = pose(b)
        phi, n, xa, xb = signed_distance(m.g_type[a], m.g_size[a], Ra, pa,
                                         m.g_type[b], m.g_size[b], Rb, pb)
        pc = 0.5 * (xa + xb)
        v_rel = (vb + torch.linalg.cross(wb, pc - ob)) - (
            va + torch.linalg.cross(wa, pc - oa))
        vn = n @ v_rel
        vt = v_rel - vn * n
        s = vn / vd
        damp = torch.where(s < 0, 1 - s,
                           torch.where(s < 2, (s - 2) ** 2 / 4, 0 * s))
        x = -phi / sigma
        fn = torch.where(x >= 37.0, -k * phi,
                         sigma * k * torch.log1p(torch.exp(
                             torch.clamp_max(x, 37.0)))) * damp
        f = n * fn + mu * fn * (-vt / torch.sqrt(vs * vs + vt @ vt))
        if m.g_body[b] >= 0:
            forces[m.g_body[b]] = forces[m.g_body[b]] + f
            torques[m.g_body[b]] = torques[m.g_body[b]] + torch.linalg.cross(
                pc - ob, f)
        if m.g_body[a] >= 0:
            forces[m.g_body[a]] = forces[m.g_body[a]] - f
            torques[m.g_body[a]] = torques[m.g_body[a]] + torch.linalg.cross(
                pc - oa, -f)
    return torch.stack(torques), torch.stack(forces)


def inverse_dynamics(m, contact, q, v, a):
    """Generalized forces (nv,) that give acceleration a at (q, v), the
    contact wrenches at (q, v) included."""
    qdot = v_to_qdot(m, q, v)
    (R, p, w, pd), (_, _, wd, pdd) = jvp(
        lambda x, y: body_velocities(m, x, y), (q, v), (qdot, a))
    r = (R @ m.com[:, :, None])[..., 0]
    a_com = (pdd + torch.linalg.cross(wd, r)
             + torch.linalg.cross(w, torch.linalg.cross(w, r)))
    mass = m.mass[:, None]
    force = mass * a_com - mass * (m.grav_scale[:, None] * m.gravity)
    I_w = R @ m.inertia @ R.mT
    Iw = (I_w @ w[:, :, None])[..., 0]
    torque = ((I_w @ wd[:, :, None])[..., 0] + torch.linalg.cross(w, Iw)
              + torch.linalg.cross(r, force))
    ext_t, ext_f = contact_wrenches(m, contact, q, v)
    _, pull = vjp(lambda y: body_velocities(m, q, y)[2:], v)
    (tau,) = pull((torque - ext_t, force - ext_f))
    return tau + m.damping * v
