"""Signed distances between two collision geometries, one pair at a time
(counterpart of ``idto_tpu/geometry/distance.py``), for the per-problem
(AoS) pipeline.

Every pair function returns ``(phi, nhat, p_a, p_b)``: the signed distance,
the world unit normal pointing from geometry A toward geometry B, and the
world witness points on each surface.  Points are ``(3,)``, rotations
``(3, 3)``; a primitive's params are ``(3,)`` and a convex hull's are its
``(m, 3)`` vertices.  Batch over pairs and instances with
``torch.func.vmap``.

Every distance is smooth almost everywhere and safe to differentiate: norms
are guarded (``_safe_norm``) and divisions that a ``torch.where`` does not
select are guarded too, since both branches are evaluated.  Clamps are
``torch.minimum`` / ``torch.maximum`` against tensors, whose derivative
splits evenly at ties, as ``jnp.clip`` and ``jnp.maximum`` do.  The
iterative searches (the ternary search along a capsule, the Frank-Wolfe
projection onto a hull, the support-plane search, the alternating
projections) run on detached inputs, and the distance is evaluated again
smoothly at the frozen minimizer: the envelope theorem's derivative, as the
JAX package's ``stop_gradient`` gives.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from idto_tpu_torch.models import mat3
from idto_tpu_torch.models.mesh import _fibonacci_directions
from idto_tpu_torch.models.model import GeomType
from idto_tpu_torch.soa.contact import _box_candidates_np, _box_edges_np
from idto_tpu_torch.soa.convex import _cylinder_ring_np, _fma
from idto_tpu_torch.utils.consts import const

_EPS = 1e-12
_FW_STEPS = 48
_PROJECTION_STEPS = 64
_TERNARY_STEPS = 48
_SUPPORT_DIRECTIONS = 256
_CONE_RADII = (0.2, 0.07, 0.025, 0.008, 0.003)
_CONE_CANDIDATES = 16

_POINT_SHAPES = (GeomType.BOX, GeomType.CAPSULE, GeomType.CYLINDER,
                 GeomType.SPHERE, GeomType.HALFSPACE, GeomType.CONVEX)
_CAPSULE_SEARCH_SHAPES = (GeomType.BOX, GeomType.HALFSPACE, GeomType.CYLINDER,
                          GeomType.CONVEX)
_SUPPORT_SHAPES = (GeomType.BOX, GeomType.CYLINDER, GeomType.CONVEX)


def _c(x, value):
    """Scalar constant matching x's dtype and device."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _safe_norm(x, dim=-1):
    return torch.sqrt(torch.sum(x * x, dim=dim) + _EPS)


def _onehot(i, n, dtype):
    return (torch.arange(n, device=i.device) == i).to(dtype)


def _vec(x, y, z):
    return torch.stack([x, y, z], dim=-1)


def _point_box_distance(p, half):
    """Signed distance from a box-frame point to the box of half-extents
    ``half``, with the outward unit normal at the closest surface point and
    that point."""
    q = torch.abs(p) - half
    qmax = torch.amax(q)
    dist_out = _safe_norm(torch.maximum(q, _c(q, 0.0)))
    outside = qmax > 0.0
    phi = torch.where(outside, dist_out, torch.minimum(qmax, _c(q, 0.0)))
    clamped = _clip(p, -half, half)
    # Inside: push to the nearest face (one-hot select).
    onehot = _onehot(torch.argmax(q), 3, p.dtype)
    pf = torch.sum(onehot * p)
    sign = torch.sign(torch.where(pf == 0, _c(p, 1.0), pf))
    inside_pt = clamped * (1 - onehot) + onehot * sign * half
    closest = torch.where(outside, clamped, inside_pt)
    normal = torch.where(outside, (p - clamped) / dist_out, onehot * sign)
    return phi, normal, closest


def _point_capsule_distance(p, radius, half_len):
    """Signed distance from a capsule-frame point to a z-aligned capsule."""
    z = _clip(p[2], -half_len, half_len)
    seg_pt = _vec(0.0 * z, 0.0 * z, z)
    d = p - seg_pt
    dist = _safe_norm(d)
    normal = d / dist
    return dist - radius, normal, seg_pt + normal * radius


def _point_cylinder_distance(p, radius, half_len):
    """Signed distance from a cylinder-frame point to a z-aligned cylinder
    with flat caps."""
    rho = _safe_norm(p[:2])
    dr = rho - radius
    dz = torch.abs(p[2]) - half_len
    zero = _c(p, 0.0)
    outside = torch.maximum(torch.stack([dr, dz]), zero)
    phi = _safe_norm(outside) + torch.minimum(torch.maximum(dr, dz), zero)

    rd = p[:2] / rho
    sz = torch.sign(torch.where(p[2] == 0, _c(p, 1.0), p[2]))
    rho_c = torch.minimum(rho, radius)
    edge_pt = _vec(rd[0] * radius, rd[1] * radius,
                   _clip(p[2], -half_len, half_len))
    cap_pt = _vec(rd[0] * rho_c, rd[1] * rho_c, sz * half_len)
    is_outside = torch.maximum(dr, dz) > 0.0
    out_pt = torch.where(dr > 0.0, edge_pt, cap_pt)
    out_n = (p - out_pt) / torch.where(
        is_outside, _safe_norm(p - out_pt), _c(p, 1.0))
    # Inside: the nearer of barrel and caps.
    barrel_closer = -dr < -dz
    in_pt = torch.where(barrel_closer, edge_pt, cap_pt)
    in_n = torch.where(barrel_closer, _vec(rd[0], rd[1], 0.0 * sz),
                       _vec(0.0 * sz, 0.0 * sz, sz))
    closest = torch.where(is_outside, out_pt, in_pt)
    normal = torch.where(is_outside, out_n, in_n)
    return phi, normal, closest


# -- convex hulls: params are the (m, 3) vertices, in the geometry frame ----


def _point_hull_projection(verts, p, iters: int = _FW_STEPS):
    """Euclidean projection of ``p`` onto conv(verts): away-step
    Frank-Wolfe on the barycentric weights from the nearest vertex, a fixed
    number of steps.  Not differentiated."""
    verts, p = verts.detach(), p.detach()
    m, dtype = verts.shape[0], p.dtype
    w = _onehot(torch.argmin(torch.sum((verts - p) ** 2, dim=1)), m, dtype)
    neg_inf = _c(p, float("-inf"))
    for _ in range(iters):
        x = w @ verts
        g = x - p  # gradient of 0.5 |x - p|^2
        scores = verts @ g
        e_s = _onehot(torch.argmin(scores), m, dtype)
        e_a = _onehot(torch.argmax(torch.where(w > 0, scores, neg_inf)), m,
                      dtype)
        d_fw = e_s @ verts - x
        d_aw = x - e_a @ verts
        use_fw = torch.sum(g * d_fw) <= torch.sum(g * d_aw)
        d = torch.where(use_fw, d_fw, d_aw)
        w_a = torch.sum(e_a * w)
        gmax = torch.where(use_fw, _c(p, 1.0),
                           w_a / torch.clamp_min(1.0 - w_a, 1e-30))
        gamma = torch.minimum(torch.clamp_min(
            -torch.sum(g * d) / torch.clamp_min(torch.sum(d * d), 1e-300),
            0.0), gmax)
        w_new = w + gamma * torch.where(use_fw, e_s - w, w - e_a)
        # The away vertex's weight w_a + gamma (w_a - 1) rounded once, as
        # XLA's fused multiply-add leaves it: on a drop step its residue's
        # sign decides whether the vertex stays active.
        w_away = _fma(gamma, w_a - 1.0, w_a)
        w = torch.where((e_a > 0) & ~use_fw, w_away, w_new)
    return w @ verts


def _deepest_support_plane(verts, p):
    """The unit direction that maximizes the support-plane margin
    <d, p> - max_v <d, v>: for a point inside, the nearest face's normal.
    A pass over 256 Fibonacci directions, then five rounds of 16 candidates
    on a shrinking cone about the best.  Not differentiated."""
    verts, p = verts.detach(), p.detach()
    dtype, device = p.dtype, p.device
    dirs = const(np.ascontiguousarray(
        _fibonacci_directions(_SUPPORT_DIRECTIONS)), device, dtype)

    def margin(ds):
        return ds @ p - torch.amax(ds @ verts.T, dim=1)

    d0 = _onehot(torch.argmax(margin(dirs)), _SUPPORT_DIRECTIONS,
                 dtype) @ dirs
    theta = np.arange(_CONE_CANDIDATES) * (2.0 * np.pi / _CONE_CANDIDATES)
    cs = const(np.cos(theta), device, dtype)[:, None]
    sn = const(np.sin(theta), device, dtype)[:, None]
    for r in _CONE_RADII:
        # Tangent frame of d0, away from its smallest component's axis.
        e = _onehot(torch.argmin(torch.abs(d0)), 3, dtype)
        t1 = mat3.cross(d0, e)
        t1 = t1 / _safe_norm(t1)
        t2 = mat3.cross(d0, t1)
        cands = d0[None] + r * (cs * t1 + sn * t2)
        cands = cands / _safe_norm(cands)[:, None]
        cands = torch.cat([d0[None], cands], dim=0)
        d0 = _onehot(torch.argmax(margin(cands)), _CONE_CANDIDATES + 1,
                     dtype) @ cands
    return d0


def _point_hull_distance(verts, p):
    """Signed distance from a hull-frame point to conv(verts): (phi,
    outward normal, closest surface point).  Outside: the distance to the
    frozen projection.  Inside: the depth below the deepest support plane
    (the sampled search's error is ~ extent * 3e-3)."""
    x = _point_hull_projection(verts, p)
    d_out = _safe_norm(p - x)
    n_in = _deepest_support_plane(verts, p)
    phi_in = n_in @ p - torch.amax(verts @ n_in)
    # Scale-relative test of "the projection converged onto p": inside.
    scale = torch.sqrt(torch.amax(torch.sum(verts * verts, dim=1)) + _EPS)
    inside = (phi_in <= 0.0) & (d_out <= 1e-3 * scale)
    phi = torch.where(inside, phi_in, d_out)
    normal = torch.where(inside, n_in, (p - x) / d_out)
    closest = torch.where(inside, p - phi_in * n_in, x)
    return phi, normal, closest


def sphere_vs_point_shape(shape_type, params_b, R_b, p_b, center_a, radius_a):
    """A sphere (A) against a point-queryable shape (B), world frame."""
    c_local = mat3.tmv(R_b, center_a - p_b)
    shape_type = GeomType(shape_type)
    if shape_type == GeomType.BOX:
        phi_pt, n_l, cl = _point_box_distance(c_local, params_b[:3])
    elif shape_type == GeomType.CAPSULE:
        phi_pt, n_l, cl = _point_capsule_distance(c_local, params_b[0],
                                                  params_b[1])
    elif shape_type == GeomType.CYLINDER:
        phi_pt, n_l, cl = _point_cylinder_distance(c_local, params_b[0],
                                                   params_b[1])
    elif shape_type == GeomType.SPHERE:
        dist = _safe_norm(c_local)
        phi_pt = dist - params_b[0]
        n_l = c_local / dist
        cl = n_l * params_b[0]
    elif shape_type == GeomType.HALFSPACE:
        # The halfspace is z <= 0 of its frame.
        zero = 0.0 * c_local[2]
        phi_pt = c_local[2]
        n_l = _vec(zero, zero, zero + 1.0)
        cl = _vec(c_local[0], c_local[1], zero)
    elif shape_type == GeomType.CONVEX:
        phi_pt, n_l, cl = _point_hull_distance(params_b, c_local)
    else:
        raise NotImplementedError(f"shape {shape_type}")
    # n_l points from B toward the sphere; A -> B is its opposite.
    n_world = -mat3.mv(R_b, n_l)
    return (phi_pt - radius_a, n_world, center_a + n_world * radius_a,
            mat3.mv(R_b, cl) + p_b)


def signed_distance(type_a, params_a, R_a, p_a, type_b, params_b, R_b, p_b):
    """Signed distance between two geometries (world frame), dispatched
    on the pair of types: (phi, nhat_AB_W, witness_A_W, witness_B_W)."""
    ta, tb = GeomType(type_a), GeomType(type_b)
    if ta == GeomType.SPHERE and tb in _POINT_SHAPES:
        return sphere_vs_point_shape(tb, params_b, R_b, p_b, p_a, params_a[0])
    if tb == GeomType.SPHERE and ta in _POINT_SHAPES:
        phi, n, wa, wb = sphere_vs_point_shape(ta, params_a, R_a, p_a, p_b,
                                               params_b[0])
        return phi, -n, wb, wa
    if ta == GeomType.BOX and tb == GeomType.BOX:
        return _box_vs_box(params_a, R_a, p_a, params_b, R_b, p_b)
    if ta == GeomType.CAPSULE and tb in _CAPSULE_SEARCH_SHAPES:
        return _capsule_vs_shape(params_a, R_a, p_a, tb, params_b, R_b, p_b)
    if tb == GeomType.CAPSULE and ta in _CAPSULE_SEARCH_SHAPES:
        phi, n, wa, wb = _capsule_vs_shape(params_b, R_b, p_b, ta, params_a,
                                           R_a, p_a)
        return phi, -n, wb, wa
    if ta == GeomType.CAPSULE and tb == GeomType.CAPSULE:
        return _capsule_vs_capsule(params_a, R_a, p_a, params_b, R_b, p_b)
    if ta in _SUPPORT_SHAPES and tb == GeomType.HALFSPACE:
        return _convex_vs_halfspace(ta, params_a, R_a, p_a, R_b, p_b)
    if ta == GeomType.HALFSPACE and tb in _SUPPORT_SHAPES:
        phi, n, wa, wb = _convex_vs_halfspace(tb, params_b, R_b, p_b, R_a,
                                              p_a)
        return phi, -n, wb, wa
    if ta in _SUPPORT_SHAPES and tb in _SUPPORT_SHAPES:
        return _convex_vs_convex(ta, params_a, R_a, p_a, tb, params_b, R_b,
                                 p_b)
    raise NotImplementedError(
        f"signed distance for pair ({ta.name}, {tb.name}) not implemented"
    )


def _segment_segment_closest(p1, q1, p2, q2):
    """Closest points between segments [p1, q1] and [p2, q2] (clamped
    projection with guarded divisions and one re-projection)."""
    d1, d2, r = q1 - p1, q2 - p2, p1 - p2
    a, e, b = mat3.dot(d1, d1), mat3.dot(d2, d2), mat3.dot(d1, d2)
    c, f = mat3.dot(d1, r), mat3.dot(d2, r)
    denom = a * e - b * b
    zero, one = _c(a, 0.0), _c(a, 1.0)
    s = _clip((b * f - c * e) / torch.where(denom < _EPS, one, denom),
              zero, one)
    t = _clip((b * s + f) / torch.where(e < _EPS, one, e), zero, one)
    # Re-project s for the clamped t (exact for a pair of segments).
    s = _clip((b * t - c) / torch.where(a < _EPS, one, a), zero, one)
    return p1 + s * d1, p2 + t * d2


def _box_vs_box(params_a, R_a, p_a, params_b, R_b, p_b):
    """Box-box distance over each box's 8 corners and 6 face centres
    against the other box (vertex-face, both ways; the face centres catch a
    face-face overlap whose deepest point is inside a face) and the 144
    edge-edge closest pairs: exact for separated boxes; penetration is the
    deepest corner's (crossed-edge penetration is approximate)."""
    dtype, device = R_a.dtype, R_a.device
    cand = const(_box_candidates_np(), device, dtype)
    half_a, half_b = params_a[:3], params_b[:3]

    def corners_vs_box(c_world, R_box, p_box, half, flip):
        def one(c):
            phi, n_l, cl = _point_box_distance(mat3.tmv(R_box, c - p_box),
                                               half)
            n_w = mat3.mv(R_box, n_l)
            return phi, (-n_w if flip else n_w), c, mat3.mv(R_box, cl) + p_box

        return vmap(one)(c_world)

    phi_a, n_a, wc_a, wb_a = corners_vs_box(
        mat3.mv(R_a, cand * half_a) + p_a, R_b, p_b, half_b, True)
    i_a = torch.argmin(phi_a)
    best = (phi_a[i_a], n_a[i_a], wc_a[i_a], wb_a[i_a])
    phi_b, n_b, wc_b, wb_b = corners_vs_box(
        mat3.mv(R_b, cand * half_b) + p_b, R_a, p_a, half_a, False)
    i_b = torch.argmin(phi_b)
    cand_b = (phi_b[i_b], n_b[i_b], wb_b[i_b], wc_b[i_b])
    pick = cand_b[0] < best[0]
    best = tuple(torch.where(pick, c, b) for c, b in zip(cand_b, best))

    edges = const(_box_edges_np(), device, dtype)
    ea = mat3.mv(R_a, edges * half_a) + p_a  # (12, 2, 3)
    eb = mat3.mv(R_b, edges * half_b) + p_b

    def one_pair(sa, sb):
        ca, cb = _segment_segment_closest(sa[0], sa[1], sb[0], sb[1])
        d = _safe_norm(ca - cb)
        return d, (cb - ca) / d, ca, cb

    phi_e, n_e, wa_e, wb_e = vmap(
        lambda sa: vmap(lambda sb: one_pair(sa, sb))(eb))(ea)
    flat = torch.argmin(phi_e.reshape(-1))
    cand_e = tuple(x.reshape((144,) + x.shape[2:])[flat]
                   for x in (phi_e, n_e, wa_e, wb_e))
    pick_e = cand_e[0] < best[0]
    return tuple(torch.where(pick_e, c, b) for c, b in zip(cand_e, best))


def _capsule_vs_capsule(params_a, R_a, p_a, params_b, R_b, p_b):
    """Capsule against capsule: the closest points of the two axis
    segments, then sphere against sphere between them."""
    ra, ha = params_a[0], params_a[1]
    rb, hb = params_b[0], params_b[1]
    da = R_a[:, 2] * ha  # half-axis vectors
    db = R_b[:, 2] * hb
    r = p_a - p_b
    A, Bq, C = mat3.dot(da, da), mat3.dot(da, db), mat3.dot(db, db)
    D, E = mat3.dot(da, r), mat3.dot(db, r)
    denom = A * C - Bq * Bq
    one = _c(A, 1.0)
    # Segment parameters s, t in [-1, 1]: p_a + s da and p_b + t db.
    s = _clip((Bq * E - C * D) / torch.where(denom < 1e-12, one, denom),
              -one, one)
    t = _clip((Bq * s + E) / torch.where(C < 1e-12, one, C), -one, one)
    s = _clip((Bq * t - D) / torch.where(A < 1e-12, one, A), -one, one)
    ca, cb = p_a + s * da, p_b + t * db
    d = _safe_norm(ca - cb)
    n_ab = (cb - ca) / d
    return d - ra - rb, n_ab, ca + n_ab * ra, cb - n_ab * rb


def _point_shape_phi(shape_type, params, p_local):
    """Signed distance alone of a shape-frame point to a shape."""
    shape_type = GeomType(shape_type)
    if shape_type == GeomType.BOX:
        return _point_box_distance(p_local, params[:3])[0]
    if shape_type == GeomType.CAPSULE:
        return _point_capsule_distance(p_local, params[0], params[1])[0]
    if shape_type == GeomType.CYLINDER:
        return _point_cylinder_distance(p_local, params[0], params[1])[0]
    if shape_type == GeomType.SPHERE:
        return _safe_norm(p_local) - params[0]
    if shape_type == GeomType.HALFSPACE:
        return p_local[2]
    if shape_type == GeomType.CONVEX:
        return _point_hull_distance(params, p_local)[0]
    raise NotImplementedError(f"shape {shape_type}")


def _capsule_vs_shape(params_cap, R_c, p_c, shape_type, params_s, R_s, p_s):
    """Capsule (A) against a convex shape (B).  The signed distance to a
    convex body is convex along the capsule's axis segment a + t (b - a),
    so a ternary search of fixed length finds the minimizing t (to 1e-8 of
    the segment after 48 steps); the capsule is then the sphere of its
    radius centred there.  The search runs on detached inputs (the envelope
    theorem gives the derivative at the frozen minimizer)."""
    radius, hl = params_cap[0], params_cap[1]
    axis_w = R_c[:, 2]
    a_w = p_c - hl * axis_w
    b_w = p_c + hl * axis_w
    a_l = mat3.tmv(R_s, a_w - p_s).detach()
    b_l = mat3.tmv(R_s, b_w - p_s).detach()
    prm = params_s.detach()

    def phi_of(t):
        return _point_shape_phi(shape_type, prm, a_l + t * (b_l - a_l))

    lo = torch.zeros_like(a_l[0])
    hi = torch.ones_like(lo)
    for _ in range(_TERNARY_STEPS):
        m1 = lo + (hi - lo) / 3.0
        m2 = hi - (hi - lo) / 3.0
        phi = vmap(phi_of)(torch.stack([m1, m2]))  # both probes at once
        pick = phi[0] < phi[1]
        lo, hi = torch.where(pick, lo, m1), torch.where(pick, m2, hi)
    t = 0.5 * (lo + hi)
    return sphere_vs_point_shape(shape_type, params_s, R_s, p_s,
                                 a_w + t * (b_w - a_w), radius)


def _solid_projection(shape_type, params, p):
    """Euclidean projection of a shape-frame point onto the solid shape
    (not differentiated: its callers freeze it)."""
    shape_type = GeomType(shape_type)
    if shape_type == GeomType.BOX:
        return _clip(p, -params[:3], params[:3])
    if shape_type == GeomType.CYLINDER:
        r, h = params[0], params[1]
        scale = torch.clamp_max(r / _safe_norm(p[:2]), 1.0)
        return torch.cat([p[:2] * scale, _clip(p[2], -h, h)[None]])
    if shape_type == GeomType.SPHERE:
        return p * torch.clamp_max(params[0] / _safe_norm(p), 1.0)
    if shape_type == GeomType.CONVEX:
        return _point_hull_projection(params, p)
    raise NotImplementedError(f"solid projection for {shape_type}")


def _surface_candidates(shape_type, params):
    """(n, 3) shape-frame surface points covering the support features:
    the penetration-depth candidates.  A box: 8 corners and 6 face
    centres; a cylinder: the two cap centres, the two rims and the mid
    ring (12 points each); a hull: its vertices."""
    shape_type = GeomType(shape_type)
    dtype, device = params.dtype, params.device
    if shape_type == GeomType.BOX:
        return const(_box_candidates_np(), device, dtype) * params[:3]
    if shape_type == GeomType.CYLINDER:
        r, h = params[0], params[1]
        ring = const(_cylinder_ring_np(), device, dtype)
        zhat = const(np.array([[0.0, 0.0, 1.0]]), device, dtype)
        return torch.cat([zhat * h, -zhat * h, ring * r + zhat * h,
                          ring * r - zhat * h, ring * r], dim=0)
    if shape_type == GeomType.CONVEX:
        return params
    raise NotImplementedError(f"surface candidates for {shape_type}")


def _point_query(shape_type, params, u):
    """(phi, outward normal, closest point) of a shape-frame point against
    a support shape."""
    shape_type = GeomType(shape_type)
    if shape_type == GeomType.BOX:
        return _point_box_distance(u, params[:3])
    if shape_type == GeomType.CONVEX:
        return _point_hull_distance(params, u)
    return _point_cylinder_distance(u, params[0], params[1])


def _convex_vs_halfspace(shape_type, params, R_a, p_a, R_h, p_h):
    """A support shape (A) against a halfspace (B, z <= 0 of its frame),
    exact: A's support point along the inward normal."""
    shape_type = GeomType(shape_type)
    n_w = R_h[:, 2]  # outward plane normal, world
    m = mat3.tmv(R_a, n_w)  # the same in A's frame
    one = _c(m, 1.0)
    if shape_type == GeomType.BOX:
        support = -torch.sign(torch.where(m == 0.0, one, m)) * params[:3]
    elif shape_type == GeomType.CYLINDER:
        r, h = params[0], params[1]
        mxy = _safe_norm(m[:2])
        z = -torch.sign(torch.where(m[2] == 0.0, one, m[2])) * h
        support = torch.cat([-m[:2] / mxy * r, z[None]])
    elif shape_type == GeomType.CONVEX:
        # The lowest stored vertex, one-hot selected so that the pose's
        # derivative flows through the winner.
        hot = _onehot(torch.argmin(params @ m.detach()), params.shape[0],
                      m.dtype)
        support = hot @ params
    else:
        raise NotImplementedError(f"halfspace pair for {shape_type}")
    x_w = mat3.mv(R_a, support) + p_a  # deepest point of A
    phi = mat3.dot(n_w, x_w - p_h)
    return phi, -n_w, x_w, x_w - phi * n_w


def _convex_vs_convex(ta, params_a, R_a, p_a, tb, params_b, R_b, p_b):
    """Support shape (A) against support shape (B).

    Separated: alternating projections between the two solids (64 rounds,
    from A's origin nudged by 1e-3 in each axis) converge to the closest
    pair; the distance is evaluated again smoothly at the frozen local
    witness coordinates.  Penetrating: each shape's surface candidates are
    scored by the other shape's signed distance and the deepest wins --
    exact for vertex-face contact, sampled for rim and edge contact."""
    Rad, pad, Rbd, pbd = (x.detach() for x in (R_a, p_a, R_b, p_b))
    prm_a, prm_b = params_a.detach(), params_b.detach()

    def proj(shape_type, prm, R, p, x):
        return mat3.mv(R, _solid_projection(shape_type, prm,
                                            mat3.tmv(R, x - p))) + p

    x = pad + 1e-3  # a nudge off the symmetric start
    for _ in range(_PROJECTION_STEPS):
        x = proj(ta, prm_a, Rad, pad, proj(tb, prm_b, Rbd, pbd, x))
    y = proj(tb, prm_b, Rbd, pbd, x)
    xa = mat3.mv(R_a, mat3.tmv(Rad, x - pad)) + p_a
    yb = mat3.mv(R_b, mat3.tmv(Rbd, y - pbd)) + p_b
    d = _safe_norm(yb - xa)
    n_sep = (yb - xa) / d

    def deepest(t_own, prm_own, R_own, p_own, t_oth, prm_oth, R_oth, p_oth):
        """The own candidate deepest in the other shape (chosen on frozen
        poses), queried again with the pose's derivative."""
        c = _surface_candidates(t_own, prm_own.detach())
        c_w = vmap(lambda u: mat3.mv(R_own.detach(), u) + p_own.detach())(c)
        phi = vmap(lambda xw: _point_shape_phi(
            t_oth, prm_oth.detach(),
            mat3.tmv(R_oth.detach(), xw - p_oth.detach())))(c_w)
        hot = _onehot(torch.argmin(phi), c.shape[0], phi.dtype)
        x_pen = mat3.mv(R_own, hot @ c) + p_own
        phi_pen, n_l, cl = _point_query(t_oth, prm_oth,
                                        mat3.tmv(R_oth, x_pen - p_oth))
        return phi_pen, x_pen, mat3.mv(R_oth, n_l), mat3.mv(R_oth, cl) + p_oth

    phi_pa, xa_pen, n_b_out, wb_a = deepest(ta, params_a, R_a, p_a,
                                            tb, params_b, R_b, p_b)
    phi_pb, yb_pen, n_a_out, wa_b = deepest(tb, params_b, R_b, p_b,
                                            ta, params_a, R_a, p_a)
    use_a = phi_pa <= phi_pb
    phi_pen = torch.where(use_a, phi_pa, phi_pb)
    n_pen = torch.where(use_a, -n_b_out, n_a_out)
    wa_pen = torch.where(use_a, xa_pen, wa_b)
    wb_pen = torch.where(use_a, wb_a, yb_pen)

    overlap = phi_pen < 0.0
    return (torch.where(overlap, phi_pen, d),
            torch.where(overlap, n_pen, n_sep),
            torch.where(overlap, wa_pen, xa),
            torch.where(overlap, wb_pen, yb))
