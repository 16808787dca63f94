"""SoA contact: signed distances and the smoothed compliant force law,
instance axis trailing (counterpart of ``idto_tpu/soa/contact.py``).

Pair kernels: sphere vs point-queryable shape (sphere, box, capsule,
cylinder, halfspace, convex hull), box vs box (14 candidate points each
way plus 144 edge pairs), capsule vs capsule (closest points of the two
axis segments), capsule vs box, cylinder, halfspace or hull (the point of
the capsule's axis where the shape's distance is least, then the sphere
query there: against a box a bisection on the distance's slope with one
Newton correction that gives the point its exact derivative, against the
others a 48-step ternary search), and the generic pairs of box, cylinder
and hull against each other or a halfspace (``soa/convex.py``).  Every
pair but a halfspace against a halfspace has a kernel; ``supports_soa``
says whether a model's pair set is covered.

Clamps are written as ``torch.minimum``/``torch.maximum`` against tensors
because their derivative splits evenly at ties, as ``jnp.clip`` and
``jnp.maximum`` do; ``torch.where`` evaluates both branches, so the same
guarded forms (``_EPS``) are kept.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from idto_tpu_torch.models.model import GeomType, Model
from idto_tpu_torch.soa import convex, mat3
from idto_tpu_torch.soa.kinematics import body_velocities
from idto_tpu_torch.utils.consts import const
from idto_tpu_torch.utils.profiler import instrument

_EPS = 1e-12

_POINT_SHAPES = (
    GeomType.BOX,
    GeomType.CAPSULE,
    GeomType.CYLINDER,
    GeomType.SPHERE,
    GeomType.HALFSPACE,
    GeomType.CONVEX,
)
# Shapes a capsule is held against by the search along its axis.
_CAPSULE_SEARCH_SHAPES = (GeomType.BOX, GeomType.HALFSPACE, GeomType.CYLINDER,
                          GeomType.CONVEX)
_TERNARY_STEPS = 48
# Bisections of [0, 1] along a capsule's axis against a box: past the
# spacing of doubles below 1, so that a least point at an end is that end.
_BISECTIONS = 64
# A box's faces whose depths at the least point lie within _TIE x the
# axis's length of the deepest's are tied there: the bisection leaves the
# point within a few roundings of a kink, where tied depths differ by
# about 1e-17 m.
_TIE = 1e-9


def pair_supported(ta, tb) -> bool:
    """The ordered type pair has an SoA kernel: all but a halfspace against
    a halfspace."""
    return not (GeomType(ta) == GeomType.HALFSPACE
                and GeomType(tb) == GeomType.HALFSPACE)


def supports_soa(model: Model) -> bool:
    """Every candidate pair of the model has an SoA kernel."""
    g = model.geoms
    if g is None or not g.pairs:
        return True
    return all(pair_supported(g.types[ia], g.types[ib]) for ia, ib in g.pairs)


def _c(x, value):
    """Scalar constant tensor matching x's dtype and device."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


# -- point-to-shape distances (components on axis 0, any trailing axes) -----


def _point_box(p, half):
    q = torch.abs(p) - half
    qmax = torch.maximum(torch.maximum(q[0], q[1]), q[2])
    outside = torch.maximum(q, _c(q, 0.0))
    dist_out = mat3.norm(outside)
    phi = torch.where(qmax > 0.0, dist_out, torch.minimum(qmax, _c(qmax, 0.0)))
    clamped = _clip(p, -half, half)
    face = torch.argmax(q, dim=0)
    onehot = torch.stack([(face == i) for i in range(3)], dim=0).to(p.dtype)
    pf = mat3.dot(onehot, p)
    sign = torch.sign(torch.where(pf == 0.0, _c(pf, 1.0), pf))
    inside_pt = clamped * (1.0 - onehot) + onehot * (sign[None] * half)
    out = (qmax > 0.0)[None]
    closest = torch.where(out, clamped, inside_pt)
    normal = torch.where(
        out, (p - clamped) / dist_out[None], onehot * sign[None]
    )
    return phi, normal, closest


def _point_capsule(p, radius, half_len):
    z = _clip(p[2], -half_len, half_len)
    d = torch.stack([p[0], p[1], p[2] - z], dim=0)
    dist = mat3.norm(d)
    phi = dist - radius
    normal = d / dist[None]
    seg = torch.stack([torch.zeros_like(z), torch.zeros_like(z), z], dim=0)
    closest = seg + normal * radius[None]
    return phi, normal, closest


def _point_cylinder(p, radius, half_len):
    rho = torch.sqrt(p[0] * p[0] + p[1] * p[1] + _EPS)
    dr = rho - radius
    dz = torch.abs(p[2]) - half_len
    out_r = torch.maximum(dr, _c(dr, 0.0))
    out_z = torch.maximum(dz, _c(dz, 0.0))
    phi = torch.sqrt(out_r * out_r + out_z * out_z + _EPS) + torch.minimum(
        torch.maximum(dr, dz), _c(dr, 0.0)
    )
    rdirx, rdiry = p[0] / rho, p[1] / rho
    sz = torch.sign(torch.where(p[2] == 0.0, _c(p, 1.0), p[2]))
    zc = _clip(p[2], -half_len, half_len)
    edge_pt = torch.stack([rdirx * radius, rdiry * radius, zc], dim=0)
    rho_c = torch.minimum(rho, radius)
    cap_pt = torch.stack([rdirx * rho_c, rdiry * rho_c, sz * half_len], dim=0)
    is_out = torch.maximum(dr, dz) > 0.0
    out_pt = torch.where((dr > 0.0)[None], edge_pt, cap_pt)
    d_out = p - out_pt
    n_out = d_out / torch.where(is_out, mat3.norm(d_out), _c(p, 1.0))[None]
    barrel_closer = (-dr < -dz)[None]
    in_pt = torch.where(barrel_closer, edge_pt, cap_pt)
    zero = torch.zeros_like(rdirx)
    n_in = torch.where(
        barrel_closer,
        torch.stack([rdirx, rdiry, zero], dim=0),
        torch.stack([zero, zero, sz], dim=0),
    )
    closest = torch.where(is_out[None], out_pt, in_pt)
    normal = torch.where(is_out[None], n_out, n_in)
    return phi, normal, closest


def sphere_vs_point_shape(shape_type, params_b, R_b, p_b, center_a, radius_a):
    """Sphere (A) vs point-queryable shape (B), world frame, components
    leading; a hull's params are its vertices.  Returns (phi, nhat_AB, w_a,
    w_b)."""
    c_local = mat3.tmv(R_b, center_a - p_b)
    if shape_type == GeomType.BOX:
        phi_pt, n_l, cl = _point_box(c_local, params_b[:3])
    elif shape_type == GeomType.CAPSULE:
        phi_pt, n_l, cl = _point_capsule(c_local, params_b[0], params_b[1])
    elif shape_type == GeomType.CYLINDER:
        phi_pt, n_l, cl = _point_cylinder(c_local, params_b[0], params_b[1])
    elif shape_type == GeomType.SPHERE:
        dist = mat3.norm(c_local)
        phi_pt = dist - params_b[0]
        n_l = c_local / dist[None]
        cl = n_l * params_b[0][None]
    elif shape_type == GeomType.HALFSPACE:
        phi_pt = c_local[2]
        zero = torch.zeros_like(c_local[2])
        n_l = torch.stack([zero, zero, torch.ones_like(c_local[2])], dim=0)
        cl = torch.stack([c_local[0], c_local[1], zero], dim=0)
    elif shape_type == GeomType.CONVEX:
        phi_pt, n_l, cl = convex.point_hull(params_b, c_local)
    else:
        raise NotImplementedError(f"shape {shape_type}")
    phi = phi_pt - radius_a
    n_world = -mat3.mv(R_b, n_l)
    w_b = mat3.mv(R_b, cl) + p_b
    w_a = center_a + n_world * radius_a[None]
    return phi, n_world, w_a, w_b


# -- box vs box --------------------------------------------------------------


def _box_candidates_np():
    signs = np.array(list(itertools.product([-1.0, 1.0], repeat=3)))
    faces = np.concatenate([np.eye(3), -np.eye(3)])
    return np.concatenate([signs, faces])  # (14, 3)


def _box_edges_np():
    edges = []
    for k in range(3):
        for s1, s2 in itertools.product([-1.0, 1.0], repeat=2):
            lo = [0.0, 0.0, 0.0]
            hi = [0.0, 0.0, 0.0]
            other = [i for i in range(3) if i != k]
            lo[k], hi[k] = -1.0, 1.0
            lo[other[0]] = hi[other[0]] = s1
            lo[other[1]] = hi[other[1]] = s2
            edges.append([lo, hi])
    return np.asarray(edges)  # (12, 2, 3)


def _argmin_select(phi, *fields):
    """argmin over axis 0 of phi (C, ...) and one-hot selection of each
    field: scalar fields (C, ...) or component-leading (3, C, ...)."""
    i = torch.argmin(phi, dim=0)
    C = phi.shape[0]
    hot = torch.stack([(i == c) for c in range(C)], dim=0).to(phi.dtype)
    out = [torch.sum(phi * hot, dim=0)]
    for f in fields:
        if f.ndim == phi.ndim + 1:
            out.append(torch.sum(f * hot[None], dim=1))
        else:
            out.append(torch.sum(f * hot, dim=0))
    return out


def _segment_segment(p1, q1, p2, q2):
    """Closest points between segments; all (3, ...)."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = mat3.dot(d1, d1)
    e = mat3.dot(d2, d2)
    b = mat3.dot(d1, d2)
    c = mat3.dot(d1, r)
    f = mat3.dot(d2, r)
    denom = a * e - b * b
    zero, one = _c(a, 0.0), _c(a, 1.0)
    s = _clip((b * f - c * e) / torch.where(denom < _EPS, one, denom), zero, one)
    t = _clip((b * s + f) / torch.where(e < _EPS, one, e), zero, one)
    s = _clip((b * t - c) / torch.where(a < _EPS, one, a), zero, one)
    return p1 + s[None] * d1, p2 + t[None] * d2


def _select(pick, new, old):
    return [
        torch.where(pick[None] if xo.ndim == pick.ndim + 1 else pick, xn, xo)
        for xo, xn in zip(old, new)
    ]


def box_vs_box(params_a, R_a, p_a, params_b, R_b, p_b):
    """Box-box distance with the JAX package's candidate set and tie
    breaking: params (3, P, 1), R (3, 3, P, N), p (3, P, N)."""
    dtype, device = R_a.dtype, R_a.device
    cand = const(_box_candidates_np(), device, dtype)
    half_a = params_a[:3]
    half_b = params_b[:3]
    # (3, 14, 1, 1) * (3, 1, P, 1) -> (3, 14, P, 1)
    ca = cand.T[:, :, None, None] * half_a[:, None]
    cb = cand.T[:, :, None, None] * half_b[:, None]

    def corners_vs_box(c_local_own, R_own, p_own, R_box, p_box, half, flip):
        c_world = mat3.mv(R_own[:, :, None], c_local_own) + p_own[:, None]
        c_in_box = mat3.tmv(R_box[:, :, None], c_world - p_box[:, None])
        phi, n_l, cl = _point_box(c_in_box, half[:, None])
        n_w = mat3.mv(R_box[:, :, None], n_l)
        wbox = mat3.mv(R_box[:, :, None], cl) + p_box[:, None]
        return phi, (-n_w if flip else n_w), c_world, wbox

    phi_a, n_a, wc_a, wb_a = corners_vs_box(ca, R_a, p_a, R_b, p_b, half_b, True)
    best = _argmin_select(phi_a, n_a, wc_a, wb_a)
    phi_b, n_b, wc_b, wb_b = corners_vs_box(cb, R_b, p_b, R_a, p_a, half_a, False)
    cand_b = _argmin_select(phi_b, n_b, wb_b, wc_b)
    best = _select(cand_b[0] < best[0], cand_b, best)

    edges = const(_box_edges_np(), device, dtype)

    def edge_world(which, R, p, half):
        # (3, 12, 1, 1) * (3, 1, P, 1) -> (3, 12, P, 1)
        pts = edges[:, which, :].T[:, :, None, None] * half[:, None]
        return mat3.mv(R[:, :, None], pts) + p[:, None]

    a0 = edge_world(0, R_a, p_a, half_a)
    a1 = edge_world(1, R_a, p_a, half_a)
    b0 = edge_world(0, R_b, p_b, half_b)
    b1 = edge_world(1, R_b, p_b, half_b)
    # (3, 12, 1, ...) x (3, 1, 12, ...) -> (3, 12, 12, ...)
    caw, cbw = _segment_segment(
        a0[:, :, None], a1[:, :, None], b0[:, None, :], b1[:, None, :]
    )
    d = mat3.norm(caw - cbw)
    n_e = (cbw - caw) / d[None]

    def flat(x):
        if x.ndim == d.ndim + 1:
            return x.reshape(x.shape[0], 144, *x.shape[3:])
        return x.reshape(144, *x.shape[2:])

    cand_e = _argmin_select(flat(d), flat(n_e), flat(caw), flat(cbw))
    return _select(cand_e[0] < best[0], cand_e, best)


# -- capsule pairs ------------------------------------------------------------


def capsule_vs_capsule(params_a, R_a, p_a, params_b, R_b, p_b):
    """Capsule vs capsule: closest points of the two axis segments (clamped
    projection with guarded divisions and one re-projection, exact for a
    pair of segments), then sphere vs sphere between them.  params
    (3, P, 1) = [radius, half length, -], R (3, 3, P, N), p (3, P, N)."""
    ra, ha = params_a[0], params_a[1]
    rb, hb = params_b[0], params_b[1]
    da = R_a[:, 2] * ha[None]  # half-axis vectors
    db = R_b[:, 2] * hb[None]
    r = p_a - p_b
    A = mat3.dot(da, da)
    Bq = mat3.dot(da, db)
    C = mat3.dot(db, db)
    D = mat3.dot(da, r)
    E = mat3.dot(db, r)
    denom = A * C - Bq * Bq
    one = _c(A, 1.0)
    # Segment parameters s, t in [-1, 1]: p_a + s da and p_b + t db.
    s = _clip((Bq * E - C * D) / torch.where(denom < _EPS, one, denom),
              -one, one)
    t = _clip((Bq * s + E) / torch.where(C < _EPS, one, C), -one, one)
    s = _clip((Bq * t - D) / torch.where(A < _EPS, one, A), -one, one)
    ca = p_a + s[None] * da
    cb = p_b + t[None] * db
    d = mat3.norm(ca - cb)
    n_ab = (cb - ca) / d[None]
    phi = d - ra - rb
    return phi, n_ab, ca + n_ab * ra[None], cb - n_ab * rb[None]


def _point_shape_phi(shape_type, params, p):
    """Signed distance alone of shape-frame points p (3, ...) to a shape:
    the objective of the ternary search along a capsule's axis."""
    if shape_type == GeomType.CYLINDER:
        return _point_cylinder(p, params[0], params[1])[0]
    if shape_type == GeomType.HALFSPACE:
        return p[2]
    if shape_type == GeomType.CONVEX:
        return convex.point_hull(params, p)[0]
    raise NotImplementedError(f"shape {shape_type}")


def _ternary_search(params_cap, R_c, p_c, shape_type, params_s, R_s, p_s):
    """The capsule's axis point where a cylinder's, a halfspace's or a
    hull's distance is least, by a 48-step ternary search on detached
    inputs (to 1e-8 of the segment; the distance is convex along the
    segment a + t (b - a)): the centre (3, P, N), t held fixed."""
    hl = params_cap[1]
    axis_w = R_c[:, 2]
    a_w = p_c - hl[None] * axis_w
    b_w = p_c + hl[None] * axis_w
    # Segment end points in the shape's frame, for the search's objective.
    a_l = mat3.tmv(R_s, a_w - p_s).detach()
    d_l = mat3.tmv(R_s, b_w - p_s).detach() - a_l
    prm = convex.with_candidate_axis(shape_type, params_s.detach())
    lo = torch.zeros_like(a_l[0])
    hi = torch.ones_like(lo)
    for _ in range(_TERNARY_STEPS):
        third = (hi - lo) / 3.0
        m = torch.stack([lo + third, hi - third], dim=0)  # (2, P, N)
        phi = _point_shape_phi(shape_type, prm,
                               a_l[:, None] + m[None] * d_l[:, None])
        pick = phi[0] < phi[1]
        lo, hi = torch.where(pick, lo, m[0]), torch.where(pick, m[1], hi)
    t = 0.5 * (lo + hi)
    return a_w + t[None] * (b_w - a_w)


def _rising(p, d, neg_d, half):
    """Whether the box distance of box-frame points p + s d rises at s = 0:
    the sign of the outward normal of ``_point_box`` along d, without its
    length (sign(p_i) taken as 1 at p_i = 0)."""
    q = torch.abs(p) - half
    sd = torch.where(p < 0.0, neg_d, d)
    out = mat3.dot(torch.clamp_min(q, 0.0), sd)
    face = torch.gather(sd, 0, torch.argmax(q, dim=0, keepdim=True))[0]
    return torch.where(torch.amax(q, dim=0) > 0.0, out, face) > 0.0


def _box_slope(p, d, half):
    """d phi / ds of the box distance of p + s d at s = 0 (the outward
    normal along d), and where p is outside the box the second derivative,
    else 0 (the distance is piecewise linear inside)."""
    phi, normal, _ = _point_box(p, half)
    slope = mat3.dot(normal, d)
    out = torch.abs(p) - half
    outside = torch.amax(out, dim=0) > 0.0
    active = (out > 0.0).to(p.dtype)
    curv = torch.where(
        outside, (mat3.dot(active * d, d) - slope * slope)
        / torch.where(outside, phi, _c(phi, 1.0)), _c(phi, 0.0))
    return slope, curv


def _six(x):
    """(3, ...) -> (6, ...): the components along the faces +x, -x, +y,
    -y, +z, -z."""
    return torch.stack([x, -x], dim=1).reshape(6, *x.shape[1:])


def _first(mask, dtype):
    """One-hot (6, ...) of the first true entry of each column of mask, or
    of the first entry where none is."""
    first = torch.argmax(mask.to(dtype), dim=0)
    return (const(np.arange(6).reshape(6, 1, 1), mask.device)
            == first).to(dtype)


def capsule_vs_box(params_cap, R_c, p_c, params_b, R_b, p_b):
    """Capsule (A) vs box (B): the sphere of the capsule's radius at the
    point of its axis segment a + t (b - a) where the box's distance phi(t)
    is least.  phi is convex in t, so its slope rises: 64 bisections of
    [0, 1] on the slope's sign, on detached inputs, give t* = the largest
    t with phi'(t) <= 0, to rounding.  One Newton correction then gives t
    its exact derivative (the implicit function theorem):
    t = t* - (g - sg(g)) / sg(g'), whose value is t* and whose derivative
    is -(dg/dq) / g', where sg holds its argument's value with no
    derivative and g is

    - outside the box, phi'(t) (phi is smooth there);
    - inside it, where phi is the deepest of the six faces' depths, each
      linear in t, and t* a kink between two: the depth of the first tied
      face (``_TIE``, faces in the order +x, -x, +y, -y, +z, -z) that rises
      along the axis less that of the first tied face that falls or stays
      level.  phi, the normal and the box's witness are then the falling
      face's, the face on a's side of t*, whatever rounding makes deepest
      at t*.

    Where t* is an end of the segment, or phi''(t*) = 0 outside (the axis
    parallel to a face it projects inside: every t of a stretch is least,
    and t* is the one nearest b), t is held at t*.  params (3, P, 1), R
    (3, 3, P, N), p (3, P, N); returns (phi, nhat_AB, w_a, w_b)."""
    radius = params_cap[0]
    half = R_c[:, 2] * params_cap[1][None]  # the half-axis, world
    hb = params_b[:3]
    a = mat3.tmv(R_b, p_c - half - p_b)  # the axis's ends, box frame
    d = mat3.tmv(R_b, 2.0 * half)
    with instrument("physics.capsule_search"):
        a0, d0, h0 = a.detach(), d.detach(), hb.detach()
        neg_d0 = -d0
        t0 = torch.zeros_like(a0[0])
        for k in range(_BISECTIONS):
            # t0 + 2^-(k+1) is the midpoint of [t0, t0 + 2^-k].
            mid = t0 + 0.5 ** (k + 1)
            t0 = torch.where(_rising(a0 + mid[None] * d0, d0, neg_d0, h0),
                             t0, mid)
        zero, one = _c(t0, 0.0), _c(t0, 1.0)
        interior = (t0 > 0.0) & (t0 < 1.0)
        p = a + t0[None] * d
        slope, curv = _box_slope(p, d, hb)
        curv = curv.detach()
        inside = torch.amax(torch.abs(p.detach()) - h0, dim=0) <= 0.0
        smooth = interior & ~inside & (curv > 0.0)
        # Inside: the tied faces at t*, the first falling (or level) one
        # and the first rising one.
        depth = _six(p) - torch.repeat_interleave(hb, 2, dim=0)
        depth0, rate0 = depth.detach(), _six(d0)
        tie = _TIE * torch.sqrt(mat3.dot(d0, d0))
        tied = depth0 >= torch.amax(depth0, dim=0) - tie
        falls, rises = tied & (rate0 <= tie), tied & (rate0 > tie)
        fall = _first(falls, p.dtype)
        across = _first(rises, p.dtype) - fall
        kink = interior & inside & torch.any(falls, dim=0) \
            & torch.any(rises, dim=0)
        gap = torch.sum(across * depth, dim=0)
        t = t0 - torch.where(
            smooth, (slope - slope.detach()) / torch.where(smooth, curv, one),
            torch.where(kink, (gap - gap.detach()) / torch.where(
                kink, torch.sum(across * rate0, dim=0), one), zero))
    center = p_c - half + t[None] * (2.0 * half)
    out = sphere_vs_point_shape(GeomType.BOX, params_b, R_b, p_b, center,
                                radius)
    # At a kink, the falling face's depth, normal and witness.
    face = fall.reshape(3, 2, *fall.shape[1:])
    face = face[:, 0] - face[:, 1]  # its signed axis, box frame
    on = torch.abs(face)
    c = mat3.tmv(R_b, center - p_b)
    n = -mat3.mv(R_b, face)
    cl = _clip(c, -hb, hb) * (1.0 - on) + face * hb
    at_kink = (mat3.dot(face, c) - mat3.dot(on, hb) - radius, n,
               center + n * radius[None], mat3.mv(R_b, cl) + p_b)
    return tuple(torch.where(kink if x.ndim == kink.ndim else kink[None],
                             k, x) for k, x in zip(at_kink, out))


def capsule_vs_shape(params_cap, R_c, p_c, shape_type, params_s, R_s, p_s):
    """Capsule (A) vs a convex shape (B): the capsule is the sphere of its
    radius centred at the point of its axis segment where the shape's
    distance is least.  Against a box that point carries its exact
    derivative (``capsule_vs_box``).  Against a cylinder, a halfspace or a
    hull the search runs on detached inputs and holds the point fixed under
    differentiation: by the envelope theorem the derivative of the distance
    is then exact, but those of the normal and the witnesses, which move
    with the point, are not (nor, through them, the force's)."""
    if shape_type == GeomType.BOX:
        return capsule_vs_box(params_cap, R_c, p_c, params_s, R_s, p_s)
    with instrument("physics.capsule_search"):
        center = _ternary_search(params_cap, R_c, p_c, shape_type, params_s,
                                 R_s, p_s)
    return sphere_vs_point_shape(shape_type, params_s, R_s, p_s, center,
                                 params_cap[0])


# -- pair dispatch + force law ----------------------------------------------


def _pair_distance(ta, prm_a, Ra, pa, tb, prm_b, Rb, pb):
    ta, tb = GeomType(ta), GeomType(tb)
    if ta == GeomType.SPHERE and tb in _POINT_SHAPES:
        return sphere_vs_point_shape(tb, prm_b, Rb, pb, pa, prm_a[0])
    if tb == GeomType.SPHERE and ta in _POINT_SHAPES:
        phi, n, wa, wb = sphere_vs_point_shape(ta, prm_a, Ra, pa, pb, prm_b[0])
        return phi, -n, wb, wa
    if ta == GeomType.BOX and tb == GeomType.BOX:
        return box_vs_box(prm_a, Ra, pa, prm_b, Rb, pb)
    if ta == GeomType.CAPSULE and tb == GeomType.CAPSULE:
        return capsule_vs_capsule(prm_a, Ra, pa, prm_b, Rb, pb)
    if ta == GeomType.CAPSULE and tb in _CAPSULE_SEARCH_SHAPES:
        return capsule_vs_shape(prm_a, Ra, pa, tb, prm_b, Rb, pb)
    if tb == GeomType.CAPSULE and ta in _CAPSULE_SEARCH_SHAPES:
        phi, n, wa, wb = capsule_vs_shape(prm_b, Rb, pb, ta, prm_a, Ra, pa)
        return phi, -n, wb, wa
    if ta in convex.SUPPORT_SHAPES and tb == GeomType.HALFSPACE:
        return convex.convex_vs_halfspace(ta, prm_a, Ra, pa, Rb, pb)
    if ta == GeomType.HALFSPACE and tb in convex.SUPPORT_SHAPES:
        phi, n, wa, wb = convex.convex_vs_halfspace(tb, prm_b, Rb, pb, Ra, pa)
        return phi, -n, wb, wa
    if ta in convex.SUPPORT_SHAPES and tb in convex.SUPPORT_SHAPES:
        return convex.convex_vs_convex(ta, prm_a, Ra, pa, tb, prm_b, Rb, pb)
    raise NotImplementedError(
        f"SoA pair ({ta.name}, {tb.name}); guard with supports_soa"
    )


def contact_wrenches(model: Model, q, v, params):
    """External contact wrenches: q (nq, N), v (nv, N) ->
    (torques (3, nl, N), forces (3, nl, N)) about body origins in world."""
    nl = model.num_links
    dtype, device = q.dtype, q.device
    N = q.shape[-1]
    geoms = model.geoms
    if geoms is None or not geoms.pairs:
        z = torch.zeros((3, nl, N), dtype=dtype, device=device)
        return z, z

    R_l, p_l, w_l, pd_l = body_velocities(model, q, v)

    bodies = np.asarray(geoms.bodies)
    body_idx = const(np.maximum(bodies, 0), device)
    is_world = const(bodies < 0, device)[None, :, None]
    eye = torch.eye(3, dtype=dtype, device=device)[:, :, None, None]
    zero = _c(q, 0.0)
    Rg_b = torch.where(is_world[None], eye, R_l[:, :, body_idx, :])
    pg_b = torch.where(is_world, zero, p_l[:, body_idx, :])
    geoms_R = mat3.from_aos_mat(geoms.R.to(dtype))[..., None]
    geoms_p = mat3.from_aos_vec(geoms.p.to(dtype))[..., None]
    Rg = mat3.mul(Rg_b, geoms_R)
    pg = pg_b + mat3.mv(Rg_b, geoms_p)
    w_g = torch.where(is_world, zero, w_l[:, body_idx, :])
    pd_g = torch.where(is_world, zero, pd_l[:, body_idx, :])
    pl_g = torch.where(is_world, zero, p_l[:, body_idx, :])

    k = params.stiffness
    sigma = params.smoothing_factor
    vd = params.dissipation_velocity
    vs = params.stiction_velocity
    mu = params.friction_coefficient

    # Group pairs by type so each group is one batched evaluation.  A box
    # against a capsule is taken as the capsule against the box (each body
    # gets the same wrench), so that every capsule-box pair shares one
    # search along the capsules' axes.
    groups: dict = {}
    for (ia, ib) in geoms.pairs:
        if (geoms.types[ia], geoms.types[ib]) == (GeomType.BOX,
                                                  GeomType.CAPSULE):
            ia, ib = ib, ia
        groups.setdefault((geoms.types[ia], geoms.types[ib]), []).append(
            (ia, ib)
        )

    torques = torch.zeros((3, nl, N), dtype=dtype, device=device)
    forces = torch.zeros((3, nl, N), dtype=dtype, device=device)
    gparams = geoms.params.to(dtype)  # (ng, 3)

    def pair_params(gtype, idx):
        """(3, P, 1) params, or a hull's vertices (3, VMAX, P, 1)."""
        if GeomType(gtype) == GeomType.CONVEX:
            return geoms.verts.to(dtype)[idx].permute(2, 1, 0)[..., None]
        return gparams[idx].T[:, :, None]

    for (ta, tb), pairs in groups.items():
        ia_np = np.array([p[0] for p in pairs])
        ib_np = np.array([p[1] for p in pairs])
        ia = const(ia_np, device)
        ib = const(ib_np, device)
        # Pair axis after the components: R (3, 3, P, N), p (3, P, N).
        phi, nhat, wa, wb = _pair_distance(
            ta, pair_params(ta, ia), Rg[:, :, ia, :], pg[:, ia, :],
            tb, pair_params(tb, ib), Rg[:, :, ib, :], pg[:, ib, :],
        )
        p_c = 0.5 * (wa + wb)
        v_a = pd_g[:, ia, :] + mat3.cross(w_g[:, ia, :], p_c - pl_g[:, ia, :])
        v_b = pd_g[:, ib, :] + mat3.cross(w_g[:, ib, :], p_c - pl_g[:, ib, :])
        v_rel = v_b - v_a

        vn = mat3.dot(nhat, v_rel)
        vt = v_rel - vn[None] * nhat

        # Hunt-Crossley-like dissipation (piecewise C^1).
        s = vn / vd
        dissipation = torch.where(
            s < 0.0, 1.0 - s,
            torch.where(s < 2.0, (s - 2.0) ** 2 / 4.0, _c(s, 0.0)),
        )
        # Softplus normal force with the overflow guard (exponent >= 37
        # -> linear limit -k*phi).
        exponent = -phi / sigma
        fn_compliant = torch.where(
            exponent >= 37.0,
            -k * phi,
            sigma * k * torch.log1p(
                torch.exp(torch.minimum(exponent, _c(exponent, 37.0)))
            ),
        )
        fn = fn_compliant * dissipation
        that = -vt / torch.sqrt(vs * vs + mat3.dot(vt, vt))[None]
        f_on_b = nhat * fn[None] + mu * fn[None] * that
        tq_b = mat3.cross(p_c - pl_g[:, ib, :], f_on_b)
        tq_a = mat3.cross(p_c - pl_g[:, ia, :], -f_on_b)

        # Accumulate into links with a static 0/1 matrix (world rows drop).
        P = len(pairs)
        S_a = np.zeros((nl, P))
        S_b = np.zeros((nl, P))
        for pi in range(P):
            if bodies[ia_np[pi]] >= 0:
                S_a[bodies[ia_np[pi]], pi] = 1.0
            if bodies[ib_np[pi]] >= 0:
                S_b[bodies[ib_np[pi]], pi] = 1.0
        S_a = const(S_a, device, dtype)
        S_b = const(S_b, device, dtype)
        torques = torques + torch.einsum("lp,cpn->cln", S_a, tq_a) \
            + torch.einsum("lp,cpn->cln", S_b, tq_b)
        forces = forces + torch.einsum("lp,cpn->cln", S_a, -f_on_b) \
            + torch.einsum("lp,cpn->cln", S_b, f_on_b)

    return torques, forces


def step_tau(model: Model, contact_params, q_next, v_next, a):
    """tau_t = ID(q_{t+1}, v_{t+1}, a_t) with implicit contact; all
    operands SoA."""
    from idto_tpu_torch.soa.dynamics import inverse_dynamics

    wrenches = contact_wrenches(model, q_next, v_next, contact_params)
    return inverse_dynamics(model, q_next, v_next, a, wrenches)
