"""SoA pair kernels of the generic convex shapes: convex hulls (CONVEX), and
box, cylinder and hull pairs against each other or a halfspace
(counterpart of the hull and generic-pair parts of
``idto_tpu/geometry/distance.py``), instance axes trailing.

Layout: points (3, *b); a primitive's params (3, P, 1); a hull's vertices
(3, M, P, 1) in its geometry frame, padded by repeating the first vertex.
Callers that query a candidate axis C insert it on both sides (points
(3, C, P, N), params (3, 1, P, 1), vertices (3, M, 1, P, 1)).

Every iterative search (the Frank-Wolfe projection onto a hull, the
support-plane search, the alternating projections between two solids)
runs on detached inputs: the value is then re-evaluated smoothly at the
frozen minimizer, so the derivative is the envelope theorem's, as in the
JAX package's ``stop_gradient`` uses.  Every argmin and argmax is a
one-hot selection that takes the first index among ties, as ``jnp.argmin``
does, so repeated (padding) vertices lose to the original.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from idto_tpu_torch.models.mesh import _fibonacci_directions
from idto_tpu_torch.models.model import GeomType
from idto_tpu_torch.soa import mat3
from idto_tpu_torch.utils.consts import const

_EPS = 1e-12
_FW_STEPS = 48  # away-step Frank-Wolfe iterations of a hull projection
_PROJECTION_STEPS = 64  # alternating projections between two solids
_SUPPORT_DIRECTIONS = 256  # coarse pass of the deepest support plane
_CONE_RADII = (0.2, 0.07, 0.025, 0.008, 0.003)  # its refinement rounds
_CONE_CANDIDATES = 16
_CYLINDER_RING = 12  # points of each ring of a cylinder's candidates

SUPPORT_SHAPES = (GeomType.BOX, GeomType.CYLINDER, GeomType.CONVEX)


def _dot(a, b):
    """<a, b> over the leading component axis, summed in component order."""
    return torch.sum(a * b, dim=0)


def _onehot(i, n, dtype):
    """(n, *i.shape) one-hot of an index tensor."""
    ar = const(np.arange(n).reshape((n,) + (1,) * i.ndim), i.device)
    return (ar == i[None]).to(dtype)


def _pick(vecs, hot):
    """Select along axis 1 of component-leading ``vecs`` (3, n, ...) with a
    one-hot (n, ...)."""
    return torch.sum(vecs * hot[None], dim=1)


def with_candidate_axis(shape_type, params):
    """Params or hull vertices with a candidate axis inserted before the
    pair axis, to broadcast against points (3, C, P, N)."""
    if GeomType(shape_type) == GeomType.CONVEX:
        return params[:, :, None]
    return params[:, None]


# -- a point against a hull ---------------------------------------------------


def hull_projection(verts, p, steps: int = _FW_STEPS):
    """Euclidean projection of points p (3, *b) onto conv(verts) (vertices
    (3, M, *b)): away-step Frank-Wolfe on the barycentric weights, from the
    nearest vertex, for a fixed number of steps.  Not differentiated."""
    verts, p = verts.detach(), p.detach()
    dtype = p.dtype
    M = verts.shape[1]
    neg_inf = torch.full((), float("-inf"), dtype=dtype, device=p.device)
    w = _onehot(torch.argmin(_dot(verts - p[:, None], verts - p[:, None]),
                             dim=0), M, dtype)
    for _ in range(steps):
        x = _pick(verts, w)
        g = x - p  # gradient of 0.5 |x - p|^2
        scores = _dot(verts, g[:, None])  # (M, ...)
        e_s = _onehot(torch.argmin(scores, dim=0), M, dtype)
        e_a = _onehot(torch.argmax(torch.where(w > 0, scores, neg_inf),
                                   dim=0), M, dtype)
        d_fw = _pick(verts, e_s) - x
        d_aw = x - _pick(verts, e_a)
        use_fw = _dot(g, d_fw) <= _dot(g, d_aw)  # the larger descent
        d = torch.where(use_fw[None], d_fw, d_aw)
        w_a = torch.sum(e_a * w, dim=0)
        gmax = torch.where(use_fw, torch.ones_like(w_a),
                           w_a / torch.clamp_min(1.0 - w_a, 1e-30))
        gamma = torch.minimum(torch.clamp_min(
            -_dot(g, d) / torch.clamp_min(_dot(d, d), 1e-300), 0.0), gmax)
        w_new = w + gamma[None] * torch.where(use_fw[None], e_s - w, w - e_a)
        # The away vertex's weight, w_a + gamma (w_a - 1), rounded once:
        # a drop step (gamma = w_a / (1 - w_a)) leaves the rounding residue
        # of gamma, whose sign decides whether the vertex stays in the
        # active set -- the value a fused multiply-add gives, as XLA's.
        w_away = _fma(gamma, w_a - 1.0, w_a)
        w = torch.where((e_a > 0) & ~use_fw[None], w_away[None], w_new)
    return _pick(verts, w)


def _split(a):
    """Dekker's split of float64 a into two halves of 26 bits each."""
    t = 134217729.0 * a  # 2^27 + 1
    hi = t - (t - a)
    return hi, a - hi


def _fma(a, b, c):
    """a * b + c with one rounding where a * b is within a factor 2 of -c
    (the product's exact error by Dekker's two-product; the sum of the
    rounded product and c is then exact, Sterbenz)."""
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return (p + c) + err


def _support_margin(dirs, p, verts):
    """<d, p> - max_v <d, v> for directions (3, K, *b): (K, *b)."""
    h = torch.amax(_dot(dirs[:, :, None], verts[:, None]), dim=1)
    return _dot(dirs, p[:, None]) - h


def deepest_support_plane(verts, p):
    """The unit direction (3, *b) that maximizes the support-plane margin
    <d, p> - max_v <d, v>: for a point inside the hull, the nearest face's
    normal.  A pass over 256 Fibonacci directions, then five rounds of 16
    candidates on a shrinking cone about the best.  Not differentiated."""
    verts, p = verts.detach(), p.detach()
    dtype, device = p.dtype, p.device
    batch = (1,) * (p.ndim - 1)
    dirs = const(np.ascontiguousarray(
        _fibonacci_directions(_SUPPORT_DIRECTIONS).T), device, dtype)
    dirs = dirs.reshape((3, _SUPPORT_DIRECTIONS) + batch)
    best = torch.argmax(_support_margin(dirs, p, verts), dim=0)
    d0 = _pick(dirs, _onehot(best, _SUPPORT_DIRECTIONS, dtype))

    theta = np.arange(_CONE_CANDIDATES) * (2.0 * np.pi / _CONE_CANDIDATES)
    cs = const(np.cos(theta), device, dtype).reshape((1, -1) + batch)
    sn = const(np.sin(theta), device, dtype).reshape((1, -1) + batch)
    for r in _CONE_RADII:
        # Tangent frame of d0, away from its smallest component's axis.
        e = _onehot(torch.argmin(torch.abs(d0), dim=0), 3, dtype)
        t1 = mat3.cross(d0, e)
        t1 = t1 / mat3.norm(t1)[None]
        t2 = mat3.cross(d0, t1)
        cands = d0[:, None] + r * (cs * t1[:, None] + sn * t2[:, None])
        cands = cands / torch.sqrt(_dot(cands, cands) + _EPS)[None]
        cands = torch.cat([d0[:, None], cands], dim=1)
        best = torch.argmax(_support_margin(cands, p, verts), dim=0)
        d0 = _pick(cands, _onehot(best, _CONE_CANDIDATES + 1, dtype))
    return d0


def point_hull(verts, p):
    """Signed distance of points p (3, *b) to conv(verts), in the hull's
    frame: (phi, outward normal, closest surface point), the contract of
    the box query.  Outside: the distance to the frozen projection.
    Inside: the depth below the deepest support plane (the sampled
    search's error is ~ extent * 3e-3)."""
    x = hull_projection(verts, p)
    d_out = mat3.norm(p - x)
    n_in = deepest_support_plane(verts, p)
    phi_in = _dot(n_in, p) - torch.amax(_dot(verts, n_in[:, None]), dim=0)
    # Scale-relative test of "the projection converged onto p": inside.
    scale = torch.sqrt(torch.amax(_dot(verts, verts), dim=0) + _EPS)
    inside = (phi_in <= 0.0) & (d_out <= 1e-3 * scale)
    phi = torch.where(inside, phi_in, d_out)
    normal = torch.where(inside[None], n_in, (p - x) / d_out[None])
    closest = torch.where(inside[None], p - phi_in[None] * n_in, x)
    return phi, normal, closest


# -- generic convex pairs -----------------------------------------------------


def solid_projection(shape_type, params, p):
    """Projection of shape-frame points onto the solid shape (not
    differentiated: its callers freeze it)."""
    shape_type = GeomType(shape_type)
    if shape_type == GeomType.BOX:
        half = params[:3]
        return torch.minimum(torch.maximum(p, -half), half)
    if shape_type == GeomType.CYLINDER:
        r, h = params[0], params[1]
        rho = torch.sqrt(p[0] * p[0] + p[1] * p[1] + _EPS)
        scale = torch.clamp_max(r / rho, 1.0)
        z = torch.minimum(torch.maximum(p[2], -h), h)
        return torch.stack([p[0] * scale, p[1] * scale, z], dim=0)
    if shape_type == GeomType.CONVEX:
        return hull_projection(params, p)
    raise NotImplementedError(f"solid projection for {shape_type}")


def _cylinder_ring_np():
    th = np.linspace(0.0, 2.0 * np.pi, _CYLINDER_RING, endpoint=False)
    return np.stack([np.cos(th), np.sin(th), np.zeros(_CYLINDER_RING)], 1)


def surface_candidates(shape_type, params):
    """(3, C, P, 1) shape-frame surface points covering the support
    features: the penetration-depth candidates.  A box: 8 corners and 6
    face centres; a cylinder: 2 cap centres, the two rims and the mid
    ring (12 points each); a hull: its vertices."""
    shape_type = GeomType(shape_type)
    dtype, device = params.dtype, params.device
    if shape_type == GeomType.BOX:
        signs = np.array(list(itertools.product([-1.0, 1.0], repeat=3)))
        pts = np.concatenate([signs, np.eye(3), -np.eye(3)])
        return const(pts.T, device, dtype)[:, :, None, None] \
            * params[:3, None]
    if shape_type == GeomType.CYLINDER:
        r, h = params[0][None, None], params[1][None, None]  # (1, 1, P, 1)
        ring = const(_cylinder_ring_np().T, device,
                     dtype)[:, :, None, None]
        zhat = const(np.array([0.0, 0.0, 1.0]), device,
                     dtype)[:, None, None, None]
        return torch.cat([zhat * h, -zhat * h, ring * r + zhat * h,
                          ring * r - zhat * h, ring * r], dim=1)
    if shape_type == GeomType.CONVEX:
        return params
    raise NotImplementedError(f"surface candidates for {shape_type}")


def point_query(shape_type, params, u):
    """(phi, outward normal, closest point) of shape-frame points u
    against a support shape."""
    shape_type = GeomType(shape_type)
    from idto_tpu_torch.soa.contact import _point_box, _point_cylinder

    if shape_type == GeomType.BOX:
        return _point_box(u, params[:3])
    if shape_type == GeomType.CONVEX:
        return point_hull(params, u)
    return _point_cylinder(u, params[0], params[1])


def convex_vs_halfspace(shape_type, params, R_a, p_a, R_h, p_h):
    """A support shape (A) against a halfspace (B, z <= 0 of its frame),
    exact: A's support point along the inward normal.  Returns (phi,
    nhat_AB, w_a, w_b)."""
    shape_type = GeomType(shape_type)
    n_w = R_h[:, 2]  # outward plane normal, world
    m = mat3.tmv(R_a, n_w)  # the same in A's frame
    one = torch.ones_like(m[0])
    if shape_type == GeomType.BOX:
        s = -torch.sign(torch.where(m == 0.0, one[None], m))
        support = s * params[:3]
    elif shape_type == GeomType.CYLINDER:
        r, h = params[0], params[1]
        mxy = torch.sqrt(m[0] * m[0] + m[1] * m[1] + _EPS)
        z = -torch.sign(torch.where(m[2] == 0.0, one, m[2])) * h
        support = torch.stack([-m[0] / mxy * r, -m[1] / mxy * r, z], dim=0)
    elif shape_type == GeomType.CONVEX:
        # The lowest stored vertex, one-hot selected so that the pose's
        # derivative flows through the winner.
        scores = _dot(params, m[:, None].detach())
        hot = _onehot(torch.argmin(scores, dim=0), params.shape[1], m.dtype)
        support = _pick(params, hot)
    else:
        raise NotImplementedError(f"halfspace pair for {shape_type}")
    x_w = mat3.mv(R_a, support) + p_a  # deepest point of A
    phi = mat3.dot(n_w, x_w - p_h)
    return phi, -n_w, x_w, x_w - phi[None] * n_w


def convex_vs_convex(ta, params_a, R_a, p_a, tb, params_b, R_b, p_b):
    """Support shape (A) against support shape (B).

    Separated: alternating projections between the two solids (64 rounds,
    from A's origin nudged by 1e-3 in each axis) converge to the closest
    pair; the distance is re-evaluated smoothly at the frozen local
    witness coordinates.  Penetrating: each shape's surface candidates are
    scored by the other shape's signed distance and the deepest wins --
    exact for vertex-face contact, sampled for rim and edge contact.
    Returns (phi, nhat_AB, w_a, w_b)."""
    Rad, pad, Rbd, pbd = R_a.detach(), p_a.detach(), R_b.detach(), \
        p_b.detach()
    prm_a, prm_b = params_a.detach(), params_b.detach()

    def proj(shape_type, prm, R, p, x):
        u = mat3.tmv(R, x - p)
        return mat3.mv(R, solid_projection(shape_type, prm, u)) + p

    x = pad + 1e-3
    for _ in range(_PROJECTION_STEPS):
        x = proj(ta, prm_a, Rad, pad, proj(tb, prm_b, Rbd, pbd, x))
    y = proj(tb, prm_b, Rbd, pbd, x)
    xa = mat3.mv(R_a, mat3.tmv(Rad, x - pad)) + p_a
    yb = mat3.mv(R_b, mat3.tmv(Rbd, y - pbd)) + p_b
    d = mat3.norm(yb - xa)
    n_sep = (yb - xa) / d[None]

    # Penetration: A's candidates in B and B's in A; the deepest of each
    # (chosen on frozen poses) is queried again with the pose's derivative.
    def deepest(t_own, prm_own, R_own, p_own, t_oth, prm_oth, R_oth, p_oth):
        c = surface_candidates(t_own, prm_own.detach())
        c_w = mat3.mv(R_own.detach()[:, :, None], c) \
            + p_own.detach()[:, None]
        u = mat3.tmv(R_oth.detach()[:, :, None], c_w
                     - p_oth.detach()[:, None])
        phi = point_query(t_oth, with_candidate_axis(
            t_oth, prm_oth.detach()), u)[0]
        hot = _onehot(torch.argmin(phi, dim=0), c.shape[1], phi.dtype)
        x_pen = mat3.mv(R_own, _pick(c, hot)) + p_own
        phi_pen, n_l, cl = point_query(t_oth, prm_oth,
                                       mat3.tmv(R_oth, x_pen - p_oth))
        return phi_pen, x_pen, mat3.mv(R_oth, n_l), mat3.mv(R_oth, cl) + p_oth

    phi_pa, xa_pen, n_b_out, wb_a = deepest(ta, params_a, R_a, p_a,
                                            tb, params_b, R_b, p_b)
    phi_pb, yb_pen, n_a_out, wa_b = deepest(tb, params_b, R_b, p_b,
                                            ta, params_a, R_a, p_a)
    use_a = (phi_pa <= phi_pb)[None]
    phi_pen = torch.where(use_a[0], phi_pa, phi_pb)
    n_pen = torch.where(use_a, -n_b_out, n_a_out)
    wa_pen = torch.where(use_a, xa_pen, wa_b)
    wb_pen = torch.where(use_a, wb_a, yb_pen)

    overlap = phi_pen < 0.0
    return (
        torch.where(overlap, phi_pen, d),
        torch.where(overlap[None], n_pen, n_sep),
        torch.where(overlap[None], wa_pen, xa),
        torch.where(overlap[None], wb_pen, yb),
    )
