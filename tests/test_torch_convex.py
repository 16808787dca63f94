"""The port's pair kernels (``soa/contact.py``, ``soa/convex.py``) against
the JAX package's ``geometry/distance.py::signed_distance``, float64 on the
CPU.

The JAX side comes from a golden (``scripts/make_torch_goldens.py convex``:
goldens/torch_convex_pairs.npz): ``jit(vmap(signed_distance))`` once per
ordered type pair over that pair's poses, and ``jax.jvp`` of it at the
separated ones.  The poses are made here, by ``pair_cases``, and the test
first checks that the golden was made from the same ones.  Each of the 35
ordered pairs the JAX package serves gets 64 random poses from a seed (a
hull is a 16-point support hull of a seeded cloud, padded by repeating its
first vertex as ``ModelBuilder`` pads it) and the poses of
``tests/test_exact_distance.py`` and ``tests/test_convex.py`` of its pair.

Tolerances:

  * distance, normal and both witnesses: 1e-9 absolute (the lengths are
    ~1 m) beyond twice the reference's own rounding spread: the largest
    change of its answer when p_a moves by 1e-13 along an axis (the golden
    holds it, from six more evaluations of each pose).  At 2-12% of the
    random poses of a pair with a hull that spread is large (up to 0.1 on
    the distance, 0.4 on the normal): 48 Frank-Wolfe steps have not
    converged there, the active vertices' scores tie at convergence, and
    rounding picks the path -- the port's answer is one of the reference's
    own.  Elsewhere the spread is ~1e-13 and the bound is 1e-9.  At most
    an eighth of a pair's poses may be decided by rounding so;
  * the pairs through the capsule's axis search: the same, with 1e-6 for
    the normal and witnesses -- 48 ternary steps resolve the minimizer to
    3.5e-9 of the axis and their last steps are decided by rounding, so two
    implementations end 1e-8..1e-7 apart on the axis
    (``tests/test_torch_soa.py``, TOL_SEARCHED);
  * forward derivatives along a random pose tangent at the separated poses
    (reference phi > 1e-3) whose reference spread is below 1e-10: 1e-7
    absolute, 1e-6 through the capsule's search -- the frozen minimizers
    (projections, searched axis points) agree to 1e-10..1e-8, and the
    derivatives are taken there.

Hull projections emulate the one fused multiply-add of XLA's that decides
a discrete step (``soa/convex.py::hull_projection``): without it the
port left a dropped vertex's weight at 0 where the reference leaves a
positive residue, and the two Frank-Wolfe paths parted.
"""
import itertools
import os

import numpy as np
import pytest
import torch

from idto_tpu_torch.models.mesh import convex_hull_vertices
from idto_tpu_torch.models.model import GeomType
from idto_tpu_torch.models.rotations import rpy_to_rot_np
from idto_tpu_torch.soa import contact as tcon

torch.set_num_threads(1)

_GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens", "torch_convex_pairs.npz")
N_RANDOM = 64
TOL = 1e-9
TOL_SEARCHED = 1e-6
TOL_JVP = 1e-7
TOL_JVP_SEARCHED = 1e-6
SEPARATED = 1e-3
PROBE = 1e-13  # shift of p_a that probes the reference's rounding spread
STABLE = 1e-10  # a pose whose reference moves less under the probes

G = GeomType
PAIRS = [(a, b) for a in G for b in G
         if not (a == G.HALFSPACE and b == G.HALFSPACE)]
# The hull and generic convex pairs: a hull in any pair, and the pairs
# of box, cylinder and halfspace (box against box keeps box_vs_box).
CONVEX_PAIRS = [p for p in PAIRS if G.CONVEX in p or (
    set(p) <= {G.BOX, G.CYLINDER, G.HALFSPACE} and p != (G.BOX, G.BOX))]
_HALF = np.array([0.4, 0.3, 0.2])
_CORNERS = np.array([s * _HALF
                     for s in itertools.product([-1.0, 1.0], repeat=3)])
_HULL = convex_hull_vertices(
    np.random.default_rng(100).normal(size=(400, 3)) * [0.3, 0.25, 0.15],
    max_verts=16)
VMAX = _HULL.shape[0] + 3
_PARAMS = {G.SPHERE: [0.3, 0.0, 0.0], G.BOX: [0.4, 0.3, 0.2],
           G.CAPSULE: [0.1, 0.3, 0.0], G.CYLINDER: [0.3, 0.5, 0.0],
           G.HALFSPACE: [0.0, 0.0, 0.0]}


def _pad(verts):
    """(VMAX, 3) by repeating the first vertex."""
    return np.concatenate([verts, np.repeat(verts[:1], VMAX - len(verts), 0)])


def _prm(t, value=None):
    if t == G.CONVEX:
        return _pad(_HULL if value is None else value)
    out = np.zeros(3)
    v = _PARAMS[t] if value is None else value
    out[: len(v)] = v
    return out


def _rot(rpy):
    return rpy_to_rot_np(np.asarray(rpy, dtype=np.float64))


_I = np.eye(3)
_O = np.zeros(3)
# (type A, params A, R_A, p_A, type B, params B, R_B, p_B): the poses of
# tests/test_exact_distance.py (TestConvexPairs) and tests/test_convex.py.
_FIXED = [
    (G.BOX, [0.5] * 3, _rot([np.pi / 4, 0, 0]), [0, 0, 1.0],
     G.HALFSPACE, [], _I, _O),
    (G.BOX, [0.5] * 3, _I, [0, 0, 0.3], G.HALFSPACE, [], _I, _O),
    (G.CYLINDER, [0.2, 0.5], _rot([np.pi / 6, 0, 0]), [0, 0, 1.0],
     G.HALFSPACE, [], _I, _O),
    (G.CYLINDER, [0.2, 0.5], _I, [0, 0, 1.0], G.HALFSPACE, [], _I, _O),
    (G.CYLINDER, [0.2, 0.5], _I, [0, 0, 0.4], G.HALFSPACE, [], _I, _O),
    (G.BOX, [0.5] * 3, _I, _O, G.CYLINDER, [0.3, 0.5], _I, [1.5, 0, 0]),
    (G.CYLINDER, [0.3, 0.5], _I, [0, 0, 1.4], G.BOX, [1, 1, 0.5], _I, _O),
    (G.CYLINDER, [0.3, 0.5], _I, [0, 0, 0.9], G.BOX, [1, 1, 0.5], _I, _O),
    (G.CYLINDER, [0.3, 0.5], _I, _O, G.CYLINDER, [0.2, 0.5], _I, [1, 0, 0]),
    (G.CYLINDER, [0.2, 0.5], _I, _O, G.CYLINDER, [0.2, 0.5],
     _rot([np.pi / 2, 0, 0]), [0, 0, 1.0]),
    (G.BOX, [0.5, 0.5, 0.5], _rot([0.3, 0.2, 0.1]), _O,
     G.CYLINDER, [0.3, 0.5], _rot([0.1, -0.2, 0.4]), [1.4, 0.3, 0.2]),
    (G.CYLINDER, [0.2, 0.5], _rot([0.5, 0, 0]), _O,
     G.CYLINDER, [0.3, 0.4], _rot([0, 0.6, 0]), [1.1, 0.4, 0.3]),
    (G.BOX, [0.5, 0.4, 0.3], _rot([0.3, 0.2, 0.1]), _O,
     G.HALFSPACE, [], _I, [0, 0, -1.2]),
    (G.CYLINDER, [0.2, 0.5], _rot([0.4, 0.3, 0]), _O,
     G.HALFSPACE, [], _I, [0, 0, -1.2]),
    (G.SPHERE, [0.2], _I, [1.0, 0.5, 0.3], G.CONVEX, _CORNERS, _I, _O),
    (G.CONVEX, _CORNERS, _I, [0, 0, 0.15], G.HALFSPACE, [], _I, _O),
    (G.CONVEX, _CORNERS, _I, [1.5, 0, 0], G.BOX, _HALF, _I, _O),
    (G.CONVEX, _CORNERS, _I, [0.75, 0, 0], G.BOX, _HALF, _I, _O),
    (G.CAPSULE, [0.1, 0.3], _I, [0, 0, 1.0], G.CONVEX, _CORNERS, _I, _O),
] + [
    # A point (a sphere of radius 0) against the box's hull: faces, edge
    # and vertex regions, and 0.05 inside the +x face.
    (G.SPHERE, [0.0], _I, p, G.CONVEX, _CORNERS, _I, _O)
    for p in ([1.0, 0, 0], [0.6, 0.5, 0], [0.9, 0.8, 0.7], [0, 0, 1.5],
              [0.35, 0, 0])
]


def _random_rotations(rng, n):
    return np.stack([_rot(r) for r in rng.uniform(-np.pi, np.pi, (n, 3))])


def pair_cases(ta, tb):
    """The poses of one ordered pair: dict of prm_a (N, 3) or hull
    vertices (N, VMAX, 3), R_a (N, 3, 3), p_a (N, 3), the same for B, and
    the pose tangent of the derivative check (dp_a, w_a, dp_b, w_b)."""
    rng = np.random.default_rng(PAIRS.index((ta, tb)))
    n = N_RANDOM
    out = dict(
        prm_a=np.stack([_prm(ta)] * n), R_a=_random_rotations(rng, n),
        p_a=rng.uniform(-0.6, 0.6, (n, 3)),
        prm_b=np.stack([_prm(tb)] * n), R_b=_random_rotations(rng, n),
        p_b=rng.uniform(-0.6, 0.6, (n, 3)),
    )
    fixed = [c for c in _FIXED if (c[0], c[4]) == (ta, tb)]
    for case in fixed:
        for key, t, prm, R, p in (("a",) + case[0:4], ("b",) + case[4:8]):
            out[f"prm_{key}"] = np.concatenate(
                [out[f"prm_{key}"], _prm(t, np.asarray(prm, float))[None]])
            out[f"R_{key}"] = np.concatenate([out[f"R_{key}"], [R]])
            out[f"p_{key}"] = np.concatenate([out[f"p_{key}"], [p]])
    m = len(out["p_a"])
    for key in ("dp_a", "w_a", "dp_b", "w_b"):
        out[key] = rng.standard_normal((m, 3))
    return out


def _port(ta, tb, case, s=None):
    """The port's kernel on every pose at once (poses on the pair axis P,
    one instance); s (P, 1) moves them along the tangent."""
    def soa(key, t):
        prm = torch.tensor(case[f"prm_{key}"])
        prm = prm.permute(2, 1, 0)[..., None] if t == G.CONVEX \
            else prm.T[:, :, None]
        R = torch.tensor(case[f"R_{key}"]).permute(1, 2, 0)[..., None]
        p = torch.tensor(case[f"p_{key}"]).T[..., None]
        if s is not None:
            RK = torch.tensor(case[f"R_{key}"] @ _skew(case[f"w_{key}"]))
            R = R + s[None, None] * RK.permute(1, 2, 0)[..., None]
            p = p + s[None] * torch.tensor(case[f"dp_{key}"]).T[..., None]
        return prm, R, p

    prm_a, R_a, p_a = soa("a", ta)
    prm_b, R_b, p_b = soa("b", tb)
    phi, n, wa, wb = tcon._pair_distance(ta, prm_a, R_a, p_a,
                                         tb, prm_b, R_b, p_b)
    # (P, 1) and (3, P, 1) -> (P,) and (P, 3)
    return phi[:, 0], n[..., 0].T, wa[..., 0].T, wb[..., 0].T


def _skew(w):
    z = np.zeros_like(w[..., 0])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1),
                     np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _searched(ta, tb):
    """The pair goes through the capsule's axis search."""
    return G.CAPSULE in (ta, tb) and not (
        {ta, tb} <= {G.CAPSULE, G.SPHERE, G.HALFSPACE})


@pytest.fixture(scope="module")
def golden():
    return np.load(_GOLDEN)


def _key(ta, tb):
    return f"{ta.name}_{tb.name}"


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: _key(*p))
def test_pair_matches_jax_signed_distance(golden, pair):
    ta, tb = pair
    k = _key(ta, tb)
    case = pair_cases(ta, tb)
    for name in ("prm_a", "R_a", "p_a", "prm_b", "R_b", "p_b"):
        assert np.array_equal(golden[f"{k}_{name}"], case[name]), name
    names = ("phi", "n", "wa", "wb")
    ref = [golden[f"{k}_{x}"] for x in names]
    spread = [golden[f"{k}_{x}_spread"] for x in names]
    got = [x.numpy() for x in _port(ta, tb, case)]
    tol = [TOL] + [TOL_SEARCHED if _searched(ta, tb) else TOL] * 3
    for name, x, r, sp, t in zip(names, got, ref, spread, tol):
        err = np.abs(x - r).reshape(len(r), -1).max(axis=1)
        assert (err <= t + 2.0 * sp).all(), (name, err.max())
    # The poses whose reference moves by more than the tolerance under the
    # probes (its answer decided by rounding) are few.
    unstable = np.any([sp > t for sp, t in zip(spread, tol)], axis=0)
    assert unstable.sum() <= len(unstable) // 8, unstable.sum()


@pytest.mark.parametrize("pair", CONVEX_PAIRS, ids=lambda p: _key(*p))
def test_pair_derivative_matches_jax_jvp(golden, pair):
    """Forward derivative along the pose tangent at the separated poses."""
    ta, tb = pair
    k = _key(ta, tb)
    case = pair_cases(ta, tb)
    sep = golden[f"{k}_phi"] > SEPARATED
    assert np.array_equal(golden[f"{k}_separated"], sep)
    stable = np.max([golden[f"{k}_{x}_spread"] for x in (
        "phi", "n", "wa", "wb")], axis=0)[sep] <= STABLE
    assert stable.sum() >= 3
    sub = {key: v[sep] for key, v in case.items()}
    s0 = torch.zeros(int(sep.sum()), 1, dtype=torch.float64)
    _, tangents = torch.func.jvp(lambda s: _port(ta, tb, sub, s), (s0,),
                                 (torch.ones_like(s0),))
    tol = TOL_JVP_SEARCHED if _searched(ta, tb) else TOL_JVP
    for x, name in zip(tangents, ("phi", "n", "wa", "wb")):
        ref = golden[f"{k}_jvp_{name}"]
        assert np.abs(x.numpy() - ref)[stable].max() < tol, name


@pytest.mark.parametrize("pair", [(a, b) for a in G for b in G],
                         ids=lambda p: _key(*p))
def test_supports_soa_where_jax_serves_the_pair(pair):
    """``pair_supported`` (and so ``supports_soa``) is true exactly where
    the JAX ``signed_distance`` traces without raising."""
    import jax
    import jax.numpy as jnp

    from idto_tpu.geometry.distance import signed_distance

    ta, tb = pair

    def shape(t):
        return (8, 3) if t == G.CONVEX else (3,)

    try:
        jax.eval_shape(lambda: signed_distance(
            int(ta), jnp.zeros(shape(ta)), jnp.eye(3), jnp.zeros(3),
            int(tb), jnp.zeros(shape(tb)), jnp.eye(3), jnp.ones(3)))
        served = True
    except NotImplementedError:
        served = False
    assert tcon.pair_supported(ta, tb) == served
    assert served == (pair != (G.HALFSPACE, G.HALFSPACE))
