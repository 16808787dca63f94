"""The port's SoA physics against ``idto_tpu.soa`` on the same seeded
inputs: FK, velocity maps, N^+, inverse dynamics, contact wrenches,
step_tau, the rollout cost and the exact partials, at B=2, T=4 on spinner
(contact, planar finger) and mini_cheetah (floating base, sphere-box and
box-box pairs).

The body velocities carried down the tree are also held to their JAX-form
definition (a jvp of the world poses) on five models, with their forward
derivative, to 1e-12.

Both sides evaluate the same float64 expressions in the same order, up to
the summation order of small contractions, so values agree to ~1e-15;
the stated tolerances are 1e-10 relative (1e-9 for the partials, which
pass through three nested forward/reverse derivatives).  The JAX side's
kinematics, inverse dynamics, contact, step_tau, rollout, cost and partials
come from goldens/torch_soa_{spinner,mini_cheetah}.npz and punyo's AoS
wrenches from goldens/torch_aos_punyo.npz (``scripts/make_torch_goldens.py
soa aos_punyo``): eagerly or jitted, each takes from seconds to a minute on
the CPU.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp, vjp, vmap
from torch.utils._python_dispatch import TorchDispatchMode

from idto_tpu.examples.registry import load_example as jax_load_example
from idto_tpu.models.model import JointType
from idto_tpu.soa import contact as jcon
from idto_tpu.soa import partials as jpart
from idto_tpu_torch import convert
from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.soa import contact as tcon
from idto_tpu_torch.soa import dynamics as tdyn
from idto_tpu_torch.soa import kinematics as tkin
from idto_tpu_torch.soa import mat3 as tmat3
from idto_tpu_torch.soa import partials as tpart
from idto_tpu_torch.soa import rollout as troll

# One intra-op thread: these tensors are tiny, and several test workers with
# a thread pool each oversubscribe the cores (a solve is then 5-10x slower).
torch.set_num_threads(1)

_GOLDENS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens")
B, T = 2, 4
RTOL = 1e-10
RTOL_PARTIALS = 1e-9


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _setup(name):
    jm, _, jprob, jparams, jqg = jax_load_example(name)
    jprob = jprob.replace(num_steps=T, q_nom=jprob.q_nom[: T + 1],
                          v_nom=jprob.v_nom[: T + 1])
    rng = np.random.default_rng(0)
    qs = np.asarray(jqg)[None, : T + 1] + 0.02 * rng.standard_normal(
        (B, T + 1, jm.nq)
    )
    # Random states for the per-instance maps, quaternions kept away from 0.
    n = B * T
    q = rng.standard_normal((jm.nq, n)) * 0.5
    for j in range(jm.num_joints):
        if JointType(jm.joint_types[j]) == JointType.FLOATING:
            q[jm.q_starts[j]] += 1.0
    v = rng.standard_normal((jm.nv, n)) * 0.3
    a = rng.standard_normal((jm.nv, n)) * 0.2
    # States near the trajectory, where the contacts are active.
    qn = qs[:, 1:].reshape(n, jm.nq).T
    return dict(
        name=name, jm=jm, jprob=jprob, jc=jparams.contact,
        tm=convert.model(jm, device="cpu"),
        tprob=convert.problem(jprob, device="cpu"),
        tc=convert.solver_params(jparams).contact,
        qs=qs, q=q, v=v, a=a, qn=qn,
    )


@pytest.fixture(scope="module", params=["spinner", "mini_cheetah"])
def case(request):
    return _setup(request.param)


def _golden(case):
    """The JAX outputs at the case's inputs, which must be the same."""
    ref = np.load(os.path.join(_GOLDENS, f"torch_soa_{case['name']}.npz"))
    for key in ("q", "v", "a", "qn", "qs"):
        assert np.array_equal(ref[key], case[key]), key
    return ref


def test_kinematics(case):
    tm = case["tm"]
    ref = _golden(case)
    q, v = torch.tensor(case["q"]), torch.tensor(case["v"])
    for tag, outs in (("fk", tkin.forward_kinematics(tm, q)),
                      ("bv", tkin.body_velocities(tm, q, v))):
        outs = list(outs)
        assert len(outs) == len([k for k in ref.files
                                 if k.startswith(tag + "_")])
        for i, x_t in enumerate(outs):
            assert _rel(x_t, ref[f"{tag}_{i}"]) < RTOL
    qd_t = tkin.v_to_qdot(tm, q, v)
    assert _rel(qd_t, ref["qdot"]) < RTOL
    assert _rel(tkin.qdot_to_v(tm, q, qd_t), ref["v_back"]) < RTOL
    assert _rel(tkin.nplus_matrix(tm, q), ref["nplus"]) < RTOL


def _velocities_by_jvp_of_the_poses(model, q, v):
    """The body velocities as a jvp of the world poses, w read off the skew
    part of Rd R^T: the JAX package's form."""
    qdot = tkin.v_to_qdot(model, q, v)
    (R, p), (Rd, pd) = jvp(lambda qq: tkin.forward_kinematics(model, qq),
                           (q,), (qdot,))
    W = tmat3.mul_t(Rd, R)
    w = 0.5 * torch.stack(
        [W[2, 1] - W[1, 2], W[0, 2] - W[2, 0], W[1, 0] - W[0, 1]], dim=0)
    return R, p, w, pd


# Revolute chains, a planar base, a floating base, the hand's fingers.
@pytest.mark.parametrize("name", ["acrobot", "hopper", "spinner",
                                  "mini_cheetah", "allegro_hand"])
def test_body_velocities_down_the_tree_equal_the_jvp_of_the_poses(name):
    """The same function: values and their forward derivative in (q, v),
    which body_accelerations and the partials take, to rounding."""
    model = load_example(name, device="cpu")[0]
    rng = np.random.default_rng(23)
    n = 6
    q = rng.standard_normal((model.nq, n)) * 0.5
    for j in range(model.num_joints):
        if JointType(model.joint_types[j]) == JointType.FLOATING:
            q[model.q_starts[j]] += 1.0
    primals = (torch.tensor(q),
               torch.tensor(rng.standard_normal((model.nv, n))))
    tangents = tuple(torch.tensor(rng.standard_normal(tuple(x.shape)))
                     for x in primals)
    got = jvp(lambda qq, vv: tkin.body_velocities(model, qq, vv), primals,
              tangents)
    want = jvp(lambda qq, vv: _velocities_by_jvp_of_the_poses(model, qq, vv),
               primals, tangents)
    for x, y in zip(got[0] + got[1], want[0] + want[1]):
        assert x.shape == y.shape and _rel(x, y) < 1e-12


def test_dynamics_and_contact(case):
    tm = case["tm"]
    ref = _golden(case)
    q, v, a, qn = (case[k] for k in ("q", "v", "a", "qn"))
    tau_t = tdyn.inverse_dynamics(tm, *(torch.tensor(x) for x in (q, v, a)))
    assert _rel(tau_t, ref["tau"]) < RTOL
    for x_t, x_j in zip(
        tcon.contact_wrenches(tm, torch.tensor(qn), torch.tensor(v),
                              case["tc"]),
        (ref["torques"], ref["forces"]),
    ):
        assert _rel(x_t, x_j) < RTOL
    st_t = tcon.step_tau(tm, case["tc"], torch.tensor(qn), torch.tensor(v),
                         torch.tensor(a))
    assert _rel(st_t, ref["step_tau"]) < RTOL


def test_rollout_cost(case):
    ref = _golden(case)
    qs = torch.tensor(case["qs"])
    tau_t, v_t = troll.generalized_forces(case["tm"], case["tprob"],
                                          case["tc"], qs)
    assert _rel(v_t, ref["roll_v"]) < RTOL and _rel(tau_t, ref["roll_tau"]) < RTOL
    assert _rel(troll.cost(case["tm"], case["tprob"], case["tc"], qs),
                ref["cost"]) < RTOL


def test_partials(case):
    jm = case["jm"]
    qs = case["qs"]
    ref = _golden(case)
    p_j = (ref["dtau_dqm"], ref["dtau_dqt"], ref["dtau_dqp"])
    p_t = tpart.id_partials_batched(case["tm"], case["tprob"], case["tc"],
                                    torch.tensor(qs))
    for x_t, x_j in zip(p_t, p_j):
        assert x_t.shape == (B, T, jm.nv, jm.nq)
        assert _rel(x_t, x_j) < RTOL_PARTIALS
    assert _rel(tpart.nplus_stack_batched(case["tm"], torch.tensor(qs)),
                jpart.nplus_stack_batched(jm, jnp.asarray(qs))) < RTOL


# -- capsule pairs and punyo: the JAX SoA layer has no capsule pairs, so the
# oracle is the AoS distance and force law -----------------------------------

N_POSES = 300
# Distances, normals and witnesses of one pair: the same float64 expressions
# on both sides, the 48 search steps included.
RTOL_PAIR = 1e-10
# Normal and witnesses of a pair that goes through the search along the
# capsule's axis.  48 steps resolve the minimizer to (2/3)^48 = 3.5e-9 of the
# segment, and over the last steps the two distances compared differ by
# less than rounding, so two implementations of the same arithmetic (XLA
# contracts multiply-adds, PyTorch does not) end 1e-8..1e-7 apart on the
# axis; the distance, flat there, still agrees to 1e-10.  With the axis
# parallel to a face the minimizer is a whole interval and the witnesses
# are not unique: those poses are held on distance and normal alone.
TOL_SEARCHED = 1e-6
N_PARALLEL = 40  # the first poses of _pair_poses
_CLOSED_FORM_PAIRS = ("capsule-capsule", "capsule-halfspace")
# Wrenches and step_tau of punyo sum 36 pairs through FK of 21 coordinates.
# The searched pairs' witnesses differ by ~1e-8 between the packages
# (TOL_SEARCHED below), and with them the moment arms: 1.3e-9 on the torques.
RTOL_PUNYO = 1e-8
# Forward-mode derivatives against central differences with a step of 1e-6:
# truncation ~1e-12 and rounding ~1e-16 / 1e-6, relative to the largest
# entry.
TOL_FD = 1e-8

_CAPSULE_PAIRS = {
    "capsule-capsule": ("CAPSULE", [0.05, 0.2], "CAPSULE", [0.08, 0.15]),
    "capsule-box": ("CAPSULE", [0.05, 0.25], "BOX", [0.3, 0.2, 0.1]),
    "box-capsule": ("BOX", [0.15, 0.2, 0.25], "CAPSULE", [0.06, 0.3]),
    "capsule-cylinder": ("CAPSULE", [0.05, 0.2], "CYLINDER", [0.2, 0.1]),
    "capsule-halfspace": ("CAPSULE", [0.05, 0.2], "HALFSPACE", []),
}


def _random_rotations(rng, n):
    quat = rng.standard_normal((n, 4))
    w, x, y, z = (quat / np.linalg.norm(quat, axis=1, keepdims=True)).T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], -1),
    ], 1)


def _pair_poses(rng, prm_a, prm_b):
    """N_POSES poses: random ones from well separated to deeply penetrating,
    then parallel axes, exactly touching surfaces and coincident centres."""
    n = N_POSES
    R_a, R_b = _random_rotations(rng, n), _random_rotations(rng, n)
    p_a = rng.uniform(-0.3, 0.3, (n, 3))
    p_b = rng.uniform(-0.3, 0.3, (n, 3))
    # Parallel: the same attitude, or both frames on the world axes.
    R_b[:N_PARALLEL] = R_a[:N_PARALLEL]
    R_a[20:N_PARALLEL] = R_b[20:N_PARALLEL] = np.eye(3)
    # Touching along x at the sum of the x extents, frames on the axes.
    ext_a = prm_a[0] if prm_a else 0.0
    ext_b = prm_b[0] if prm_b else 0.0
    R_a[40:50] = R_b[40:50] = np.eye(3)
    p_b[40:50] = p_a[40:50] + [ext_a + ext_b, 0.0, 0.0]
    # Centres a hair apart: deep penetration.
    p_b[50:60] = p_a[50:60] + 1e-3 * rng.standard_normal((10, 3))
    return R_a, p_a, R_b, p_b


@pytest.mark.parametrize("pair", sorted(_CAPSULE_PAIRS))
def test_capsule_pairs_match_aos_distance(pair):
    from idto_tpu.geometry.distance import signed_distance
    from idto_tpu.models.model import GeomType as JGeom
    from idto_tpu_torch.models.model import GeomType as TGeom

    ta, prm_a, tb, prm_b = _CAPSULE_PAIRS[pair]
    rng = np.random.default_rng(sorted(_CAPSULE_PAIRS).index(pair))
    R_a, p_a, R_b, p_b = _pair_poses(rng, prm_a, prm_b)
    pa3 = np.zeros(3)
    pa3[: len(prm_a)] = prm_a
    pb3 = np.zeros(3)
    pb3[: len(prm_b)] = prm_b
    ref = jax.jit(jax.vmap(
        lambda Ra, xa, Rb, xb: signed_distance(
            JGeom[ta], jnp.asarray(pa3), Ra, xa,
            JGeom[tb], jnp.asarray(pb3), Rb, xb)
    ))(*(jnp.asarray(x) for x in (R_a, p_a, R_b, p_b)))

    def soa_R(R):  # (N, 3, 3) -> (3, 3, 1, N)
        return torch.tensor(R).permute(1, 2, 0)[:, :, None]

    def soa_p(p):  # (N, 3) -> (3, 1, N)
        return torch.tensor(p).T[:, None]

    out = tcon._pair_distance(
        TGeom[ta], torch.tensor(pa3)[:, None, None], soa_R(R_a), soa_p(p_a),
        TGeom[tb], torch.tensor(pb3)[:, None, None], soa_R(R_b), soa_p(p_b))
    phi, nhat, wa, wb = (np.asarray(x) for x in out)
    phi_j, n_j, wa_j, wb_j = (np.asarray(x) for x in ref)
    assert (phi_j < 0).sum() > 20 and (phi_j > 0).sum() > 20
    assert np.abs(phi[0] - phi_j).max() < RTOL_PAIR
    errs = [np.abs(x_t[:, 0].T - x_j).max(axis=1)
            for x_t, x_j in ((nhat, n_j), (wa, wa_j), (wb, wb_j))]
    if pair in _CLOSED_FORM_PAIRS:
        assert max(e.max() for e in errs) < RTOL_PAIR
    else:
        assert errs[0].max() < TOL_SEARCHED
        unique = slice(N_PARALLEL, None)
        assert max(e[unique].max() for e in errs[1:]) < TOL_SEARCHED
    # Everywhere, the port's witnesses are phi apart along its normal.
    # (guarded norms put sqrt(1e-12) into the cylinder's distance).
    assert np.abs((wb - wa) - phi * nhat).max() < 2e-6


def _punyo_inputs():
    jm, _, jprob, jparams, jqg = jax_load_example("punyo")
    rng = np.random.default_rng(3)
    n = 6
    # States along the initial guess, where arms and ball touch, with noise.
    knots = np.asarray(jqg)[rng.integers(0, jprob.num_steps + 1, n)]
    q = (knots + 0.05 * rng.standard_normal(knots.shape)).T
    v = 0.3 * rng.standard_normal((jm.nv, n))
    a = 0.2 * rng.standard_normal((jm.nv, n))
    tm = convert.model(jm, device="cpu")
    assert not jcon.supports_soa(jm) and tcon.supports_soa(tm)
    return dict(jm=jm, jc=jparams.contact, tm=tm,
                tc=convert.solver_params(jparams).contact, q=q, v=v, a=a)


@pytest.fixture(scope="module")
def punyo():
    return _punyo_inputs()


def test_punyo_wrenches_and_step_tau_match_aos(punyo):
    """Against the AoS reference's wrenches and step_tau at the same
    states (goldens/torch_aos_punyo.npz)."""
    ref = np.load(os.path.join(_GOLDENS, "torch_aos_punyo.npz"))
    for key in ("q", "v", "a"):
        assert np.array_equal(ref[key], punyo[key]), key
    tm, tc = punyo["tm"], punyo["tc"]
    q, v, a = (punyo[k] for k in ("q", "v", "a"))
    tq_j, f_j = ref["torques"], ref["forces"]
    tq_t, f_t = tcon.contact_wrenches(tm, torch.tensor(q), torch.tensor(v), tc)
    assert np.abs(np.asarray(f_j)).max() > 1.0  # the contacts are active
    # (3, nl, N) against (N, nl, 3)
    assert _rel(tq_t.permute(2, 1, 0), tq_j) < RTOL_PUNYO
    assert _rel(f_t.permute(2, 1, 0), f_j) < RTOL_PUNYO
    tau_t = tcon.step_tau(tm, tc, *(torch.tensor(x) for x in (q, v, a)))
    assert _rel(tau_t.T, ref["tau"]) < RTOL_PUNYO


def test_punyo_partials_match_central_differences(punyo):
    """dtau/dq of step_tau, through the capsule pairs, against central
    differences of the port's own step_tau.

    The search's minimizer is held fixed under differentiation (as the
    reference's stop_gradient holds it).  By the envelope theorem that
    leaves the derivative of the distance exact, but not that of the
    witness points and the normal, which move with the minimizer: at the
    YAML smoothing (0.01 m) punyo's forearm capsules lie 3-14 mm above the
    ground box, those pairs carry force, and dtau/dq differs from central
    differences by up to 1.0 on entries of size 1 (in both packages: the
    port's derivative equals ``jacfwd`` of the reference's AoS step_tau to
    4e-11 there).  With the smoothing at 0.1 mm the ground pairs carry no
    force (exp(-30)), the arm-ball, arm-arm and ball-ground contacts stay
    active, and the derivative must be the exact one."""
    import dataclasses

    tm = punyo["tm"]
    tc = dataclasses.replace(punyo["tc"], smoothing_factor=1e-4)
    q, v, a = (torch.tensor(punyo[k]) for k in ("q", "v", "a"))

    def f(qq):
        return tcon.step_tau(tm, tc, qq, v, a)

    Gq = tpart._jac_rows(f, q, tm.nq)  # (nq, nv, n)
    assert float(Gq.abs().max()) > 100.0  # contact stiffness is in there
    eps = 1e-6
    for j in range(tm.nq):
        e = torch.zeros_like(q)
        e[j] = eps
        fd = (f(q + e) - f(q - e)) / (2 * eps)
        assert float((Gq[j] - fd).abs().max()) < TOL_FD * float(
            Gq.abs().max()), j


def test_punyo_partials_match_jacfwd_of_the_aos_reference(punyo):
    """dtau/dq at the YAML contact parameters, the configuration the solver
    runs, where central differences do not apply (see above): the port's
    forward-mode rows against ``jacfwd`` of the reference's AoS ``step_tau``
    on the same six states (goldens/torch_partials_punyo.npz, from
    ``scripts/make_torch_goldens.py partials``).  Both hold the search's
    minimizer fixed, so the same expressions are differentiated; the
    minimizers themselves end ~1e-8 apart (TOL_SEARCHED), which shows as
    3.6e-11 of the largest entry: held to RTOL_PARTIALS."""
    ref = np.load(os.path.join(_GOLDENS, "torch_partials_punyo.npz"))
    tm, tc = punyo["tm"], punyo["tc"]
    for key in ("q", "v", "a"):
        assert np.array_equal(ref[key].T, punyo[key]), key
    q, v, a = (torch.tensor(punyo[k]) for k in ("q", "v", "a"))
    Gq = tpart._jac_rows(lambda qq: tcon.step_tau(tm, tc, qq, v, a), q,
                         tm.nq)  # (nq, nv, n)
    want = ref["dtau_dq"]  # (n, nv, nq)
    assert want.shape == (q.shape[1], tm.nv, tm.nq)
    assert np.abs(want).max() > 100.0
    assert _rel(Gq.permute(2, 1, 0), want) < RTOL_PARTIALS


def test_capsule_search_distance_derivative_is_exact():
    """The envelope theorem on the searched distance itself: d phi by
    forward mode through ``capsule_vs_shape`` (minimizer held fixed) equals
    central differences of phi (minimizer free), on random poses of a
    capsule against a box, moved along a random translation and turned
    about a random axis.  Held where the capsule's axis stays outside the
    box: inside it the point distance is a maximum over faces, the minimum
    along the axis sits on a kink between two of them, and no derivative at
    a fixed minimizer is the derivative of the minimum (the reference's is
    not either).  Contacts that deep, a radius and more, are past what the
    force law is used for."""
    from torch.func import jvp

    from idto_tpu_torch.models.model import GeomType as TGeom
    from idto_tpu_torch.models.rotations import axis_angle_to_rot

    rng = np.random.default_rng(11)
    n = 64
    prm_c = torch.tensor([0.05, 0.25, 0.0])[:, None, None]
    prm_b = torch.tensor([0.3, 0.2, 0.1])[:, None, None]
    R_c = torch.tensor(_random_rotations(rng, n)).permute(1, 2, 0)[:, :, None]
    R_b = torch.tensor(_random_rotations(rng, n)).permute(1, 2, 0)[:, :, None]
    p_c = torch.tensor(rng.uniform(-0.4, 0.4, (n, 3))).T[:, None]
    p_b = torch.zeros_like(p_c)
    axis = torch.tensor(_random_rotations(rng, 1)[0, :, :1])  # (3, 1)
    shift = torch.tensor(rng.standard_normal(3))[:, None, None]

    def phi(x):
        """The capsule turned by x about ``axis`` and moved by x shift."""
        dR = axis_angle_to_rot(axis, x.reshape(1, -1))  # (3, 3, 1, n)
        return tcon.capsule_vs_shape(
            prm_c, torch.einsum("ikpn,kjpn->ijpn", dR, R_c),
            p_c + x * shift, TGeom.BOX, prm_b, R_b, p_b)[0]

    x0 = torch.zeros((1, n), dtype=torch.float64)
    d_ad = jvp(phi, (x0,), (torch.ones_like(x0),))[1]
    eps = 1e-6
    d_fd = (phi(x0 + eps) - phi(x0 - eps)) / (2 * eps)
    outside = phi(x0) > -float(prm_c[0]) + 1e-3
    assert 40 < int(outside.sum()) < n
    assert float(d_fd[outside].abs().max()) > 0.5
    # The minimizer is known to 3.5e-9 of the segment, so the derivative
    # taken there is off by that times the mixed second derivative: ~1e-8.
    assert float((d_ad - d_fd)[outside].abs().max()) < 1e-7


# -- the 3x3 contractions of soa/mat3.py: broadcast multiply-and-sum, held
# against NumPy's products and against the einsum forms' derivatives --------

_EINSUM = {
    "mul": "ik...,kj...->ij...",
    "mul_t": "ik...,jk...->ij...",
    "t_mul": "ki...,kj...->ij...",
    "mv": "ij...,j...->i...",
    "tmv": "ji...,j...->i...",
}
# Instance axes of (the matrix, the second operand); size 1 where an operand
# is shared, as the per-body constants R[..., None] are.
_INSTANCE_AXES = {
    "one_axis": ((7,), (7,)),
    "two_axes": ((4, 5), (4, 5)),
    "shared_matrix": ((4, 1), (4, 5)),
    "shared_operand": ((1, 5), (4, 5)),
}
# Sums of three float64 products, in another order than NumPy's.
RTOL_MAT3 = 1e-14


def _numpy_product(fn, A, X):
    """The product on the AoS layout (instances first), by np.matmul."""
    A = np.moveaxis(A, (0, 1), (-2, -1))
    if fn in ("t_mul", "tmv"):
        A = np.swapaxes(A, -1, -2)
    if fn in ("mv", "tmv"):
        return np.moveaxis((A @ np.moveaxis(X, 0, -1)[..., None])[..., 0],
                           -1, 0)
    X = np.moveaxis(X, (0, 1), (-2, -1))
    if fn == "mul_t":
        X = np.swapaxes(X, -1, -2)
    return np.moveaxis(A @ X, (-2, -1), (0, 1))


@pytest.mark.parametrize("axes", sorted(_INSTANCE_AXES))
@pytest.mark.parametrize("fn", sorted(_EINSUM))
def test_mat3_contraction(fn, axes):
    f = getattr(tmat3, fn)
    ref = functools.partial(torch.einsum, _EINSUM[fn])
    rng = np.random.default_rng(17)
    ia, ix = _INSTANCE_AXES[axes]
    lead = (3,) if fn in ("mv", "tmv") else (3, 3)

    def draw(shape, k=()):
        return torch.tensor(rng.standard_normal(k + shape))

    A, X = draw((3, 3) + ia), draw(lead + ix)
    out = f(A, X)
    want = _numpy_product(fn, A.numpy(), X.numpy())
    assert out.shape == want.shape
    assert _rel(out, want) < RTOL_MAT3

    dA, dX = draw((3, 3) + ia), draw(lead + ix)
    for got, exp in zip(jvp(f, (A, X), (dA, dX)), jvp(ref, (A, X), (dA, dX))):
        assert _rel(got, exp) < RTOL_MAT3
    ct = draw(tuple(out.shape))
    for got, exp in zip(vjp(f, A, X)[1](ct), vjp(ref, A, X)[1](ct)):
        assert got.shape == exp.shape and _rel(got, exp) < RTOL_MAT3
    As, Xs = draw((3, 3) + ia, (2,)), draw(lead + ix, (2,))
    assert _rel(vmap(f)(As, Xs), vmap(ref)(As, Xs)) < RTOL_MAT3
    # The partials' form: vmap over tangents of a jvp, one operand batched.
    assert _rel(vmap(lambda t: jvp(f, (A, X), (dA, t))[1])(Xs),
                vmap(lambda t: jvp(ref, (A, X), (dA, t))[1])(Xs)) < RTOL_MAT3


class _TinyMatrixProducts(TorchDispatchMode):
    """Records each matrix product whose matrices are all 4x4 or smaller."""

    _OPS = {torch.ops.aten.mm: 0, torch.ops.aten.bmm: 0,
            torch.ops.aten.addmm: 1, torch.ops.aten.baddbmm: 1}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        first = self._OPS.get(func.overloadpacket)
        if first is not None:
            dims = [d for m in args[first : first + 2] for d in m.shape[-2:]]
            if max(dims) <= 4:
                self.seen.append((str(func), [tuple(m.shape) for m in
                                              args[first : first + 2]]))
        return func(*args, **(kwargs or {}))


# The mini cheetah: the spinner's nv = nq = 3 makes the partials' own
# (nv, nv) x (nv, nq) products 3x3 too.
@pytest.mark.parametrize("case", ["mini_cheetah"], indirect=True)
def test_mat3_route_dispatches_no_tiny_matrix_products(case, monkeypatch):
    qs = torch.tensor(case["qs"])

    def physics():
        with _TinyMatrixProducts() as rec:
            parts = tpart.id_partials_batched(case["tm"], case["tprob"],
                                              case["tc"], qs)
            tau, _ = troll.generalized_forces(case["tm"], case["tprob"],
                                              case["tc"], qs)
        return (*parts, tau), rec.seen

    out, seen = physics()
    assert seen == []
    for fn, spec in _EINSUM.items():
        monkeypatch.setattr(tmat3, fn, functools.partial(torch.einsum, spec))
    out_einsum, seen_einsum = physics()
    assert seen_einsum  # the einsum forms dispatch them: the check can fail
    for x, y in zip(out, out_einsum):
        assert _rel(x, y) < 1e-13
