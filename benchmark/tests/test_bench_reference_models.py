"""The plain reference builds the examples that have no cell yet, from a
configuration-shaped file under ``fixtures/`` and the URDF copies under
``reference/assets/``, and agrees with the port: punyo (a prismatic lift,
capsule limbs, gravity off on the robot), dual_jaco (one URDF read twice,
prefixed and posed, and a free box), jaco, kuka and jaco_ball; and the
harness's own run and check read a punyo replan cell made of those files.
The three benchmarked configurations build the same model and iteration as
before, bit for bit (``fixtures/reference_golden.npz``, made with the
reference as it was before prismatic joints, capsules, per-link gravity
and URDF instances were added)."""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from conftest import BENCH_DIR, ROOT
from reference.model import rpy

EXAMPLES = ("punyo", "dual_jaco", "jaco", "kuka", "jaco_ball")
BENCHMARKED = ("mini_cheetah", "hopper", "allegro_hand")
FIXTURES = os.path.join(BENCH_DIR, "tests", "fixtures")
GOLDEN = os.path.join(FIXTURES, "reference_golden.npz")
SEED = 2**31 + 5
STATES = 8
# The port finds a capsule's point nearest a box by a 48-step ternary
# search, which leaves t within (2/3)^48 = 3.5e-9 of the segment; punyo
# has 8 such pairs.  Every other pair is in closed form on both sides.
RTOL = {"punyo": 1e-8}
RTOL_CLOSED_FORM = 1e-11
PHI_ATOL = 1e-12
# phi is second order in t where its minimiser is smooth and inside the
# segment, but first order where it is an end of the axis or a kink (the
# axis inside the box), which the search approaches and does not reach:
# there the gap is up to (2/3)^48 times |d phi / dt| <= the axis's length.
TERNARY = (2.0 / 3.0) ** 48


def _config(name):
    with open(os.path.join(FIXTURES, f"{name}.json")) as f:
        return json.load(f)


def _contact(solver):
    c = {k: solver[k] for k in ("dissipation_velocity", "smoothing_factor",
                                "friction_coefficient", "stiction_velocity")}
    c["stiffness"] = solver["contact_stiffness"]
    return c


def _states(ref, n=STATES):
    """n seeded states around the configuration's q_init: every DoF moved
    by 0.3 N(0, 1) (a free body's quaternion renormalised, its position by
    0.1 N(0, 1)), v and a drawn N(0, 1)."""
    m = ref.model
    gen = torch.Generator().manual_seed(SEED)
    q0 = torch.as_tensor(ref.base["q_init"])
    q = q0 + 0.3 * torch.randn((n, m.nq), generator=gen, dtype=torch.float64)
    for s in m.floating_q_starts:
        q[:, s:s + 4] = q[:, s:s + 4] / q[:, s:s + 4].norm(dim=1,
                                                          keepdim=True)
        q[:, s + 4:s + 7] = q0[s + 4:s + 7] + 0.1 * torch.randn(
            (n, 3), generator=gen, dtype=torch.float64)
    v = torch.randn((n, m.nv), generator=gen, dtype=torch.float64)
    a = torch.randn((n, m.nv), generator=gen, dtype=torch.float64)
    return q, v, a


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def built():
    """{name: (config, Reference, the port's Loaded)}."""
    from reference import Reference
    from yardstick import program

    return {name: (_config(name), Reference(_config(name), "cpu"),
                   program.load(_config(name), "cpu"))
            for name in EXAMPLES}


@pytest.mark.parametrize("name", ("punyoid", "jaco_arm", "kuka_iiwa",
                                  "mini_cheetah", "hopper", "allegro_hand"))
def test_urdf_copy_equals_its_source(name):
    with open(os.path.join(BENCH_DIR, "reference", "assets",
                           f"{name}.urdf"), "rb") as f:
        copy = f.read()
    with open(os.path.join(ROOT, "idto_tpu", "assets", f"{name}.urdf"),
              "rb") as f:
        assert copy == f.read()


def test_reference_imports_nothing_of_the_program():
    """No module of the reference imports the port, the JAX package or
    JAX, by whole top-level name."""
    from yardstick import imports

    forbidden = imports.FORBIDDEN | {"idto_tpu_torch"}
    folder = os.path.join(BENCH_DIR, "reference")
    for fname in sorted(os.listdir(folder)):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(folder, fname)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".", 1)[0] not in forbidden, (fname, n)


@pytest.mark.parametrize("name", EXAMPLES)
def test_sizes_and_pairs_equal_the_ports(name, built):
    config, ref, loaded = built[name]
    m, pm = ref.model, loaded.model
    g = pm.geoms
    assert (m.nq, m.nv, m.B.shape[1]) == (pm.nq, pm.nv, pm.nu)
    assert (m.nq, m.nv, m.B.shape[1]) == tuple(
        config["sizes"][k] for k in ("nq", "nv", "nu"))
    assert m.pairs == [tuple(p) for p in g.pairs]
    assert len(m.pairs) == config["sizes"]["contact_pairs"]
    assert m.g_type == list(g.types) and m.g_body == list(g.bodies)
    assert m.g_names == list(g.names)
    assert m.link_names == list(pm.link_names)
    assert m.jtype == list(pm.joint_types)
    assert m.parent == list(pm.joint_parents)
    assert torch.equal(m.B, pm.B)
    assert torch.equal(m.grav_scale, pm.grav_scale)
    assert torch.equal(m.damping, pm.damping)
    assert m.unactuated == list(pm.unactuated_vdofs)


@pytest.mark.parametrize("name", EXAMPLES)
def test_poses_wrenches_and_tau_equal_the_ports(name, built):
    """Every geometry's world pose, the contact wrenches and inverse
    dynamics at 8 seeded states, against the port's ``soa`` functions;
    punyo's wrenches and tau at the states with no capsule-box tie."""
    from idto_tpu_torch.soa import contact as sc
    from idto_tpu_torch.soa import dynamics as sd
    from idto_tpu_torch.soa import kinematics as sk
    from reference import physics

    config, ref, loaded = built[name]
    m, pm = ref.model, loaded.model
    q, v, a = _states(ref)
    contact = _contact(ref.solver)
    R_l, p_l = vmap(lambda x: physics.forward_kinematics(m, x))(q)
    torques, forces = vmap(
        lambda x, y: physics.contact_wrenches(m, contact, x, y))(q, v)
    tau = vmap(lambda x, y, z: physics.inverse_dynamics(m, contact, x, y,
                                                        z))(q, v, a)

    PR, Pp = sk.forward_kinematics(pm, q.T.contiguous())
    wrenches = sc.contact_wrenches(pm, q.T.contiguous(), v.T.contiguous(),
                                   loaded.params.contact)
    ptau = sd.inverse_dynamics(pm, q.T.contiguous(), v.T.contiguous(),
                               a.T.contiguous(), wrenches)
    gR, gp = _geometry_poses(m, R_l, p_l)
    pgR, pgp = _geometry_poses(m, PR.permute(3, 2, 0, 1),
                               Pp.permute(2, 1, 0))
    assert _rel(gR, pgR) < RTOL_CLOSED_FORM
    assert _rel(gp, pgp) < RTOL_CLOSED_FORM
    # A state where a capsule's axis runs inside a box to a tie of two
    # faces is compared pair by pair (test_pair_distances_equal_the_ports):
    # the port's face there is its search's last midpoint's.
    keep = ~torch.stack([tie for tie, _, _ in _ties(m, gR, gp).values()]
                        ).any(dim=0) if name == "punyo" else slice(None)
    tol = RTOL.get(name, RTOL_CLOSED_FORM)
    for got, want in ((torques, wrenches[0].permute(2, 1, 0)),
                      (forces, wrenches[1].permute(2, 1, 0)),
                      (tau, ptau.T)):
        # Relative to the largest over the 8 states.
        assert float((got - want)[keep].abs().max()
                     / want.abs().max()) < tol
    assert forces[keep].abs().max() > 1.0  # contact is active there
    assert forces[keep].shape[0] >= STATES // 2


def _ties(m, gR, gp):
    """{(ia, ib): (tie (S,), the tied faces' A -> B normals (S, 6, 3), the
    first falling tied face's (S, 3))} of each capsule-box pair at the
    geometry poses: where the reference's capsule centre lies inside the
    box with two or more faces' depths tied there (``physics.TIE``)."""
    from reference import physics
    from reference.model import BOX, CAPSULE

    faces = torch.as_tensor(physics._FACES)
    out = {}
    for ia, ib in m.pairs:
        ta, tb = m.g_type[ia], m.g_type[ib]
        if not (CAPSULE in (ta, tb) and BOX in (ta, tb)):
            continue
        phi, n, wa, wb = vmap(lambda Ra, pa, Rb, pb: physics.signed_distance(
            ta, m.g_size[ia], Ra, pa, tb, m.g_size[ib], Rb, pb))(
                gR[:, ia], gp[:, ia], gR[:, ib], gp[:, ib])
        cap, box = (ia, ib) if ta == CAPSULE else (ib, ia)
        r, hl = m.g_size[cap][0], m.g_size[cap][1]
        centre = wa - n * r if ta == CAPSULE else wb + n * r
        Rb = gR[:, box]
        c = (Rb.mT @ (centre - gp[:, box])[..., None])[..., 0]
        d = (Rb.mT @ (2 * hl * gR[:, cap][:, :, 2])[..., None])[..., 0]
        depth = c @ faces.T - m.g_size[box] @ faces.abs().T
        tie_len = physics.TIE * d.norm(dim=1, keepdim=True)
        tied = depth >= depth.amax(dim=1, keepdim=True) - tie_len
        falls = tied & (d @ faces.T <= tie_len)
        sign = -1.0 if ta == CAPSULE else 1.0  # A -> B
        normals = sign * (Rb[:, None] @ faces[None, :, :, None])[..., 0]
        first = normals[torch.arange(len(c)), torch.argmax(
            falls.to(torch.float64), dim=1)]
        tie = (depth.amax(dim=1) < 0) & (tied.sum(dim=1) >= 2)
        out[(ia, ib)] = tie, normals * tied[..., None], first
    return out


def _geometry_poses(m, R_l, p_l):
    """World rotation (S, ng, 3, 3) and origin (S, ng, 3) of every
    geometry, from the links' (S, nl, 3, 3) and (S, nl, 3)."""
    Rs, ps = [], []
    for g, b in enumerate(m.g_body):
        if b < 0:
            Rs.append(m.g_R[g].expand(R_l.shape[0], 3, 3))
            ps.append(m.g_p[g].expand(R_l.shape[0], 3))
        else:
            Rs.append(R_l[:, b] @ m.g_R[g])
            ps.append(p_l[:, b] + R_l[:, b] @ m.g_p[g])
    return torch.stack(Rs, dim=1), torch.stack(ps, dim=1)


@pytest.mark.parametrize("name", EXAMPLES)
def test_pair_distances_equal_the_ports(name, built):
    """phi, the normal and both witnesses of every candidate pair at the
    same geometry poses, against the port's pair kernels."""
    from idto_tpu_torch.soa import contact as sc
    from reference import physics
    from reference.model import BOX, CAPSULE

    config, ref, loaded = built[name]
    m, g = ref.model, loaded.model.geoms
    q, _, _ = _states(ref)
    gR, gp = _geometry_poses(
        m, *vmap(lambda x: physics.forward_kinematics(m, x))(q))
    ties = _ties(m, gR, gp)
    for ia, ib in m.pairs:
        ta, tb = m.g_type[ia], m.g_type[ib]
        got = vmap(lambda Ra, pa, Rb, pb: physics.signed_distance(
            ta, m.g_size[ia], Ra, pa, tb, m.g_size[ib], Rb, pb))(
                gR[:, ia], gp[:, ia], gR[:, ib], gp[:, ib])
        want = sc._pair_distance(
            ta, g.params[ia][:, None, None], gR[:, ia].permute(1, 2, 0)[
                :, :, None], gp[:, ia].T[:, None],
            tb, g.params[ib][:, None, None], gR[:, ib].permute(1, 2, 0)[
                :, :, None], gp[:, ib].T[:, None])
        want = [want[0][0]] + [w[:, 0].T for w in want[1:]]
        if CAPSULE in (ta, tb) and BOX in (ta, tb):
            # The search leaves the capsule's centre up to a few TERNARY
            # times the axis's length L off (near a smooth minimum its last
            # comparisons are of values equal to rounding: 1.7 TERNARY
            # seen), and the normal by that over the centre's distance to
            # the box, phi + r (floored at 1 mm).
            cap = ia if ta == CAPSULE else ib
            r, L = float(m.g_size[cap][0]), 2.0 * float(m.g_size[cap][1])
            phi_atol = TERNARY * L
            tol = (4.0 * TERNARY * L * (1.0 + 1.0 / torch.clamp_min(
                want[0] + r, 1e-3)))[:, None]
        else:
            phi_atol, tol = PHI_ATOL, torch.full((len(q), 1), (
                RTOL_CLOSED_FORM * max(1.0, max(float(y.abs().max())
                                                for y in want[1:]))))
        assert (got[0] - want[0]).abs().max() < phi_atol, (ia, ib)
        tie = torch.zeros(len(q), dtype=torch.bool)
        if (ia, ib) in ties:
            # At a tie of two faces the reference takes the first falling
            # one's normal, the port one of the tied faces'.
            tie, normals, falling = ties[(ia, ib)]
            assert ((got[1][tie] - falling[tie]).abs() < 1e-12).all()
            assert ((want[1][tie][:, None] - normals[tie]).abs().amax(
                dim=2) < tol[tie]).any(dim=1).all(), (ia, ib)
        for x, y in zip(got[1:], want[1:]):
            assert ((x - y)[~tie].abs() < tol[~tie]).all(), (ia, ib)


# Capsule against box: the reference's own derivatives against its own
# central differences.  A box of half-extents (0.15, 0.07, 0.17) at the
# origin and a capsule of radius 0.05 and half length 0.12 posed by x =
# (centre, w): rotation R0 quat_to_rot([1, w]) at w = 0; ``free`` names
# the components of x differentiated.
HALF = (0.15, 0.07, 0.17)
CAPSULE_SIZE = (0.05, 0.12, 0.0)
CASES = {
    # The axis passes a vertical edge of the box askew, outside it: phi is
    # strictly convex along the axis and least inside the segment.
    "interior": ((0.22, 0.16, 0.02), (0.9, 0.4, 0.3), range(6)),
    # Tilted over the top face: least at the lower end.
    "end": ((0.02, 0.0, 0.34), (0.5, 0.2, 0.0), range(6)),
    # The axis along x, parallel to the top face, over it and past its edge
    # at x = 0.15: every t up to the edge is least; the reference takes
    # the edge's t and holds it.  That point moves with the capsule only
    # along x, and a tilt moves the least point to an end, so the
    # translations across the axis and the turn about it are compared.
    "parallel": ((0.1, 0.0, 0.2), None, (1, 2, 5)),
    # The axis enters the box through its +x face and leaves through its
    # +y face: inside, the deepest point is the kink where the +y face's
    # depth, falling along the axis, meets the rising +x face's.
    "through": ((0.11, 0.02, 0.01), (0.0, 1.49, -0.32), range(6)),
    # The axis crosses the box's thin y extent through its mid-plane: the
    # kink where the -y face's depth meets the +y face's.
    "across": ((0.02, 0.01, 0.03), (0.0, 1.3744, 1.4711), range(6)),
}
_ALONG_X = ((0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (-1.0, 0.0, 0.0))


def _rotation(case):
    if CASES[case][1] is None:
        return torch.tensor(_ALONG_X, dtype=torch.float64)
    return torch.as_tensor(rpy(*CASES[case][1]))


def _capsule_box(R0, x):
    from reference import physics
    from reference.model import BOX, CAPSULE

    one = torch.ones(1, dtype=x.dtype)
    R = R0 @ physics.quat_to_rot(torch.cat([one, x[3:]]))
    out = physics.signed_distance(
        CAPSULE, torch.tensor(CAPSULE_SIZE, dtype=x.dtype), R, x[:3],
        BOX, torch.tensor(HALF, dtype=x.dtype), torch.eye(3, dtype=x.dtype),
        torch.zeros(3, dtype=x.dtype))
    return torch.cat([out[0][None], out[1], out[2], out[3]])


@pytest.mark.parametrize("case", sorted(CASES))
def test_capsule_box_derivatives_match_central_differences(case):
    """phi, the normal and both witnesses: jacfwd against central
    differences, relative to the largest derivative."""
    from reference import physics

    R0 = _rotation(case)
    x = torch.tensor(CASES[case][0] + (0.0, 0.0, 0.0), dtype=torch.float64)
    # The slope of phi along the axis at its two ends decides the case.
    a = x[:3] - R0[:, 2] * CAPSULE_SIZE[1]
    d = 2 * R0[:, 2] * CAPSULE_SIZE[1]
    h = torch.tensor(HALF, dtype=torch.float64)
    s0, _ = physics._box_slope(a, d, h)
    s1, _ = physics._box_slope(a + d, d, h)
    if case in ("interior", "through", "across"):
        assert s0 < 0 < s1
    elif case == "end":
        assert s0 > 0
    else:
        assert s0 == 0 < s1

    # The axis's least point is inside the box where phi + r < 0.
    inside = _capsule_box(R0, x)[0] + CAPSULE_SIZE[0] < 0
    assert bool(inside) == (case in ("through", "across"))
    J = jacfwd(lambda y: _capsule_box(R0, y))(x)
    step = 1e-6
    for k in CASES[case][2]:
        e = torch.zeros(6, dtype=torch.float64)
        e[k] = step
        cd = (_capsule_box(R0, x + e) - _capsule_box(R0, x - e)) / (2 * step)
        assert (J[:, k] - cd).abs().max() < 1e-6 * J.abs().max(), (case, k)
    assert J.abs().max() > 0.1


def test_lone_prismatic_joint(tmp_path):
    """One link on a prismatic joint: tau = m a + damping v - s m g . axis,
    with the gravity scale s 1 and 0."""
    from reference import model as ref_model
    from reference import physics

    urdf = tmp_path / "slider.urdf"
    urdf.write_text(
        '<robot name="slider"><link name="slide"><inertial>'
        '<mass value="2.5"/><origin xyz="0.1 0 0"/>'
        '<inertia ixx="0.01" iyy="0.02" izz="0.03"/></inertial></link>'
        '<joint name="j" type="prismatic"><parent link="world"/>'
        '<child link="slide"/><origin xyz="0 0 1" rpy="0.3 -0.2 0.5"/>'
        '<axis xyz="1 1 1"/><dynamics damping="0.7"/>'
        '<limit lower="-1" upper="1"/></joint>'
        '<transmission name="t"><joint name="j"/></transmission></robot>')
    g = torch.tensor([0.0, 0.0, -9.81], dtype=torch.float64)
    for on in (True, False):
        m = ref_model.build({"model": {"urdf": str(urdf),
                                       "gravity": g.tolist(),
                                       "gravity_enabled": on}},
                            "cpu", torch.float64)
        assert (m.nq, m.nv, m.B.shape[1]) == (1, 1, 1)
        axis = m.R_pj[0] @ (torch.ones(3, dtype=torch.float64) / 3 ** 0.5)
        q, v, a = (torch.tensor([x], dtype=torch.float64)
                   for x in (0.4, -1.3, 2.2))
        tau = physics.inverse_dynamics(m, _contact(
            {"dissipation_velocity": 0.1, "smoothing_factor": 0.01,
             "friction_coefficient": 0.5, "stiction_velocity": 0.1,
             "contact_stiffness": 100.0}), q, v, a)
        want = 2.5 * a + 0.7 * v - (2.5 * (g @ axis) if on else 0.0)
        assert torch.allclose(tau, want, rtol=1e-14, atol=1e-14), on
        R, p = physics.forward_kinematics(m, q)
        assert torch.allclose(p[0], torch.tensor([0.0, 0.0, 1.0],
                                                 dtype=torch.float64)
                              + 0.4 * axis, rtol=0, atol=1e-15)
        assert torch.equal(R[0], m.R_pj[0])


@pytest.mark.parametrize("name", ("dual_jaco", "jaco", "kuka", "jaco_ball"))
def test_one_iteration_matches_the_port(name, built):
    """One iteration at the YAML's sizes from the YAML's guess: the
    reference against the port's batch solve, as the benchmarked
    configurations are held (punyo's gap is measured, not held: the port's
    capsule search holds t fixed in its derivative)."""
    from yardstick import program

    config, ref, loaded = built[name]
    params = loaded.params.replace(max_iterations=1, check_convergence=False)
    sol, st, _ = program.solve_batch(
        loaded.model, program.broadcast_problem(loaded.prob, 1), params,
        loaded.q_guess[None])
    b = ref.base
    it = ref.iterate(b["q_guess"][None], b["q_init"][None],
                     b["v_init"][None], b["q_nom"][None],
                     torch.tensor([ref.solver["Delta0"]],
                                  dtype=torch.float64))
    step = (it.q - loaded.q_guess[None]).norm()
    assert float((sol.q - it.q).norm() / step) < 1e-5
    assert float((st.cost[0, 0] - it.cost[0]).abs() / it.cost[0]) < 1e-12
    assert bool(it.accepted[0])


def golden_readings():
    """{key: array} of the benchmarked configurations' reference models
    and one iteration each from the YAML guess moved by seeded 1e-3 N(0, 1)
    on every knot after the first."""
    from reference import Reference

    out = {}
    for name in BENCHMARKED:
        with open(os.path.join(BENCH_DIR, "configs", f"{name}.json")) as f:
            ref = Reference(json.load(f), "cpu")
        for field in dataclasses.fields(ref.model):
            value = getattr(ref.model, field.name)
            out[f"{name}.model.{field.name}"] = (
                value.numpy() if isinstance(value, torch.Tensor)
                else np.asarray(value))
        b = ref.base
        gen = torch.Generator().manual_seed(SEED)
        q = torch.as_tensor(b["q_guess"])[None].clone()
        q[:, 1:] += 1e-3 * torch.randn(q[:, 1:].shape, generator=gen,
                                       dtype=torch.float64)
        it = ref.iterate(q, b["q_init"][None], b["v_init"][None],
                         b["q_nom"][None],
                         torch.tensor([ref.solver["Delta0"]],
                                      dtype=torch.float64))
        for field in dataclasses.fields(it):
            out[f"{name}.iteration.{field.name}"] = getattr(
                it, field.name).numpy()
    return out


def test_benchmarked_configurations_are_unchanged():
    """Every tensor and list of the three benchmarked configurations'
    reference models, and one iteration's q, cost, tau, radius, ratio and
    acceptance, bit for bit as the golden has them; the fields added since
    hold what the golden's models had implicitly."""
    golden = np.load(GOLDEN)
    got = golden_readings()
    added = {f"{n}.model.{k}" for n in BENCHMARKED
             for k in ("grav_scale", "link_names", "g_names")}
    assert set(got) == set(golden.files) | added
    for key in golden.files:
        want = golden[key]
        assert got[key].dtype == want.dtype and got[key].shape == want.shape
        assert got[key].tobytes() == want.tobytes(), key
    for n in BENCHMARKED:
        assert (got[f"{n}.model.grav_scale"] == 1.0).all()


if __name__ == "__main__":
    # python benchmark/tests/test_bench_reference_models.py --golden PATH
    # writes the golden from the reference of the checkout it runs in.
    torch.set_num_threads(2)
    np.savez(sys.argv[sys.argv.index("--golden") + 1], **golden_readings())


def test_the_check_reads_a_punyo_replan_run():
    """The harness's own run and check (``yardstick/runner.py``,
    ``yardstick/correct.py::readings``) on a punyo replan cell made of the
    fixture, the replan traffic and a replan cell's metrics, at 4 knots
    and 3 initial iterations: every reading of the check comes back
    finite.  ``flops_per_solve`` is a placeholder (the configuration's
    own is counted by the PR that adds it; no untraced metric reads it)
    and the limits are infinite: the readings are what is tested here, not
    punyo's limits."""
    import copy
    import math
    import time

    from conftest import TINY_ITERS, TINY_STEPS
    from yardstick import manifest, program, runner

    config = _config("punyo")
    config["flops_per_solve"] = {"value": 1, "frozen": False}
    full = copy.deepcopy(config)
    config["problem"]["num_steps"] = TINY_STEPS
    config["solver"]["max_iters"] = TINY_ITERS
    like = manifest.Manifest(ROOT).cell("hopper.replan")
    t = dict(like.traffic)
    t.update(warm_replans=1, check_replans=4, settle_s=0)
    cell = dataclasses.replace(
        like, name="punyo.replan", config_name="punyo", config=config,
        traffic=t, limits={k: math.inf for k in like.limits})

    def load(c, device):
        from idto_tpu_torch.examples.config import (
            build_initial_guess, build_problem, build_solver_params)

        loaded = program.load(full, device)
        cfg = dataclasses.replace(loaded.yaml_config,
                                  num_steps=c["problem"]["num_steps"],
                                  max_iters=c["solver"]["max_iters"])
        return program.Loaded(
            loaded.model, cfg, build_problem(cfg, loaded.model,
                                             device=device),
            build_solver_params(cfg), build_initial_guess(cfg,
                                                          device=device))

    prog = type(sys)("punyo_program")
    prog.__dict__.update({k: getattr(program, k) for k in dir(program)
                          if not k.startswith("_")})
    prog.load = load
    result, lines = runner.run_cell(cell, SEED, 0.5, False, "cpu",
                                    time.perf_counter(), prog=prog)
    assert set(result["checks"]) == {"step_gap", "control_gap",
                                     "radius_gap"}
    for name, c in result["checks"].items():
        assert math.isfinite(c["value"]), (name, c)
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["correct"]
    assert {"replan_ms", "setup_s"} <= set(result["metrics"])
