"""Models with the generic convex pairs and hull bodies, through the port's
contact wrenches and its solve, float64 on the CPU.

  * mini_cheetah with three cylinder hills (30 pairs, three of them the body
    box against a hill): ``contact_wrenches`` against the JAX AoS
    ``contact/force.py::contact_wrenches`` at a few states; and the
    YAML's problem cut to T=8, B=2, two iterations, against the JAX
    package's ``solve_batch`` (``vmap(solve_trust_region)``, its AoS
    physics) from goldens/torch_hills_cheetah.npz (``scripts/
    make_torch_goldens.py hills``): 1e-8 on q and the costs, 1e-6 on tau
    (its entries span five decades), through the scan-Thomas and through
    cyclic reduction alike -- both measured 1.2e-18 on q here.  (At the
    T=20 guess, cyclic reduction is 3e-4..7e-4 off a dense solve, condition
    8.8e9, ``PERF.md`` §6; the T=8 problem does not show it.)
  * a floating pad whose collision geometry is a ``<mesh>`` (a box's 8
    corners) loaded through an SDF file, over a ground halfspace: its
    wrenches against the JAX AoS ones with the same file parsed by the JAX
    package, and its solve against the same pad built as a BOX primitive
    (the hull of a box is the box: 1e-12 on q).
  * the hull pad against the cheetah's ground box (a CONVEX-BOX pair)
    through ``contact_wrenches`` and its forward derivative, against the
    AoS reference: 1e-10 relative.

The AoS wrenches come from goldens/torch_geometry_wrenches.npz
(``scripts/make_torch_goldens.py wrenches``: eager, they took 25-30 s a
model here).
"""
import dataclasses
import itertools
import os

import numpy as np
import pytest
import torch

from idto_tpu_torch import convert
from idto_tpu_torch.examples import registry as treg
from idto_tpu_torch.examples.config import (
    ExampleConfig,
    build_initial_guess,
    build_problem,
    build_solver_params,
)
from idto_tpu_torch.models.model import GeomType, JointType, ModelBuilder
from idto_tpu_torch.models.sdf import parse_model_file
from idto_tpu_torch.optimizer.problem import (
    LinearSolverType,
    ProblemDefinition,
)
from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch
from idto_tpu_torch.soa import contact as tcon

from tests.test_torch_model import _assert_same

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GOLDEN = os.path.join(_REPO, "goldens", "torch_hills_cheetah.npz")
_WRENCH_GOLDEN = os.path.join(_REPO, "goldens",
                              "torch_geometry_wrenches.npz")
HILLS = 3
HILLS_T = 8
HILLS_B = 2
HILLS_ITERS = 2
RTOL_SOLVE = 1e-8
RTOL_WRENCH = 1e-10
PAD_HALF = (0.1, 0.1, 0.02)
PAD_T = 6
RTOL_BOX_HULL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def hills_cfg(cfg):
    """The YAML's problem and solver settings at T=8."""
    return dataclasses.replace(cfg, num_steps=HILLS_T)


def hills_guesses(q_guess):
    """B q guesses: the YAML guess plus 0.01 N(0, 1) from a seed, q_0 kept."""
    rng = np.random.default_rng(6)
    qg = np.asarray(q_guess)[None] + 0.01 * rng.standard_normal(
        (HILLS_B,) + np.shape(q_guess))
    qg[:, 0] = np.asarray(q_guess)[0]
    return qg


def _hills_inputs():
    cfg = ExampleConfig.load(os.path.join(
        treg._DATA_ROOT, "examples", "configs", "mini_cheetah.yaml"))
    cfg = hills_cfg(cfg)
    model = treg._mini_cheetah(hills=HILLS).finalize(device="cpu")
    prob = build_problem(cfg, model, device="cpu")
    params = build_solver_params(cfg).replace(max_iterations=HILLS_ITERS)
    qg = hills_guesses(build_initial_guess(cfg, device="cpu").numpy())
    return model, prob, params, qg


def test_hills_model_is_served():
    model = treg._mini_cheetah(hills=HILLS).finalize(device="cpu")
    g = model.geoms
    types = [(GeomType(g.types[a]), GeomType(g.types[b])) for a, b in g.pairs]
    assert len(g.pairs) == 30
    assert types.count((GeomType.BOX, GeomType.CYLINDER)) == HILLS
    assert tcon.supports_soa(model)


@pytest.fixture(scope="module")
def wrench_golden():
    return np.load(_WRENCH_GOLDEN)


@pytest.mark.parametrize("linear", ["thomas", "cr"])
def test_hills_solve_matches_jax_golden(linear):
    ref = np.load(_GOLDEN)
    model, prob, params, qg = _hills_inputs()
    assert np.array_equal(ref["q_guess"], qg)
    if linear == "cr":
        params = params.replace(
            linear_solver=LinearSolverType.CYCLIC_REDUCTION)
    sol, stats, _ = solve_batch(model, broadcast_problem(prob, HILLS_B),
                                params, torch.as_tensor(qg))
    assert stats.num_iters.tolist() == ref["num_iters"].tolist()
    assert _rel(sol.q, ref["q"]) < RTOL_SOLVE
    assert _rel(stats.cost, ref["cost"]) < RTOL_SOLVE
    assert _rel(sol.tau, ref["tau"]) < 1e2 * RTOL_SOLVE


def hills_wrench_states(q_guess, nv):
    """States along the guess pushed into the first hill: the body box
    penetrates it, the feet touch the ground box and the hill."""
    rng = np.random.default_rng(7)
    q = np.asarray(q_guess)[[0, 5, 10]].T.copy()
    q[4] = [1.05, 1.1, 0.98]  # base x at the first hill's near side
    q += 0.02 * rng.standard_normal(q.shape)
    return q, 0.3 * rng.standard_normal((nv, q.shape[1]))


def test_hills_wrenches_match_jax_aos(wrench_golden):
    from idto_tpu.examples import registry as jreg

    tm = treg._mini_cheetah(hills=HILLS).finalize(device="cpu")
    _assert_same(tm, convert.model(jreg._mini_cheetah(hills=HILLS)
                                   .finalize(), device="cpu"), "model")
    _, _, _, params, q_guess = treg.load_example("mini_cheetah",
                                                  device="cpu")
    q, v = hills_wrench_states(q_guess.numpy(), tm.nv)
    ref = wrench_golden
    assert np.array_equal(ref["hills_q"], q) and np.array_equal(
        ref["hills_v"], v)
    tq, f = tcon.contact_wrenches(tm, torch.tensor(q), torch.tensor(v),
                                  params.contact)
    assert np.abs(ref["hills_forces"]).max() > 1.0
    assert _rel(tq, ref["hills_torques"]) < RTOL_WRENCH
    assert _rel(f, ref["hills_forces"]) < RTOL_WRENCH


# -- the hull pad -------------------------------------------------------------

PAD_SDF = """<?xml version="1.0"?>
<sdf version="1.7">
  <model name="pad">
    <link name="pad">
      <inertial><mass>1.0</mass>
        <inertia><ixx>1e-3</ixx><iyy>1e-3</iyy><izz>1e-3</izz>
                 <ixy>0</ixy><ixz>0</ixz><iyz>0</iyz></inertia>
      </inertial>
      <collision name="pad_hull">
        <geometry><mesh><uri>pad.obj</uri></mesh></geometry>
      </collision>
    </link>
  </model>
</sdf>
"""


def pad_corners():
    return np.array([s * np.asarray(PAD_HALF)
                     for s in itertools.product([-1.0, 1.0], repeat=3)])


def write_pad_files(directory):
    """pad.obj (a box's 8 corners) and pad.sdf in ``directory``; returns
    the SDF's path."""
    with open(os.path.join(directory, "pad.obj"), "w") as f:
        f.write("\n".join("v " + " ".join(repr(float(c)) for c in v)
                          for v in pad_corners()) + "\n")
    path = os.path.join(directory, "pad.sdf")
    with open(path, "w") as f:
        f.write(PAD_SDF)
    return path


def pad_problem(nq, nv, T, dtype, device):
    """Slide the pad, resting 1 mm deep in the ground, 5 cm along x in T
    steps of 0.05 s: weights Qq = 10 on x, y, z and 1 on the quaternion,
    Qv = 0.1, R = 1e-3, final weights 10x the running ones.  Solved
    without equality constraints: the floating base is unactuated, and R
    prices the generalized forces the motion needs."""
    q0 = np.array([1.0, 0, 0, 0, 0.0, 0.0, PAD_HALF[2] - 1e-3])
    q1 = q0.copy()
    q1[4] = 0.05
    s = np.linspace(0.0, 1.0, T + 1)[:, None]
    Qq = np.array([1.0] * 4 + [10.0] * 3)

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                               device=device)

    return ProblemDefinition(
        num_steps=T, dt=0.05, q_init=t(q0), v_init=t(np.zeros(nv)),
        q_nom=t(q0 + s * (q1 - q0)), v_nom=t(np.zeros((T + 1, nv))),
        Qq=t(Qq), Qv=t(np.full(nv, 0.1)), R=t(np.full(nv, 1e-3)),
        Qf_q=t(10 * Qq), Qf_v=t(np.full(nv, 1.0)))


def pad_builder(shape):
    """The pad as a hull, a BOX primitive, over a halfspace ("ground") or
    the cheetah's ground box ("box_ground")."""
    hull, ground = shape.split("_", 1) if "_" in shape else (shape, "ground")
    b = ModelBuilder()
    b.add_link("pad", "world", JointType.FLOATING, mass=1.0,
               inertia=np.eye(3) * 1e-3)
    if hull == "hull":
        b.add_geometry("pad", GeomType.CONVEX, verts=pad_corners(),
                       name="pad_hull")
    else:
        b.add_geometry("pad", GeomType.BOX, list(PAD_HALF), name="pad_box")
    if ground == "ground":
        b.add_geometry("world", GeomType.HALFSPACE, name="ground")
    else:
        treg._add_ground_box(b, z_top=0.0)
    return b


def _pad_solve(model, T):
    from idto_tpu_torch.optimizer.problem import SolverParameters

    prob = pad_problem(model.nq, model.nv, T, torch.float64, "cpu")
    params = SolverParameters(max_iterations=2, check_convergence=False,
                              equality_constraints=False)
    qg = prob.q_nom.expand(2, -1, -1).clone()
    qg[1, 1:, 6] += 0.005
    return solve_batch(model, broadcast_problem(prob, 2), params, qg)


def test_pad_from_sdf_mesh_solves_as_the_box(tmp_path):
    """mesh -> CONVEX -> hull against the halfspace, through the SDF
    parser: the same solve as the pad built as a BOX primitive."""
    from idto_tpu.models.sdf import parse_model_file as jax_parse

    path = write_pad_files(str(tmp_path))
    pad = parse_model_file(path).finalize(device="cpu")
    _assert_same(pad, convert.model(jax_parse(path).finalize(),
                                    device="cpu"), "model")
    _assert_same(pad.geoms.verts[0], torch.as_tensor(pad_corners()), "verts")
    b = parse_model_file(path)
    b.add_geometry("world", GeomType.HALFSPACE, name="ground")
    hull = b.finalize(device="cpu")
    box = pad_builder("box").finalize(device="cpu")
    sol_h, stats_h, _ = _pad_solve(hull, PAD_T)
    sol_b, stats_b, _ = _pad_solve(box, PAD_T)
    assert torch.isfinite(sol_h.q).all()
    assert (stats_h.cost[:, -1] < stats_h.cost[:, 0]).all()
    assert (stats_h.solver_flag == stats_b.solver_flag).all()
    assert _rel(sol_h.q, sol_b.q) < RTOL_BOX_HULL
    assert _rel(stats_h.cost, stats_b.cost) < RTOL_BOX_HULL


def pad_wrench_states():
    """Four states of the pad near the ground (up to 1 cm in it, slightly
    tilted), velocities and a q tangent, from a seed."""
    rng = np.random.default_rng(8)
    n = 4
    quat = rng.standard_normal((n, 4)) * [1.0, 0.1, 0.1, 0.1]
    q = np.concatenate([quat / np.linalg.norm(quat, axis=1, keepdims=True),
                        rng.uniform(-0.05, 0.05, (n, 2)),
                        rng.uniform(-0.01, 0.03, (n, 1))], axis=1).T
    return q, 0.2 * rng.standard_normal((6, n)), rng.standard_normal((7, n))


def jax_pad_model(shape):
    """The pad of ``pad_builder`` built by the JAX package."""
    from idto_tpu.examples import registry as jreg
    from idto_tpu.models.model import GeomType as JG
    from idto_tpu.models.model import JointType as JJ
    from idto_tpu.models.model import ModelBuilder as JBuilder

    jb = JBuilder()
    jb.add_link("pad", "world", JJ.FLOATING, mass=1.0,
                inertia=np.eye(3) * 1e-3)
    jb.add_geometry("pad", JG.CONVEX, verts=pad_corners(), name="pad_hull")
    if shape == "hull":
        jb.add_geometry("world", JG.HALFSPACE, name="ground")
    else:
        jreg._add_ground_box(jb, z_top=0.0)
    return jb.finalize()


@pytest.mark.parametrize("shape", ["hull", "hull_box_ground"])
def test_pad_wrenches_and_derivative_match_jax_aos(shape, wrench_golden):
    """The hull pad over the halfspace and against the cheetah's ground box
    (CONVEX-BOX: the alternating projections with a 48-step hull
    projection each): wrenches and their forward derivative along a q
    tangent, against the AoS reference's (default contact parameters)."""
    from idto_tpu_torch.contact.force import ContactParams

    tm = pad_builder(shape).finalize(device="cpu")
    _assert_same(tm, convert.model(jax_pad_model(shape), device="cpu"),
                 "model")
    q, v, dq = pad_wrench_states()
    ref = wrench_golden
    assert np.array_equal(ref[f"{shape}_q"], q)
    qt, vt, dqt = (torch.tensor(x) for x in (q, v, dq))
    got = torch.func.jvp(
        lambda x: tcon.contact_wrenches(tm, x, vt, ContactParams()), (qt,),
        (dqt,))
    assert np.abs(ref[f"{shape}_forces"]).max() > 1.0  # in contact
    for (tq, f), tag in zip(got, ("", "jvp_")):
        assert _rel(tq, ref[f"{shape}_{tag}torques"]) < RTOL_WRENCH
        assert _rel(f, ref[f"{shape}_{tag}forces"]) < RTOL_WRENCH
