"""The port's per-problem (AoS) physics -- ``models/{kinematics,dynamics,
mat3}.py``, ``geometry/distance.py``, ``contact/force.py``,
``optimizer/trajectory_aos.py`` and ``optimizer/partials.py::id_partials``
-- against the JAX package's AoS functions and against the port's own SoA
layer, float64 on the CPU.

Inputs are made here from a seed (``states``): four states near each
example's initial guess, where the contacts are active, and a T=3
trajectory.  The JAX side comes from goldens (``python
scripts/make_torch_goldens.py aos``: goldens/torch_aos_{pendulum,acrobot,
spinner,mini_cheetah}.npz, ``jit(vmap(...))`` of each AoS function at the
same inputs), punyo's capsule pairs from goldens/torch_aos_punyo.npz and
torch_partials_punyo.npz, and the pair distances from
goldens/torch_convex_pairs.npz (``tests/test_torch_convex.py``'s poses and
the reference's own rounding spread).

Tolerances: 1e-11 relative on kinematics, dynamics, wrenches and step_tau;
1e-9 on the partials (three nested forward and reverse derivatives).  Both
packages evaluate the same float64 expressions, up to the summation order
of small contractions.  Every vmap must batch natively: a batching-rule
fallback warning fails the test.
"""
import os

import numpy as np
import pytest
import torch
from torch.func import vmap

from idto_tpu_torch.contact import force as tforce
from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.geometry import distance as tdist
from idto_tpu_torch.models import dynamics as tdyn
from idto_tpu_torch.models import kinematics as tkin
from idto_tpu_torch.models.model import GeomType
from idto_tpu_torch.models.rotations import rpy_to_rot_np
from idto_tpu_torch.optimizer import partials as tpart
from idto_tpu_torch.optimizer import trajectory_aos as ttraj
from idto_tpu_torch.soa import contact as scon
from idto_tpu_torch.soa import dynamics as sdyn
from idto_tpu_torch.soa import kinematics as skin
from idto_tpu_torch.soa import partials as spart
from idto_tpu_torch.soa import rollout as sroll

# One intra-op thread: these tensors are tiny, and several test workers with
# a thread pool each oversubscribe the cores.
torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

_GOLDENS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens")
CASES = ("pendulum", "acrobot", "spinner", "mini_cheetah")
N, T = 4, 3
RTOL = 1e-11
RTOL_PARTIALS = 1e-9
# Punyo's capsule pairs go through the 48-step search along the capsule's
# axis, whose last steps are decided by rounding: two implementations end
# ~1e-8 apart on the axis (tests/test_torch_soa.py, RTOL_PUNYO).
RTOL_SEARCHED = 1e-8


def states(name, q_guess, nv, seed):
    """Seeded inputs: N states near the guess's knots (q, v, a), and a
    trajectory of T steps along the guess."""
    rng = np.random.default_rng(seed)
    q_guess = np.asarray(q_guess)
    knots = q_guess[rng.integers(0, len(q_guess), N)]
    return dict(
        q=knots + 0.05 * rng.standard_normal(knots.shape),
        v=0.3 * rng.standard_normal((N, nv)),
        a=0.2 * rng.standard_normal((N, nv)),
        traj=q_guess[: T + 1] + 0.02 * rng.standard_normal(
            (T + 1, q_guess.shape[1])),
    )


def short(prob):
    """The problem cut to T steps."""
    return prob.replace(num_steps=T, q_nom=prob.q_nom[: T + 1],
                        v_nom=prob.v_nom[: T + 1])


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _setup(name, seed):
    model, _, prob, params, q_guess = load_example(name, device="cpu")
    x = states(name, q_guess.numpy(), model.nv, seed)
    return dict(name=name, model=model, prob=short(prob),
                contact=params.contact,
                **{k: torch.tensor(v) for k, v in x.items()})


@pytest.fixture(scope="module", params=CASES)
def case(request):
    c = _setup(request.param, CASES.index(request.param))
    ref = np.load(os.path.join(_GOLDENS, f"torch_aos_{c['name']}.npz"))
    for key in ("q", "v", "a", "traj"):
        assert np.array_equal(ref[key], c[key].numpy()), key
    c["ref"] = ref
    return c


def _physics(c):
    """The AoS functions at the case's states, vmapped over them."""
    m, ct = c["model"], c["contact"]
    q, v, a = c["q"], c["v"], c["a"]
    R, p = vmap(lambda x: tkin.forward_kinematics(m, x))(q)
    _, _, w, pd = vmap(lambda x, y: tkin.body_velocities(m, x, y))(q, v)
    qdot = vmap(lambda x, y: tkin.v_to_qdot(m, x, y))(q, v)
    (tq, f), info = vmap(lambda x, y: tforce.contact_wrenches(
        m, x, y, ct, return_info=True))(q, v)
    return dict(
        fk_R=R, fk_p=p, bv_w=w, bv_pd=pd, qdot=qdot,
        v_back=vmap(lambda x, y: tkin.qdot_to_v(m, x, y))(q, qdot),
        nplus=vmap(lambda x: tkin.nplus_matrix(m, x))(q),
        tau=vmap(lambda x, y, z: tdyn.inverse_dynamics(m, x, y, z))(q, v, a),
        M=vmap(lambda x: tdyn.mass_matrix(m, x))(q),
        h=vmap(lambda x, y, t, g: tdyn.bias_forces(m, x, y, (t, g)))(
            q, v, tq, f),
        qdd=vmap(lambda x, y, z, t, g: tdyn.forward_dynamics(
            m, x, y, z, (t, g)))(q, v, a, tq, f),
        torques=tq, forces=f, info_phi=info.phi, info_normal=info.normal,
        info_p_contact=info.p_contact, info_force=info.force,
        step_tau=vmap(lambda x, y, z: ttraj.step_tau(m, ct, x, y, z))(
            q, v, a),
    )


_KINEMATICS = ("fk_R", "fk_p", "bv_w", "bv_pd", "qdot", "v_back", "nplus")
_DYNAMICS = ("tau", "M", "h", "qdd")
_CONTACT = ("torques", "forces", "info_phi", "info_normal", "info_p_contact",
            "info_force", "step_tau")


@pytest.fixture(scope="module")
def physics(case):
    return _physics(case)


@pytest.mark.parametrize("group", ("kinematics", "dynamics", "contact"))
def test_physics_matches_jax_aos(case, physics, group):
    keys = {"kinematics": _KINEMATICS, "dynamics": _DYNAMICS,
            "contact": _CONTACT}[group]
    ref = case["ref"]
    for key in keys:
        assert physics[key].shape == ref[key].shape, key
        if ref[key].size:
            assert _rel(physics[key], ref[key]) < RTOL, key


def test_contacts_are_active_where_the_model_has_them(case, physics):
    if case["model"].geoms is not None and case["model"].geoms.pairs:
        assert float(physics["forces"].abs().max()) > 1.0
    else:
        assert physics["info_phi"].shape == (N, 0)


def test_trajectory_matches_jax_aos(case):
    m, prob, ct, q = case["model"], case["prob"], case["contact"], case["traj"]
    ref = case["ref"]
    v = ttraj.velocities(m, prob, q)
    tau = ttraj.generalized_forces(m, prob, ct, q)
    assert _rel(v, ref["traj_v"]) < RTOL
    assert _rel(ttraj.accelerations(prob, v), ref["traj_a"]) < RTOL
    assert _rel(tau, ref["traj_tau"]) < RTOL
    assert _rel(ttraj.cost(m, prob, ct, q), ref["traj_cost"]) < RTOL
    assert _rel(ttraj.cost(m, prob, ct, q, tau=tau, v=v),
                ref["traj_cost"]) < RTOL


def test_partials_match_jax_aos(case):
    parts = tpart.id_partials(case["model"], case["prob"], case["contact"],
                              case["traj"])
    for name, x in zip(("dqm", "dqt", "dqp"), parts):
        assert _rel(x, case["ref"][name]) < RTOL_PARTIALS, name
    assert float(parts.dtau_dqm[0].abs().max()) == 0.0


def test_partials_match_one_jacfwd_over_the_triplet(case):
    args = (case["model"], case["prob"], case["contact"], case["traj"])
    for x, y in zip(tpart.id_partials(*args),
                    tpart.id_partials_full_jacfwd(*args)):
        assert _rel(x, y) < RTOL_PARTIALS


def test_per_problem_dispatch_takes_the_aos_partials(case):
    from idto_tpu_torch.optimizer.problem import SolverParameters

    m, prob, q = case["model"], case["prob"], case["traj"]
    params = SolverParameters(contact=case["contact"])
    for x, y in zip(tpart.id_partials_for(m, prob, params, q),
                    tpart.id_partials(m, prob, case["contact"], q)):
        assert torch.equal(x, y)
    nplus = tpart.nplus_stack(m, q)
    assert nplus.shape == (T + 1, m.nv, m.nq)
    assert torch.equal(nplus[1], tkin.nplus_matrix(m, q[1]))


# -- AoS against the port's SoA layer ----------------------------------------

SOA_CASES = CASES + ("jaco", "punyo")


@pytest.fixture(scope="module", params=SOA_CASES)
def soa_case(request):
    c = _setup(request.param, 10 + SOA_CASES.index(request.param))
    c["aos"] = _physics(c)
    return c


def _soa_tol(c):
    return RTOL_SEARCHED if c["name"] == "punyo" else RTOL


def test_kinematics_match_soa(soa_case):
    m, aos = soa_case["model"], soa_case["aos"]
    q, v = soa_case["q"].T, soa_case["v"].T
    R, p = skin.forward_kinematics(m, q)
    _, _, w, pd = skin.body_velocities(m, q, v)
    qdot = skin.v_to_qdot(m, q, v)
    for key, x in (("fk_R", R.permute(3, 2, 0, 1)),
                   ("fk_p", p.permute(2, 1, 0)), ("bv_w", w.permute(2, 1, 0)),
                   ("bv_pd", pd.permute(2, 1, 0)), ("qdot", qdot.T),
                   ("v_back", skin.qdot_to_v(m, q, qdot).T),
                   ("nplus", skin.nplus_matrix(m, q).permute(2, 0, 1))):
        assert _rel(aos[key], x) < RTOL, key


def test_dynamics_and_contact_match_soa(soa_case):
    m, ct, aos = soa_case["model"], soa_case["contact"], soa_case["aos"]
    q, v, a = soa_case["q"].T, soa_case["v"].T, soa_case["a"].T
    tq, f = scon.contact_wrenches(m, q, v, ct)
    tol = _soa_tol(soa_case)
    assert _rel(aos["torques"], tq.permute(2, 1, 0)) < tol
    assert _rel(aos["forces"], f.permute(2, 1, 0)) < tol
    assert _rel(aos["tau"], sdyn.inverse_dynamics(m, q, v, a).T) < RTOL
    assert _rel(aos["M"], sdyn.mass_matrix(m, q).permute(2, 0, 1)) < RTOL
    assert _rel(aos["qdd"], sdyn.forward_dynamics(m, q, v, a, (tq, f)).T) \
        < tol
    assert _rel(aos["step_tau"], scon.step_tau(m, ct, q, v, a).T) < tol


def test_trajectory_and_partials_match_soa(soa_case):
    m, ct = soa_case["model"], soa_case["contact"]
    prob, q = soa_case["prob"], soa_case["traj"]
    tol = _soa_tol(soa_case)
    tau_s, v_s = sroll.generalized_forces(m, prob, ct, q[None])
    assert _rel(ttraj.velocities(m, prob, q), v_s[0]) < RTOL
    assert _rel(ttraj.generalized_forces(m, prob, ct, q), tau_s[0]) < tol
    assert _rel(ttraj.cost(m, prob, ct, q),
                sroll.cost(m, prob, ct, q[None])[0]) < tol
    parts_s = spart.id_partials_batched(m, prob, ct, q[None])
    for x, y in zip(tpart.id_partials(m, prob, ct, q), parts_s):
        assert _rel(x, y[0]) < max(tol, RTOL_PARTIALS)


# -- punyo's capsule pairs against the JAX AoS goldens -----------------------


@pytest.fixture(scope="module")
def punyo():
    from tests.test_torch_soa import _punyo_inputs

    return _punyo_inputs()


def test_punyo_wrenches_and_step_tau_match_jax_aos(punyo):
    ref = np.load(os.path.join(_GOLDENS, "torch_aos_punyo.npz"))
    m, ct = punyo["tm"], punyo["tc"]
    q, v, a = (torch.tensor(punyo[k].T) for k in ("q", "v", "a"))
    tq, f = vmap(lambda x, y: tforce.contact_wrenches(m, x, y, ct))(q, v)
    assert np.abs(ref["forces"]).max() > 1.0
    assert _rel(tq, ref["torques"]) < RTOL_SEARCHED
    assert _rel(f, ref["forces"]) < RTOL_SEARCHED
    tau = vmap(lambda x, y, z: ttraj.step_tau(m, ct, x, y, z))(q, v, a)
    assert _rel(tau, ref["tau"]) < RTOL_SEARCHED


def test_punyo_dtau_dq_matches_jax_jacfwd(punyo):
    from torch.func import jacfwd

    ref = np.load(os.path.join(_GOLDENS, "torch_partials_punyo.npz"))
    m, ct = punyo["tm"], punyo["tc"]
    q, v, a = (torch.tensor(punyo[k].T) for k in ("q", "v", "a"))
    G = vmap(lambda x, y, z: jacfwd(
        lambda qq: ttraj.step_tau(m, ct, qq, y, z))(x))(q, v, a)
    assert np.abs(ref["dtau_dq"]).max() > 100.0
    assert _rel(G, ref["dtau_dq"]) < RTOL_PARTIALS


# -- pair distances ----------------------------------------------------------

# The pairs held here: box-box, a hull against a box (the hull pad of
# chip_smoke.py's geometry phase), the capsule pairs and the sphere pairs
# of the examples.  tests/test_torch_convex.py holds the SoA kernels on all
# 35; the AoS loops cost the same per pose.
G = GeomType
PAIRS = ((G.BOX, G.BOX), (G.CONVEX, G.BOX), (G.CAPSULE, G.BOX),
         (G.CAPSULE, G.CAPSULE), (G.SPHERE, G.BOX), (G.BOX, G.SPHERE),
         (G.SPHERE, G.CAPSULE), (G.CYLINDER, G.HALFSPACE))


@pytest.fixture(scope="module")
def convex_golden():
    return np.load(os.path.join(_GOLDENS, "torch_convex_pairs.npz"))


@pytest.mark.parametrize("pair", PAIRS,
                         ids=lambda p: f"{p[0].name}_{p[1].name}")
def test_pair_matches_jax_signed_distance(convex_golden, pair):
    """The distance, normal and witnesses of each pose within 1e-9 (1e-6
    through the capsule's search) beyond twice the reference's own
    rounding spread, as tests/test_torch_convex.py holds the SoA
    kernels."""
    from tests import test_torch_convex as tc

    ta, tb = pair
    k = tc._key(ta, tb)
    case = tc.pair_cases(ta, tb)
    for name in ("prm_a", "R_a", "p_a", "prm_b", "R_b", "p_b"):
        assert np.array_equal(convex_golden[f"{k}_{name}"], case[name]), name
    got = vmap(lambda pa, Ra, xa, pb, Rb, xb: tdist.signed_distance(
        ta, pa, Ra, xa, tb, pb, Rb, xb))(*(torch.tensor(case[x]) for x in (
            "prm_a", "R_a", "p_a", "prm_b", "R_b", "p_b")))
    tol = [tc.TOL] + [tc.TOL_SEARCHED if tc._searched(ta, tb)
                      else tc.TOL] * 3
    for name, x, t in zip(("phi", "n", "wa", "wb"), got, tol):
        ref, spread = convex_golden[f"{k}_{name}"], \
            convex_golden[f"{k}_{name}_spread"]
        err = np.abs(x.numpy() - ref).reshape(len(ref), -1).max(axis=1)
        assert (err <= t + 2.0 * spread).all(), (name, err.max())


def _sd(ta, pa, Ra, xa, tb, pb, Rb, xb):
    def t(x, width=None):
        x = np.asarray(x, dtype=np.float64)
        if width and x.size < width:
            x = np.concatenate([x, np.zeros(width - x.size)])
        return torch.tensor(x)

    return tdist.signed_distance(ta, t(pa, 3), t(Ra), t(xa),
                                 tb, t(pb, 3), t(Rb), t(xb))


_I3 = np.eye(3)
_O3 = np.zeros(3)
_RX = rpy_to_rot_np([0.0, np.pi / 2, 0.0])  # a capsule's z-axis onto x
# tests/test_exact_distance.py's analytic oracles: (name, pair A, pair B,
# exact phi, absolute tolerance).
ORACLES = (
    ("barrel_on_box_edge", (G.CAPSULE, [0.1, 0.5], _RX, [0, 1.3, 1.4]),
     (G.BOX, [1, 1, 1], _I3, _O3), 0.4, 1e-6),
    ("tilted_capsule_on_box_face",
     (G.CAPSULE, [0.1, 0.5], rpy_to_rot_np([np.pi / 6, 0, 0]), [0, 0, 1.0]),
     (G.BOX, [2, 2, 0.5], _I3, _O3),
     1.0 - 0.5 * np.cos(np.pi / 6) - 0.1 - 0.5, 1e-6),
    ("capsule_beside_cylinder", (G.CAPSULE, [0.1, 0.4], _I3, [1, 0, 0]),
     (G.CYLINDER, [0.3, 0.5], _I3, _O3), 0.6, 1e-6),
    ("edge_on_box_face", (G.BOX, [0.5] * 3, _I3, _O3),
     (G.BOX, [0.5] * 3, rpy_to_rot_np([np.pi / 4, 0, 0]), [0, 0, 1.5]),
     1.0 - np.sqrt(2) / 2, 1e-9),
    ("skew_edge_edge", (G.BOX, [0.5] * 3, _I3, _O3),
     (G.BOX, [0.5] * 3, rpy_to_rot_np([0, np.pi / 4, 0]), [0, 0, 1.5]),
     1.0 - np.sqrt(2) / 2, 1e-9),
    ("vertex_vertex", (G.BOX, [0.5] * 3, _I3, _O3),
     (G.BOX, [0.5] * 3, _I3, [1.2, 1.3, 1.4]),
     np.linalg.norm(np.array([0.2, 0.3, 0.4])), 1e-9),
    ("penetrating_vertex_face", (G.BOX, [0.5] * 3, _I3, _O3),
     (G.BOX, [0.5] * 3, _I3, [0, 0, 0.95]), -0.05, 1e-9),
    ("box_tilted_over_halfspace",
     (G.BOX, [0.5] * 3, rpy_to_rot_np([np.pi / 4, 0, 0]), [0, 0, 1.0]),
     (G.HALFSPACE, [], _I3, _O3), 1.0 - np.sqrt(2) / 2, 1e-12),
    ("cylinder_cap_in_box", (G.CYLINDER, [0.3, 0.5], _I3, [0, 0, 0.9]),
     (G.BOX, [1, 1, 0.5], _I3, _O3), -0.1, 1e-9),
    ("crossed_cylinders", (G.CYLINDER, [0.2, 0.5], _I3, _O3),
     (G.CYLINDER, [0.2, 0.5], rpy_to_rot_np([np.pi / 2, 0, 0]), [0, 0, 1.0]),
     0.3, 1e-5),
)


@pytest.mark.parametrize("oracle", ORACLES, ids=lambda o: o[0])
def test_signed_distance_exact_oracles(oracle):
    _, a, b, want, atol = oracle
    phi, n, wa, wb = _sd(*a, *b)
    assert abs(float(phi) - want) <= atol
    # The witnesses are phi apart along the normal.
    assert float((wb - wa - phi * n).abs().max()) < max(atol, 1e-6) * 10


def test_barrel_on_box_edge_witness_lies_on_the_edge():
    _, a, b, _, _ = ORACLES[0]
    wb = _sd(*a, *b)[3].numpy()
    np.testing.assert_allclose(wb[1:], [1.0, 1.0], atol=1e-5)
    assert abs(wb[0]) <= 0.5 + 1e-6


def test_capsule_distance_derivative_matches_central_differences():
    """The envelope theorem through the searched minimizer
    (tests/test_exact_distance.py's barrel-on-edge gradient check)."""
    from torch.func import grad

    prm_c, prm_b = torch.tensor([0.1, 0.5, 0.0]), torch.tensor([1.0] * 3)
    Rx, I3 = torch.tensor(_RX), torch.eye(3, dtype=torch.float64)

    def phi_of(p):
        return tdist.signed_distance(G.CAPSULE, prm_c, Rx, p, G.BOX, prm_b,
                                     I3, torch.zeros(3,
                                                     dtype=torch.float64))[0]

    p0 = torch.tensor([0.15, 1.3, 1.4])
    g = grad(phi_of)(p0)
    for k in range(3):
        e = torch.zeros(3, dtype=torch.float64)
        e[k] = 1e-6
        fd = (phi_of(p0 + e) - phi_of(p0 - e)) / 2e-6
        assert abs(float(g[k] - fd)) < 1e-4


# -- small counterparts ------------------------------------------------------


def test_mat3_matches_explicit_products():
    from idto_tpu_torch.models import mat3

    rng = np.random.default_rng(5)
    A, B = (torch.tensor(rng.standard_normal((4, 3, 3))) for _ in range(2))
    a, b = (torch.tensor(rng.standard_normal((4, 3))) for _ in range(2))
    An, Bn, an, bn = A.numpy(), B.numpy(), a.numpy(), b.numpy()
    T_ = np.swapaxes
    for got, want in (
            (mat3.mul(A, B), An @ Bn), (mat3.mul_t(A, B), An @ T_(Bn, 1, 2)),
            (mat3.t_mul(A, B), T_(An, 1, 2) @ Bn),
            (mat3.mv(A, a), np.einsum("nij,nj->ni", An, an)),
            (mat3.tmv(A, a), np.einsum("nji,nj->ni", An, an)),
            (mat3.cross(a, b), np.cross(an, bn)),
            (mat3.dot(a, b), np.sum(an * bn, -1)),
            (mat3.transpose(A), T_(An, 1, 2))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-15)


def test_soa_layout_round_trips_and_unskew_inverts_skew():
    from idto_tpu_torch.models.rotations import skew, unskew
    from idto_tpu_torch.soa import mat3 as smat3

    rng = np.random.default_rng(6)
    M = torch.tensor(rng.standard_normal((5, 2, 3, 3)))
    x = torch.tensor(rng.standard_normal((5, 2, 3)))
    assert torch.equal(smat3.to_aos_mat(smat3.from_aos_mat(M)), M)
    assert torch.equal(smat3.to_aos_vec(smat3.from_aos_vec(x)), x)
    S = smat3.from_aos_mat(M)
    assert torch.equal(smat3.to_aos_mat(smat3.transpose(S)), M.mT)
    w = torch.tensor(rng.standard_normal((3, 7)))
    assert torch.allclose(unskew(skew(w)), w, rtol=0, atol=1e-15)
