"""The port's model building, config loading and package boundary.

The port's own ``load_example`` (its URDF parser, ModelBuilder and YAML
translation) must leave exactly what ``convert`` makes of the JAX
package's ``load_example``: static topology equal, numbers equal to the
last bit (both parse the same files into float64 with numpy).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from idto_tpu.examples.registry import load_example as jax_load_example
from idto_tpu_torch import convert
from idto_tpu_torch.examples.registry import example_names, load_example
from idto_tpu_torch.models.model import Model
from idto_tpu_torch.parallel.batching import broadcast_problem

# One intra-op thread: these tensors are tiny, and several test workers with
# a thread pool each oversubscribe the cores (a solve is then 5-10x slower).
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same(a, b, where):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), where
    elif dataclasses.is_dataclass(a):
        assert type(a) is type(b), where
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{where}.{f.name}")
    else:
        assert a == b, where


@pytest.mark.parametrize("name", [
    "pendulum", "acrobot", "spinner", "hopper", "airhockey", "mini_cheetah",
    "kuka", "jaco", "jaco_ball", "dual_jaco", "allegro_hand", "punyo"])
def test_load_example_matches_converted_jax(name):
    jm, _, jprob, jparams, jqg = jax_load_example(name)
    model, cfg, prob, params, q_guess = load_example(name, device="cpu")
    _assert_same(model, convert.model(jm, device="cpu"), f"{name}.model")
    _assert_same(prob, convert.problem(jprob, device="cpu"), f"{name}.problem")
    _assert_same(params, convert.solver_params(jparams), f"{name}.params")
    _assert_same(q_guess, convert.tensor(jqg, device="cpu"), f"{name}.q_guess")


@pytest.mark.parametrize("name", ["jaco", "mini_cheetah"])
def test_load_example_test_mode_matches_converted_jax(name):
    """``test_mode`` applies the reference's ``--test`` overrides."""
    _, jcfg, _, jparams, _ = jax_load_example(name, test_mode=True)
    _, cfg, _, params, _ = load_example(name, test_mode=True, device="cpu")
    _assert_same(params, convert.solver_params(jparams), f"{name}.params")
    assert params.max_iterations == 10 and not cfg.mpc
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("variant", ["hills", "upside_down", "dual_prefix",
                                     "gravity_switch"])
def test_builder_variants_match_converted_jax(variant):
    """The build functions' options: the cheetah's cylinder hills, the allegro
    hand's flipped gravity, one URDF parsed twice under prefixes with a base
    pose (dual_jaco's link order), and gravity switched off on one link."""
    from idto_tpu.examples import registry as jreg
    from idto_tpu_torch.examples import registry as treg
    from idto_tpu_torch.models.model import GeomType
    from idto_tpu_torch.soa.contact import supports_soa

    if variant == "hills":
        jb = jreg._mini_cheetah(hills=3, hill_height=0.08, hill_spacing=1.5)
        tb = treg._mini_cheetah(hills=3, hill_height=0.08, hill_spacing=1.5)
    elif variant == "upside_down":
        jb, tb = jreg._allegro_hand(True), treg._allegro_hand(True)
    elif variant == "dual_prefix":
        jb, tb = jreg._dual_jaco(), treg._dual_jaco()
    else:
        jb, tb = jreg._kuka(), treg._kuka()
        for b in (jb, tb):
            b.set_gravity_enabled("box", False)
            b.set_gravity_enabled(b._link_names[0], True)
    model = tb.finalize(device="cpu")
    _assert_same(model, convert.model(jb.finalize(), device="cpu"), variant)
    # The hills meet the cheetah's body box: a box-cylinder pair, served by
    # the generic convex pair kernel (soa/convex.py), as every variant's
    # pairs are.
    assert supports_soa(model)
    if variant == "hills":
        assert model.geoms.types.count(int(GeomType.CYLINDER)) == 3
        assert model.geoms.names[-3:] == ("hill_0", "hill_1", "hill_2")
    elif variant == "upside_down":
        assert model.gravity.tolist() == [0.0, 0.0, 9.81]
    elif variant == "dual_prefix":
        left = [n for n in model.link_names if n.startswith("left_")]
        right = [n for n in model.link_names if n.startswith("right_")]
        assert len(left) == len(right) > 0
        # q's layout follows the order of add_link: left arm, right arm, box.
        assert model.link_names == tuple(left + right + ["box"])
        assert model.nu == 14 and float(model.grav_scale.sum()) == 1.0
    else:
        assert model.grav_scale[0] == 1.0 and model.grav_scale[-1] == 0.0


def test_registry_and_model_helpers():
    assert example_names() == [
        "acrobot", "airhockey", "allegro_hand", "dual_jaco", "hopper", "jaco",
        "jaco_ball", "kuka", "mini_cheetah", "pendulum", "punyo", "spinner"]
    model, _, prob, _, _ = load_example("mini_cheetah", device="cpu")
    assert isinstance(model, Model)
    assert (model.nq, model.nv, model.nu) == (19, 18, 12)
    assert model.unactuated_vdofs == tuple(range(6))
    # All 15 geometry pairs are candidates: the URDF's feet filter group is
    # read back empty by both parsers (its <ignored_collision_filter_group>
    # child also matches the group tag and overwrites it), and the port
    # keeps that behaviour for parity.
    assert len(model.geoms.pairs) == 15
    m32 = model.to(dtype=torch.float32)
    assert m32.R_pj.dtype == torch.float32 and m32.geoms.R.dtype == torch.float32
    assert m32.levels == model.levels
    probs = broadcast_problem(prob, 3)
    assert probs.q_nom.shape == (3, 21, 19) and probs.num_steps == 20


def test_port_imports_neither_jax_nor_reference():
    """Importing every module of the port (found by walking the package,
    so a new module is checked without being listed) and ``chip_smoke``
    pulls in no JAX and no idto_tpu."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import idto_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "idto_tpu_torch.__path__, 'idto_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "from idto_tpu_torch.examples.registry import load_example\n"
        "load_example('mini_cheetah', device='cpu')\n"
        "load_example('punyo', device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'idto_tpu.')) or m == 'idto_tpu')\n"
        "print(json.dumps({'names': names, 'bad': bad}))\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["bad"] == []
    for name in ("idto_tpu_torch.api", "idto_tpu_torch.optimizer.linesearch",
                 "idto_tpu_torch.examples.velocity_command",
                 "idto_tpu_torch.utils.checkpoint",
                 "idto_tpu_torch.utils.profiler",
                 "idto_tpu_torch.utils.timing", "idto_tpu_torch.ops.cr_kernel",
                 "idto_tpu_torch.mpc.runner", "idto_tpu_torch.utils.playback",
                 "idto_tpu_torch.utils.liveview", "idto_tpu_torch.soa.convex",
                 "idto_tpu_torch.models.mesh", "idto_tpu_torch.models.sdf",
                 "idto_tpu_torch.parallel.horizon",
                 "idto_tpu_torch.parallel.multihost"):
        assert name in out["names"], name
