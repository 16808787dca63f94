"""The port's model building, config loading and package boundary.

The port's own ``load_example`` (its URDF parser, ModelBuilder and YAML
translation) must leave exactly what ``convert`` makes of the JAX
package's ``load_example``: static topology equal, numbers equal to the
last bit (both parse the same files into float64 with numpy).
"""
import dataclasses
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


@pytest.mark.parametrize("name", ["pendulum", "spinner", "mini_cheetah"])
def test_load_example_matches_converted_jax(name):
    jm, _, jprob, jparams, jqg = jax_load_example(name)
    model, cfg, prob, params, q_guess = load_example(name, device="cpu")
    _assert_same(model, convert.model(jm, device="cpu"), f"{name}.model")
    _assert_same(prob, convert.problem(jprob, device="cpu"), f"{name}.problem")
    _assert_same(params, convert.solver_params(jparams), f"{name}.params")
    _assert_same(q_guess, convert.tensor(jqg, device="cpu"), f"{name}.q_guess")


def test_registry_and_model_helpers():
    assert example_names() == ["mini_cheetah", "pendulum", "spinner"]
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
    """Importing the whole port slice pulls in no JAX and no idto_tpu."""
    code = (
        "import sys\n"
        "import idto_tpu_torch.convert\n"
        "import idto_tpu_torch.examples.registry\n"
        "import idto_tpu_torch.examples.config\n"
        "import idto_tpu_torch.parallel.batching\n"
        "import idto_tpu_torch.optimizer.batched\n"
        "import idto_tpu_torch.optimizer.solver\n"
        "import idto_tpu_torch.ops.cr_kernel\n"
        "import idto_tpu_torch.soa.partials\n"
        "from idto_tpu_torch.examples.registry import load_example\n"
        "load_example('mini_cheetah', device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'idto_tpu.')) or m == 'idto_tpu')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
