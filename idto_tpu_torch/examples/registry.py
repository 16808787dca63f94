"""Example registry (counterpart of ``idto_tpu/examples/registry.py``):
pendulum, spinner and mini_cheetah so far.  Model files and YAML configs
are read from the JAX package's data directories by path."""
from __future__ import annotations

import os

import torch

from idto_tpu_torch.models.model import GeomType, ModelBuilder
from idto_tpu_torch.models.urdf import parse_urdf_file

_DATA_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "idto_tpu",
)


def _asset(name: str) -> str:
    return os.path.join(_DATA_ROOT, "assets", name)


def _add_ground_box(
    builder: ModelBuilder, *, z_top: float = 0.0, size: float = 25.0,
    depth: float = 10.0
) -> None:
    """Large ground box welded to the world."""
    builder.add_geometry(
        "world",
        GeomType.BOX,
        [size / 2, size / 2, depth / 2],
        p=(0.0, 0.0, z_top - depth / 2),
        name="ground",
    )


def _pendulum() -> ModelBuilder:
    return parse_urdf_file(_asset("pendulum.urdf"))


def _spinner() -> ModelBuilder:
    return parse_urdf_file(_asset("spinner_friction.urdf"))


def _mini_cheetah() -> ModelBuilder:
    b = parse_urdf_file(_asset("mini_cheetah.urdf"))
    _add_ground_box(b, z_top=0.0)
    return b


_REGISTRY = {
    "pendulum": (_pendulum, "pendulum.yaml"),
    "spinner": (_spinner, "spinner.yaml"),
    "mini_cheetah": (_mini_cheetah, "mini_cheetah.yaml"),
}


def example_names():
    return sorted(_REGISTRY)


def load_example(name: str, dtype=torch.float64, device="cuda"):
    """(model, config, problem, params, q_guess) for an example."""
    from idto_tpu_torch.examples.config import (
        ExampleConfig,
        build_initial_guess,
        build_problem,
        build_solver_params,
    )

    build, config = _REGISTRY[name]
    cfg = ExampleConfig.load(os.path.join(_DATA_ROOT, "examples", "configs",
                                          config))
    model = build().finalize(dtype=dtype, device=device)
    prob = build_problem(cfg, model, dtype=dtype, device=device)
    params = build_solver_params(cfg)
    q_guess = build_initial_guess(cfg, dtype=dtype, device=device)
    return model, cfg, prob, params, q_guess
