"""Example registry (counterpart of ``idto_tpu/examples/registry.py``):
pendulum, acrobot, spinner, hopper, airhockey and mini_cheetah.  The arm
examples whose contact pairs the SoA physics covers (kuka, jaco_ball,
dual_jaco) still need the free-floating manipuland helpers; jaco,
allegro_hand and punyo need pair kernels that are not ported.  Model files
and YAML configs are read from the JAX package's data directories by
path."""
from __future__ import annotations

import os

import numpy as np
import torch

from idto_tpu_torch.models.model import GeomType, JointType, ModelBuilder
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


def _acrobot() -> ModelBuilder:
    return parse_urdf_file(_asset("acrobot.urdf"))


def _spinner() -> ModelBuilder:
    return parse_urdf_file(_asset("spinner_friction.urdf"))


def _hopper() -> ModelBuilder:
    b = parse_urdf_file(_asset("hopper.urdf"))
    _add_ground_box(b, z_top=0.0)
    return b


def _airhockey() -> ModelBuilder:
    """Pusher and puck built in code: prismatic x/y and a revolute pusher
    over massless dummy links, a planar-joint puck; both with a sphere
    collision of radius 0.1."""
    b = ModelBuilder()
    mass, radius, height = 0.1, 0.1, 0.05
    # Solid cylinder inertia about z.
    izz = 0.5 * mass * radius**2
    ixx = mass * (3 * radius**2 + height**2) / 12.0
    inertia = np.diag([ixx, ixx, izz])
    b.add_link("dummy1", "world", JointType.PRISMATIC,
               joint_name="pusher_x", axis=(1, 0, 0))
    b.add_link("dummy2", "dummy1", JointType.PRISMATIC,
               joint_name="pusher_y", axis=(0, 1, 0))
    b.add_link("pusher", "dummy2", JointType.REVOLUTE,
               joint_name="pusher_theta", axis=(0, 0, 1),
               mass=mass, inertia=inertia)
    b.add_actuator("pusher_x")
    b.add_actuator("pusher_y")
    b.add_actuator("pusher_theta")
    b.add_geometry("pusher", GeomType.SPHERE, [radius],
                   name="pusher_collision")
    b.add_link("puck", "world", JointType.PLANAR, joint_name="puck_joint",
               damping=(0.1, 0.1, 0.1), mass=mass, inertia=inertia)
    b.add_geometry("puck", GeomType.SPHERE, [radius], name="puck_collision")
    return b


def _mini_cheetah() -> ModelBuilder:
    b = parse_urdf_file(_asset("mini_cheetah.urdf"))
    _add_ground_box(b, z_top=0.0)
    return b


_REGISTRY = {
    "pendulum": (_pendulum, "pendulum.yaml"),
    "acrobot": (_acrobot, "acrobot.yaml"),
    "spinner": (_spinner, "spinner.yaml"),
    "hopper": (_hopper, "hopper.yaml"),
    "airhockey": (_airhockey, "airhockey.yaml"),
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
