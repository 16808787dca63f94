"""Example registry (counterpart of ``idto_tpu/examples/registry.py``): the
twelve examples, each a function that builds the model and a YAML config.
Every pair type they use has an SoA kernel (``soa.contact.supports_soa``):
jaco and allegro_hand need only sphere and box pairs, punyo the capsule
pairs as well.  No example uses a mesh, an SDF file or a convex hull.  Model
files and YAML configs are read from the JAX package's data directories by
path."""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from idto_tpu_torch.models.model import GeomType, JointType, ModelBuilder
from idto_tpu_torch.models.rotations import rpy_to_rot_np
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


def _mini_cheetah(hills: int = 0, hill_height: float = 0.05,
                  hill_spacing: float = 1.0) -> ModelBuilder:
    b = parse_urdf_file(_asset("mini_cheetah.urdf"))
    _add_ground_box(b, z_top=0.0)
    # Optional hills: cylinders on their side, welded to the world.
    for i in range(hills):
        b.add_geometry(
            "world", GeomType.CYLINDER, [1.0, 12.5],
            R=rpy_to_rot_np([np.pi / 2, 0.0, 0.0]),
            p=(2.0 + hill_spacing * i, 0.0, -1.0 + hill_height),
            name=f"hill_{i}",
        )
    return b


def _solid_sphere_inertia(mass: float, radius: float) -> np.ndarray:
    return np.eye(3) * (0.4 * mass * radius**2)


def _solid_box_inertia(mass: float, half) -> np.ndarray:
    hx, hy, hz = half
    return np.diag([
        mass / 3.0 * (hy**2 + hz**2),
        mass / 3.0 * (hx**2 + hz**2),
        mass / 3.0 * (hx**2 + hy**2),
    ])


def _add_free_sphere(b: ModelBuilder, name: str, radius: float, mass: float):
    """Free-floating ball manipuland."""
    b.add_link(
        name, "world", JointType.FLOATING, joint_name=f"{name}_joint",
        mass=mass, inertia=_solid_sphere_inertia(mass, radius),
    )
    b.add_geometry(name, GeomType.SPHERE, [radius], name=f"{name}_collision")


def _add_free_box(b: ModelBuilder, name: str, half, mass: float):
    """Free-floating box manipuland."""
    b.add_link(
        name, "world", JointType.FLOATING, joint_name=f"{name}_joint",
        mass=mass, inertia=_solid_box_inertia(mass, half),
    )
    b.add_geometry(name, GeomType.BOX, list(half), name=f"{name}_collision")


def _kuka() -> ModelBuilder:
    """Kuka iiwa (sphere collisions, no gravity on the arm) pushes a box
    across the ground."""
    b = parse_urdf_file(_asset("kuka_iiwa.urdf"), gravity_enabled=False)
    _add_free_box(b, "box", (0.138, 0.099, 0.088), 1.45)
    _add_ground_box(b, z_top=0.0)
    return b


def _jaco_arm(b: Optional[ModelBuilder] = None, prefix: str = "",
              y: float = 0.27) -> ModelBuilder:
    """A jaco arm without gravity, welded at yaw pi/2 and (0, y, 0.11)."""
    return parse_urdf_file(
        _asset("jaco_arm.urdf"), builder=b, gravity_enabled=False,
        prefix=prefix, R_base=rpy_to_rot_np([0.0, 0.0, np.pi / 2]),
        p_base=(0.0, y, 0.11),
    )


def _jaco() -> ModelBuilder:
    """Jaco arm pushes a 15 cm box on the ground."""
    b = _jaco_arm()
    _add_free_box(b, "box", (0.075, 0.075, 0.075), 0.55)
    _add_ground_box(b, z_top=0.0)
    return b


def _dual_jaco() -> ModelBuilder:
    """Two jaco arms (one file parsed twice, at y = +/-0.27) lift one
    box."""
    b = _jaco_arm(prefix="left_")
    _jaco_arm(b, prefix="right_", y=-0.27)
    _add_free_box(b, "box", (0.075, 0.075, 0.075), 0.55)
    _add_ground_box(b, z_top=0.0)
    return b


def _jaco_ball() -> ModelBuilder:
    """Jaco arm rolls a ball (r=0.06, m=0.3) on the ground."""
    b = _jaco_arm()
    _add_free_sphere(b, "ball", 0.06, 0.3)
    _add_ground_box(b, z_top=0.0)
    return b


def _allegro_hand(upside_down: bool = False) -> ModelBuilder:
    """Palm-up allegro hand rotates a ball (r=0.06, m=0.05) in hand, no
    ground; ``upside_down`` flips gravity."""
    b = parse_urdf_file(_asset("allegro_hand.urdf"), gravity_enabled=True)
    if upside_down:
        b.set_gravity((0.0, 0.0, 9.81))
    _add_free_sphere(b, "ball", 0.06, 0.05)
    return b


def _punyo() -> ModelBuilder:
    """Punyo humanoid (capsule limbs, no gravity on the robot) hugs and
    lifts a large ball (r=0.2, m=1.0) off the ground."""
    b = parse_urdf_file(_asset("punyoid.urdf"), gravity_enabled=False)
    _add_free_sphere(b, "ball", 0.2, 1.0)
    _add_ground_box(b, z_top=0.0)
    return b


@dataclasses.dataclass(frozen=True)
class ExampleDef:
    name: str
    build: Callable[[], ModelBuilder]
    config: str
    # A separate plant for the closed-loop simulator (None: the optimizer's
    # model), with the same state and actuation layout.
    build_sim: Optional[Callable[[], ModelBuilder]] = None
    # Contact overrides on the simulation side: ContactParams fields, plus
    # ``stiffness_scale`` / ``smoothing_scale`` factors on the optimizer's.
    sim_contact: Optional[dict] = None


# The simulator's stand-in for a near-rigid (hydroelastic) plant: same
# kinematics, contact ten times stiffer and ten times less smoothed than the
# law the optimizer plans with.
_HYDRO_SIM_CONTACT = {"stiffness_scale": 10.0, "smoothing_scale": 0.1}

_REGISTRY = {
    "pendulum": ExampleDef("pendulum", _pendulum, "pendulum.yaml"),
    "acrobot": ExampleDef("acrobot", _acrobot, "acrobot.yaml"),
    "spinner": ExampleDef("spinner", _spinner, "spinner.yaml"),
    "hopper": ExampleDef("hopper", _hopper, "hopper.yaml"),
    "mini_cheetah": ExampleDef("mini_cheetah", _mini_cheetah,
                               "mini_cheetah.yaml"),
    "airhockey": ExampleDef("airhockey", _airhockey, "airhockey.yaml"),
    "kuka": ExampleDef("kuka", _kuka, "kuka.yaml"),
    "jaco": ExampleDef("jaco", _jaco, "jaco.yaml",
                       sim_contact=_HYDRO_SIM_CONTACT),
    "dual_jaco": ExampleDef("dual_jaco", _dual_jaco, "dual_jaco.yaml",
                            sim_contact=_HYDRO_SIM_CONTACT),
    "jaco_ball": ExampleDef("jaco_ball", _jaco_ball, "jaco_ball.yaml",
                            sim_contact=_HYDRO_SIM_CONTACT),
    "allegro_hand": ExampleDef("allegro_hand", _allegro_hand,
                               "allegro_hand.yaml",
                               sim_contact=_HYDRO_SIM_CONTACT),
    "punyo": ExampleDef("punyo", _punyo, "punyo.yaml",
                        sim_contact=_HYDRO_SIM_CONTACT),
}


def example_names():
    return sorted(_REGISTRY)


def get_example(name: str) -> ExampleDef:
    return _REGISTRY[name]


def load_example(name: str, test_mode: bool = False, dtype=torch.float64,
                 device="cuda"):
    """(model, config, problem, params, q_guess) for an example;
    ``test_mode`` applies the ``--test`` overrides to the config."""
    from idto_tpu_torch.examples.config import (
        ExampleConfig,
        build_initial_guess,
        build_problem,
        build_solver_params,
    )

    ex = get_example(name)
    cfg = ExampleConfig.load(os.path.join(_DATA_ROOT, "examples", "configs",
                                          ex.config))
    if test_mode:
        cfg = cfg.apply_test_mode()
    model = ex.build().finalize(dtype=dtype, device=device)
    prob = build_problem(cfg, model, dtype=dtype, device=device)
    params = build_solver_params(cfg)
    q_guess = build_initial_guess(cfg, dtype=dtype, device=device)
    return model, cfg, prob, params, q_guess


def load_sim_plant(name: str, params, dtype=torch.float64, device="cuda"):
    """(sim_model, sim_contact) for the closed-loop simulator where the
    example's simulated plant differs from the optimizer's; (None, None)
    where it simulates the optimizer's model under the optimizer's
    contact."""
    ex = get_example(name)
    sim_model = (ex.build_sim().finalize(dtype=dtype, device=device)
                 if ex.build_sim else None)
    sim_contact = None
    if ex.sim_contact:
        sc = dict(ex.sim_contact)
        contact = params.contact
        sim_contact = dataclasses.replace(
            contact,
            stiffness=contact.stiffness * sc.pop("stiffness_scale", 1.0),
            smoothing_factor=(
                contact.smoothing_factor * sc.pop("smoothing_scale", 1.0)
            ),
            **sc,
        )
    return sim_model, sim_contact
