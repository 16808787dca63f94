"""YAML example configuration and its translation into
ProblemDefinition + SolverParameters (counterpart of
``idto_tpu/examples/config.py``).  Reads the JAX package's YAML files."""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch
import yaml

from idto_tpu_torch.contact.force import ContactParams
from idto_tpu_torch.models.model import JointType, Model
from idto_tpu_torch.optimizer.problem import (
    ConvergenceTolerances,
    GradientsMethod,
    LinearSolverType,
    LinesearchMethod,
    ProblemDefinition,
    ScalingMethod,
    SolverMethod,
    SolverParameters,
    linear_interp_nominal,
)


class ConfigWarning(UserWarning):
    """A YAML option was accepted but cannot take effect in this build."""


@dataclasses.dataclass
class ExampleConfig:
    """Deserialized YAML options (same schema and defaults as the JAX
    package's ExampleConfig)."""

    q_init: list = dataclasses.field(default_factory=list)
    v_init: list = dataclasses.field(default_factory=list)
    q_nom_start: list = dataclasses.field(default_factory=list)
    q_nom_end: list = dataclasses.field(default_factory=list)
    q_nom_relative_to_q_init: Optional[list] = None
    q_guess: Optional[list] = None
    Qq: list = dataclasses.field(default_factory=list)
    Qv: list = dataclasses.field(default_factory=list)
    R: list = dataclasses.field(default_factory=list)
    Qfq: list = dataclasses.field(default_factory=list)
    Qfv: list = dataclasses.field(default_factory=list)
    time_step: float = 0.05
    num_steps: int = 40
    max_iters: int = 100
    method: str = "trust_region"
    linesearch: str = "armijo"
    gradients_method: str = "autodiff"
    linear_solver: str = "pentadiagonal_lu"
    scaling: bool = True
    scaling_method: str = "double_sqrt"
    equality_constraints: bool = True
    normalize_quaternions: bool = False
    Delta0: float = 1e-1
    Delta_max: float = 1e5
    num_threads: int = 1
    tolerances: dict = dataclasses.field(default_factory=dict)
    contact_stiffness: float = 100.0
    dissipation_velocity: float = 0.1
    smoothing_factor: float = 0.1
    friction_coefficient: float = 0.5
    stiction_velocity: float = 0.05
    mpc: bool = False
    mpc_iters: int = 1
    controller_frequency: float = 50.0
    sim_time: float = 5.0
    sim_time_step: float = 1e-3
    sim_realtime_rate: float = 1.0
    feed_forward: bool = True
    Kp: list = dataclasses.field(default_factory=list)
    Kd: list = dataclasses.field(default_factory=list)
    play_target_trajectory: bool = False
    play_initial_guess: bool = False
    play_optimal_trajectory: bool = False
    linesearch_plot_every_iteration: bool = False
    print_debug_data: bool = False
    save_solver_stats_csv: bool = True
    verbose: bool = False

    @classmethod
    def load(cls, path: str) -> "ExampleConfig":
        with open(path) as f:
            raw = yaml.safe_load(f)
        # YAML 1.1 reads exponent literals without a dot ("1e5") as
        # strings; coerce numeric-typed fields and numeric lists.
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in raw.items():
            if k not in fields:
                warnings.warn(
                    f"{path}: unknown config key {k!r} ignored",
                    ConfigWarning, stacklevel=2,
                )
                continue
            ftype = fields[k].type
            if ftype == "float":
                v = float(v)
            elif ftype == "int":
                v = int(v)
            elif isinstance(v, list):
                v = [
                    float(x) if isinstance(x, (str, int, float))
                    and not isinstance(x, bool) else x
                    for x in v
                ]
            elif k == "tolerances" and isinstance(v, dict):
                v = {kk: float(vv) for kk, vv in v.items()}
            kwargs[k] = v
        return cls(**kwargs)

    def apply_test_mode(self) -> "ExampleConfig":
        """The ``--test`` smoke-mode overrides: ten iterations, no MPC, no
        files written, nothing played back."""
        return dataclasses.replace(
            self, max_iters=10, mpc=False, save_solver_stats_csv=False,
            play_optimal_trajectory=False, play_initial_guess=False,
            play_target_trajectory=False, num_threads=1,
        )


def build_problem(
    cfg: ExampleConfig, model: Model, dtype=torch.float64, device="cuda"
) -> ProblemDefinition:
    nq, nv = model.nq, model.nv
    q_init = np.asarray(cfg.q_init, dtype=np.float64)
    v_init = np.asarray(cfg.v_init, dtype=np.float64)
    if q_init.shape != (nq,) or v_init.shape != (nv,):
        raise ValueError(f"q_init/v_init shapes {q_init.shape}/{v_init.shape} "
                         f"do not match nq={nq}, nv={nv}")
    rel = np.asarray(
        cfg.q_nom_relative_to_q_init
        if cfg.q_nom_relative_to_q_init is not None
        else [False] * nq
    )
    q_nom_start = np.asarray(cfg.q_nom_start, dtype=np.float64) + rel * q_init
    q_nom_end = np.asarray(cfg.q_nom_end, dtype=np.float64) + rel * q_init
    q_nom = linear_interp_nominal(q_nom_start, q_nom_end, cfg.num_steps)

    if nq == nv:
        v_nom = np.zeros((cfg.num_steps + 1, nv))
        v_nom[0] = v_init
        v_nom[1:] = (q_nom[1:] - q_nom[:-1]) / cfg.time_step
    else:
        # Quaternion dofs: v_nom = v_init everywhere.
        v_nom = np.tile(v_init, (cfg.num_steps + 1, 1))

    for j in range(model.num_joints):
        if JointType(model.joint_types[j]) == JointType.FLOATING:
            qs = model.q_starts[j]
            q_nom[:, qs : qs + 4] /= np.linalg.norm(
                q_nom[:, qs : qs + 4], axis=-1, keepdims=True
            )
            q_init[qs : qs + 4] /= np.linalg.norm(q_init[qs : qs + 4])

    def t(x):
        return torch.as_tensor(
            np.asarray(x, dtype=np.float64), dtype=dtype, device=device
        )

    return ProblemDefinition(
        num_steps=cfg.num_steps,
        dt=cfg.time_step,
        q_init=t(q_init),
        v_init=t(v_init),
        q_nom=t(q_nom),
        v_nom=t(v_nom),
        Qq=t(cfg.Qq),
        Qv=t(cfg.Qv),
        R=t(cfg.R),
        Qf_q=t(cfg.Qfq),
        Qf_v=t(cfg.Qfv),
    )


def build_solver_params(cfg: ExampleConfig) -> SolverParameters:
    gm_name = "autodiff" if cfg.gradients_method == "exact" else (
        cfg.gradients_method
    )
    tol = ConvergenceTolerances(**cfg.tolerances) if cfg.tolerances else (
        ConvergenceTolerances()
    )
    return SolverParameters(
        method=SolverMethod(cfg.method),
        linesearch_method=LinesearchMethod(cfg.linesearch),
        max_iterations=cfg.max_iters,
        linear_solver=LinearSolverType(cfg.linear_solver),
        gradients_method=GradientsMethod(gm_name),
        normalize_quaternions=cfg.normalize_quaternions,
        scaling=cfg.scaling,
        scaling_method=ScalingMethod(cfg.scaling_method),
        equality_constraints=cfg.equality_constraints,
        Delta0=cfg.Delta0,
        Delta_max=cfg.Delta_max,
        check_convergence=bool(cfg.tolerances),
        tolerances=tol,
        contact=ContactParams(
            stiffness=cfg.contact_stiffness,
            smoothing_factor=cfg.smoothing_factor,
            dissipation_velocity=cfg.dissipation_velocity,
            stiction_velocity=cfg.stiction_velocity,
            friction_coefficient=cfg.friction_coefficient,
        ),
        verbose=cfg.verbose,
    )


def build_initial_guess(
    cfg: ExampleConfig, dtype=torch.float64, device="cuda"
):
    """Linear interpolation q_init -> q_guess, (T+1, nq)."""
    q_guess_end = (
        np.asarray(cfg.q_guess, dtype=np.float64)
        if cfg.q_guess is not None
        else np.asarray(cfg.q_init, dtype=np.float64)
    )
    guess = linear_interp_nominal(
        np.asarray(cfg.q_init, dtype=np.float64), q_guess_end, cfg.num_steps
    )
    return torch.as_tensor(guess, dtype=dtype, device=device)
