"""Carry objects of the JAX package across into the port.

Each function reads its argument by attribute, as plain Python values and
numpy arrays (``np.asarray`` of every array field), so this module does not
import ``idto_tpu`` or ``jax``.  The tests use it to feed both packages
identical inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from idto_tpu_torch.contact.force import ContactParams
from idto_tpu_torch.models.model import CollisionGeoms, Model
from idto_tpu_torch.optimizer.problem import (
    ConvergenceTolerances,
    GradientsMethod,
    LinearSolverType,
    LinesearchMethod,
    ProblemDefinition,
    ScalingMethod,
    SolverMethod,
    SolverParameters,
)

_MODEL_STATIC = (
    "joint_types", "joint_parents", "q_starts", "v_starts", "nq", "nv", "nu",
    "joint_names", "link_names", "actuator_joints", "levels", "type_groups",
)
_MODEL_ARRAYS = (
    "R_pj", "p_pj", "axis", "damping", "mass", "com", "inertia", "B",
    "gravity", "grav_scale",
)
_PROBLEM_ARRAYS = ("q_init", "v_init", "q_nom", "v_nom", "Qq", "Qv", "R",
                   "Qf_q", "Qf_v")
_TOLERANCES = tuple(ConvergenceTolerances.__dataclass_fields__)
_CONTACT = tuple(ContactParams.__dataclass_fields__)


def tensor(x, dtype=torch.float64, device="cuda"):
    """Array-like -> tensor (float arrays take ``dtype``)."""
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a.astype(np.float64), dtype=dtype, device=device)
    return torch.as_tensor(a, device=device)


def model(m, dtype=torch.float64, device="cuda") -> Model:
    g = m.geoms
    if getattr(g, "verts", None) is not None:
        raise NotImplementedError("CONVEX geometry is not ported yet")
    geoms = CollisionGeoms(
        types=tuple(g.types), bodies=tuple(g.bodies), pairs=tuple(g.pairs),
        names=tuple(g.names),
        R=tensor(g.R, dtype, device), p=tensor(g.p, dtype, device),
        params=tensor(g.params, dtype, device),
    )
    return Model(
        geoms=geoms,
        **{k: getattr(m, k) for k in _MODEL_STATIC},
        **{k: tensor(getattr(m, k), dtype, device) for k in _MODEL_ARRAYS},
    )


def problem(p, dtype=torch.float64, device="cuda") -> ProblemDefinition:
    return ProblemDefinition(
        num_steps=int(p.num_steps), dt=float(p.dt),
        **{k: tensor(getattr(p, k), dtype, device) for k in _PROBLEM_ARRAYS},
    )


def solver_params(s) -> SolverParameters:
    """Enums map by value; the JAX-only switches (``cr_use_pallas``,
    ``record_iteration_times``, ``debug_compare_against_dense``) have no
    counterpart and are dropped."""
    return SolverParameters(
        method=SolverMethod(s.method.value),
        linesearch_method=LinesearchMethod(s.linesearch_method.value),
        max_iterations=int(s.max_iterations),
        max_linesearch_iterations=int(s.max_linesearch_iterations),
        linear_solver=LinearSolverType(s.linear_solver.value),
        gradients_method=GradientsMethod(s.gradients_method.value),
        normalize_quaternions=bool(s.normalize_quaternions),
        exact_hessian=bool(s.exact_hessian),
        scaling=bool(s.scaling),
        scaling_method=ScalingMethod(s.scaling_method.value),
        equality_constraints=bool(s.equality_constraints),
        Delta0=float(s.Delta0),
        Delta_max=float(s.Delta_max),
        check_convergence=bool(s.check_convergence),
        tolerances=ConvergenceTolerances(
            **{k: float(getattr(s.tolerances, k)) for k in _TOLERANCES}
        ),
        contact=ContactParams(
            **{k: float(getattr(s.contact, k)) for k in _CONTACT}
        ),
        verbose=bool(s.verbose),
    )
