"""Problem definition and solver parameters (counterpart of
``idto_tpu/optimizer/problem.py``; field names kept).

Cost weights are diagonal vectors.  ``ProblemDefinition`` tensors may carry
a leading scenario axis (see ``parallel.batching.broadcast_problem``).
``cr_use_pallas`` keeps the JAX package's name and documented meaning; here
it picks among the cyclic-reduction routes of ``optimizer/solver.py``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import numpy as np

from idto_tpu_torch.contact.force import ContactParams
from idto_tpu_torch.utils.structs import tensor_dataclass


@tensor_dataclass
class ProblemDefinition:
    """Shapes: q_init (nq,), v_init (nv,), q_nom (T+1, nq), v_nom (T+1, nv),
    Qq/Qf_q (nq,), Qv/Qf_v/R (nv,), each optionally with a leading (B,)."""

    num_steps: int = 0
    dt: float = 0.05
    q_init: Any = None
    v_init: Any = None
    q_nom: Any = None
    v_nom: Any = None
    Qq: Any = None
    Qv: Any = None
    R: Any = None
    Qf_q: Any = None
    Qf_v: Any = None


class SolverMethod(enum.Enum):
    TRUST_REGION = "trust_region"
    LINESEARCH = "linesearch"


class LinesearchMethod(enum.Enum):
    ARMIJO = "armijo"
    BACKTRACKING = "backtracking"


class ScalingMethod(enum.Enum):
    SQRT = "sqrt"
    ADAPTIVE_SQRT = "adaptive_sqrt"
    DOUBLE_SQRT = "double_sqrt"
    ADAPTIVE_DOUBLE_SQRT = "adaptive_double_sqrt"


class GradientsMethod(enum.Enum):
    AUTODIFF = "autodiff"
    FORWARD_DIFFERENCES = "forward_differences"
    CENTRAL_DIFFERENCES = "central_differences"
    CENTRAL_DIFFERENCES4 = "central_differences4"


class LinearSolverType(enum.Enum):
    PENTA_LU = "pentadiagonal_lu"
    DENSE_LDLT = "dense_ldlt"
    CYCLIC_REDUCTION = "cyclic_reduction"


@dataclasses.dataclass(frozen=True)
class ConvergenceTolerances:
    rel_cost_reduction: float = 0.0
    abs_cost_reduction: float = 0.0
    rel_gradient_along_dq: float = 0.0
    abs_gradient_along_dq: float = 0.0
    rel_state_change: float = 0.0
    abs_state_change: float = 0.0


@dataclasses.dataclass(frozen=True)
class SolverParameters:
    """Solver configuration; defaults match the JAX package's."""

    method: SolverMethod = SolverMethod.TRUST_REGION
    linesearch_method: LinesearchMethod = LinesearchMethod.ARMIJO
    max_iterations: int = 100
    max_linesearch_iterations: int = 50
    linear_solver: LinearSolverType = LinearSolverType.PENTA_LU
    gradients_method: GradientsMethod = GradientsMethod.AUTODIFF
    normalize_quaternions: bool = False
    exact_hessian: bool = False
    scaling: bool = True
    scaling_method: ScalingMethod = ScalingMethod.DOUBLE_SQRT
    equality_constraints: bool = True
    Delta0: float = 1e-1
    Delta_max: float = 1e5
    check_convergence: bool = False
    tolerances: ConvergenceTolerances = dataclasses.field(
        default_factory=ConvergenceTolerances
    )
    contact: ContactParams = dataclasses.field(default_factory=ContactParams)
    verbose: bool = False
    # Re-solve every Newton step densely and print the relative difference
    # from the banded solve.  Debug only: densifies the Hessian each
    # iteration.
    debug_compare_against_dense: bool = False
    # Route of CYCLIC_REDUCTION.  None: the fused kernel (one launch per
    # solve, ops/cr_kernel.py).  False: level-wise cyclic reduction
    # (ops/cyclic_reduction.py), one factorization reused by every solve of
    # the iteration, no kernel.  True: the fused kernel up to 64 packed
    # super-rows, beyond that the hybrid: level-wise down to 64 rows, then
    # the kernel on the tail.
    cr_use_pallas: Optional[bool] = None
    # Time each iteration into Stats.time (optimizer/itimer.py): in a batch,
    # each scenario's row holds the batch iterations it ran.
    record_iteration_times: bool = False

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)


def linear_interp_nominal(
    q_start: np.ndarray, q_end: np.ndarray, num_steps: int
) -> np.ndarray:
    """Linear interpolation for nominal trajectories and initial guesses."""
    alphas = np.linspace(0.0, 1.0, num_steps + 1)[:, None]
    return (1 - alphas) * np.asarray(q_start)[None, :] + alphas * np.asarray(
        q_end
    )[None, :]
