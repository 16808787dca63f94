"""Model-predictive controller: warm-started re-solves on the device
(counterpart of ``idto_tpu/mpc/controller.py``).

One ``mpc_step`` call:

  1. resamples the previous solution spline at shifted times as the new
     initial guess, pinning q_guess[0] = q0,
  2. shifts the nominal trajectory for the DoFs marked
     ``q_nom_relative_to_q_init`` by (q0 - q_nom_old[0]),
  3. re-solves from the warm start with the carried trust-region radius,
  4. stores the new solution spline stamped with the current time.

The port has one solver, the batch-native one, so every tensor here leads
with a scenario axis B (B robots replanned together; B = 1 for one), and
``prob`` is a problem whose tensors lead with B
(``parallel.batching.broadcast_problem``).  The velocity-command step and
the closed-loop simulator are not ported yet.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from idto_tpu_torch.models.model import JointType, Model
from idto_tpu_torch.models.rotations import (
    normalize_quat,
    quat_conj,
    quat_mul,
)
from idto_tpu_torch.mpc.trajectory_store import StoredTrajectory
from idto_tpu_torch.optimizer.batched import solve_trust_region_batched
from idto_tpu_torch.optimizer.problem import (
    ProblemDefinition,
    SolverParameters,
)
from idto_tpu_torch.optimizer.solver import Solution
from idto_tpu_torch.utils.consts import const
from idto_tpu_torch.utils.structs import tensor_dataclass


@tensor_dataclass
class MpcCarry:
    """Everything persisted between re-solves: the stored trajectory, the
    trust radius and the shifted nominal."""

    stored: StoredTrajectory = None
    Delta: Any = None  # (B,)
    q_nom: Any = None  # (B, T+1, nq) current (possibly shifted) nominal


def make_mpc_params(params: SolverParameters, mpc_iters: int) -> SolverParameters:
    """Per-solve iteration cap for real-time replanning."""
    return params.replace(max_iterations=mpc_iters, check_convergence=False)


def mpc_initialize(
    model: Model,
    prob: ProblemDefinition,
    params: SolverParameters,
    q_guess,
) -> tuple[MpcCarry, Solution]:
    """Initial full solve that seeds the warm start; q_guess (B, T+1, nq)."""
    sol, _, warm = solve_trust_region_batched(model, prob, params, q_guess)
    stored = StoredTrajectory.from_solution(model, sol, 0.0, prob.dt)
    return MpcCarry(stored=stored, Delta=warm.Delta, q_nom=prob.q_nom), sol


def shift_nominal(model: Model, q_nom, q0, q_nom_relative):
    """Shift the nominal trajectories q_nom (B, T+1, nq) by (q0 - q_nom[0])
    on the DoFs selected by the ``q_nom_relative_to_q_init`` mask; q0 is
    (B, nq).

    When the mask selects any component of a floating base's quaternion, an
    additive shift would leave it non-unit and wrong; those four components
    are instead shifted by left composition with the relative rotation
    dq = q0_quat * conj(q_nom0_quat), the rotation carrying the old nominal
    base attitude onto the measured one, and kept in the hemisphere of the
    unshifted nominal (shortest path).  The mask is host data (numpy): the
    per-joint layout decision is made on the host."""
    mask_np = np.asarray(q_nom_relative, dtype=bool)
    sel = const(mask_np.astype(np.float64), q_nom.device, q_nom.dtype)
    out = q_nom + sel * (q0[:, None] - q_nom[:, :1])
    for j in range(model.num_joints):
        if JointType(model.joint_types[j]) != JointType.FLOATING:
            continue
        qs = model.q_starts[j]
        if not mask_np[qs : qs + 4].any():
            continue
        qn = q_nom[:, :, qs : qs + 4].permute(2, 0, 1)  # (4, B, T+1)
        dquat = quat_mul(
            normalize_quat(q0[:, qs : qs + 4].T),
            quat_conj(normalize_quat(qn[:, :, 0])),
        )
        rotated = normalize_quat(quat_mul(dquat[:, :, None], qn))
        sign = torch.where(torch.sum(rotated * qn, dim=0) < 0, -1.0, 1.0)
        out = torch.cat([
            out[..., :qs], (rotated * sign).permute(1, 2, 0),
            out[..., qs + 4 :],
        ], dim=-1)
    return out


def mpc_step(
    model: Model,
    prob: ProblemDefinition,
    mpc_params: SolverParameters,
    q_nom_relative,  # (nq,) 0/1 mask, host data
    carry: MpcCarry,
    x0,  # (B, nq + nv) current state estimates
    t_now: float,
) -> tuple[MpcCarry, Solution]:
    T = prob.num_steps
    nq = model.nq
    q0 = x0[:, :nq]
    v0 = x0[:, nq:]

    # 1. Warm-start guess: resample the stored spline at shifted times.
    times = t_now + torch.arange(T + 1, dtype=x0.dtype,
                                 device=x0.device) * prob.dt
    q_guess = carry.stored.sample_state(times)[0]
    q_guess = torch.cat([q0[:, None], q_guess[:, 1:]], dim=1)

    # 2. Shift the nominal trajectory for relative DoFs.
    q_nom_new = shift_nominal(model, carry.q_nom, q0, q_nom_relative)

    # 3. Re-solve from the warm start with the carried trust radius.
    prob_now = prob.replace(q_init=q0, v_init=v0, q_nom=q_nom_new)
    sol, _, warm = solve_trust_region_batched(
        model, prob_now, mpc_params, q_guess, Delta0=carry.Delta
    )

    # 4. Store the solution spline.
    stored = StoredTrajectory.from_solution(model, sol, t_now, prob.dt)
    return MpcCarry(stored=stored, Delta=warm.Delta, q_nom=q_nom_new), sol
