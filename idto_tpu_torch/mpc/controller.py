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
(``parallel.batching.broadcast_problem``).

On CUDA tensors a step is a chain of captured CUDA graphs
(``utils/graphs.py``): steps 1-2, the solve's start, its iterations and
its closing forces, and step 4, each replayed with the carry kept on the
device.  ``t_now`` is a 0-d device tensor (a number becomes one by a fill
on the device, never a host copy), so a new time costs no capture; with
``mpc_iters: 1`` under the Thomas solver the host reads nothing inside a
step, as the JAX package's jitted step.  ``mpc.runner.run_mpc`` closes
the loop around it with ``mpc.simulator``.  ``mpc_step_velocity_command``
replans from a commanded body velocity instead of a fixed nominal (the
joystick-driven cheetah; ``examples/velocity_command.py``).
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
    quat_to_rot,
    rot_to_quat,
    rpy_to_rot,
)
from idto_tpu_torch.mpc.trajectory_store import StoredTrajectory
from idto_tpu_torch.optimizer.batched import solve_trust_region_batched
from idto_tpu_torch.optimizer.problem import (
    ProblemDefinition,
    SolverParameters,
)
from idto_tpu_torch.optimizer.solver import Solution
from idto_tpu_torch.utils import graphs
from idto_tpu_torch.utils.consts import const
from idto_tpu_torch.utils.profiler import instrument
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


def _as_time(t, like):
    """``t`` as a 0-d tensor of like's dtype and device; a number is filled
    in on the device (no host copy, no synchronization)."""
    if isinstance(t, torch.Tensor):
        return t.to(dtype=like.dtype, device=like.device)
    return torch.full((), float(t), dtype=like.dtype, device=like.device)


def _store(model, dt, sol, Delta, q_nom, t_now) -> MpcCarry:
    """The carry of a solve: its splines stamped with ``t_now``."""
    def fn(sol, Delta, q_nom, t_now):
        return MpcCarry(
            stored=StoredTrajectory.from_solution(model, sol, t_now, dt),
            Delta=Delta, q_nom=q_nom)

    return graphs.run("mpc.store", fn, (sol, Delta, q_nom, t_now),
                      model=model, key=(dt,))


def mpc_initialize(
    model: Model,
    prob: ProblemDefinition,
    params: SolverParameters,
    q_guess,
) -> tuple[MpcCarry, Solution]:
    """Initial full solve that seeds the warm start; q_guess (B, T+1, nq)."""
    sol, _, warm = solve_trust_region_batched(model, prob, params, q_guess)
    carry = _store(model, prob.dt, sol, warm.Delta, prob.q_nom,
                   _as_time(0.0, q_guess))
    return carry, sol


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


def velocity_command_nominal(model: Model, prob: ProblemDefinition, q0,
                             command):
    """Velocity-command (joystick) nominal trajectories of a floating-base
    robot: the commanded body-frame (vx, vy) and yaw rate wz integrated from
    each current base pose.  q0 (B, nq); command (B, 3) or (3,), a tensor,
    so a new command costs no host read.  Returns (q_nom (B, T+1, nq),
    v_nom (B, T+1, nv)); the other DoFs keep prob's nominal.

    Velocity layout: the commanded linear velocity goes to v[base+3:base+5]
    and the yaw rate to v[base+2] (world angular z), as in the JAX package;
    the reference's python demo writes indices 4 and 3 of v, one slot high
    for both, against the floating joint's [w(3), v(3)] layout."""
    floats = [
        j for j in range(model.num_joints)
        if JointType(model.joint_types[j]) == JointType.FLOATING
    ]
    if not floats:
        raise ValueError("velocity_command_nominal needs a floating base")
    j = floats[0]
    qs, vs = model.q_starts[j], model.v_starts[j]
    T = prob.num_steps
    B = q0.shape[0]
    dtype, device = q0.dtype, q0.device
    cmd = torch.as_tensor(command, dtype=dtype, device=device).expand(B, 3)
    vx, vy, wz = cmd[:, 0], cmd[:, 1], cmd[:, 2]

    quat0 = normalize_quat(q0[:, qs : qs + 4].T)  # (4, B)
    R = quat_to_rot(quat0)  # (3, 3, B)
    v_world = R[:, 0] * vx + R[:, 1] * vy  # (3, B): R [vx, vy, 0]
    yaw0 = torch.atan2(R[1, 0], R[0, 0])

    ts = torch.arange(T + 1, dtype=dtype, device=device) * prob.dt
    x_nom = q0[:, qs + 4, None] + v_world[0][:, None] * ts
    y_nom = q0[:, qs + 5, None] + v_world[1][:, None] * ts
    yaw = yaw0[:, None] + wz[:, None] * ts  # (B, T+1)
    zero = torch.zeros_like(yaw)
    quats = rot_to_quat(rpy_to_rot(torch.stack([zero, zero, yaw])))
    # Shortest path relative to the current attitude.
    sign = torch.where(
        torch.einsum("ibt,ib->bt", quats, quat0) < 0, -1.0, 1.0)
    quats = (quats * sign).permute(1, 2, 0)  # (B, T+1, 4)

    q_nom = prob.q_nom.to(dtype).expand(B, T + 1, model.nq)
    q_nom = torch.cat([q_nom[..., :qs], quats, x_nom[..., None],
                       y_nom[..., None], q_nom[..., qs + 6 :]], dim=-1)
    v_nom = prob.v_nom.to(dtype).expand(B, T + 1, model.nv)
    cols = torch.stack([wz[:, None].expand(B, T + 1),
                        v_world[0][:, None].expand(B, T + 1),
                        v_world[1][:, None].expand(B, T + 1)], dim=-1)
    v_nom = torch.cat([v_nom[..., : vs + 2], cols, v_nom[..., vs + 5 :]],
                      dim=-1)
    return q_nom, v_nom


def _warm_guess(carry, q0, prob, t_now):
    """The stored spline resampled at shifted times, q_guess[0] = q0."""
    T = prob.num_steps
    times = t_now + torch.arange(T + 1, dtype=q0.dtype,
                                 device=q0.device) * prob.dt
    q_guess = carry.stored.sample_state(times)[0]
    return torch.cat([q0[:, None], q_guess[:, 1:]], dim=1)


def _replan(model, prob, mpc_params, carry, x0, t_now, nominal, key,
            extra=None):
    """One re-solve: ``nominal(prob, carry, q0, extra)`` gives the
    problem's new nominal fields; returns (the new carry, the solution)."""
    t_now = _as_time(t_now, x0)

    def start(prob, carry, x0, t_now, extra):
        nq = model.nq
        q0 = x0[:, :nq]
        # 1. Warm-start guess: resample the stored spline at shifted times.
        q_guess = _warm_guess(carry, q0, prob, t_now)
        # 2. The nominal trajectory of this replan.
        prob_now = prob.replace(q_init=q0, v_init=x0[:, nq:],
                                **nominal(prob, carry, q0, extra))
        return prob_now, q_guess, carry.Delta, t_now

    with instrument("mpc.step"):
        prob_now, q_guess, Delta, t_now = graphs.run(
            "mpc.replan_start", start, (prob, carry, x0, t_now, extra),
            model=model, key=key, clone=False)
        # 3. Re-solve from the warm start with the carried trust radius.
        sol, _, warm = solve_trust_region_batched(
            model, prob_now, mpc_params, q_guess, Delta0=Delta
        )
        # 4. Store the solution spline.
        return _store(model, prob.dt, sol, warm.Delta, prob_now.q_nom,
                      t_now), sol


def mpc_step(
    model: Model,
    prob: ProblemDefinition,
    mpc_params: SolverParameters,
    q_nom_relative,  # (nq,) 0/1 mask, host data
    carry: MpcCarry,
    x0,  # (B, nq + nv) current state estimates
    t_now,  # 0-d tensor (or a number) on x0's device
) -> tuple[MpcCarry, Solution]:
    rel = tuple(bool(x) for x in np.asarray(q_nom_relative, dtype=bool))

    def nominal(prob, carry, q0, extra):
        # Shift the nominal trajectory for relative DoFs.
        return {"q_nom": shift_nominal(model, carry.q_nom, q0, rel)}

    return _replan(model, prob, mpc_params, carry, x0, t_now, nominal,
                   ("shift", rel))


def mpc_step_velocity_command(
    model: Model,
    prob: ProblemDefinition,
    mpc_params: SolverParameters,
    carry: MpcCarry,
    x0,  # (B, nq + nv) current state estimates
    t_now,  # 0-d tensor (or a number) on x0's device
    command,  # (B, 3) or (3,) commanded (vx, vy, wz), a tensor
) -> tuple[MpcCarry, Solution]:
    """``mpc_step`` with the nominal from a body-frame velocity command
    (``velocity_command_nominal``) in place of the shifted fixed nominal."""

    def nominal(prob, carry, q0, command):
        q_nom, v_nom = velocity_command_nominal(model, prob, q0, command)
        return {"q_nom": q_nom, "v_nom": v_nom}

    return _replan(model, prob, mpc_params, carry, x0, t_now, nominal,
                   ("velocity_command",),
                   torch.as_tensor(command, dtype=x0.dtype,
                                   device=x0.device))
