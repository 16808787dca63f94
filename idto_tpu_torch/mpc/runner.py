"""Closed-loop MPC harness (counterpart of ``idto_tpu/mpc/runner.py``).

An initial full solve seeds the warm start, then the loop alternates

    [solve at t_k]  ->  [simulate one replan period under the *previous*
                         trajectory]  ->  ...

The one-period lag models the solver's latency: the plan made at t_k is
only tracked from t_{k+1} on.  One robot is simulated (B = 1 on the port's
batch-leading tensors); the logs are host arrays.  Each replan's time goes
to the step and the simulator as a 0-d device tensor, so that on the card
both replay their captured graphs (the first of each captures them, and its
time stays out of the means, as the JAX runner leaves out its compile).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from idto_tpu_torch.models.model import Model
from idto_tpu_torch.mpc.controller import (
    make_mpc_params,
    mpc_initialize,
    mpc_step,
)
from idto_tpu_torch.mpc.simulator import simulate_segment
from idto_tpu_torch.parallel.batching import broadcast_problem


@dataclasses.dataclass
class MpcResult:
    num_solves: int
    mean_solve_time: float  # seconds a re-solve, the first left out
    mean_sim_time: float  # seconds a simulated replan period, likewise
    times: np.ndarray  # (S,) time after each simulator substep
    q_log: np.ndarray  # (S, nq)
    v_log: np.ndarray  # (S, nv)
    u_log: np.ndarray  # (S, nu)


def _sync(x):
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _mean_after_first(seconds):
    return float(np.mean(seconds[1:] if len(seconds) > 1 else seconds))


def run_mpc(
    model: Model,
    cfg,
    prob,
    params,
    q_guess,
    sim_model: Model | None = None,
    sim_contact=None,
    on_replan=None,
) -> MpcResult:
    """Closed-loop MPC of one robot on the device of ``prob``'s tensors.

    ``sim_model`` / ``sim_contact`` let the simulated plant differ from the
    one the optimizer plans with (``examples.registry.load_sim_plant``: a
    stiffer, less smoothed contact); both default to the optimizer's.  The
    sim model must share the optimizer model's state and actuation layout.

    ``on_replan(t_now, q_plan)`` is called after every re-solve with the
    planned knot trajectory (T+1, nq) as a host array.
    """
    sim_model = sim_model if sim_model is not None else model
    sim_contact = sim_contact if sim_contact is not None else params.contact
    if (sim_model.nq, sim_model.nv, sim_model.nu) != (
            model.nq, model.nv, model.nu):
        raise ValueError("the sim model must share the optimizer model's "
                         "state and actuation layout")
    replan_period = 1.0 / cfg.controller_frequency
    h = cfg.sim_time_step
    substeps = max(1, int(round(replan_period / h)))
    num_replans = int(cfg.sim_time * cfg.controller_frequency)

    dtype, device = prob.q_init.dtype, prob.q_init.device
    rel = np.asarray(
        cfg.q_nom_relative_to_q_init
        if cfg.q_nom_relative_to_q_init is not None
        else [False] * model.nq,
        dtype=np.float64,
    )
    Kp = torch.as_tensor(np.asarray(cfg.Kp, dtype=np.float64), dtype=dtype,
                         device=device)
    Kd = torch.as_tensor(np.asarray(cfg.Kd, dtype=np.float64), dtype=dtype,
                         device=device)
    mpc_params = make_mpc_params(params, cfg.mpc_iters)
    probs = broadcast_problem(prob, 1)

    # Initial full solve (seeds the warm start).
    carry, _ = mpc_initialize(model, probs, params, q_guess[None])

    q = prob.q_init[None]
    v = prob.v_init[None]
    logs, times, solve_times, sim_times = [], [], [], []
    for k in range(num_replans):
        t_now = torch.full((), k * replan_period, dtype=dtype, device=device)
        x0 = torch.cat([q, v], dim=1)

        _sync(x0)
        t0 = time.perf_counter()
        new_carry, sol = mpc_step(model, probs, mpc_params, rel, carry, x0,
                                  t_now)
        _sync(x0)
        solve_times.append(time.perf_counter() - t0)

        if on_replan is not None:
            on_replan(k * replan_period, sol.q[0].cpu().numpy())

        # Simulate under the PREVIOUS stored trajectory (one-period delay),
        # on the simulation plant.
        t0 = time.perf_counter()
        q, v, log = simulate_segment(
            sim_model, sim_contact, h, substeps, carry.stored, Kp, Kd, q, v,
            t_now, cfg.feed_forward,
        )
        _sync(x0)
        sim_times.append(time.perf_counter() - t0)
        carry = new_carry
        logs.append(log)
        times.append(k * replan_period + np.arange(1, substeps + 1) * h)

    def cat(i, width):
        if not logs:
            return np.zeros((0, width))
        return torch.cat([log[i][0] for log in logs]).cpu().numpy()

    return MpcResult(
        num_solves=num_replans,
        mean_solve_time=_mean_after_first(solve_times) if solve_times else 0.0,
        mean_sim_time=_mean_after_first(sim_times) if sim_times else 0.0,
        times=np.concatenate(times) if times else np.zeros(0),
        q_log=cat(0, model.nq),
        v_log=cat(1, model.nv),
        u_log=cat(2, model.nu),
    )
