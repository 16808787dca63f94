"""Punyo's replans at T 4 through the port (``mpc/controller.py``:
``mpc_initialize``, then ``mpc_step``) and through the benchmark's plain
reference (``benchmark/reference/``: the controller's spline warm start
and nominal shift in ``mpc.py``, one dense trust-region iteration in
``solver.py``), float64 on the CPU.

Punyo is the one example whose pairs put a capsule against a box: the
point of the capsule's axis nearest the box has to carry its exact
derivative into the Gauss-Newton step (``soa/contact.py::capsule_vs_box``),
and the reference's ``_capsule_vs_box`` is the specification.  Each replan
starts from the port's previous plan, one controller period (1/15 s) on,
with a seeded 0.01 N(0, 1) kick on v, as the benchmark's ``replan``
traffic drives it; the reference works out the same replan from the same
plan.  Readings over the three replans: step gap 1.5e-9 to 2.5e-9,
control gap 1.4e-9 to 3.2e-8, the radius equal; with the point held fixed
under differentiation (the JAX package's search) 1.3e-3 to 1.1e-2 and
1.7e-3 to 4.1e-3.  The limits lie between, 40 and 30 times above the
first readings.
"""
import dataclasses

import numpy as np
import torch

from idto_tpu_torch.examples.config import (build_initial_guess,
                                            build_problem,
                                            build_solver_params)
from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.mpc import controller as mpc
from idto_tpu_torch.parallel.batching import broadcast_problem
from torch_bench import punyo_config

# One intra-op thread: several test workers share the cores.
torch.set_num_threads(1)

T = 4
INIT_ITERS = 3
REPLANS = 3
PERIOD = 1.0 / 15.0  # the YAML's controller_frequency
KICK = 0.01
STEP_GAP = 1e-7
CONTROL_GAP = 1e-6


def _measured_state(sol, dt, quat_start, kick):
    """The plan's state one period after its first knot, linear between
    knots, the ball's quaternion renormalized, plus the kick on v."""
    f = PERIOD / dt
    i = int(np.floor(f))
    w = f - i
    q = (1.0 - w) * sol.q[:, i] + w * sol.q[:, i + 1]
    v = (1.0 - w) * sol.v[:, i] + w * sol.v[:, i + 1]
    quat = q[:, quat_start:quat_start + 4]
    q = torch.cat([q[:, :quat_start], quat / quat.norm(dim=1, keepdim=True),
                   q[:, quat_start + 4:]], dim=1)
    return torch.cat([q, v + kick], dim=1)


def test_replans_match_the_plain_reference():
    from reference import Reference

    config = punyo_config()
    config["problem"]["num_steps"] = T
    ref = Reference(config, "cpu")
    model, cfg, _, _, _ = load_example("punyo", device="cpu")
    cfg = dataclasses.replace(cfg, num_steps=T, max_iters=INIT_ITERS)
    probs = broadcast_problem(build_problem(cfg, model, device="cpu"), 1)
    params = build_solver_params(cfg)
    carry, sol = mpc.mpc_initialize(
        model, probs, params, build_initial_guess(cfg, device="cpu")[None])
    mpc_params = mpc.make_mpc_params(params, 1)
    rel = np.zeros(model.nq, dtype=bool)
    assert cfg.q_nom_relative_to_q_init is None
    (quat_start,) = config["measured_state"]["quaternion_q_starts"]
    gen = torch.Generator().manual_seed(2**31 + 19)
    t_prev = 0.0
    for k in range(1, REPLANS + 1):
        t_now = k * PERIOD
        kick = KICK * torch.randn((1, model.nv), generator=gen,
                                  dtype=torch.float64)
        x0 = _measured_state(sol, cfg.time_step, quat_start, kick)
        new_carry, new_sol = mpc.mpc_step(
            model, probs, mpc_params, rel, carry, x0,
            torch.tensor(t_now, dtype=torch.float64))

        q0, v0 = x0[:, :model.nq], x0[:, model.nq:]
        guess = ref.warm_guess(sol.q, torch.tensor([t_now - t_prev]), q0)
        it = ref.iterate(guess, q0, v0, ref.shifted_nominal(q0), carry.Delta)
        step = (it.q - guess).norm()
        assert float(step) > 1e-3  # the replan moves the plan
        assert float((new_sol.q - it.q).norm() / step) < STEP_GAP, k
        u_ref = ref.control(it.tau)
        u = ref.control(new_sol.tau)
        assert float((u - u_ref).norm() / u_ref.norm()) < CONTROL_GAP, k
        assert torch.equal(new_carry.Delta, it.Delta), k
        carry, sol, t_prev = new_carry, new_sol, t_now
