"""Forward simulator: semi-implicit Euler over the port's own dynamics
(counterpart of ``idto_tpu/mpc/simulator.py``).

    v' = v + h FD(q, v, u)        (forward dynamics with contact)
    q' = q + h N(q) v'

``simulate_segment`` advances a fixed number of substeps under a stored
trajectory (PD-plus and feed-forward).  States lead with the scenario axis
B (B robots simulated together).  A substep reads nothing back to the host:
the loop over substeps is a Python loop of device work, and on CUDA
tensors the whole segment is one captured CUDA graph (``utils/graphs.py``),
replayed with ``t_start`` a 0-d device tensor.
"""
from __future__ import annotations

import torch

from idto_tpu_torch.contact.force import ContactParams
from idto_tpu_torch.models.model import Model
from idto_tpu_torch.mpc.pd import pd_plus_control
from idto_tpu_torch.mpc.trajectory_store import StoredTrajectory
from idto_tpu_torch.soa.contact import contact_wrenches
from idto_tpu_torch.soa.dynamics import forward_dynamics
from idto_tpu_torch.soa.kinematics import normalize_quaternions, v_to_qdot
from idto_tpu_torch.utils import graphs


def sim_step(model: Model, contact: ContactParams, h: float, q, v, u):
    """One step of size h: q (B, nq), v (B, nv), u (B, nu) -> (q', v')."""
    qs, vs = q.T, v.T  # instance axis trailing for the physics
    wrenches = contact_wrenches(model, qs, vs, contact)
    tau_applied = model.B.to(q.dtype) @ u.T
    a = forward_dynamics(model, qs, vs, tau_applied, wrenches)
    v_new = vs + h * a
    q_new = qs + h * v_to_qdot(model, qs, v_new)
    return normalize_quaternions(model, q_new.T), v_new.T


def simulate_segment(
    model: Model,
    contact: ContactParams,
    h: float,
    num_substeps: int,
    stored: StoredTrajectory,
    Kp,
    Kd,
    q0,
    v0,
    t_start,
    feed_forward: bool = True,
):
    """Advance (q0, v0) (B, nq) / (B, nv) by ``num_substeps`` steps of size
    h from time ``t_start`` (a 0-d tensor, or a number), tracking the
    stored trajectory with the PD-plus controller.  Returns (q, v, (q_log,
    v_log, u_log)) with logs (B, num_substeps, .): the state after each
    substep and the control that drove it."""
    if not isinstance(t_start, torch.Tensor):
        t_start = torch.full((), float(t_start), dtype=q0.dtype,
                             device=q0.device)

    def segment(stored, Kp, Kd, q, v, t_start):
        # The references of every substep in three spline evaluations.
        times = t_start + h * torch.arange(num_substeps, dtype=q.dtype,
                                           device=q.device)
        q_ref, v_ref = stored.sample_state(times)
        u_ff = stored.sample_control(times)
        q_log, v_log, u_log = [], [], []
        for i in range(num_substeps):
            u = pd_plus_control(model, Kp, Kd, q_ref[:, i], v_ref[:, i],
                                u_ff[:, i], q, v, feed_forward)
            q, v = sim_step(model, contact, h, q, v, u)
            q_log.append(q)
            v_log.append(v)
            u_log.append(u)
        return q, v, tuple(torch.stack(x, dim=1)
                           for x in (q_log, v_log, u_log))

    return graphs.run("sim.segment", segment,
                      (stored, Kp, Kd, q0, v0, t_start), model=model,
                      key=(contact, h, num_substeps, feed_forward))
