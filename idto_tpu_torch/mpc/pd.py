"""PD-plus tracking controller (counterpart of ``idto_tpu/mpc/pd.py``):

    u = feed_forward * u_nom + B_q^T (Kp (q_nom - q)) + B^T (Kd (v_nom - v))

The per-dof YAML gains Kp (length nq) and Kd (length nv) are projected onto
the actuated coordinates.  States lead with the scenario axis B.
"""
from __future__ import annotations

import numpy as np

from idto_tpu_torch.models.model import Model
from idto_tpu_torch.utils.consts import const


def actuation_q_matrix(model: Model) -> np.ndarray:
    """B_q (nq, nu): selects the actuated q coordinates (each actuator
    drives a single-dof joint)."""
    Bq = np.zeros((model.nq, model.nu))
    for a, j in enumerate(model.actuator_joints):
        Bq[model.q_starts[j], a] = 1.0
    return Bq


def pd_plus_control(
    model: Model, Kp, Kd, q_nom, v_nom, u_nom, q, v, feed_forward: bool = True
):
    """u (B, nu) from states (B, nq) / (B, nv) and gains (nq,) / (nv,)."""
    Bq = const(actuation_q_matrix(model), q.device, q.dtype)
    u = (Kp * (q_nom - q)) @ Bq + (Kd * (v_nom - v)) @ model.B.to(q.dtype)
    if feed_forward:
        u = u + u_nom
    return u
