"""The plain reference's problem data and the MPC controller's warm start:
the YAML's nominal, guess and weights worked out again from the
configuration file, the natural cubic spline through a plan's knots, and
the nominal shifted to the measured state."""
from __future__ import annotations

import numpy as np
import torch

from reference.solver import Batch


def _lerp(a, b, T):
    s = np.linspace(0.0, 1.0, T + 1)[:, None]
    return (1 - s) * np.asarray(a)[None] + s * np.asarray(b)[None]


def base_problem(m, config):
    """(q_init, v_init, q_nom, v_nom, q_guess, weights) as float64 numpy,
    from the configuration's copy of the YAML."""
    P = config["problem"]
    T, dt = int(P["num_steps"]), float(P["time_step"])
    q_init = np.asarray(P["q_init"], dtype=np.float64)
    v_init = np.asarray(P["v_init"], dtype=np.float64)
    rel = np.asarray(P.get("q_nom_relative_to_q_init", [False] * m.nq),
                     dtype=bool)
    q_nom = _lerp(np.asarray(P["q_nom_start"]) + rel * q_init,
                  np.asarray(P["q_nom_end"]) + rel * q_init, T)
    if m.nq == m.nv:
        v_nom = np.zeros((T + 1, m.nv))
        v_nom[0] = v_init
        v_nom[1:] = (q_nom[1:] - q_nom[:-1]) / dt
    else:
        v_nom = np.tile(v_init, (T + 1, 1))
    q_guess = _lerp(q_init, P.get("q_guess", P["q_init"]), T)
    for s in m.floating_q_starts:
        q_nom[:, s:s + 4] /= np.linalg.norm(q_nom[:, s:s + 4], axis=-1,
                                            keepdims=True)
        q_init[s:s + 4] /= np.linalg.norm(q_init[s:s + 4])
    weights = {k: np.asarray(P[k], dtype=np.float64)
               for k in ("Qq", "Qv", "R", "Qfq", "Qfv")}
    return dict(q_init=q_init, v_init=v_init, q_nom=q_nom, v_nom=v_nom,
                q_guess=q_guess, rel=rel, weights=weights, T=T, dt=dt)


def batch(base, q_init, v_init, q_nom, device, dtype) -> Batch:
    def t(x):
        return torch.as_tensor(x, device=device).to(dtype)

    return Batch(q_init=t(q_init), v_init=t(v_init), q_nom=t(q_nom),
                 v_nom=t(base["v_nom"]),
                 **{k: t(v) for k, v in base["weights"].items()},
                 dt=base["dt"], T=base["T"])


def spline_values(y, dt, t):
    """The natural cubic splines through knots y (S, n, d), dt apart,
    at local times t (S, P); outside the knots the end segment's cubic
    extrapolates.  (S, P, d)."""
    S, n, d = y.shape
    A = (4.0 * torch.eye(n - 2, dtype=y.dtype, device=y.device)
         + torch.diag(torch.ones(n - 3, dtype=y.dtype, device=y.device), 1)
         + torch.diag(torch.ones(n - 3, dtype=y.dtype, device=y.device), -1))
    rhs = 6.0 * (y[:, 2:] - 2.0 * y[:, 1:-1] + y[:, :-2]) / dt ** 2
    M = torch.linalg.solve(A, rhs)
    M = torch.cat([torch.zeros_like(y[:, :1]), M, torch.zeros_like(y[:, :1])],
                  dim=1)
    i = torch.clamp(torch.floor(t / dt).long(), 0, n - 2)
    tau = (t - i.to(y.dtype) * dt)[..., None]
    take = torch.arange(S, device=y.device)[:, None]
    y0, y1, M0, M1 = y[take, i], y[take, i + 1], M[take, i], M[take, i + 1]
    a = (M1 - M0) / (6.0 * dt)
    b = M0 / 2.0
    c = (y1 - y0) / dt - dt * (2.0 * M0 + M1) / 6.0
    return y0 + tau * (c + tau * (b + tau * a))


def warm_guess(prev_q, elapsed, q0, dt):
    """The previous plan resampled ``elapsed`` (S,) later at the knots'
    spacing, its first knot replaced by the measured q0 (S, nq)."""
    T1 = prev_q.shape[1]
    t = elapsed[:, None] + dt * torch.arange(T1, dtype=prev_q.dtype,
                                             device=prev_q.device)
    q = spline_values(prev_q, dt, t)
    return torch.cat([q0[:, None], q[:, 1:]], dim=1)


def shifted_nominal(base, q0, device, dtype):
    """The nominal moved so that its relative DoFs start at q0 (S, nq):
    each replan's shift keeps the nominal's own offsets, so replan k's is
    the first nominal moved by q0_k - q_nom[0]."""
    q_nom = torch.as_tensor(base["q_nom"], device=device).to(dtype)
    sel = torch.as_tensor(base["rel"].astype(np.float64),
                          device=device).to(dtype)
    return q_nom[None] + sel * (q0[:, None] - q_nom[None, :1])
