"""Solver statistics and cost-landscape CSV files (counterpart of
``idto_tpu/optimizer/stats_io.py``): the same headers, columns and number
format as the JAX package's files.

The functions take one problem: an unbatched Stats (as ``solver.solve``
returns it) and q of shape (T+1, nq).  The cost sweeps evaluate every
point of the grid as one batch of trajectories.
"""
from __future__ import annotations

import numpy as np
import torch

from idto_tpu_torch.optimizer import itimer, trajectory


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def attach_iteration_times(stats):
    """``stats`` with ``time`` filled from the iteration timer of the last
    solve (``SolverParameters.record_iteration_times``; the solve fills it
    already, so this only repeats it)."""
    return itimer.attach(stats)


def save_stats_csv(stats, path: str) -> None:
    """Per-iteration statistics: iter, time, cost, ls_iters, alpha, delta,
    q_norm, dq_norm, dqH_norm, trust_ratio, grad_norm, dL_dq, h_norm,
    merit."""
    iters = int(_np(stats.num_iters))
    cols = [
        ("iter", np.arange(iters)),
        ("time", _np(stats.time)[:iters]),
        ("cost", _np(stats.cost)[:iters]),
        ("ls_iters", _np(stats.ls_iters)[:iters]),
        ("alpha", _np(stats.alpha)[:iters]),
        ("delta", _np(stats.delta)[:iters]),
        ("q_norm", _np(stats.q_norm)[:iters]),
        ("dq_norm", _np(stats.dq_norm)[:iters]),
        ("dqH_norm", _np(stats.dqH_norm)[:iters]),
        ("trust_ratio", _np(stats.rho)[:iters]),
        ("grad_norm", _np(stats.grad_norm)[:iters]),
        ("dL_dq", _np(stats.dL_dq)[:iters]),
        ("h_norm", _np(stats.h_norm)[:iters]),
        ("merit", _np(stats.merit)[:iters]),
    ]
    header = ",".join(name for name, _ in cols)
    data = np.stack(
        [np.asarray(col, dtype=np.float64) for _, col in cols], axis=1
    )
    np.savetxt(path, data, delimiter=",", header=header, comments="")


def save_contour_csv(model, prob, params, q, path: str,
                     i1=(1, 0), i2=(2, 0), rng=0.5, n=50) -> None:
    """2-D cost landscape over two decision variables, i1 and i2 as
    (timestep, dof) pairs, +-rng around their current values.  Columns:
    q1, q2, L."""
    t1, d1 = i1
    t2, d2 = i2
    c1 = float(q[t1, d1])
    c2 = float(q[t2, d2])
    g1 = np.linspace(c1 - rng, c1 + rng, n)
    g2 = np.linspace(c2 - rng, c2 + rng, n)
    A, B = np.meshgrid(g1, g2, indexing="ij")
    qs = q[None].repeat(n * n, 1, 1)
    qs[:, t1, d1] = torch.as_tensor(A.ravel(), dtype=q.dtype, device=q.device)
    qs[:, t2, d2] = torch.as_tensor(B.ravel(), dtype=q.dtype, device=q.device)
    L = _np(trajectory.cost(model, prob, params.contact, qs))
    data = np.stack([A.ravel(), B.ravel(), L], axis=1)
    np.savetxt(path, data, delimiter=",", header="q1,q2,L", comments="")


def save_lineplot_csv(model, prob, params, q, direction, path: str,
                      lo=-0.2, hi=1.2, n=100) -> None:
    """1-D cost sweep L(q + alpha * direction).  Columns: alpha, L."""
    alphas = np.linspace(lo, hi, n)
    a = torch.as_tensor(alphas, dtype=q.dtype, device=q.device)
    qs = q[None] + a[:, None, None] * direction[None]
    L = _np(trajectory.cost(model, prob, params.contact, qs))
    data = np.stack([alphas, L], axis=1)
    np.savetxt(path, data, delimiter=",", header="alpha,L", comments="")
