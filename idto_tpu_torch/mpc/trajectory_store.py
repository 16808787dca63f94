"""Stored trajectories with natural cubic spline interpolation (counterpart
of ``idto_tpu/mpc/trajectory_store.py``).

The MPC solution is kept as natural cubic splines of q, v and u through
uniformly spaced knots: knot second derivatives come from the standard
tridiagonal system with natural boundary conditions, and evaluation outside
the knot range extrapolates with the boundary segment's polynomial.  Every
tensor leads with the scenario axis B (one spline per robot); ``value``
takes a vector of times.
"""
from __future__ import annotations

from typing import Any

import torch

from idto_tpu_torch.utils import linalg
from idto_tpu_torch.utils.structs import tensor_dataclass

# LU factors of the (n-2) x (n-2) matrix tridiag(1, 4, 1), which depends on
# the knot count alone: factored once per (n, dtype, device).  A factor made
# inside a CUDA graph capture would hold no values until a replay, so the
# warm-up run before each capture (``utils/graphs.py``) fills this cache,
# and a miss while capturing raises.
_SYSTEMS: dict = {}


def _natural_system(n, dtype, device):
    key = (n, dtype, str(device))
    if key not in _SYSTEMS:
        if (torch.device(device).type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(f"spline system {key} first made inside a "
                               "CUDA graph capture")
        A = (
            4.0 * torch.eye(n - 2, dtype=dtype, device=device)
            + torch.diag(torch.ones(n - 3, dtype=dtype, device=device), 1)
            + torch.diag(torch.ones(n - 3, dtype=dtype, device=device), -1)
        )
        _SYSTEMS[key] = linalg.lu_factor(A)
    return _SYSTEMS[key]


def _natural_cubic_m(y, dt):
    """Second derivatives M (B, n, d) of the natural cubic splines through
    uniformly spaced knots y (B, n, d): M[0] = M[n-1] = 0 and
    M[i-1] + 4 M[i] + M[i+1] = 6 (y[i+1] - 2 y[i] + y[i-1]) / dt^2."""
    n = y.shape[1]
    if n < 3:
        return torch.zeros_like(y)
    rhs = 6.0 * (y[:, 2:] - 2.0 * y[:, 1:-1] + y[:, :-2]) / dt**2
    M_inner = linalg.lu_solve(*_natural_system(n, y.dtype, y.device), rhs)
    zero = torch.zeros_like(y[:, :1])
    return torch.cat([zero, M_inner, zero], dim=1)


@tensor_dataclass
class CubicSpline:
    dt: float = 0.05
    y: Any = None  # (B, n, d) knot values
    M: Any = None  # (B, n, d) knot second derivatives

    @classmethod
    def fit(cls, y, dt: float) -> "CubicSpline":
        return cls(dt=dt, y=y, M=_natural_cubic_m(y, dt))

    def value(self, t):
        """Evaluate at times t (P,), counted from the spline's first knot:
        (B, P, d).  Outside the knot range the boundary segment's
        polynomial extrapolates."""
        n = self.y.shape[1]
        dt = self.dt
        i = torch.clamp(torch.floor(t / dt).to(torch.int64), 0, n - 2)
        tau = (t - i.to(self.y.dtype) * dt)[None, :, None]
        y0, y1 = self.y[:, i], self.y[:, i + 1]
        M0, M1 = self.M[:, i], self.M[:, i + 1]
        # Standard cubic-spline segment formula on [0, dt].
        a = (M1 - M0) / (6.0 * dt)
        b = M0 / 2.0
        c = (y1 - y0) / dt - dt * (2.0 * M0 + M1) / 6.0
        return y0 + tau * (c + tau * (b + tau * a))


@tensor_dataclass
class StoredTrajectory:
    """MPC solution splines (q, v, u) on the device with their start
    time."""

    start_time: Any = None  # scalar tensor
    q: CubicSpline = None
    v: CubicSpline = None
    u: CubicSpline = None

    @classmethod
    def from_solution(cls, model, solution, start_time, dt):
        """u knots are B^T tau with the last step repeated.  ``start_time``
        is a 0-d tensor on the solution's device (a number is copied there
        from the host)."""
        u_knots = torch.einsum("vu,btv->btu", model.B.to(solution.tau.dtype),
                               solution.tau)
        u_knots = torch.cat([u_knots, u_knots[:, -1:]], dim=1)
        return cls(
            start_time=torch.as_tensor(start_time, dtype=solution.q.dtype,
                                       device=solution.q.device),
            q=CubicSpline.fit(solution.q, dt),
            v=CubicSpline.fit(solution.v, dt),
            u=CubicSpline.fit(u_knots, dt),
        )

    def sample_state(self, t):
        local = t - self.start_time
        return self.q.value(local), self.v.value(local)

    def sample_control(self, t):
        return self.u.value(t - self.start_time)
