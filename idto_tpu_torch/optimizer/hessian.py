"""Gradient and Gauss-Newton Hessian assembly from the inverse-dynamics
partials (counterpart of ``idto_tpu/optimizer/hessian.py``).

All inputs may carry leading scenario axes: partials (..., T, nv, nq),
nplus (..., T+1, nv, nq), q (..., T+1, nq), v (..., T+1, nv), tau
(..., T, nv); the problem's weights are (..., d) or shared (d,).

Structure of the lower bands (uppers by symmetry):
  C[t] = Qq' + dv_t/dq_t^T Qv' dv_t/dq_t
       + dtau_{t-1}/dq_t^T R' dtau_{t-1}/dq_t + dtau_t/dq_t^T R' dtau_t/dq_t
       + [t < T-1]  dtau_{t+1}/dq_t^T R' dtau_{t+1}/dq_t
                  + dv_{t+1}/dq_t^T Qv' dv_{t+1}/dq_t
       + [t == T-1] dv_T/dq_t^T Qf_v' dv_T/dq_t
  B[t+1] = H[t+1][t], A[t+2] = H[t+2][t]
with C[0] = I pinning q_0, B[1] = A[2] = 0, primed weights Qq' = 2 dt Qq
etc. (terminal weights unscaled by dt), and the Gauss-Newton velocity
partials dv_t/dq_t = N^+/dt, dv_t/dq_{t-1} = -N^+/dt.
"""
from __future__ import annotations

import torch

from idto_tpu_torch.models.model import Model
from idto_tpu_torch.ops.penta import PentaBands, make_symmetric_from_lower
from idto_tpu_torch.optimizer.partials import IdPartials
from idto_tpu_torch.optimizer.problem import ProblemDefinition


def _wquad(J1, w, J2):
    """J1^T diag(w) J2 per block: (..., n, j, i), (..., j), (..., n, j, k)
    -> (..., n, i, k)."""
    return J1.transpose(-1, -2) @ (w[..., None, :, None] * J2)


def _wvec(J, w, r):
    """J^T diag(w) r per block: (..., n, j, i), (..., j), (..., n, j)
    -> (..., n, i)."""
    return torch.einsum("...nji,...nj->...ni", J, w[..., None, :] * r)


def _t(x, lo, hi):
    """Time slice lo:hi of a (..., T, a, b) stack."""
    return x[..., lo:hi, :, :]


def _weights(prob: ProblemDefinition, dtype):
    dt = prob.dt
    return (
        2 * dt * prob.Qq.to(dtype), 2 * dt * prob.Qv.to(dtype),
        2 * dt * prob.R.to(dtype), 2 * prob.Qf_q.to(dtype),
        2 * prob.Qf_v.to(dtype),
    )


def gradient_from_partials(
    model: Model, prob: ProblemDefinition, partials: IdPartials, nplus, q, v,
    tau,
):
    """dL/dq from the partials, with the same Gauss-Newton treatment of
    the velocity map as the Hessian; the first block is zero (q_0 fixed)."""
    T = prob.num_steps
    Qq, Qv, R, Qf_q, Qf_v = _weights(prob, q.dtype)
    dv_dqt = nplus / prob.dt
    dm, dtt, dp = partials
    dq_err = q - prob.q_nom.to(q.dtype)
    dv_err = v - prob.v_nom.to(q.dtype)

    g_mid = (
        Qq[..., None, :] * dq_err[..., 1:T, :]
        + _wvec(_t(dv_dqt, 1, T), Qv, dv_err[..., 1:T, :])
        + _wvec(_t(dp, 0, T - 1), R, tau[..., 0 : T - 1, :])
        + _wvec(_t(dtt, 1, T), R, tau[..., 1:T, :])
    )
    if T > 1:
        extra = _wvec(-_t(dv_dqt, 2, T), Qv, dv_err[..., 2:T, :]) + _wvec(
            _t(dm, 2, T), R, tau[..., 2:T, :]
        )
        term_last = _wvec(-_t(dv_dqt, T, T + 1), Qf_v, dv_err[..., T : T + 1, :])
        g_mid = g_mid + torch.cat([extra, term_last], dim=-2)

    g_last = (
        Qf_q * dq_err[..., T, :]
        + _wvec(_t(dv_dqt, T, T + 1), Qf_v, dv_err[..., T : T + 1, :])[..., 0, :]
        + _wvec(_t(dp, T - 1, T), R, tau[..., T - 1 : T, :])[..., 0, :]
    )
    zero = torch.zeros_like(q[..., :1, :])
    return torch.cat([zero, g_mid, g_last[..., None, :]], dim=-2)


def gauss_newton_hessian(
    model: Model, prob: ProblemDefinition, partials: IdPartials, nplus
) -> PentaBands:
    T = prob.num_steps
    nq = model.nq
    dtype, device = nplus.dtype, nplus.device
    batch = nplus.shape[:-3]
    Qq, Qv, R, Qf_q, Qf_v = _weights(prob, dtype)
    dv_dqt = nplus / prob.dt
    dm, dtt, dp = partials

    # ---- diagonal band C ----
    C_mid = (
        torch.diag_embed(Qq)[..., None, :, :]
        + _wquad(_t(dv_dqt, 1, T), Qv, _t(dv_dqt, 1, T))
        + _wquad(_t(dp, 0, T - 1), R, _t(dp, 0, T - 1))
        + _wquad(_t(dtt, 1, T), R, _t(dtt, 1, T))
    )
    dv_next_dqt = -_t(dv_dqt, 2, T + 1)  # dv_{t+1}/dq_t, t = 1..T-1
    if T > 1:
        C_extra = _wquad(_t(dm, 2, T), R, _t(dm, 2, T)) + _wquad(
            _t(dv_next_dqt, 0, T - 2), Qv, _t(dv_next_dqt, 0, T - 2)
        )
        C_term = _wquad(
            _t(dv_next_dqt, T - 2, T - 1), Qf_v, _t(dv_next_dqt, T - 2, T - 1)
        )
        C_mid = C_mid + torch.cat([C_extra, C_term], dim=-3)
    C_last = (
        torch.diag_embed(Qf_q)
        + _wquad(_t(dv_dqt, T, T + 1), Qf_v, _t(dv_dqt, T, T + 1))[..., 0, :, :]
        + _wquad(_t(dp, T - 1, T), R, _t(dp, T - 1, T))[..., 0, :, :]
    )
    eye = torch.eye(nq, dtype=dtype, device=device).expand(batch + (1, nq, nq))
    C = torch.cat(
        [eye, C_mid, C_last.expand(batch + (nq, nq))[..., None, :, :]], dim=-3
    )

    # ---- sub-diagonal band B (B[t+1] = H[t+1][t], t = 1..T-1) ----
    B_mid = _wquad(_t(dp, 1, T), R, _t(dtt, 1, T))
    if T > 1:
        B_extra = _wquad(_t(dtt, 2, T), R, _t(dm, 2, T)) + _wquad(
            _t(dv_dqt, 2, T), Qv, -_t(dv_dqt, 2, T)
        )
        B_term = _wquad(_t(dv_dqt, T, T + 1), Qf_v, -_t(dv_dqt, T, T + 1))
        B_mid = B_mid + torch.cat([B_extra, B_term], dim=-3)
    zeros2 = torch.zeros(batch + (2, nq, nq), dtype=dtype, device=device)
    B = torch.cat([zeros2, B_mid], dim=-3)

    # ---- sub-sub-diagonal band A (A[t+2] = H[t+2][t], t = 1..T-2) ----
    A_mid = _wquad(_t(dp, 2, T), R, _t(dm, 2, T))
    zeros3 = torch.zeros(batch + (3, nq, nq), dtype=dtype, device=device)
    A = torch.cat([zeros3, A_mid], dim=-3)
    return make_symmetric_from_lower(A, B, C)
