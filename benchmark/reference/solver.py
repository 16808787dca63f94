"""One Gauss-Newton trust-region iteration of the plain reference, dense.

For a trajectory q (T+1 knots, q_0 fixed):

    v_0 = v_init,  v_t = N^+(q_t) (q_t - q_{t-1}) / dt
    tau_t = ID(q_{t+1}, v_{t+1}, (v_{t+1} - v_t) / dt),   t = 0..T-1
    L = dt sum_{t<T} (|q_t - q_nom_t|^2_Qq + |v_t - v_nom_t|^2_Qv
                      + |tau_t|^2_R) + |q_T - q_nom_T|^2_Qfq
        + |v_T - v_nom_T|^2_Qfv

The residuals' Jacobian J is built dense: the identity for q, +-N^+/dt for
v (the Gauss-Newton treatment of the velocity map), and each step's exact
d tau_t / d(q_{t-1}, q_t, q_{t+1}) from one ``jacfwd`` over the triplet;
q_0's columns are zero.  g = J^T W r and H = J^T W J (W twice the
weights), with H's q_0 block the identity.  Then, as IDTO's solver: the
diagonal scaling D = min(1, diag(H)^-1/4); with equality constraints on
the unactuated forces h = tau[unactuated], multipliers from the Schur
complement and the merit L + h^T lambda; the Newton step by a dense LU
solve, kept where its residual is below 1e-6 of the gradient (0.25 in
float32), else the Cauchy step; the dogleg in the radius Delta; the trial
point, renormalized where the configuration says so; the ratio of actual
to predicted merit reduction; acceptance when it is positive; the radius
update.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.func import jacfwd, vmap

from reference import physics


@dataclasses.dataclass
class Batch:
    """Per-sample problem data (each leads with S) and shared weights."""

    q_init: torch.Tensor  # (S, nq)
    v_init: torch.Tensor  # (S, nv)
    q_nom: torch.Tensor  # (S, T+1, nq)
    v_nom: torch.Tensor  # (T+1, nv)
    Qq: torch.Tensor
    Qv: torch.Tensor
    R: torch.Tensor
    Qfq: torch.Tensor
    Qfv: torch.Tensor
    dt: float
    T: int


def _bsum(x):
    return x.flatten(1).sum(dim=1)


def velocities(m, P, q):
    """(S, T+1, nv)."""
    S, Tp1, nq = q.shape
    dq = ((q[:, 1:] - q[:, :-1]) / P.dt).reshape(-1, nq)
    N = vmap(lambda x: physics.nplus(m, x))(q[:, 1:].reshape(-1, nq))
    v = (N @ dq[:, :, None])[..., 0].reshape(S, Tp1 - 1, m.nv)
    return torch.cat([P.v_init[:, None], v], dim=1)


def forces(m, contact, P, q, v=None):
    """tau (S, T, nv)."""
    if v is None:
        v = velocities(m, P, q)
    S = q.shape[0]
    a = (v[:, 1:] - v[:, :-1]) / P.dt
    tau = vmap(lambda x, y, z: physics.inverse_dynamics(m, contact, x, y, z))(
        q[:, 1:].reshape(-1, m.nq), v[:, 1:].reshape(-1, m.nv),
        a.reshape(-1, m.nv))
    return tau.reshape(S, P.T, m.nv)


def cost(P, q, v, tau):
    dq = q - P.q_nom
    dv = v - P.v_nom
    run = (_bsum(dq[:, :-1] ** 2 * P.Qq) + _bsum(dv[:, :-1] ** 2 * P.Qv)
           + _bsum(tau ** 2 * P.R)) * P.dt
    return run + _bsum(dq[:, -1] ** 2 * P.Qfq) + _bsum(dv[:, -1] ** 2
                                                       * P.Qfv)


def partials(m, contact, P, q):
    """d tau_t / d q_{t-1}, d q_t, d q_{t+1}: (S, T, nv, nq) each; the
    first is zero at t = 0."""
    S, Tp1, nq = q.shape
    T, dt = P.T, P.dt
    qm = torch.cat([q[:, :1], q[:, :-2]], dim=1)  # q_{t-1}, q_0 at t = 0
    first = torch.zeros((S, T), dtype=torch.bool, device=q.device)
    first[:, 0] = True
    v0 = P.v_init[:, None].expand(S, T, m.nv)

    def tau_step(a, b, c, v_init, is_first):
        v_t = torch.where(is_first, v_init, physics.nplus(m, b) @ (b - a) / dt)
        v_p = physics.nplus(m, c) @ (c - b) / dt
        return physics.inverse_dynamics(m, contact, c, v_p, (v_p - v_t) / dt)

    d = vmap(jacfwd(tau_step, argnums=(0, 1, 2)))(
        qm.reshape(-1, nq), q[:, :-1].reshape(-1, nq),
        q[:, 1:].reshape(-1, nq), v0.reshape(-1, m.nv), first.reshape(-1))
    d = [x.reshape(S, T, m.nv, nq) for x in d]
    d[0] = torch.where(first[:, :, None, None], torch.zeros_like(d[0]), d[0])
    return d


def gauss_newton(m, contact, P, q, v, tau):
    """(g (S, n), H (S, n, n), J_tau (S, T nv, n)) with n = (T+1) nq."""
    S, Tp1, nq = q.shape
    T, nv, dt = P.T, m.nv, P.dt
    n = Tp1 * nq
    dm, dtt, dp = partials(m, contact, P, q)
    N = vmap(lambda x: physics.nplus(m, x))(q.reshape(-1, nq)).reshape(
        S, Tp1, nv, nq)
    kw = dict(dtype=q.dtype, device=q.device)
    Jq = torch.eye(n, **kw).expand(S, n, n)
    Jv = torch.zeros((S, T, nv, Tp1, nq), **kw)
    Jt = torch.zeros((S, T, nv, Tp1, nq), **kw)
    for t in range(T):
        Jv[:, t, :, t + 1] = N[:, t + 1] / dt
        Jv[:, t, :, t] = -N[:, t + 1] / dt
        if t > 0:
            Jt[:, t, :, t - 1] = dm[:, t]
        Jt[:, t, :, t] = dtt[:, t]
        Jt[:, t, :, t + 1] = dp[:, t]
    Jv = Jv.reshape(S, T * nv, n)
    Jt = Jt.reshape(S, T * nv, n)
    Jt[:, :, :nq] = 0.0  # q_0 is not a decision variable
    J = torch.cat([Jq, Jv, Jt], dim=1)
    J[:, :, :nq] = 0.0
    two = 2.0
    wq = torch.cat([(two * dt * P.Qq).expand(T, nq),
                    (two * P.Qfq)[None]], dim=0).reshape(-1)
    wv = torch.cat([(two * dt * P.Qv).expand(T - 1, nv),
                    (two * P.Qfv)[None]], dim=0).reshape(-1)
    wt = (two * dt * P.R).expand(T, nv).reshape(-1)
    w = torch.cat([wq, wv, wt])
    r = torch.cat([(q - P.q_nom).reshape(S, -1),
                   (v[:, 1:] - P.v_nom[1:]).reshape(S, -1),
                   tau.reshape(S, -1)], dim=1)
    g = (J.mT @ (w * r)[:, :, None])[..., 0]
    H = J.mT @ (w[None, :, None] * J)
    H[:, :nq, :] = 0.0
    H[:, :, :nq] = 0.0
    H[:, :nq, :nq] = torch.eye(nq, **kw)
    g[:, :nq] = 0.0
    return g, H, Jt


def normalize(m, q):
    for s in m.floating_q_starts:
        quat = q[..., s:s + 4]
        q = torch.cat([q[..., :s], quat / torch.linalg.vector_norm(
            quat, dim=-1, keepdim=True), q[..., s + 4:]], dim=-1)
    return q


@dataclasses.dataclass
class Iteration:
    q: torch.Tensor  # (S, T+1, nq) after the iteration
    cost: torch.Tensor  # (S,) at the start
    tau: torch.Tensor  # (S, T, nv) at q
    Delta: torch.Tensor  # (S,) after the iteration
    rho: torch.Tensor
    accepted: torch.Tensor


def iterate(m, solver, P, q, Delta, cond_out=None) -> Iteration:
    """One trust-region iteration from q (S, T+1, nq) with radius Delta
    (S,); ``solver`` is the configuration's solver values.  ``cond_out``,
    a list, receives the 2-norm condition number of each problem's scaled
    Hessian (S,): the factor by which rounding can move the step."""
    contact = {k: solver[k] for k in ("dissipation_velocity",
                                      "smoothing_factor",
                                      "friction_coefficient",
                                      "stiction_velocity")}
    contact["stiffness"] = solver["contact_stiffness"]
    dtype = q.dtype
    S, Tp1, nq = q.shape
    v = velocities(m, P, q)
    tau = forces(m, contact, P, q, v)
    L = cost(P, q, v, tau)
    g, H, Jt = gauss_newton(m, contact, P, q, v, tau)

    if solver["scaling"]:
        D = torch.clamp_max(1.0 / torch.sqrt(torch.sqrt(torch.clamp_min(
            torch.diagonal(H, dim1=1, dim2=2), 1e-30))), 1.0)
    else:
        D = torch.ones_like(g)
    Hs = D[:, :, None] * H * D[:, None, :]
    gs = D * g
    if cond_out is not None:
        ev = torch.linalg.eigvalsh(Hs).abs()
        cond_out.append(ev.amax(dim=1) / ev.amin(dim=1))
    un = m.unactuated
    if solver["equality_constraints"] and un:
        rows = torch.tensor([t * m.nv + i for t in range(P.T) for i in un],
                            device=q.device)
        h = tau[:, :, un].reshape(S, -1)
        Js = Jt[:, rows] * D[:, None, :]
        X = torch.linalg.solve(Hs, torch.cat([gs[:, :, None], Js.mT], dim=2))
        Hg, HJ = X[:, :, 0], X[:, :, 1:]
        lam = torch.linalg.solve(Js @ HJ, (h - (Js @ Hg[:, :, None])[..., 0])
                                 [:, :, None])[..., 0]
        gm = gs + (Js.mT @ lam[:, :, None])[..., 0]
        merit = L + _bsum(h * lam)
    else:
        lam = None
        gm = gs
        merit = L
    p_newton = -torch.linalg.solve(Hs, gm[:, :, None])[..., 0]
    Hgm = (Hs @ gm[:, :, None])[..., 0]
    gg, gHg = _bsum(gm * gm), _bsum(gm * Hgm)
    p_cauchy = -(gg / torch.clamp_min(gHg, 1e-300))[:, None] * gm
    res = (Hs @ p_newton[:, :, None])[..., 0] + gm
    rtol = 0.25 if dtype == torch.float32 else 1e-6
    ok = torch.isfinite(p_newton).all(dim=1) & (
        torch.sqrt(_bsum(res * res)) / torch.sqrt(torch.clamp_min(
            gg, torch.finfo(dtype).tiny)) < rtol)
    p_newton = torch.where(ok[:, None], p_newton, p_cauchy)
    fact_ok = torch.isfinite(p_newton).all(dim=1)

    # Dogleg, in units of the radius.
    Dl = Delta[:, None]
    pU, pH = p_cauchy / Dl, p_newton / Dl
    nU, nH = torch.sqrt(_bsum(pU * pU)), torch.sqrt(_bsum(pH * pH))
    diff = pH - pU
    a2, b2, c2 = _bsum(diff * diff), 2.0 * _bsum(pU * diff), _bsum(pU * pU) - 1
    a_safe = torch.clamp_min(a2, 1e-300)
    disc = torch.clamp_min((b2 / a_safe) ** 2 - 4.0 * (c2 / a_safe), 0.0)
    s_quad = (-(b2 / a_safe) + torch.sqrt(disc)) / 2.0
    s_lin = -c2 / torch.where(b2 == 0, torch.ones_like(b2), b2)
    s = torch.where(a2 < torch.finfo(dtype).eps, s_lin, s_quad)
    leg1 = nU >= 1.0
    inside = nH <= 1.0
    step = torch.where(
        leg1[:, None], (Delta / torch.clamp_min(nU, 1e-300))[:, None] * pU,
        torch.where(inside[:, None], pH * Dl, (pU + s[:, None] * diff) * Dl))
    boundary = leg1 | ~inside

    q_try = q + (D * step).reshape(S, Tp1, nq)
    if solver["normalize_quaternions"]:
        q_try = normalize(m, q_try)
    v_try = velocities(m, P, q_try)
    tau_try = forces(m, contact, P, q_try, v_try)
    merit_try = cost(P, q_try, v_try, tau_try)
    if lam is not None:
        merit_try = merit_try + _bsum(tau_try[:, :, un].reshape(S, -1) * lam)
    predicted = -_bsum(gm * step) - 0.5 * _bsum(
        step * (Hs @ step[:, :, None])[..., 0])
    actual = merit - merit_try
    guard = 10 * torch.finfo(dtype).eps / P.dt / P.dt
    rho = torch.where((predicted < guard) & (actual < guard),
                      torch.full_like(actual, 0.5), actual / predicted)
    rho = torch.where(torch.isfinite(rho), rho, torch.full_like(rho, -1.0))
    accept = (rho > 0.0) & fact_ok
    Delta_new = torch.where(
        rho < 0.25, 0.25 * Delta,
        torch.where((rho > 0.75) & boundary,
                    torch.clamp_max(2.0 * Delta, solver["Delta_max"]),
                    Delta))
    Delta_new = torch.where(fact_ok, Delta_new, Delta)
    return Iteration(
        q=torch.where(accept[:, None, None], q_try, q), cost=L,
        tau=torch.where(accept[:, None, None], tau_try, tau),
        Delta=Delta_new, rho=rho, accepted=accept)
