"""The comparison that decides ``correct``.

After the window has closed, the peak memory has been read and the
program's graphs are freed, a sample of the operations the run produced
(drawn from the seed; the first one of the chain, the first and the last
of the window always among them) is worked out again by the plain
reference (``reference/``) from the state each started from, and each
output is judged:

* ``step_gap``: |q_prog - q_ref| / max(|q_ref - q_in|, |q_prog - q_in|,
  1e-9 |q_in|), the worst over the sample.  A step the program did not
  take, or took where the reference rejected it, reads about 1; where both
  rejected it the floor keeps two roundings of one warm start from
  reading as a step.
* ``step_gap_cond`` (batch): each sampled scenario's ``step_gap`` over
  cond(H) u, the condition number of the reference's scaled Hessian at the
  call's start times float64's unit roundoff (2^-53): how far rounding
  alone can move a step there, since a float64 solve of that system is
  correct to about that much.  A scenario the perturbation puts on a stiff
  contact can reach cond(H) 4e14 (the others 4e9 to 6e9), where two float64
  implementations of one iteration (the reference on the CPU and on the
  card, the port on the CPU and on the card) part by 2e-3 to 1e-2 of the
  step; there a ``step_gap`` limit set from well-conditioned scenarios would
  judge rounding, while a step the program did not take still reads
  1 / (cond(H) u), over 20.
* ``cost_gap`` (batch): |L_prog - L_ref| / |L_ref| of the cost at each
  call's start, the physics (inverse dynamics and contact) alone.
* ``control_gap`` (replan): |u_prog - u_ref| / |u_ref| of the first
  control the host read.
* ``radius_gap`` (replan): |Delta_prog - Delta_ref| / Delta_ref of the
  trust radius the replan hands to the next one, the dogleg's acceptance
  as the radius update sees it.  The update scales the radius by 1/4, 1 or
  2, so a radius scaled wrongly, or left unchanged where the reference
  scales it, reads 1/2 or more.

The reference follows a chain from the program's own state: a batch call
starts from the q the previous call returned (the first call from the
seed's inputs, worked out by the reference alone), a replan from the
previous plan's knots and trust radius (the first from ``mpc_initialize``'s
plan).  The measured state, the time and the disturbance are the
benchmark's own inputs; the warm start, the shifted nominal, the problem
and the iteration are the reference's.
"""
from __future__ import annotations

import torch

from yardstick import traffic as tr


def _gap(a, b, scale):
    num = torch.linalg.vector_norm((a - b).flatten(1), dim=1)
    den = torch.clamp_min(scale, torch.finfo(a.dtype).tiny)
    return torch.where(num == 0, torch.zeros_like(num), num / den)


def _step_gap(q_prog, q_ref, q_in):
    def norm(x):
        return torch.linalg.vector_norm(x.flatten(1), dim=1)

    return _gap(q_prog, q_ref, torch.maximum(
        torch.maximum(norm(q_ref - q_in), norm(q_prog - q_in)),
        1e-9 * norm(q_in)))


# Sampled operations (a batch's scenarios of its calls) the reference
# works out at a time.
CHUNK = 16


def _chunks(items, size=CHUNK):
    for i in range(0, len(items), size):
        yield items[i:i + size]


def check_batch(drv, ref, cell, seed):
    """Readings of a ``batch`` run: {name: worst gap}."""
    t = cell.traffic
    n = len(drv.history)
    calls = tr.sample(seed, n, int(t["check_calls"]), (0, drv.warm, n - 1))
    rows = tr.sample(seed + 1, drv.batch, int(t["check_scenarios"]),
                     (0, drv.batch - 1))
    base = ref.base
    dq = tr.perturbation(seed, drv.batch, ref.model.nq, float(t["std"]))
    picks = [(c, r) for c in calls for r in rows]
    worst = {"step_gap_cond": 0.0, "cost_gap": 0.0}
    unit = torch.finfo(torch.float64).eps / 2
    for chunk in _chunks(picks):
        rs = [r for _, r in chunk]
        q_in = ref.tensor(torch.stack([
            torch.as_tensor(base["q_guess"] + dq[r][None]).to(ref.device)
            if c == 0 else drv.history[c - 1][0][r].to(ref.device)
            for c, r in chunk]))
        q_prog = ref.tensor(torch.stack([drv.history[c][0][r]
                                         for c, r in chunk]))
        cost_prog = ref.tensor(torch.stack([drv.history[c][1][r]
                                            for c, r in chunk]))
        cond = []
        it = ref.iterate(
            q_in, base["q_init"][None] + dq[rs],
            base["v_init"][None].repeat(len(rs), 0),
            base["q_nom"][None].repeat(len(rs), 0),
            torch.full((len(rs),), float(ref.solver["Delta0"]),
                       dtype=torch.float64), cond)
        step = _step_gap(q_prog, it.q, q_in) / (cond[0].double() * unit)
        cost = _gap(cost_prog[:, None], it.cost[:, None], it.cost.abs())
        worst["step_gap_cond"] = max(worst["step_gap_cond"],
                                     float(step.max()))
        worst["cost_gap"] = max(worst["cost_gap"], float(cost.max()))
    return worst


def check_replan(drv, ref, cell, seed):
    """Readings of a ``replan`` run: {name: worst gap}."""
    t = cell.traffic
    n = len(drv.history)
    # The chain's first replan, and a sample of the window's with its first
    # and its last.
    w = n - drv.warm
    picks = [0] + [drv.warm + i for i in tr.sample(
        seed, w, int(t["check_replans"]), (0, w - 1))]
    nq = ref.model.nq
    worst = {"step_gap": 0.0, "control_gap": 0.0, "radius_gap": 0.0}
    for chunk in _chunks(picks):
        prev_q, prev_t, Delta, x0, t_now, q_prog, u_prog, D_prog = (
            [] for _ in range(8))
        for k in chunk:
            if k == 0:
                pq, pt, pD = drv.sol0.q, 0.0, drv.carry0.Delta
            else:
                h = drv.history[k - 1]
                pq, pt, pD = h[3].q, float(h[1]), h[2].Delta
            x, tk, carry, sol, u = drv.history[k]
            prev_q.append(pq)
            prev_t.append(torch.full((pq.shape[0],), pt, dtype=torch.float64))
            Delta.append(pD)
            x0.append(x)
            t_now.append(torch.full((pq.shape[0],), float(tk),
                                    dtype=torch.float64))
            q_prog.append(sol.q)
            u_prog.append(u)
            D_prog.append(carry.Delta)

        def cat(xs):
            return ref.tensor(torch.cat([torch.as_tensor(x).to(
                ref.device) for x in xs]))

        x0 = cat(x0)
        q0, v0 = x0[:, :nq], x0[:, nq:]
        guess = ref.warm_guess(cat(prev_q), cat(t_now) - cat(prev_t), q0)
        it = ref.iterate(guess, q0, v0, ref.shifted_nominal(q0), cat(Delta))
        step = _step_gap(cat(q_prog), it.q, guess)
        u_ref = ref.control(it.tau)
        control = _gap(cat(u_prog), u_ref,
                       torch.linalg.vector_norm(u_ref, dim=1))
        radius = _gap(cat(D_prog)[:, None], it.Delta[:, None], it.Delta)
        worst["step_gap"] = max(worst["step_gap"], float(step.max()))
        worst["control_gap"] = max(worst["control_gap"],
                                   float(control.max()))
        worst["radius_gap"] = max(worst["radius_gap"], float(radius.max()))
    return worst


CHECKS = {"replan": check_replan, "batch": check_batch}


def readings(drv, cell, seed, device, dtype=torch.float64):
    """The run's compared numbers, from the reference in ``dtype``."""
    from reference import Reference

    ref = Reference(cell.config, device, dtype)
    return CHECKS[drv.kind](drv, ref, cell, seed)


def judge(values: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}}; every reading has a limit."""
    return {name: {"value": values[name], "limit": float(limits[name])}
            for name in values}
