"""The general traffic generator and the two loops it feeds.

A traffic mix is a JSON file of parameters (``traffic/<name>.json``); its
``kind`` picks the loop that feeds the program:

* ``replan``: one caller, as on a robot.  Set-up runs ``mpc_initialize``,
  ``warm_replans`` replans and then replans for ``settle_s`` seconds, so
  that the window starts once the replans run at their steady rate; then
  back-to-back ``mpc_step`` calls, each one controller period after the
  last.  Replan k's measured state is the
  previous plan's state one period later (linear between its knots, the
  floating bases' quaternions renormalized) with a seeded ``std`` N(0, 1)
  disturbance on v.  A replan ends when the host holds the new plan's
  first control (``tau_0`` mapped through the actuation matrix, copied to
  the host).
* ``batch``: ``batch`` scenarios whose q_init and guess move by a seeded
  ``std`` N(0, 1) (``bench_torch.py``'s perturbation); chained
  ``solve_batch`` calls of ``max_iterations`` iterations with no
  convergence test, each guessing the previous call's q.  Set-up makes
  ``warm_calls`` calls, one at a time; the fastest of them after the
  first (which captures) sets how many calls stay in flight: as many as
  take ``queue_s`` seconds, so that the card stays fed while the host
  stands still.

Every input comes from ``--seed``: the same seed gives the same inputs.
Each loop keeps what its window produced (references to the program's
outputs, which the program hands out as fresh tensors), so that the check
can follow any sampled operation from the state it started from.
"""
from __future__ import annotations

import math
import time
import types

import numpy as np
import torch


class Kicks:
    """The replans' velocity disturbances in order: each a (batch, nv)
    float64 ``std`` N(0, 1), drawn on ``device`` by a generator seeded
    once from the seed."""

    def __init__(self, seed: int, batch: int, nv: int, std: float, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.shape, self.std, self.device = (batch, nv), std, device

    def next(self):
        return self.std * torch.randn(self.shape, generator=self.gen,
                                      dtype=torch.float64,
                                      device=self.device)


def perturbation(seed: int, batch: int, nq: int, std: float):
    """(batch, nq) float64: ``std`` N(0, 1) from ``default_rng(seed)``."""
    return std * np.random.default_rng(seed).standard_normal((batch, nq))


def sample(seed: int, n: int, k: int, always=()) -> list:
    """Sorted indices of ``k`` of ``range(n)`` drawn from the seed (a
    stream apart from the inputs'), the indices in ``always`` among them."""
    keep = sorted({i for i in always if 0 <= i < n})
    rest = [i for i in range(n) if i not in keep]
    rng = np.random.default_rng([seed, 7])
    extra = rng.choice(len(rest), size=min(max(k - len(keep), 0),
                                           len(rest)), replace=False)
    return sorted(keep + [rest[i] for i in extra])


def measured_state(q, v, period, dt, quat_starts, noise):
    """The plan's state ``period`` after its first knot, linear between
    knots, each quaternion renormalized, with ``noise`` added to v:
    (B, nq + nv)."""
    f = period / dt
    i = int(math.floor(f + 1e-9))
    w = f - i
    if w < 1e-9:
        qs, vs = q[:, i], v[:, i]
    else:
        qs = (1.0 - w) * q[:, i] + w * q[:, i + 1]
        vs = (1.0 - w) * v[:, i] + w * v[:, i + 1]
    for s in quat_starts:
        quat = qs[:, s:s + 4]
        qs = torch.cat([qs[:, :s],
                        quat / torch.linalg.vector_norm(quat, dim=-1,
                                                        keepdim=True),
                        qs[:, s + 4:]], dim=-1)
    return torch.cat([qs, vs + noise], dim=-1)


class ReplanLoop:
    """The ``replan`` mix: set-up in the constructor, one replan a
    ``step``; ``history`` holds every replan's (x0, t, carry, solution,
    control)."""

    kind = "replan"

    def __init__(self, prog, config, traffic, seed, device):
        self.prog = prog
        self.loaded = prog.load(config, device)
        model, prob = self.loaded.model, self.loaded.prob
        solver = config["solver"]
        self.batch = int(traffic["batch"])
        self.period = 1.0 / float(solver["controller_frequency"])
        self.dt = float(config["problem"]["time_step"])
        self.quat_starts = config["measured_state"]["quaternion_q_starts"]
        self.kicks = Kicks(seed, self.batch, model.nv, float(traffic["std"]),
                           device)
        self._cuda = torch.device(device).type == "cuda"
        self.rel = prog.relative_mask(self.loaded)
        self.probs = prog.broadcast_problem(prob, self.batch)
        self.mpc_params = prog.mpc_params(self.loaded.params,
                                          int(solver["mpc_iters"]))
        q_guesses = self.loaded.q_guess[None].expand(
            self.batch, -1, -1).contiguous()
        self.carry0, self.sol0 = prog.mpc_initialize(
            model, self.probs, self.loaded.params, q_guesses)
        self.history = []
        self.latencies = []
        self.solves_per_op = self.batch * int(solver["mpc_iters"])
        for _ in range(int(traffic["warm_replans"])):
            self.step()
        settle_end = time.perf_counter() + float(traffic["settle_s"])
        while time.perf_counter() < settle_end:
            self.step()
        self.drain()
        self.warm = len(self.history)
        self.latencies.clear()

    def step(self):
        k = len(self.history)
        start = torch.cuda.Event(enable_timing=True) if self._cuda else None
        if start is not None:
            start.record()
        prev_carry, prev_sol = (self.history[-1][2:4] if self.history
                                else (self.carry0, self.sol0))
        x0 = measured_state(prev_sol.q, prev_sol.v, self.period, self.dt,
                            self.quat_starts, self.kicks.next())
        # A number: the controller fills it in on the device (no host copy,
        # and a 0-d tensor of its own, so the regions' keys do not change).
        t_now = (k + 1) * self.period
        carry, sol = self.prog.mpc_step(
            self.loaded.model, self.probs, self.mpc_params, self.rel,
            prev_carry, x0, t_now)
        control = (sol.tau[:, 0] @ self.loaded.model.B).cpu()
        if start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.latencies.append((start, end))
        self.history.append((x0, t_now, carry, sol, control))

    def drain(self):
        if self._cuda:
            torch.cuda.synchronize()

    def latency_seconds(self):
        """Each window replan's latency by CUDA events, in seconds."""
        return [1e-3 * a.elapsed_time(b) for a, b in self.latencies]

    def outputs_finite(self):
        """(replans checked, replans with a non-finite plan or control)."""
        window = self.history[self.warm:]
        bad = sum(1 for h in window
                  if not (bool(torch.isfinite(h[3].q).all())
                          and bool(torch.isfinite(h[4]).all())))
        return len(window), bad

    def release(self):
        """Drop the program's state but what the check reads."""
        self.carry0 = types.SimpleNamespace(Delta=self.carry0.Delta)
        self.sol0 = types.SimpleNamespace(q=self.sol0.q)
        self.history = [
            (x0, t, types.SimpleNamespace(Delta=c.Delta),
             types.SimpleNamespace(q=s.q), u)
            for x0, t, c, s, u in self.history]
        self.probs = self.mpc_params = self.loaded = None


class BatchLoop:
    """The ``batch`` mix: set-up in the constructor, one chained call a
    ``step``; ``history`` holds every call's (q, cost at its start)."""

    kind = "batch"

    def __init__(self, prog, config, traffic, seed, device):
        self.prog = prog
        self.loaded = prog.load(config, device)
        prob, q_guess = self.loaded.prob, self.loaded.q_guess
        self.batch = int(traffic["batch"])
        self.depth = 1
        self.params = self.loaded.params.replace(
            max_iterations=int(traffic["max_iterations"]),
            check_convergence=False)
        dq = torch.as_tensor(
            perturbation(seed, self.batch, q_guess.shape[-1],
                         float(traffic["std"])),
            dtype=q_guess.dtype, device=q_guess.device)
        probs = prog.broadcast_problem(prob, self.batch)
        self.probs = probs.replace(q_init=probs.q_init + dq)
        self.q0 = q_guess[None] + dq[:, None]
        self.solves_per_op = self.batch * int(traffic["max_iterations"])
        self.history = []
        self._events = []
        call_s = []
        for _ in range(int(traffic["warm_calls"])):
            t = time.perf_counter()
            self.step()
            self.drain()
            call_s.append(time.perf_counter() - t)
        self.depth = max(1, round(float(traffic["queue_s"])
                                  / min(call_s[1:] or call_s)))
        self.warm = len(self.history)

    @property
    def _cuda(self):
        return self.q0.is_cuda

    def step(self):
        q_in = self.history[-1][0] if self.history else self.q0
        sol, st, _ = self.prog.solve_batch(self.loaded.model, self.probs,
                                           self.params, q_in)
        self.history.append((sol.q, st.cost[:, 0]))
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record()
            self._events.append(ev)
            if len(self._events) > self.depth:
                self._events.pop(0).synchronize()

    def drain(self):
        if self._cuda:
            torch.cuda.synchronize()
        self._events.clear()

    def latency_seconds(self):
        return []

    def outputs_finite(self):
        """(solves checked, solves with a non-finite q or cost)."""
        bad = 0
        for q, cost in self.history[self.warm:]:
            ok = torch.isfinite(q).flatten(1).all(dim=1) & torch.isfinite(
                cost)
            bad += int((~ok).sum())
        return self.batch * (len(self.history) - self.warm), bad

    def release(self):
        """Drop the program's state; the check reads ``history`` alone."""
        self.loaded = self.probs = self.params = None


LOOPS = {"replan": ReplanLoop, "batch": BatchLoop}


def start(prog, config, traffic, seed, device):
    """The loop of the mix's ``kind``, set up from the seed."""
    return LOOPS[traffic["kind"]](prog, config, traffic, seed, device)
