#!/usr/bin/env python3
"""Readings that set a cell's correctness limits; the benchmark's own runs
never run this.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
                                 --seconds <s> --mode <mode> [--device cuda]

Each seed is one run of the cell through the harness (set-up, a window of
``--seconds``, the check against the float64 reference), all in one
process, with the timed operation served by:

* ``program``: the port, as in a benchmark run (the lower readings);
* ``control``: the plain reference computed in float32, the nearest
  precision below the configuration's float64 (the upper readings);
* ``unchanged``: the port, but each operation hands back the state it was
  given (a step that returns its state unchanged);
* ``half``: the port on the first half of the batch only, the rest handed
  back unchanged (half of the batch left out);
* ``altered``: the port, with one number of each answer moved where it is
  produced (one knot of one scenario's plan, by 1e-3);
* ``radius``: the port, but each replan hands on the trust radius it was
  given (a radius update left out).

One JSON line a seed: the mode, the seed and the readings with their
limits.  The cells run on one card, so no fault of an exchange between
cards applies.
"""
import argparse
import dataclasses
import json
import os
import sys
import time
import types

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path.insert(1, ROOT)

import torch  # noqa: E402

from yardstick import manifest, program, runner  # noqa: E402


def _ns(**kw):
    return types.SimpleNamespace(**kw)


class _Adapter:
    """The program adapter with ``mpc_step`` and ``solve_batch`` replaced;
    everything else (set-up, inputs, counters) is the port's."""

    def __init__(self, base=program):
        for name in dir(base):
            if not name.startswith("_") and not hasattr(type(self), name):
                setattr(self, name, getattr(base, name))
        self._base = base


class ReferenceProgram(_Adapter):
    """The reference in ``dtype`` in the program's place."""

    def __init__(self, config, dtype=torch.float32, base=program):
        super().__init__(base)
        self.config, self.dtype, self.ref = config, dtype, None

    def _reference(self, device):
        from reference import Reference

        if self.ref is None:
            self.ref = Reference(self.config, device, self.dtype)
        return self.ref

    def solve_batch(self, model, probs, params, q_guesses):
        ref = self._reference(q_guesses.device)
        it = ref.iterate(q_guesses, probs.q_init, probs.v_init,
                         probs.q_nom.expand(q_guesses.shape), torch.full(
                             (q_guesses.shape[0],), params.Delta0))
        return (_ns(q=it.q.double()), _ns(cost=it.cost.double()[:, None]),
                None)

    def mpc_step(self, model, probs, params, rel, carry, x0, t_now):
        from reference import solver as rsolver

        ref = self._reference(x0.device)
        nq = ref.model.nq
        q0, v0 = ref.tensor(x0[:, :nq]), ref.tensor(x0[:, nq:])
        prev = carry.stored
        elapsed = torch.full((x0.shape[0],),
                             float(t_now) - float(prev.start_time))
        guess = ref.warm_guess(prev.q.y, elapsed, q0)
        q_nom = ref.shifted_nominal(q0)
        it = ref.iterate(guess, q0, v0, q_nom, carry.Delta)
        from reference import mpc as rmpc

        P = rmpc.batch(ref.base, q0, v0, q_nom, ref.device, ref.dtype)
        v = rsolver.velocities(ref.model, P, it.q)
        new = _ns(Delta=it.Delta.double(), stored=_ns(
            q=_ns(y=it.q.double()), start_time=t_now))
        return new, _ns(q=it.q.double(), v=v.double(), tau=it.tau.double())


class FaultyProgram(_Adapter):
    """The port with one fault planted in its timed operation."""

    def __init__(self, fault, base=program):
        super().__init__(base)
        self.fault = fault

    def solve_batch(self, model, probs, params, q_guesses):
        if self.fault == "half":
            from idto_tpu_torch.parallel.batching import map_scenarios

            h = q_guesses.shape[0] // 2
            sub = map_scenarios(lambda x: x[:h], probs)
            sol, st, w = self._base.solve_batch(model, sub, params,
                                                q_guesses[:h])
            q = torch.cat([sol.q, q_guesses[h:]])
            cost = torch.cat([st.cost, st.cost[:1].expand(
                q_guesses.shape[0] - h, -1)])
            return _ns(q=q), _ns(cost=cost), w
        sol, st, w = self._base.solve_batch(model, probs, params, q_guesses)
        if self.fault == "unchanged":
            return _ns(q=q_guesses.clone()), st, w
        if self.fault == "altered":
            q = sol.q.clone()
            q[0, -1, -1] += 1e-3
            return _ns(q=q), st, w
        raise ValueError(f"no fault {self.fault!r} for a batch")

    def mpc_step(self, model, probs, params, rel, carry, x0, t_now):
        new, sol = self._base.mpc_step(model, probs, params, rel, carry, x0,
                                       t_now)
        if self.fault == "unchanged":
            return carry, _ns(q=carry.stored.q.y, v=carry.stored.v.y,
                              tau=sol.tau)
        if self.fault == "altered":
            q = sol.q.clone()
            q[0, -1, -1] += 1e-3
            return new, _ns(q=q, v=sol.v, tau=sol.tau)
        if self.fault == "radius":
            return dataclasses.replace(new, Delta=carry.Delta), sol
        raise ValueError(f"no fault {self.fault!r} for a replan")


def adapter(mode, cell, base=program):
    if mode == "program":
        return base
    if mode == "control":
        return ReferenceProgram(cell.config, torch.float32, base)
    return FaultyProgram(mode, base)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", default="program",
                    choices=("program", "control", "unchanged", "half",
                             "altered", "radius"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = manifest.Manifest(ROOT).cell(args.workload)
    if "settle_s" in cell.traffic:
        # The readings compare answers, not rates: no settling stretch.
        cell = dataclasses.replace(cell,
                                   traffic={**cell.traffic, "settle_s": 0})
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, _ = runner.run_cell(cell, seed, args.seconds, False,
                                    args.device, t0,
                                    prog=adapter(args.mode, cell))
        print(json.dumps({"mode": args.mode, "workload": args.workload,
                          "seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
