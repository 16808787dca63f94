"""The linesearch solve and the horizon-sharded trust region of the
PyTorch/CUDA port (``idto_tpu_torch``) on one NVIDIA GPU, each replayed
from captured CUDA graphs (``utils/graphs.py``) against the same call made
eagerly (``graphs.eager()``).

Rows (float64, B=1):

* ``armijo``: mini_cheetah at its YAML size, Armijo, once for each search
  chunk in ``--chunks`` (``optimizer/linesearch.py::SEARCH_CHUNK``, set for
  the row; a chunk named again is measured again, in the order given);
* ``backtracking``: the hopper at its YAML size with its equality
  constraints, backtracking on the exact-l1 merit, at the module's chunk;
* ``horizon``: mini_cheetah at T=159 with cyclic reduction on an NCCL
  group of one (``chip_smoke.long_cheetah_inputs``), through an explicit
  ``HorizonSplit`` (the regions hold the collectives and the distributed
  cyclic reduction) and through ``solve_trust_region_horizon_sharded``
  (no split on an axis of one: the kernel's route).

For each: ms an iteration, the difference of a 3-iteration and a
1-iteration call over 2, each the median of ``--reps`` calls after the
first (which captures); the eager route's the same way from one call each;
the seconds of the captures; peak GiB of each route; the host calls an
iteration from ``torch.profiler`` (kernel launches, graph launches, async
copies, synchronizations), likewise a difference of two calls; and the
largest difference between the routes' results (0.0: bitwise).

Usage: python3 scripts/bench_torch_linesearch.py [--out PATH.json]
           [--only armijo,backtracking,horizon] [--chunks 1,2,4,8,16]
           [--reps N]

Prints one line a row and, last, one JSON object with every row, the
card's name and its power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import torch

import chip_smoke
from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.ops import cr_kernel
from idto_tpu_torch.optimizer import linesearch
from idto_tpu_torch.optimizer.problem import LinesearchMethod, SolverMethod
from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch
from idto_tpu_torch.utils import graphs

ITERS = (1, 3)


def synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def measure(tag, call_at, reps):
    """``call_at(K)`` makes a call of K iterations.  Returns the row."""
    row = {}
    eager, eager_out = {}, {}
    graphs.reset()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for K in ITERS:
        with graphs.eager():
            eager[K], eager_out[K] = synced(call_at(K))
    row["eager_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    first, ms, calls, diffs = {}, {}, {}, {}
    for K in ITERS:
        seconds = sum(graphs.capture_seconds.values())
        first[K], got = synced(call_at(K))
        row[f"capture_s_iters{K}"] = (sum(graphs.capture_seconds.values())
                                      - seconds)
        diffs.update({f"iters{K} {k}": v for k, v in chip_smoke.route_diff(
            got, eager_out[K]).items()})
        del got
        times = []
        for _ in range(reps):
            t, got = synced(call_at(K))
            times.append(t)
        diffs.update({f"iters{K} {k}": max(v, diffs[f"iters{K} {k}"])
                      for k, v in chip_smoke.route_diff(
                          got, eager_out[K]).items()})
        del got
        ms[K] = statistics.median(times)
        cr_kernel.launches = 0
        calls[K] = chip_smoke.host_calls(call_at(K))
        calls[K]["kernel_launches"] = cr_kernel.launches
    row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    row["graphs"] = graphs.captures
    lo, hi = ITERS
    span = hi - lo
    row.update(
        iteration_ms=(ms[hi] - ms[lo]) / span,
        eager_iteration_ms=(eager[hi] - eager[lo]) / span,
        call_ms={K: ms[K] for K in ITERS},
        eager_call_ms={K: eager[K] for K in ITERS},
        first_call_ms={K: first[K] for K in ITERS},
        host_calls={K: calls[K] for K in ITERS},
        host_calls_a_iteration={k: (calls[hi][k] - calls[lo][k]) / span
                                for k in calls[hi]},
        max_rel_diff=max(diffs.values()),
        nonzero_diff={k: v for k, v in diffs.items() if v},
    )
    out = eager_out[hi]
    stats = out[1]
    if hasattr(stats, "ls_iters"):
        row["ls_iters"] = stats.ls_iters.cpu().tolist()
    del eager_out, out
    graphs.reset()
    torch.cuda.empty_cache()
    print(f"{tag}: an iteration {row['iteration_ms']:.1f} ms captured, "
          f"{row['eager_iteration_ms']:.1f} ms eager; captures "
          f"{row['capture_s_iters1']:.2f} + {row['capture_s_iters3']:.2f} s "
          f"({row['graphs']} graphs); peak {row['peak_gib']:.3f} GiB "
          f"(eager {row['eager_peak_gib']:.3f}); host calls an iteration "
          f"{row['host_calls_a_iteration']}; max rel diff "
          f"{row['max_rel_diff']:.3e}", flush=True)
    return row


def linesearch_call(name, method):
    model, _, prob, params, q_guess = load_example(
        name, dtype=torch.float64, device="cuda")
    probs = broadcast_problem(prob, 1)
    p = params.replace(method=SolverMethod.LINESEARCH,
                       linesearch_method=LinesearchMethod(method))

    def call_at(K):
        pk = p.replace(max_iterations=K)
        return lambda: solve_batch(model, probs, pk, q_guess[None])
    return call_at


def horizon_rows(reps):
    from idto_tpu_torch.optimizer.batched import solve_trust_region_batched
    from idto_tpu_torch.parallel import horizon, multihost
    from idto_tpu_torch.parallel.batching import make_mesh

    model, prob, params, qg = chip_smoke.long_cheetah_inputs("cuda", 1)
    mesh = make_mesh(axis="horizon", device="cuda")
    rows = {}
    try:
        split = horizon.HorizonSplit(multihost.axis_group(mesh, "horizon"),
                                     prob.num_steps)

        def split_at(K):
            pk = params.replace(max_iterations=K)
            return lambda: solve_trust_region_batched(
                model, broadcast_problem(prob, 1), pk, qg[None],
                horizon=split)

        def entry_at(K):
            pk = params.replace(max_iterations=K)
            return lambda: horizon.solve_trust_region_horizon_sharded(
                model, prob, pk, qg, mesh)

        rows["horizon_split_ws1"] = measure(
            f"horizon-sharded cheetah T={prob.num_steps}, an explicit split "
            "on NCCL at world size 1", split_at, reps)
        rows["horizon_entry_ws1"] = measure(
            f"solve_trust_region_horizon_sharded cheetah T={prob.num_steps} "
            "at world size 1 (no split: the kernel)", entry_at, reps)
    finally:
        graphs.reset()  # the graphs hold the group's collectives
        torch.distributed.destroy_process_group()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="BENCH_TORCH_LINESEARCH.json")
    ap.add_argument("--only", default="armijo,backtracking,horizon")
    ap.add_argument("--chunks", default="1,2,4,8,16")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    chip_smoke.phase_build()
    only = args.only.split(",")
    rows = {}
    shipped = linesearch.SEARCH_CHUNK
    if "armijo" in only:
        call_at = linesearch_call("mini_cheetah", "armijo")
        for chunk in (int(c) for c in args.chunks.split(",")):
            linesearch.SEARCH_CHUNK = chunk
            key = f"armijo_cheetah_chunk{chunk}"
            n = sum(k == key or k.startswith(key + "_run")
                    for k in rows)  # a chunk run again
            rows[key + (f"_run{n + 1}" if n else "")] = measure(
                f"Armijo cheetah B=1, search chunk {chunk}", call_at,
                args.reps)
        linesearch.SEARCH_CHUNK = shipped
    if "backtracking" in only:
        rows[f"backtracking_hopper_chunk{shipped}"] = measure(
            f"backtracking hopper B=1, search chunk {shipped}",
            linesearch_call("hopper", "backtracking"), args.reps)
    if "horizon" in only:
        rows.update(horizon_rows(args.reps))
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "search_chunk": shipped,
              "rows": rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1, default=str)
    print(json.dumps(result, default=str), flush=True)


if __name__ == "__main__":
    main()
