#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port (``idto_tpu_torch``): mini
cheetah (T=20, nq=19, nv=18) warm-started solves per second on one GPU,
batched over scenarios (counterpart of ``bench.py``).

    python3 bench_torch.py [--linear-solver {penta_lu,cyclic_reduction}]
                           [--dtype {float64,float32}] [--device {cuda,cpu}]
                           [--seed 0]

Each "solve" is one Gauss-Newton trust-region iteration (exact partials
through ``torch.func``, the banded Hessian, the penta-diagonal solve,
dogleg, trust-ratio rollout) from a warm start through
``parallel.batching.solve_batch``: the unit of work of the reference's
per-replan ``mpc_iters=1`` solve.  At batch 1, 256 and 4096 the solves are
chained (each call takes the previous call's q as its guess) with one wait
at the end, after one warm call: 50, 20 and 5 calls.  Batches above
``CHUNK`` are micro-batched from the host.  Then ``mpc_initialize``, one
warm ``mpc_step`` and 30 chained replans 0.016 s apart.

On the card every call replays captured CUDA graphs (``utils/graphs.py``,
the counterpart of the jitted calls ``bench.py`` times): each batch starts
from no graph, and its warm call captures them (its seconds are printed,
as the capture's, and stay out of the times, as ``bench.py``'s compile).
An earlier line gives the eager route's B=1 and B=256 calls and replans
(under ``graphs.eager()``; fewer calls: ``EAGER_CALLS``, ``EAGER_REPLANS``).

Times come from CUDA events and a synchronize; nothing is subtracted.
Peak memory is ``max_memory_allocated`` over a batch's calls, its capture
included (the graphs' memory pool counts).  The
Newton-quality share is the share of scenarios whose step was a Newton
step, not the contained Cauchy step that replaces a Newton solve failing
the residual acceptance (the solver's FACTORIZATION_FAILED flag, which the
Thomas rescue of a failed cyclic-reduction solve clears).  Any non-finite
q, cost or trust ratio fails the run.

The last line of standard output is one JSON object with ``bench.py``'s
keys (``metric``, ``unit``, ``device``, ``latency_ms_batch1``,
``solves_per_s_batch{256,4096}``, ``flops_per_solve``,
``measured_tflops``, ``mpc_replan_ms``, ``value``, ``vs_baseline``,
``latency_vs_60hz_budget``) and the port's own: the card's power limit,
dtype, linear solver, CHUNK, ``newton_share_batch{B}``,
``peak_gib_batch{B}``, ``rescue_share_batch{B}`` (the share of solves the
Thomas rescue re-solved) and ``cr_kernel_launches``.  The run is on the card
unless ``--device cpu`` is given; without a card it fails.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.mpc.controller import (
    make_mpc_params,
    mpc_initialize,
    mpc_step,
)
from idto_tpu_torch.ops import cr_kernel
from idto_tpu_torch.optimizer import batched
from idto_tpu_torch.optimizer.problem import LinearSolverType
from idto_tpu_torch.optimizer.solver import SolverFlag
from idto_tpu_torch.parallel.batching import (
    broadcast_problem,
    map_scenarios,
    solve_batch,
)
from idto_tpu_torch.utils import graphs, timing

# Scenarios a call of ``solve_batch`` takes; larger batches are split into
# calls of this many from the host, one after the other.  On the captured
# route four calls of 1024 take as long as one of 4096 (16.45 against 16.53
# s on an H100 at 700 W) at a quarter of the peak (13.7 against 54.4 GiB),
# and leave room for an eager pass beside the graphs (PERF.md §5).
CHUNK = 1024
BATCHES = (1, 256, 4096)
REPLANS = 30
# Timed calls of the eager route's line, by batch, and its replans.
EAGER_CALLS = {1: 10, 256: 5}
EAGER_REPLANS = 10
REPLAN_DT = 0.016
# The reference's real-time budget: one replan at its controller frequency
# (mini_cheetah.yaml controller_frequency: 60), one solve a replan.
BASELINE_SOLVES_PER_S = 60.0
LINEAR_SOLVERS = {"penta_lu": LinearSolverType.PENTA_LU,
                  "cyclic_reduction": LinearSolverType.CYCLIC_REDUCTION}
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def log(msg):
    print(f"[bench] {msg}", flush=True)


def calls_for(batch):
    """Timed calls at a batch, as ``bench.py`` counts them."""
    return 50 if batch == 1 else 20 if batch <= 256 else 5


def load(linear_solver="penta_lu", dtype="float64", device="cuda"):
    """mini_cheetah at its YAML settings, one iteration a solve, no
    convergence test, with the linear solver named: (model, config,
    problem, params, q_guess)."""
    model, cfg, prob, params, q_guess = load_example(
        "mini_cheetah", dtype=DTYPES[dtype], device=device)
    params = params.replace(
        max_iterations=1, check_convergence=False,
        linear_solver=LINEAR_SOLVERS[linear_solver])
    return model, cfg, prob, params, q_guess


def perturbation(batch, nq, seed):
    """(batch, nq) float64: 0.01 N(0, 1) from ``default_rng(seed)``."""
    return 0.01 * np.random.default_rng(seed).standard_normal((batch, nq))


def batch_inputs(prob, q_guess, batch, seed):
    """(problems, guesses) of ``batch`` scenarios: q_init moved by the
    perturbation, and the example's guess moved by the same amount at
    every knot."""
    dq = torch.as_tensor(perturbation(batch, q_guess.shape[-1], seed),
                         dtype=q_guess.dtype, device=q_guess.device)
    probs = broadcast_problem(prob, batch)
    probs = probs.replace(q_init=probs.q_init + dq)
    return probs, q_guess[None] + dq[:, None]


def make_step(model, params, chunk=CHUNK):
    """step(problems, guesses) -> (q, cost, rho, newton) of one solve of
    each scenario: cost and trust ratio of the iteration, and whether its
    step was a Newton step.  A batch above ``chunk`` (a multiple of it) is
    solved ``chunk`` scenarios a call."""

    def chunk_step(probs, qg):
        sol, stats, _ = solve_batch(model, probs, params, qg)
        newton = stats.solver_flag != int(SolverFlag.FACTORIZATION_FAILED)
        return sol.q, stats.cost[:, 0], stats.rho[:, 0], newton

    def step(probs, qg):
        batch = qg.shape[0]
        if batch <= chunk:
            return chunk_step(probs, qg)
        if batch % chunk:
            raise ValueError(f"batch {batch} is not a multiple of the "
                             f"chunk {chunk}")
        outs = []
        for lo in range(0, batch, chunk):
            sl = slice(lo, lo + chunk)
            outs.append(chunk_step(map_scenarios(lambda x: x[sl], probs),
                                   qg[sl]))
        return tuple(torch.cat(parts) for parts in zip(*outs))

    return step


def check_finite(out, what):
    q, cost, rho = out[:3]
    if not bool(torch.isfinite(q).all()):
        raise RuntimeError(f"{what}: the benched solve gave a non-finite q")
    if not (bool(torch.isfinite(cost).all())
            and bool(torch.isfinite(rho).all())):
        raise RuntimeError(f"{what}: non-finite cost or trust ratio")


def measure_batch(step, probs, qg, calls, device):
    """One warm call (from no captured graph: it captures them), then
    ``calls`` chained calls with one wait.  Returns (seconds a call,
    [seconds of each call], the last output, peak GiB or None on the CPU,
    share of the solves the Thomas rescue re-solved); the warm call's
    seconds are left in ``measure_batch.warm_seconds``."""
    on_cuda = torch.device(device).type == "cuda"
    graphs.reset()
    if on_cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    batched.rescued = 0
    timing.sync(device)
    t0 = time.perf_counter()
    out = step(probs, qg)
    timing.sync(device)
    warm_s = time.perf_counter() - t0
    total, per_call, out = timing.time_chain(
        lambda i, prev: step(probs, prev[0]), out, calls, device)
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_cuda else None
    rescued = batched.rescued / (qg.shape[0] * (calls + 1))
    measure_batch.warm_seconds = warm_s
    return total / calls, per_call, out, peak, rescued


def count_flops(step, probs, qg, width):
    """Operations of one call at ``width`` scenarios, from
    ``FlopCounterMode`` (matrix products only)."""
    from torch.utils.flop_counter import FlopCounterMode

    sl = slice(0, width)
    counter = FlopCounterMode(display=False)
    # Eagerly: a replay dispatches no op for the counter to see.
    with counter, graphs.eager():
        step(map_scenarios(lambda x: x[sl], probs), qg[sl])
    return counter.get_total_flops()


def replan_ms(model, cfg, prob, params, q_guess, replans, device):
    """``mpc_initialize``, one warm replan at t = 0 (it captures the
    replan's graphs), then ``replans`` chained replans REPLAN_DT apart from
    the initial state, each time a device tensor, one wait at the end: ms
    a replan."""
    mpc_params = make_mpc_params(params, 1)
    rel = np.asarray(cfg.q_nom_relative_to_q_init
                     if cfg.q_nom_relative_to_q_init is not None
                     else [False] * model.nq)
    probs = broadcast_problem(prob, 1)
    x0 = torch.cat([prob.q_init, prob.v_init])[None]
    carry, _ = mpc_initialize(model, probs, params, q_guess[None])

    def replan(i, prev):
        t = torch.full((), REPLAN_DT * i, dtype=x0.dtype, device=x0.device)
        return mpc_step(model, probs, mpc_params, rel, prev[0], x0, t)

    out = replan(0, (carry,))
    timing.sync(device)
    total, _, out = timing.time_chain(lambda i, prev: replan(i + 1, prev),
                                      out, replans, device)
    if not bool(torch.isfinite(out[1].q).all()):
        raise RuntimeError("replan: non-finite q")
    return 1e3 * total / replans


def card(device):
    """(device name, power limit in W or None, the nvidia-smi line)."""
    if torch.device(device).type != "cuda":
        return "cpu", None, None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    watts = float(smi.rsplit(",", 1)[1].strip().split()[0])
    return torch.cuda.get_device_name(0), watts, smi


def percentile(xs, p):
    """The p-th percentile of xs by the nearest rank."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, int(np.ceil(p / 100 * len(xs))) - 1))]


def eager_line(step, prob, q_guess, model, cfg, params, batches, seed,
               iters, replans, device):
    """The eager route's times (``graphs.eager()``): ms a call at B=1 and
    B=256 (where benched) and ms a replan, chained as the captured ones."""
    line = {}
    with graphs.eager():
        for batch in [b for b in (1, 256) if b in batches]:
            probs, qg = batch_inputs(prob, q_guess, batch, seed)
            calls = EAGER_CALLS[batch] if iters is None else iters
            dt = measure_batch(step, probs, qg, calls, device)[0]
            line[f"eager_ms_batch{batch}"] = round(1e3 * dt, 3)
            del probs, qg
        line["eager_mpc_replan_ms"] = round(replan_ms(
            model, cfg, prob, params, q_guess,
            EAGER_REPLANS if iters is None else replans, device), 3)
    return line


def run(linear_solver="penta_lu", dtype="float64", device="cuda", seed=0,
        batches=BATCHES, iters=None, replans=REPLANS, chunk=CHUNK):
    """The whole benchmark: (the result dictionary, {batch: q of the last
    call}).  The eager route's line and each batch's capture seconds are
    logged before it."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    model, cfg, prob, params, q_guess = load(linear_solver, dtype, device)
    name, watts, smi = card(device)
    if smi is not None:
        log(f"nvidia-smi: {smi}")
    step = make_step(model, params, chunk)
    eager = eager_line(step, prob, q_guess, model, cfg, params, batches,
                       seed, iters, replans, device)
    cr_kernel.launches = 0
    result = {
        "metric": "mini_cheetah_mpc_solves_per_s",
        "unit": "solves/s",
        "device": name,
        "power_limit_w": watts,
        "dtype": dtype,
        "linear_solver": linear_solver,
        "chunk": chunk,
    }
    last_q = {}
    for batch in batches:
        probs, qg = batch_inputs(prob, q_guess, batch, seed)
        calls = calls_for(batch) if iters is None else iters
        dt, per_call, out, peak, rescued = measure_batch(
            step, probs, qg, calls, device)
        eager[f"first_call_s_batch{batch}"] = round(
            measure_batch.warm_seconds, 3)
        eager[f"capture_s_batch{batch}"] = round(
            sum(graphs.capture_seconds.values()), 3)
        check_finite(out, f"batch {batch}")
        last_q[batch] = out[0]
        if batch == 1:
            result["latency_ms_batch1"] = round(dt * 1e3, 3)
            ms = [1e3 * t for t in per_call]
            log(f"B=1 per call: median {statistics.median(ms):.3f} ms, p80 "
                f"{percentile(ms, 80):.3f} ms of {len(ms)} calls")
        else:
            result[f"solves_per_s_batch{batch}"] = round(batch / dt, 2)
        result[f"newton_share_batch{batch}"] = float(
            out[3].to(torch.float64).mean())
        result[f"peak_gib_batch{batch}"] = (
            None if peak is None else round(peak, 3))
        result[f"rescue_share_batch{batch}"] = rescued
        log(f"B={batch}: {1e3 * dt:.3f} ms a call over {calls} chained "
            f"calls, Newton share {result[f'newton_share_batch{batch}']}, "
            f"rescued {rescued}, peak {peak} GiB")
        if batch == max(batches):
            width = min(batch, chunk)
            flops = count_flops(step, probs, qg, width)
            log("FLOPs: torch.utils.flop_counter counts matrix products "
                "(mm, bmm, addmm, ...) only; bench.py's XLA cost analysis "
                "counted every operation")
            if flops > 0:
                result["flops_per_solve"] = round(flops / width)
                result["measured_tflops"] = round(
                    flops * (batch // width) / dt / 1e12, 6)
            else:
                log("FLOPs: the counter saw no matrix product through "
                    "torch.func; flops_per_solve and measured_tflops are "
                    "left out")
        del probs, qg, out
    graphs.reset()
    result["mpc_replan_ms"] = round(
        replan_ms(model, cfg, prob, params, q_guess, replans, device), 3)
    eager["capture_s_replan"] = round(sum(graphs.capture_seconds.values()),
                                      3)
    log(f"eager route and captures: {json.dumps(eager)}")
    big = max(batches)
    headline = result.get(f"solves_per_s_batch{big}")
    result["value"] = headline
    result["vs_baseline"] = (None if headline is None
                             else round(headline / BASELINE_SOLVES_PER_S, 4))
    result["latency_vs_60hz_budget"] = (
        round(result["latency_ms_batch1"] / (1e3 / BASELINE_SOLVES_PER_S), 4)
        if "latency_ms_batch1" in result else None)
    result["cr_kernel_launches"] = cr_kernel.launches
    return result, last_q


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--linear-solver", choices=sorted(LINEAR_SOLVERS),
                    default="penta_lu",
                    help="the YAML's pentadiagonal_lu (Thomas) or cyclic "
                         "reduction (the CUDA kernel)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float64")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the scenarios' perturbations")
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)),
                    help="comma-separated batch sizes (default 1,256,4096)")
    ap.add_argument("--iters", type=int, default=None,
                    help="timed calls at every batch (default 50 at B=1, "
                         "20 up to 256, 5 above)")
    ap.add_argument("--replans", type=int, default=REPLANS)
    ap.add_argument("--chunk", type=int, default=CHUNK,
                    help="scenarios a solve_batch call takes")
    args = ap.parse_args(argv)
    result, _ = run(args.linear_solver, args.dtype, args.device, args.seed,
                    tuple(int(b) for b in args.batches.split(",")),
                    args.iters, args.replans, args.chunk)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
