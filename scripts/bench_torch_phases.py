"""Per-phase time of one trust-region iteration of the PyTorch/CUDA port
(``idto_tpu_torch``) on one NVIDIA GPU: the mini-cheetah, the constrained
hopper, the mini-cheetah MPC replan, the six manipulation examples
(``--only fleet``) and one simulator substep of jaco (``--only simulator``).

Times each phase of ``optimizer.batched.solve_trust_region_batched`` on
the inputs ``chip_smoke.py`` uses (cyclic reduction, float64): the rollout
(velocities and inverse dynamics), the exact partials, the linear-algebra
tail (gradient, Hessian, scaling, the CR Newton solve with its containment,
the Cauchy step), the CR solve alone, the Thomas rescue solve, the dogleg,
and the whole iteration.  Each time is the median over ``REPS`` calls of
the host clock around the call and a ``torch.cuda.synchronize()``, after
one warm-up call.  Then one iteration is traced with ``torch.profiler`` to
give the device's busy share, the kernels that take the most time, and
the host's counts of kernel launches, stream synchronizations and copies.
The phases run eagerly; the whole iteration, the replan and the simulator
replay their captured CUDA graphs (``utils/graphs.py``; the warm-up call
captures them), so their host counts are graph launches and copies.

The hopper's rows (its YAML settings but for cyclic reduction, float64,
equality constraints on: R = 121 right-hand sides in the Schur solve) add
the constraint part of the tail: the Jacobian assembly and the R = 121
solve.  ``mpc_replan_ms`` is the mean of 30 chained replans 0.016 s apart
after ``mpc_initialize`` and one warm replan, one synchronize at the end,
as the reference's bench chains them.

Usage: python3 scripts/bench_torch_phases.py [--out PATH.json]
           [--only cheetah,hopper,mpc,profile,fleet,simulator]
           [--profile-batch B] [--package-root DIR]

``fleet`` gives the phase rows of kuka, jaco, jaco_ball, dual_jaco,
allegro_hand and punyo at B=1 and at ``chip_smoke.FLEET_BATCH``;
``simulator`` times one substep of jaco's simulated plant (contact query,
forward dynamics, integration) at the YAML step and traces it for the
host's launch and synchronization counts.

``--package-root`` names a directory that holds another checkout's
``idto_tpu_torch`` (for example the parent commit unpacked by ``git
archive``); with ``--only cheetah,profile`` two versions can be compared in
one run on one card.
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
# The package may come from another checkout; chip_smoke.py's helpers
# always from this one.
for _i, _arg in enumerate(sys.argv):
    if _arg == "--package-root":
        sys.path.insert(0, os.path.abspath(sys.argv[_i + 1]))

import torch

import chip_smoke
from chip_smoke import cheetah_inputs
from idto_tpu_torch.ops import cr_kernel, penta
from idto_tpu_torch.optimizer import batched, solver
from idto_tpu_torch.parallel.batching import broadcast_problem
from idto_tpu_torch.soa import partials, rollout

BATCHES = (1, 256, 4096)
REPS = 3
HOPPER_BATCHES = (1, 256)
PROFILE_BATCHES = (1, 256)


def timed(fn, reps):
    """(median ms over reps calls after one warm-up, last result)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def phases(batch, reps, inputs=cheetah_inputs, example="mini_cheetah"):
    model, prob, params, qg = inputs(batch, 0, "cuda")
    params = params.replace(max_iterations=1)
    probs = broadcast_problem(prob, batch)
    contact = params.contact
    row = {"example": example, "batch": batch}
    row["rollout_ms"], (tau, v) = timed(
        lambda: rollout.generalized_forces(model, probs, contact, qg), reps)
    row["cost_ms"], cost = timed(
        lambda: rollout.cost(model, probs, contact, qg, tau=tau, v=v), reps)
    row["partials_ms"], parts = timed(
        lambda: partials.id_partials_batched(model, probs, contact, qg), reps)
    row["nplus_ms"], nplus = timed(
        lambda: partials.nplus_stack_batched(model, qg), reps)
    D = torch.ones_like(qg)
    row["linear_tail_ms"], prep = timed(
        lambda: solver._prepare_from_physics(
            model, probs, params, qg, D, cost, v, tau, parts, nplus), reps)
    row["cr_solve_ms"], _ = timed(
        lambda: cr_kernel.solve_many(prep.H, prep.g_merit[:, None]), reps)
    if getattr(prep, "Js", None) is not None:
        unact = model.unactuated_vdofs
        row["constraint_jacobian_ms"], _ = timed(
            lambda: solver._constraint_jacobian_dense(
                model, probs, parts, unact) * prep.D[:, None], reps)
        stack = torch.cat([prep.gs[:, None], prep.Js], dim=1)
        row["schur_rhs"] = int(stack.shape[1])
        row["cr_solve_schur_ms"], _ = timed(
            lambda: cr_kernel.solve_many(prep.H, stack), reps)
    row["thomas_solve_ms"], _ = timed(
        lambda: penta.solve(prep.H, prep.g_merit), reps)
    row["rescue_ms"], prep = timed(
        lambda: batched._rescue_degraded_solves(params, prep), reps)
    Delta = torch.full((batch,), params.Delta0, dtype=qg.dtype, device="cuda")
    row["dogleg_ms"], _ = timed(lambda: solver._dogleg(prep, Delta), reps)
    torch.cuda.reset_peak_memory_stats()
    row["iteration_ms"], _ = timed(
        lambda: batched.solve_trust_region_batched(model, probs, params, qg),
        reps)
    row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    row["newton_solves_ok"] = int(prep.solve_ok.sum())
    return row


def mpc_replans(n_replans=30):
    """Mean ms of ``n_replans`` chained replans after ``mpc_initialize``
    and one warm replan (the carry feeds the next replan; one synchronize at
    the end), and the median of as many timed one by one."""
    _, each, _ = chip_smoke.run_replans("cuda", n_replans, timed=True)
    carry, replan = chip_smoke.replan_setup("cuda")
    carry, _ = replan(carry, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_replans):
        carry, _ = replan(carry, i + 1)
    torch.cuda.synchronize()
    chained = time.perf_counter() - t0
    return {"example": "mini_cheetah", "batch": 1,
            "mpc_replan_ms": 1e3 * chained / n_replans,
            "mpc_replan_ms_median_each": statistics.median(each[1:]),
            "replans": n_replans}


def profile_iteration(batch):
    model, prob, params, qg = cheetah_inputs(batch, 0, "cuda")
    params = params.replace(max_iterations=1)
    probs = broadcast_problem(prob, batch)
    return {"batch": batch, **profile_call(
        lambda: batched.solve_trust_region_batched(model, probs, params, qg))}


def simulator_substep():
    """One substep of jaco's simulated plant (B=1, the stiffer simulation
    contact, the YAML step) from q_init under zero control: median ms and
    the profile of one call."""
    from idto_tpu_torch.examples.registry import load_example, load_sim_plant
    from idto_tpu_torch.mpc import simulator

    model, cfg, prob, params, _ = load_example("jaco", device="cuda")
    _, contact = load_sim_plant("jaco", params, device="cuda")
    q, v = prob.q_init[None], prob.v_init[None]
    u = torch.zeros((1, model.nu), dtype=q.dtype, device="cuda")

    def step():
        return simulator.sim_step(model, contact, cfg.sim_time_step, q, v, u)

    ms, _ = timed(step, 10)
    return {"example": "jaco", "batch": 1, "sim_substep_ms": ms,
            **profile_call(step)}


def profile_call(fn):
    """Trace one call of fn (after a warm-up call) with torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side entries only: an operator's row repeats its kernels' time.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    host = {e.key: e.count for e in prof.key_averages()
            if e.key.startswith(("cudaLaunchKernel", "cudaStreamSynchronize",
                                 "cudaMemcpy", "cudaDeviceSynchronize"))}
    return {
        "host_calls": host,
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "top_kernels": [
            {"name": e.key[:80], "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3}
            for e in top
        ],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the rows here")
    ap.add_argument("--only", default="cheetah,hopper,mpc,profile")
    ap.add_argument("--profile-batch", type=int, default=None,
                    help="profile this batch only (default: 1 and 256)")
    ap.add_argument("--package-root", default=None)
    args = ap.parse_args()
    only = args.only.split(",")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()

    if "cheetah" in only:
        for batch in BATCHES:
            emit(phases(batch, REPS))
    if "hopper" in only:
        for batch in HOPPER_BATCHES:
            emit(phases(batch, REPS, chip_smoke.hopper_inputs, "hopper"))
    if "mpc" in only:
        emit(mpc_replans())
    if "fleet" in only:
        for name in chip_smoke.FLEET:
            for batch in (1, chip_smoke.FLEET_BATCH):
                emit(phases(
                    batch, REPS,
                    lambda b, seed, dev, n=name: chip_smoke.fleet_inputs(
                        n, b, seed, dev), name))
    if "simulator" in only:
        emit(simulator_substep())
    if "profile" in only:
        for batch in ([args.profile_batch] if args.profile_batch
                      else PROFILE_BATCHES):
            emit(profile_iteration(batch))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": smi, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
