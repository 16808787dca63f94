"""Scenario-data-parallel throughput of the PyTorch/CUDA port
(``idto_tpu_torch``): chained solves per second of the scenario-sharded
mini-cheetah batch (``parallel.batching.solve_batch_sharded``), by world
size and per card (counterpart of ``scripts/bench_multichip.py``).

    python3 scripts/bench_torch_multichip.py [--world 2] [--batch-per-rank 128]
        [--backend nccl|gloo] [--iters 3] [--out chiprun_out/torch_multichip.json]
    python3 scripts/bench_torch_multichip.py --two-process   # gloo, CPU
    python3 scripts/bench_torch_multichip.py --probe         # gloo facts
    python3 scripts/bench_torch_multichip.py --horizon [--world 4]

Each world size is a fresh group of spawned ranks, one process a rank
(world size 1, then ``--world``).  A rank solves ``--batch-per-rank``
scenarios of the cheetah at its YAML size (cyclic reduction, float64, one
iteration a solve) and feeds each solve's q to the next as its guess;
``--iters`` chained solves are timed with CUDA events around the chain
(``utils/timing.py``) after one warm solve.  The rate is the whole batch
over the slowest rank's seconds a solve.  The backend is NCCL, one card a
rank, unless ``--backend gloo`` asks for gloo with CUDA tensors, which lets
several ranks share one card (NCCL refuses two ranks on one GPU).  With
fewer cards than ranks the ranks share cards and the host's cores, so the
efficiency figure (rate at ``--world`` over ``--world`` times the rate at
1) measures that contention, not scaling, and the JSON says so.

``--two-process`` runs two gloo ranks on the CPU with a short cheetah
(T=4, two scenarios a rank) through ``multihost.initialize`` and
``solve_batch_global`` from each rank's local scenarios.  ``--probe`` tries
each collective of ``torch.distributed`` that the parallel layer could use
on CUDA tensors under gloo (two ranks on one card) and under NCCL (one
rank): all_gather, all_reduce (sum and min, float64 and int32), broadcast,
and send/recv (gloo only, in a group of its own that a crash or hang
cannot take the rest down with).  ``--horizon`` times one iteration of the
horizon-sharded cheetah over ``chip_smoke.PARALLEL_T`` steps (CUDA events,
after a warm one), replayed from captured graphs (on NCCL; gloo's regions
run directly) and eagerly, in turns (captured, eager, eager, captured);
once more eagerly with each collective synchronized and timed; at world
size 1 and ``--world``; and holds two captured iterations against the
eager ones (their largest difference) and against the same solve made
unsharded on rank 0's card.  The JSON goes to ``--out``; the
script commits no artifact.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np
import torch
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

JOIN_SECONDS = 600


def _spawn(fn, world, *args):
    """Run fn(rank, world, rendezvous, directory, *args) in ``world``
    spawned ranks; returns each rank's JSON result, or raises."""
    with tempfile.TemporaryDirectory() as directory:
        ctx = mp.start_processes(
            fn, args=(world, f"file://{directory}/rv", directory) + args,
            nprocs=world, join=False, start_method="spawn")
        t0 = time.perf_counter()
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > JOIN_SECONDS:
                    raise TimeoutError(f"ranks ran past {JOIN_SECONDS} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        out = []
        for r in range(world):
            with open(os.path.join(directory, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out


def _write(directory, rank, result):
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _rate_rank(rank, world, rendezvous, directory, batch, iters, backend):
    """One rank of a throughput run."""
    from chip_smoke import cheetah_inputs
    from idto_tpu_torch.parallel import multihost
    from idto_tpu_torch.parallel.batching import (
        broadcast_problem,
        make_mesh,
        solve_batch_sharded,
    )
    from idto_tpu_torch.utils import timing

    multihost.initialize(rendezvous, world, rank, device="cuda",
                         backend=backend)
    mesh = make_mesh(axis="scenario", device="cuda")
    B = batch * world
    model, prob, params, qg = cheetah_inputs(B, 0, "cuda", iters=1)
    probs = broadcast_problem(prob, B)
    state = {"q": qg}

    def step():
        sol, _, _, mean_cost = solve_batch_sharded(model, probs, params,
                                                   state["q"], mesh)
        state["q"], state["mean_cost"] = sol.q, mean_cost

    seconds = timing.time_throughput(step, [()], calls=iters, device="cuda")
    mean_cost = float(state["mean_cost"])
    if not np.isfinite(mean_cost):
        raise AssertionError("non-finite mean cost")
    _write(directory, rank, {"seconds_per_solve": seconds,
                             "mean_cost": mean_cost,
                             "backend": torch.distributed.get_backend()})
    torch.distributed.destroy_process_group()


def _device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": smi[0] if smi else "not read"}


def run_bench(world, batch, iters, backend):
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this bench measures the card")
    cards = torch.cuda.device_count()
    if backend == "nccl" and world > cards:
        raise SystemExit(f"NCCL needs a card a rank ({cards} for {world} "
                         "ranks): pass --backend gloo to share cards")
    from idto_tpu_torch.ops import cr_kernel

    cr_kernel.build()  # once, before the ranks load it
    rates = {}
    for w in (1, world):
        out = _spawn(_rate_rank, w, batch, iters, backend)
        slowest = max(o["seconds_per_solve"] for o in out)
        rates[w] = {"backend": out[0]["backend"], "world_size": w,
                    "cards": min(w, cards), "batch": batch * w,
                    "seconds_per_solve": [o["seconds_per_solve"]
                                          for o in out],
                    "solves_per_s": batch * w / slowest,
                    "solves_per_s_per_card": batch * w / slowest
                    / min(w, cards),
                    "mean_cost": out[0]["mean_cost"]}
    eff = rates[world]["solves_per_s"] / (world * rates[1]["solves_per_s"])
    shared = world > cards
    return {
        "bench": "scenario_dp_multichip_torch",
        "model": "mini_cheetah",
        "dtype": "float64",
        "linear_solver": "cyclic_reduction",
        "device": _device(),
        "batch_per_rank": batch,
        "chained_solves": iters,
        "by_world_size": [rates[1], rates[world]],
        "per_rank_efficiency": eff,
        "note": (
            f"{world} ranks share {cards} card(s) and the host's cores: the "
            "efficiency measures that contention, not scaling"
            if shared else "one card a rank"),
    }


def _horizon_rank(rank, world, rendezvous, directory, backend, iters):
    """One rank of the horizon-sharded cheetah (``chip_smoke.PARALLEL_T``)."""
    import chip_smoke
    from idto_tpu_torch.optimizer.solver import solve
    from idto_tpu_torch.parallel import multihost
    from idto_tpu_torch.parallel.batching import make_mesh
    from idto_tpu_torch.parallel.horizon import (
        solve_trust_region_horizon_sharded,
    )
    from idto_tpu_torch.utils import timing

    from idto_tpu_torch.utils import graphs

    multihost.initialize(rendezvous, world, rank, device="cuda",
                         backend=backend)
    mesh = make_mesh(axis="horizon", device="cuda")
    model, prob, params, qg = chip_smoke.long_cheetah_inputs("cuda", 1)

    def iteration():
        return solve_trust_region_horizon_sharded(model, prob, params, qg,
                                                  mesh)

    def eager_iteration():
        with graphs.eager():
            return iteration()

    # The captured route (the warm-up call captures) and the eager one in
    # turns: captured, eager, eager, captured.
    seconds, eager_seconds = [], []
    for route in ("captured", "eager", "eager", "captured"):
        fn = iteration if route == "captured" else eager_iteration
        (seconds if route == "captured" else eager_seconds).append(
            timing.time_fn(fn, [()], reps=iters, device="cuda"))
    spent, restore = chip_smoke.timed_collectives()
    try:  # the collectives are Python calls on the eager route only
        synced_ms, _ = chip_smoke.synced_ms(eager_iteration)
    finally:
        restore()
    two = params.replace(max_iterations=2)
    sol = solve_trust_region_horizon_sharded(model, prob, two, qg, mesh)[0]
    with graphs.eager():
        sol_eager = solve_trust_region_horizon_sharded(model, prob, two, qg,
                                                       mesh)[0]
    result = {"backend": torch.distributed.get_backend(),
              "seconds_per_iteration": seconds,
              "eager_seconds_per_iteration": eager_seconds,
              "captured_vs_eager_max_abs": max(
                  float((a - b).abs().max()) for a, b in (
                      (sol.q, sol_eager.q), (sol.tau, sol_eager.tau))),
              "graphs_captured": graphs.captures,
              "regions_run_directly": dict(graphs.direct_runs),
              "synced_eager_iteration_ms": synced_ms,
              "collective_ms": 1e3 * spent[0], "collectives": spent[1]}
    if rank == 0:  # the same two iterations unsharded on this rank's card
        result["q_vs_single"] = chip_smoke.rel_err(
            sol.q, solve(model, prob, two, qg)[0].q)
    _write(directory, rank, result)
    graphs.reset()  # the graphs hold the group's collectives
    torch.distributed.destroy_process_group()


def run_horizon(world, iters, backend):
    """The horizon-sharded cheetah at world size 1 and ``world``."""
    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this bench measures the card")
    if (chip_smoke.PARALLEL_T + 1) % world:
        raise SystemExit(f"{chip_smoke.PARALLEL_T + 1} knots do not divide "
                         f"{world} ranks")
    from idto_tpu_torch.ops import cr_kernel

    cr_kernel.build()
    runs = []
    for w in (1, world):
        out = _spawn(_horizon_rank, w, backend, iters)
        runs.append({"backend": out[0]["backend"], "world_size": w,
                     "cards": min(w, torch.cuda.device_count()),
                     "ranks": out})
    return {"bench": "horizon_sharded_cheetah_torch", "model": "mini_cheetah",
            "num_steps": chip_smoke.PARALLEL_T, "dtype": "float64",
            "device": _device(), "timed_iterations": iters,
            "by_world_size": runs,
            "note": "world size 1 is the unsharded solve (the fused "
                    "kernel); above it, distributed cyclic reduction"}


def two_process():
    """Two gloo ranks on the CPU through solve_batch_global."""
    out = _spawn(_two_process_rank, 2)
    if not all(np.isfinite(o["mean_cost"]) for o in out):
        raise AssertionError("non-finite mean cost")
    if out[0]["mean_cost"] != out[1]["mean_cost"]:
        raise AssertionError("the ranks' mean costs differ")
    return {"bench": "two_process_gloo_cpu", "backend": out[0]["backend"],
            "world_size": 2, "device": "cpu", "ranks": out}


def _two_process_rank(rank, world, rendezvous, directory):
    torch.set_num_threads(1)
    from chip_smoke import cheetah_inputs
    from idto_tpu_torch.parallel import multihost
    from idto_tpu_torch.parallel.batching import broadcast_problem

    ok = multihost.initialize(rendezvous, world, rank, device="cpu")
    if not ok:
        raise AssertionError("initialize did not make a group of two")
    T, local_B = 4, 2
    model, prob, params, qg = cheetah_inputs(local_B, rank, "cpu", iters=1)
    prob = prob.replace(num_steps=T, q_nom=prob.q_nom[:T + 1],
                        v_nom=prob.v_nom[:T + 1])
    mesh = multihost.make_global_mesh(sp=1, device="cpu")
    t0 = time.perf_counter()
    sol, stats, _, mean_cost = multihost.solve_batch_global(
        model, broadcast_problem(prob, local_B), params,
        qg[:, :T + 1].numpy(), mesh)
    _write(directory, rank, {
        "backend": torch.distributed.get_backend(),
        "global_batch": int(sol.q.shape[0]), "mean_cost": float(mean_cost),
        "seconds": time.perf_counter() - t0})
    torch.distributed.destroy_process_group()


def _collectives(device):
    """Which collectives run on ``device`` tensors and give the right
    answer in the current group."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    facts = {}

    def attempt(name, fn):
        try:
            facts[name] = "ok" if fn() else "wrong result"
        except (RuntimeError, ValueError, TypeError) as e:
            facts[name] = f"raised: {str(e).splitlines()[0][:160]}"

    def gather():
        x = torch.full((3,), float(rank), dtype=torch.float64, device=device)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return all(float(p[0]) == r for r, p in enumerate(parts))

    def reduce(op, dtype, want):
        x = torch.full((2,), rank + 1, dtype=dtype, device=device)
        dist.all_reduce(x, op=op)
        return int(x[0]) == want

    def broadcast():
        x = torch.full((2,), float(rank + 7), dtype=torch.float64,
                       device=device)
        dist.broadcast(x, src=0)
        return float(x[0]) == 7.0

    attempt("all_gather float64", gather)
    for dtype in (torch.float64, torch.int32):
        name = str(dtype).split(".")[-1]
        attempt(f"all_reduce sum {name}",
                lambda: reduce(dist.ReduceOp.SUM, dtype,
                               world * (world + 1) // 2))
        attempt(f"all_reduce min {name}",
                lambda: reduce(dist.ReduceOp.MIN, dtype, 1))
    attempt("broadcast float64", broadcast)
    return facts


def _probe_rank(rank, world, rendezvous, directory, backend, p2p):
    from idto_tpu_torch.parallel import multihost

    multihost.initialize(rendezvous, world, rank, device="cuda",
                         backend=backend)
    import torch.distributed as dist

    if p2p:
        x = torch.full((4,), float(rank + 1), device="cuda")
        if rank == 0:
            dist.send(x, dst=1)
            facts = {"send": "returned"}
        else:
            dist.recv(x, src=0)
            torch.cuda.synchronize()
            facts = {"recv": "ok" if float(x[0]) == 1.0 else
                     f"wrong result {float(x[0])}"}
    else:
        facts = _collectives("cuda")
    _write(directory, rank, facts)
    dist.destroy_process_group()


def probe():
    """The collectives gloo and NCCL take on CUDA tensors here."""
    out = {"device": _device()}
    out["nccl_world_1"] = _spawn(_probe_rank, 1, "nccl", False)[0]
    out["gloo_world_2_one_card"] = _spawn(_probe_rank, 2, "gloo", False)[0]
    try:
        res = _spawn(_probe_rank, 2, "gloo", True)
        out["gloo_send_recv_one_card"] = {**res[0], **res[1]}
    except (TimeoutError, ProcessException, FileNotFoundError) as e:
        out["gloo_send_recv_one_card"] = (
            f"failed: {type(e).__name__}: {str(e).strip().splitlines()[-1]}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--batch-per-rank", type=int, default=128)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--two-process", action="store_true")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--horizon", action="store_true",
                    help="the horizon-sharded cheetah instead of the "
                         "scenario-sharded batch")
    ap.add_argument("--out", default=os.path.join(
        _REPO, "chiprun_out", "torch_multichip.json"))
    args = ap.parse_args(argv)
    if args.two_process:
        result = two_process()
    elif args.probe:
        result = probe()
    elif args.horizon:
        result = run_horizon(args.world, args.iters, args.backend)
    else:
        result = run_bench(args.world, args.batch_per_rank, args.iters,
                           args.backend)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
