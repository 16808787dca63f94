"""Example runner (counterpart of ``idto_tpu/examples/run.py``).

Usage:
    python -m idto_tpu_torch.examples.run spinner [--test] [--mpc] [--verbose]
    python -m idto_tpu_torch.examples.run --list

The solve runs on the GPU in float64; ``--device cpu`` is the only way to
run it elsewhere.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("example", nargs="?", help="example name")
    parser.add_argument("--list", action="store_true", help="list examples")
    parser.add_argument(
        "--test", action="store_true",
        help="smoke-test mode: 10 iterations, no MPC",
    )
    parser.add_argument("--mpc", action="store_true",
                        help="run closed-loop MPC")
    parser.add_argument("--verbose", action="store_true",
                        help="print the per-iteration table")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the tensors live (default: the GPU)")
    args = parser.parse_args(argv)

    from idto_tpu_torch.examples.registry import example_names, load_example

    if args.list or not args.example:
        print("available examples:", ", ".join(example_names()))
        return 0

    import torch

    model, cfg, prob, params, q_guess = load_example(
        args.example, test_mode=args.test, device=args.device
    )
    print(
        f"[{args.example}] nq={model.nq} nv={model.nv} nu={model.nu} "
        f"T={prob.num_steps} dt={prob.dt} "
        f"pairs={len(model.geoms.pairs)} device={args.device}"
    )

    if args.mpc and cfg.mpc and not args.test:
        from idto_tpu_torch.examples.registry import load_sim_plant
        from idto_tpu_torch.mpc.runner import run_mpc

        sim_model, sim_contact = load_sim_plant(args.example, params,
                                                device=args.device)
        result = run_mpc(model, cfg, prob, params, q_guess,
                         sim_model=sim_model, sim_contact=sim_contact)
        print(
            f"MPC: {result.num_solves} solves, "
            f"mean solve time {1e3 * result.mean_solve_time:.2f} ms "
            f"({1.0 / max(result.mean_solve_time, 1e-9):.1f} Hz), "
            f"mean simulated period {1e3 * result.mean_sim_time:.2f} ms"
        )
        finite = np.isfinite(result.q_log).all(axis=1)
        if not finite.all():
            # The simulator is explicit in the PD terms: gains with
            # h Kd / M > 2 on some joint (the arm examples' wrists) diverge.
            print(f"simulated state non-finite from t = "
                  f"{result.times[np.argmin(finite)]:.4g} s on")
            return 1
        return 0

    from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    # The first call pays the one-time costs (on the GPU: the kernel's
    # build, the constant tables); the second is the solve time.
    seconds = []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        sol, stats, _ = solve_batch(model, broadcast_problem(prob, 1), params,
                                    q_guess[None])
        sync()
        seconds.append(time.perf_counter() - t0)

    def row(x):
        return x[0].cpu().numpy()

    iters = int(stats.num_iters[0])
    costs = row(stats.cost)
    if args.verbose:
        hdr = (f"{'iter':>5} {'cost':>12} {'Delta':>10} {'rho':>10} "
               f"{'|dq|':>10} {'|g|':>10} {'merit':>12}")
        cols = [row(getattr(stats, k))
                for k in ("delta", "rho", "dq_norm", "grad_norm", "merit")]
        for k in range(iters):
            if k % 50 == 0:
                print(hdr)
            print(f"{k:5d} {costs[k]:12.6g} " + " ".join(
                f"{c[k]:10.4g}" for c in cols[:4]) + f" {cols[4][k]:12.6g}")
    print(f"iterations:     {iters}")
    print(f"initial cost:   {costs[0]:.6g}")
    print(f"final cost:     {costs[max(iters - 1, 0)]:.6g}")
    print(f"solve time:     {seconds[1] * 1e3:.1f} ms "
          f"(first call {seconds[0]:.1f} s)")
    print(f"final q[T]:     {row(sol.q)[-1]}")
    print(f"max |tau|:      {np.abs(row(sol.tau)).max():.4g}")
    reason = int(stats.convergence_reason[0])
    names = [name for bit, name in
             [(1, "cost_reduction"), (2, "gradient"), (4, "state_change")]
             if reason & bit]
    print(f"convergence:    {'+'.join(names) if names else 'max_iterations'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
