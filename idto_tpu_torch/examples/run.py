"""Example runner (counterpart of ``idto_tpu/examples/run.py``).

Usage:
    python -m idto_tpu_torch.examples.run spinner [--test] [--mpc] [--verbose]
        [--stats-csv F] [--contour-csv F] [--lineplot-csv F]
        [--quadratic-csv F] [--linesearch-csv F] [--print-debug-data]
        [--profile] [--live [PORT]] [--playback OUT.html]
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
    parser.add_argument("--stats-csv", default=None,
                        help="write per-iteration stats to this CSV file")
    parser.add_argument("--contour-csv", default=None,
                        help="write a 2-D cost-landscape CSV over the "
                             "first two decision variables")
    parser.add_argument("--lineplot-csv", default=None,
                        help="write a 1-D cost sweep along the total solve "
                             "displacement sol.q - q_guess")
    parser.add_argument("--quadratic-csv", default=None,
                        help="write per-iteration quadratic-model data "
                             "(the reference's quadratic_data.csv)")
    parser.add_argument("--linesearch-csv", default=None,
                        help="write the linesearch residual sweep over "
                             "alpha in [-0.2, 1.2] along the final Newton "
                             "direction")
    parser.add_argument("--print-debug-data", action="store_true",
                        help="print per-iteration Hessian condition "
                             "numbers")
    parser.add_argument("--profile", action="store_true",
                        help="print the span table: host-clock and device "
                             "time of each span")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the tensors live (default: the GPU)")
    parser.add_argument("--live", default=None, type=int, nargs="?",
                        const=8765, metavar="PORT",
                        help="with --mpc: serve a live WebGL viewer on "
                             "localhost:PORT (default 8765) and stream every "
                             "replan's planned trajectory to it over a "
                             "websocket")
    parser.add_argument("--playback", default=None, metavar="OUT.html",
                        help="export the solved trajectory as a standalone "
                             "WebGL playback HTML; the YAML's "
                             "play_initial_guess / play_target_trajectory "
                             "flags add <name>_{guess,target}.html next to "
                             "OUT.html")
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
        viewer = on_replan = None
        if args.live is not None:
            from idto_tpu_torch.utils.liveview import LiveViewer

            viewer = LiveViewer(model, dt=prob.dt, port=args.live)
            print(f"live viewer: http://localhost:{viewer.port}")

            def on_replan(t_now, q_plan):
                viewer.publish(q_plan)

        try:
            result = run_mpc(model, cfg, prob, params, q_guess,
                             sim_model=sim_model, sim_contact=sim_contact,
                             on_replan=on_replan)
        finally:
            if viewer is not None:
                viewer.close()
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

    from idto_tpu_torch.optimizer.solver import solve
    from idto_tpu_torch.utils import profiler
    from idto_tpu_torch.utils.profiler import instrument

    profiler.set_enabled(args.profile)

    want_csv = args.stats_csv or (cfg.save_solver_stats_csv and not args.test)

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    # The first call pays the one-time costs (on the GPU: the kernel's
    # build, the constant tables); the second is the solve time.
    seconds = []
    for scope in ("first solve", "solve"):
        sync()
        t0 = time.perf_counter()
        with instrument(scope):
            sol, stats, warm = solve(model, prob, params, q_guess)
            sync()
        seconds.append(time.perf_counter() - t0)

    if want_csv:
        # A separate solve with the iteration timer, so that its events do
        # not touch the timed solve above.
        with instrument("timed solve for the CSV"):
            stats = solve(model, prob,
                          params.replace(record_iteration_times=True),
                          q_guess)[1]

    def row(x):
        return x.cpu().numpy()

    iters = int(stats.num_iters)
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
    reason = int(stats.convergence_reason)
    names = [name for bit, name in
             [(1, "cost_reduction"), (2, "gradient"), (4, "state_change")]
             if reason & bit]
    print(f"convergence:    {'+'.join(names) if names else 'max_iterations'}")

    if want_csv:
        from idto_tpu_torch.optimizer.stats_io import save_stats_csv

        path = args.stats_csv or "solver_stats.csv"
        save_stats_csv(stats, path)
        print(f"stats written to {path}")
    if args.contour_csv:
        from idto_tpu_torch.optimizer.stats_io import save_contour_csv

        with instrument("contour"):
            save_contour_csv(model, prob, params, sol.q, args.contour_csv)
        print(f"contour data written to {args.contour_csv}")
    if args.lineplot_csv:
        from idto_tpu_torch.optimizer.stats_io import save_lineplot_csv

        with instrument("lineplot"):
            save_lineplot_csv(model, prob, params, q_guess,
                              sol.q - q_guess, args.lineplot_csv)
        print(f"lineplot data written to {args.lineplot_csv}")
    if args.quadratic_csv:
        from idto_tpu_torch.optimizer.debug_dump import save_quadratic_csv

        with instrument("quadratic"):
            save_quadratic_csv(model, prob, params, q_guess,
                               args.quadratic_csv, n_iters=iters)
        print(f"quadratic-model data written to {args.quadratic_csv}")
    if args.linesearch_csv:
        from idto_tpu_torch.optimizer.debug_dump import (
            save_linesearch_residual_csv,
        )

        # Along the final Newton direction at the solved iterate.
        with instrument("linesearch residual"):
            save_linesearch_residual_csv(model, prob, params, sol.q,
                                         warm.dqH, args.linesearch_csv)
        print(f"linesearch residual written to {args.linesearch_csv}")
    if args.print_debug_data:
        from idto_tpu_torch.optimizer.debug_dump import (
            print_condition_numbers,
            replay_iterations,
        )

        for r in replay_iterations(model, prob, params, q_guess, iters):
            print(f"iter {r.k}:")
            print_condition_numbers(r)
    if args.playback:
        import os

        from idto_tpu_torch.utils.playback import export_html

        base, ext = os.path.splitext(args.playback)
        out = export_html(model, sol.q, prob.dt, args.playback,
                          title=f"{args.example} (optimal)")
        print(f"playback written to {out}")
        extras = []
        if cfg.play_initial_guess:
            extras.append((q_guess, "guess"))
        if cfg.play_target_trajectory:
            extras.append((prob.q_nom, "target"))
        for qs, tag in extras:
            out = export_html(model, qs, prob.dt, f"{base}_{tag}{ext}",
                              title=f"{args.example} ({tag})")
            print(f"playback written to {out}")
    if args.profile:
        print(profiler.table_of_averages(args.device))
        profiler.set_enabled(False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
