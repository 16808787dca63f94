"""Velocity-command (joystick) closed-loop MPC (counterpart of
``idto_tpu/examples/velocity_command.py``).

The reference drives the mini cheetah's MPC from a gamepad (left stick:
body-frame vx / vy, right stick: yaw rate; the nominal integrated from the
current pose).  This headless version takes a command schedule on the
command line and runs the same loop: a velocity-command replan, then one
simulated replan period tracking the new plan, with the command a tensor
(a new command costs no host read inside a step).

Usage:
    python -m idto_tpu_torch.examples.velocity_command mini_cheetah \\
        --schedule "0: 0.3 0 0; 2: 0.3 0 0.5; 4: 0 0 0" --sim-time 6 \\
        [--device cuda|cpu] [--live [PORT]] [--playback OUT.html]

Each schedule entry is "t_start: vx vy wz" (body-frame m/s, rad/s).  The
solve runs on the GPU in float64; ``--device cpu`` is the only way to run
it elsewhere.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def parse_schedule(text: str):
    """'0: 0.3 0 0; 2: 0 0 0.5' -> [(0.0, (0.3, 0, 0)), (2.0, (0, 0, 0.5))]."""
    out = []
    for entry in text.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        t_str, cmd_str = entry.split(":")
        vals = [float(x) for x in cmd_str.replace(",", " ").split()]
        if len(vals) != 3:
            raise ValueError(f"need 'vx vy wz' in {entry!r}")
        out.append((float(t_str), tuple(vals)))
    out.sort(key=lambda e: e[0])
    if not out:
        raise ValueError("empty schedule")
    return out


def command_at(schedule, t):
    """The command of the last entry that started at or before t (the
    first entry's before it)."""
    cmd = schedule[0][1]
    for t0, c in schedule:
        if t >= t0:
            cmd = c
    return cmd


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("example", nargs="?", default="mini_cheetah",
                        help="a floating-base example (default mini_cheetah)")
    parser.add_argument("--schedule", default="0: 0.3 0 0",
                        help="'t: vx vy wz; t: vx vy wz; ...'")
    parser.add_argument("--sim-time", type=float, default=None,
                        help="override the YAML sim_time")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the tensors live (default: the GPU)")
    parser.add_argument("--live", default=None, type=int, nargs="?",
                        const=8765, metavar="PORT",
                        help="serve a live WebGL viewer on localhost:PORT "
                             "(default 8765) and stream every replan's plan")
    parser.add_argument("--playback", default=None, metavar="OUT.html",
                        help="export the simulated run as a standalone WebGL "
                             "playback HTML (the sim log at ~50 frames/s)")
    args = parser.parse_args(argv)
    schedule = parse_schedule(args.schedule)

    import torch

    from idto_tpu_torch.examples.registry import load_example, load_sim_plant
    from idto_tpu_torch.mpc.controller import (
        make_mpc_params,
        mpc_initialize,
        mpc_step_velocity_command,
    )
    from idto_tpu_torch.mpc.simulator import simulate_segment
    from idto_tpu_torch.parallel.batching import broadcast_problem

    model, cfg, prob, params, q_guess = load_example(args.example,
                                                     device=args.device)
    if not cfg.mpc:
        raise SystemExit(f"{args.example} has no MPC configuration")
    sim_model, sim_contact = load_sim_plant(args.example, params,
                                            device=args.device)
    sim_model = sim_model if sim_model is not None else model
    sim_contact = sim_contact if sim_contact is not None else params.contact

    replan = 1.0 / cfg.controller_frequency
    h = cfg.sim_time_step
    substeps = max(1, int(round(replan / h)))
    sim_time = args.sim_time if args.sim_time is not None else cfg.sim_time
    num_replans = int(sim_time / replan)
    mpc_params = make_mpc_params(params, cfg.mpc_iters)
    dtype, device = prob.q_init.dtype, prob.q_init.device
    Kp = torch.as_tensor(np.asarray(cfg.Kp, dtype=np.float64), dtype=dtype,
                         device=device)
    Kd = torch.as_tensor(np.asarray(cfg.Kd, dtype=np.float64), dtype=dtype,
                         device=device)
    probs = broadcast_problem(prob, 1)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    viewer = None
    if args.live is not None:
        from idto_tpu_torch.utils.liveview import LiveViewer

        viewer = LiveViewer(model, dt=prob.dt, port=args.live)
        print(f"live viewer: http://localhost:{viewer.port}")

    carry, _ = mpc_initialize(model, probs, params, q_guess[None])
    q, v = prob.q_init[None], prob.v_init[None]
    q_log = [q.cpu().numpy()]
    solve_times = []
    for k in range(num_replans):
        t_now = k * replan
        cmd = torch.tensor(command_at(schedule, t_now), dtype=dtype,
                           device=device)
        # The time as a device tensor: the step and the simulator replay
        # their captured graphs with it (the first replan captures them).
        t_dev = torch.full((), t_now, dtype=dtype, device=device)
        x0 = torch.cat([q, v], dim=1)
        sync()
        t0 = time.perf_counter()
        carry, sol = mpc_step_velocity_command(model, probs, mpc_params,
                                               carry, x0, t_dev, cmd)
        sync()
        solve_times.append(time.perf_counter() - t0)
        if viewer is not None:
            viewer.publish(sol.q[0])
        q, v, log = simulate_segment(sim_model, sim_contact, h, substeps,
                                     carry.stored, Kp, Kd, q, v, t_dev,
                                     cfg.feed_forward)
        q_log.append(log[0][0].cpu().numpy())

    qs = np.concatenate(q_log)
    mean_ms = 1e3 * float(np.mean(solve_times[1:] if len(solve_times) > 1
                                  else solve_times))
    base_xy = qs[-1, 4:6] - qs[0, 4:6]
    print(f"[{args.example}] {num_replans} replans, "
          f"mean solve {mean_ms:.2f} ms ({1e3 / max(mean_ms, 1e-9):.1f} Hz)")
    print(f"base displacement: dx={base_xy[0]:+.3f} m dy={base_xy[1]:+.3f} m")
    if viewer is not None:
        viewer.close()
    if args.playback:
        from idto_tpu_torch.utils.playback import export_html

        # Subsample the simulator's log to ~50 frames a second.
        stride = max(1, int(round(0.02 / h)))
        out = export_html(model, qs[::stride], h * stride, args.playback,
                          title=f"{args.example} velocity-command MPC")
        print(f"playback written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
