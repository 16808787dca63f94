"""One run of one cell: set-up, the measured window, the metrics, the
check, the result line.

The window starts once set-up has ended: every shape of the cell warmed
up and captured, the device idle.  It runs operations back to back until
``seconds`` have passed on the host clock and ends when the last one has
completed.  No graph may be captured inside it (the port's capture
counter is read before and after).  With ``trace`` a stretch of it is
profiled (``trace.py``), and a traced run's rates are taken over the part
of the window after the stretch, which starts with the device idle.
"""
from __future__ import annotations

import time
import types

import torch

from yardstick import card, correct, manifest, program, traffic
from yardstick.trace import Stretch

# Operations of the window before its traced stretch starts.
TRACE_LEAD = 1


def run_window(drv, seconds: float, trace_ops: int = 0, lead: int = 0):
    """Operations until ``seconds`` have passed.  Returns (window seconds,
    operations, the traced stretch's summary or None, seconds and
    operations after the stretch).  The stretch begins after ``lead``
    operations and ends with the device idle, so the part of the window
    after it is clean of the profiler."""
    drv.drain()
    t0 = time.perf_counter()
    n, stretch = 0, None
    t_after, n_after = t0, 0
    while True:
        if trace_ops and n == lead and stretch is None:
            stretch = Stretch()
            stretch.start()
        if stretch is not None and not stretch.stopped:
            with stretch.range(drv.kind):
                drv.step()
            if n + 1 == lead + trace_ops:
                with stretch.range("drain"):
                    drv.drain()
                stretch.stop()
                t_after, n_after = time.perf_counter(), n + 1
        else:
            drv.step()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    traced = trace_ops
    if stretch is not None and not stretch.stopped:
        with stretch.range("drain"):
            drv.drain()
        stretch.stop()
        traced = n - lead
        t_after, n_after = time.perf_counter(), n
    drv.drain()
    t_end = time.perf_counter()
    summary = stretch.reduce(traced) if stretch is not None else None
    return t_end - t0, n, summary, t_end - t_after, n - n_after


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device, t_process: float, prog=program, check=True):
    """(result dictionary, the check's lines for standard error)."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    drv = traffic.start(prog, cell.config, cell.traffic, seed, device)
    drv.drain()
    setup_s = time.perf_counter() - t_process
    by_region = prog.capture_seconds_by_region()
    captured = prog.captures()

    window, ops, summary, rate_window, rate_ops = run_window(
        drv, seconds, int(cell.traffic["trace_ops"]) if trace else 0,
        TRACE_LEAD)
    if prog.captures() != captured:
        raise RuntimeError("a graph was captured inside the measured window")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    attempted, failed = drv.outputs_finite()
    latencies = drv.latency_seconds()
    ctx = types.SimpleNamespace(
        kind=drv.kind, config=cell.config, setup_s=setup_s,
        capture_s=sum(by_region.values()), window_s=window, ops=ops,
        solves=ops * drv.solves_per_op,
        rate_window_s=rate_window,
        rate_solves=rate_ops * drv.solves_per_op,
        solves_per_op=drv.solves_per_op,
        latencies_s=latencies,
        rate_latencies_s=latencies[len(latencies) - rate_ops:]
        if rate_ops else [],
        peak_bytes=peak, trace=summary,
        peak_flops=card.FP64_TENSOR_PEAK_FLOPS)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.reader(m.name)(ctx)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}

    drv.release()
    prog.release()
    checks, t_check = {}, time.perf_counter()
    if check:
        checks = correct.judge(correct.readings(drv, cell, seed, device),
                               cell.limits)
    t_check = time.perf_counter() - t_check
    ok = failed == 0 and bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values())
    result = {
        "correct": ok,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": (card.device_record(cell.chips, peak) if cuda else
                   {"platform": "cpu", "kind": "cpu", "count": 0,
                    "memory_peak_bytes": 0}),
    }
    if trace and summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["check_s"] = t_check
    result["checks"] = checks
    lines = ["capture seconds by region: " + ", ".join(
        f"{k} {v:.3f}" for k, v in by_region.items())]
    lines += [f"check {name}: {c['value']:.6e} (limit {c['limit']:.3e})"
             for name, c in checks.items()]
    lines.append(f"check non-finite outputs: {failed} of {attempted} "
                 "(limit 0)")
    return result, lines
