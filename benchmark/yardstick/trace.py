"""A profiled stretch of the measured window and its reduction.

With ``--trace 1`` the run profiles a bounded stretch of its window (a
dozen replans, or a few calls) with ``torch.profiler`` (CPU and CUDA
activities), so that the events stay in memory and the trace file stays
small.  Each operation of the stretch runs inside a ``record_function``
range named ``bench.<what>``; the stretch is the span from the first such
range's start to the last one's end, and the last range waits for the
device.  The trace is exported to a temporary Chrome trace, read back and
deleted.

Device activity is every ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
event; its union over the stretch is the busy time.  Host
synchronizations are the blocking CUDA runtime calls inside the
operations' ranges (the closing drain left out).

The profiler slows the host: on the H100 each ``cudaGraphLaunch`` of the
port's graphs takes milliseconds under CUPTI, so a replan's stretch
overstates the time a replan takes (``metrics/device_idle_share.replan``
sets the trace's busy time against the CUDA-event latency of the replans
after the stretch instead).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from collections import defaultdict

from yardstick import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")
SYNC_NAMES = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize",
    "cudaEventSynchronize", "cudaStreamWaitEvent_host", "cudaMemcpy",
})
RANGE_PREFIX = "bench."
TOP = 10


@dataclasses.dataclass
class Summary:
    ops: int  # timed operations (replans or calls) in the stretch
    window_s: float
    busy_s: float
    kernels: int
    host_syncs: int
    device_ops: list  # [[name, seconds], ...], most time first
    idle_gaps: list  # [[what the host was doing, seconds], ...]


def summarize(events, ops: int) -> Summary:
    """Reduce Chrome-trace events (dicts with cat, name, ts, dur in us) of
    a stretch that holds ``ops`` timed operations."""
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith(RANGE_PREFIX)]
    if not ranges:
        raise ValueError("the trace holds no bench.* range")
    lo = min(float(e["ts"]) for e in ranges)
    hi = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in ranges)

    def inside(e):
        return lo <= float(e["ts"]) < hi

    dev = [e for e in events if e.get("cat") in DEVICE_CATS and inside(e)]
    intervals = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                 for e in dev]
    busy_us = stats.union_length(intervals, lo, hi)
    by_name = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += float(e.get("dur", 0.0)) * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    host = sorted((e for e in events if e.get("cat") in HOST_CATS
                   and e.get("ph") == "X"), key=lambda e: float(e["ts"]))
    ops_ranges = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                  for e in ranges if e["name"] != RANGE_PREFIX + "drain"]
    runtime = [e for e in host if e.get("cat") == "cuda_runtime"
               and any(a <= float(e["ts"]) < b for a, b in ops_ranges)]
    labelled = []
    for a, b in stats.gaps(intervals, lo, hi)[:TOP]:
        mid = 0.5 * (a + b)
        around = [e for e in host if float(e["ts"]) <= mid
                  < float(e["ts"]) + float(e.get("dur", 0.0))]
        what = (max(around, key=lambda e: (float(e["ts"]),
                                           -float(e.get("dur", 0.0))))["name"]
                if around else "host: no traced call")
        labelled.append([what, (b - a) * 1e-6])
    return Summary(
        ops=ops,
        window_s=(hi - lo) * 1e-6,
        busy_s=busy_us * 1e-6,
        kernels=sum(1 for e in dev if e.get("cat") == "kernel"),
        host_syncs=sum(1 for e in runtime if e["name"] in SYNC_NAMES),
        device_ops=[[n, s] for n, s in device_ops],
        idle_gaps=labelled,
    )


class Stretch:
    """Profiles the operations between ``start`` and ``stop``; ``reduce``
    reads the events once the window has closed, so that the export does
    not take the window's time."""

    def __init__(self):
        import torch

        self._torch = torch
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
        self.stopped = False
        self.summary = None

    def range(self, what: str):
        return self._torch.profiler.record_function(RANGE_PREFIX + what)

    def start(self):
        self._prof.start()

    def stop(self):
        """Stop profiling; the events wait for ``reduce``."""
        self._prof.stop()
        self.stopped = True

    def reduce(self, ops: int):
        """Export, read back and reduce the stretch (after the window)."""
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "stretch.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self._prof = None
        self.summary = summarize(events, ops)
        return self.summary
