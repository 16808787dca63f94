"""Does the port's timing wait for the card?  (Counterpart of
``scripts/calibrate_timing.py``.)

    python3 scripts/bench_torch_calibrate_timing.py [--device {cuda,cpu}]

Times a chain of 8 float32 4096 x 4096 products (``tanh(x @ w)``, TF32
off, so the products run at the float32 rate of the FMA pipes), whose
operation count is known, three ways:

  1. enqueue only: the host clock around the calls, no wait;
  2. synchronize: the host clock around the calls and
     ``torch.cuda.synchronize()``, the wait ``bench_torch.py`` ends with;
  3. CUDA events before and after the calls, as ``utils/timing.py`` times.

The rate from (2) must sit below the card's float32 peak (66.9 TFLOP/s,
``chip_smoke.PEAK_FLOPS``): a rate above it would mean the wait returned
before the work was done.  Prints one JSON line naming the card and its
power limit, and exits non-zero if (2) is above the peak.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import torch

from bench_torch import card
from chip_smoke import PEAK_FLOPS

N = 4096
CHAIN = 8
FLOPS = 2 * N * N * N * CHAIN
REPS = 5


def chain(x, w):
    for _ in range(CHAIN):
        x = torch.tanh(x @ w)
    return x


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    on_cuda = args.device == "cuda"
    if on_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    name, watts, smi = card(args.device)
    gen = torch.Generator(device=args.device).manual_seed(0)
    x = torch.randn((N, N), generator=gen, device=args.device) / N**0.5
    w = torch.randn((N, N), generator=gen, device=args.device) / N**0.5

    def wait():
        if on_cuda:
            torch.cuda.synchronize()

    chain(x, w)
    wait()

    t0 = time.perf_counter()
    for _ in range(REPS):
        chain(x, w)
    t_enqueue = (time.perf_counter() - t0) / REPS
    wait()

    t0 = time.perf_counter()
    for _ in range(REPS):
        chain(x, w)
    wait()
    t_sync = (time.perf_counter() - t0) / REPS

    if on_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            chain(x, w)
        end.record()
        end.synchronize()
        t_events = 1e-3 * start.elapsed_time(end) / REPS
    else:
        t_events = None

    peak = max(PEAK_FLOPS[4].values())
    res = {
        "device": name, "power_limit_w": watts, "nvidia_smi": smi,
        "flops_per_call": FLOPS, "reps": REPS,
        "enqueue_ms": 1e3 * t_enqueue,
        "sync_ms": 1e3 * t_sync,
        "events_ms": None if t_events is None else 1e3 * t_events,
        "sync_tflops": FLOPS / t_sync / 1e12,
        "events_tflops": None if t_events is None
        else FLOPS / t_events / 1e12,
        "float32_peak_tflops": peak / 1e12,
        "sync_below_peak": FLOPS / t_sync < peak,
    }
    print(json.dumps(res), flush=True)
    if on_cuda and not res["sync_below_peak"]:
        raise SystemExit("the synchronized rate is above the float32 peak: "
                         "the wait did not wait")


if __name__ == "__main__":
    main()
