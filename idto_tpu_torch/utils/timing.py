"""Timing that waits for the GPU (counterpart of
``idto_tpu/utils/timing.py``).

Work on a CUDA tensor returns before the card has done it, so a host clock
around a call measures the launch.  These helpers bracket calls with CUDA
events on the current stream and wait for the last one; on the CPU they
read ``time.perf_counter``.  The JAX package's ``measure_rtt``, which
measured a remote-TPU round trip, has no counterpart.
"""
from __future__ import annotations

import time
from typing import Callable, Sequence

import torch


def _on_cuda(device) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def sync(device=None) -> None:
    """Wait until the work queued on ``device`` (default: the current CUDA
    device, if any) has finished."""
    if _on_cuda(device):
        torch.cuda.synchronize(device)


def _seconds(fn, args, device):
    if _on_cuda(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        return 1e-3 * start.elapsed_time(end)
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def time_fn(fn: Callable, inputs: Sequence[tuple], reps: int = 10,
            device=None) -> float:
    """Median seconds of one call of ``fn`` (CUDA events around each call
    on the GPU), after one warm-up call.  ``inputs`` is a list of argument
    tuples cycled through."""
    fn(*inputs[0])
    sync(device)
    ts = sorted(_seconds(fn, inputs[r % len(inputs)], device)
                for r in range(reps))
    return ts[len(ts) // 2]


def time_throughput(fn: Callable, inputs: Sequence[tuple], calls: int = 10,
                    device=None) -> float:
    """Seconds per call over ``calls`` back-to-back calls with one wait at
    the end: the steady-state rate, launches overlapped with device work."""
    fn(*inputs[0])
    sync(device)

    def chain():
        for r in range(calls):
            fn(*inputs[r % len(inputs)])

    return _seconds(chain, (), device) / calls


def time_chain(fn: Callable, out, calls: int, device=None):
    """``calls`` chained calls ``out = fn(i, out)``, each taking what the
    one before it returned, with one wait at the end: on the GPU a CUDA
    event is recorded before the first call and after each call, on the CPU
    the host clock is read there.  Returns (seconds of the whole chain,
    [seconds of each call], the last call's output)."""
    cuda = _on_cuda(device)

    def mark():
        if not cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    marks = [mark()]
    for i in range(calls):
        out = fn(i, out)
        marks.append(mark())
    if cuda:
        marks[-1].synchronize()
        seconds = [1e-3 * a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        seconds = [b - a for a, b in zip(marks, marks[1:])]
    return sum(seconds), seconds, out
