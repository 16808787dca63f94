"""Per-iteration wall time of a solve (counterpart of
``idto_tpu/optimizer/itimer.py``).

With ``SolverParameters.record_iteration_times`` the solve loop calls
:func:`reset` before its first iteration and :func:`mark` at the end of
each one.  On the GPU each call records a CUDA event on the current stream
and nothing waits for it inside the loop; :func:`collect` reads the events
once, after the solve.  The events go between graph replays, never into a
capture (a timing event cannot be captured): the loop marks an iteration
after its replay.  On the CPU they read ``time.perf_counter``.  The
first duration runs from :func:`reset`, each later one from the previous
mark.  A batched solve has one clock for all its scenarios; :func:`attach`
gives each scenario the times of the batch iterations it ran.
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

_marks: list = []
_start = None


def _stamp(device):
    if device is not None and torch.device(device).type == "cuda":
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the iteration timer inside a graph capture")
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def reset(device=None) -> None:
    """Start a capture window on ``device`` (the CPU when None)."""
    global _start
    _marks.clear()
    _start = _stamp(device)


def mark() -> None:
    """Record the end of one iteration, on the clock :func:`reset` chose."""
    if _start is None:
        return
    _marks.append(_stamp("cuda") if isinstance(_start, torch.cuda.Event)
                  else time.perf_counter())


def collect() -> List[float]:
    """Per-iteration durations in seconds since the last :func:`reset`;
    empty if it was never called or no iteration ran."""
    if _start is None or not _marks:
        return []
    stamps = [_start] + _marks
    if isinstance(_start, torch.cuda.Event):
        _marks[-1].synchronize()
        return [1e-3 * a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]
    return [b - a for a, b in zip(stamps, stamps[1:])]


def attach(stats):
    """``stats`` with its ``time`` filled from :func:`collect`: entry k of
    a scenario's row is the time of batch iteration k, for each k below
    that scenario's ``num_iters``, and NaN past them.  ``time`` is
    (max_iters,) or (B, max_iters) with ``num_iters`` () or (B,)."""
    times = collect()
    if not times:
        return stats
    t = stats.time
    row = np.full(t.shape[-1], np.nan)
    n = min(len(times), row.size)
    row[:n] = times[:n]
    row = torch.as_tensor(row, dtype=t.dtype, device=t.device)
    ran = (torch.arange(t.shape[-1], device=t.device)
           < stats.num_iters.to(t.device)[..., None])
    return stats.replace(time=torch.where(ran, row, torch.full_like(row,
                                                                    np.nan)))
