"""Scope-based host-side profiler (the port's own copy of
``idto_tpu/utils/profiler.py``, which has no JAX in it).

Analog of the reference's ``INSTRUMENT_FUNCTION`` / ``TableOfAverages``
instrumentation (utils/profiler.h:165-235): nested scope timers with
self-time attribution and an averaged report table.  The timers read the
host clock: a scope that launches GPU work and does not wait for it
measures the launches; ``torch.profiler`` or CUDA events
(``utils/timing.py``) measure the device.

Usage:
    with instrument("solve"):
        ...
    print(table_of_averages())

Enabled by default (cheap); disable globally with set_enabled(False) --
the analog of the reference's ENABLE_TIMERS compile-time flag.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass


@dataclass
class _Timer:
    samples: int = 0
    total: float = 0.0
    child_time: float = 0.0

    @property
    def self_total(self) -> float:
        return self.total - self.child_time


_timers: dict[str, _Timer] = {}
_stack: list[tuple[str, float]] = []
_enabled = True


def set_enabled(flag: bool) -> None:
    global _enabled
    _enabled = flag


def reset() -> None:
    _timers.clear()
    _stack.clear()


@contextlib.contextmanager
def instrument(name: str):
    if not _enabled:
        yield
        return
    start = time.perf_counter()
    _stack.append((name, start))
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        _stack.pop()
        t = _timers.setdefault(name, _Timer())
        t.samples += 1
        t.total += elapsed
        if _stack:
            parent = _timers.setdefault(_stack[-1][0], _Timer())
            parent.child_time += elapsed


def table_of_averages() -> str:
    """Formatted report: time/sample, samples, total, self-time share
    (reference: TableOfAverages, utils/profiler.cc)."""
    if not _timers:
        return "(no instrumented scopes)"
    lines = [
        f"{'scope':<40} {'ms/sample':>12} {'samples':>8} "
        f"{'total s':>10} {'self %':>8}"
    ]
    for name, t in sorted(
        _timers.items(), key=lambda kv: -kv[1].total
    ):
        per = 1e3 * t.total / max(t.samples, 1)
        selfpct = 100.0 * t.self_total / max(t.total, 1e-12)
        lines.append(
            f"{name:<40} {per:>12.3f} {t.samples:>8} "
            f"{t.total:>10.3f} {selfpct:>8.1f}"
        )
    return "\n".join(lines)
