"""The benchmark's door to the program's spans
(``idto_tpu_torch/utils/profiler.py``): the device stamps of every captured
region and of the named spans inside it, kept in a ring in the program's
own memory and read here after the window, before the program is released.

:func:`newest` copies the ring to the host once and groups its records into
operations: a replan opens at the first stamp of ``mpc.replan_start``, a
batch call at the first stamp of ``solve.start``, and each runs until the
next one opens.  A program without spans (an earlier commit) gives None,
so a metric that reads them is left out of the line.  This module imports
``idto_tpu_torch`` only.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

OPENERS = {"replan": "mpc.replan_start", "batch": "solve.start"}

# Replans read: the last of set-up's settling replans, not the window's.
# Once a torch.profiler has run in the process, the host takes ~10 ms
# longer to launch ``solve.prepare``'s graph, so a traced run's replans
# after its stretch wait that long outside the regions; their device time
# inside the regions is the same.
SETTLED = 100


@dataclasses.dataclass
class Operation:
    """One operation's device time and kernels, from its stamps."""

    span_ms: dict  # span or region name -> device ms under no named child
    outside_ms: float  # first to last stamp, in no region
    kernels: dict  # span or region name -> kernel nodes under no child


def read_program():
    """(records ever written, the ring's records in order, the site table)
    of the program, or None where it has no spans."""
    try:
        from idto_tpu_torch.utils import profiler
    except ImportError:
        return None
    if not hasattr(profiler, "device_records"):
        return None
    got = profiler.device_records()
    if got is None:
        return None
    return got[0], got[1], profiler.sites, profiler.intervals


def operations(count, records, sites, intervals, kind, n):
    """The newest ``n`` operations of ``kind`` in ``records`` (the ring's
    newest records of ``count`` written, oldest first), oldest first.
    Raises where the ring holds fewer than ``n`` of them: it overwrote
    them, or they never ran."""
    opener = OPENERS[kind]
    starts = [pos for pos, code in enumerate(records[:, 0].tolist())
              if not code & 1 and sites[code >> 1].parent == -1
              and sites[code >> 1].name == opener]
    if len(starts) < n:
        lost = count - len(records)
        raise RuntimeError(
            f"the span ring holds {len(starts)} {kind} operations of the "
            f"{n} asked for" + (f"; it overwrote its {lost} oldest records"
                                if lost else ""))
    starts = starts[len(starts) - n:]
    ends = starts[1:] + [len(records)]
    return [_operation(records[a:b], sites, intervals)
            for a, b in zip(starts, ends)]


def _operation(records, sites, intervals) -> Operation:
    ivs = intervals(records)
    ids = {iv[0] for iv in ivs}
    captured = all(sites[i].kernels is not None for i in ids)
    below = defaultdict(int)  # site -> kernel nodes of its child spans
    if captured:
        for i in ids:
            if sites[i].parent != -1:
                below[sites[i].parent] += sites[i].kernels + 2
    span_ns, kernels = defaultdict(int), defaultdict(int)
    inside_ns = 0
    for site, _, t0, t1, self_ns in ivs:
        s = sites[site]
        span_ns[s.name] += self_ns
        if captured:
            kernels[s.name] += s.kernels - below[site]
        if s.parent == -1:
            inside_ns += t1 - t0
    first, last = int(records[0, 1]), int(records[-1, 1])
    return Operation(
        span_ms={k: 1e-6 * v for k, v in span_ns.items()},
        outside_ms=1e-6 * (last - first - inside_ns),
        kernels=dict(kernels) if captured else None)


def newest(kind: str, n: int):
    """The program's newest ``n`` operations of ``kind`` (``replan`` or
    ``batch``), or None where the program has no spans or ``n`` < 1."""
    got = read_program()
    if got is None or n < 1:
        return None
    return operations(*got, kind, n)


def mean_ms(ops, prefix: str) -> float:
    """Mean over ``ops`` of the device ms of the spans named ``prefix``*."""
    return sum(sum(v for k, v in op.span_ms.items() if k.startswith(prefix))
               for op in ops) / len(ops)


def mean_kernels(ops, prefix: str):
    """Mean over ``ops`` of the kernel nodes of the spans named
    ``prefix``*, or None where a span was not captured."""
    if any(op.kernels is None for op in ops):
        return None
    return sum(sum(v for k, v in op.kernels.items() if k.startswith(prefix))
               for op in ops) / len(ops)


def replans(ctx):
    """Set-up's last :data:`SETTLED` replans, which ran settled and
    untraced just before the window, or None."""
    if ctx.kind != "replan" or not ctx.ops:
        return None
    ops = newest("replan", ctx.ops + SETTLED)
    return None if ops is None else ops[:SETTLED]


def calls(ctx):
    """The batch calls after the traced stretch (the profiler does not move
    a call's device time in its regions), or None."""
    if ctx.kind != "batch" or ctx.solves_per_op <= 0:
        return None
    return newest("batch", round(ctx.rate_solves / ctx.solves_per_op))
