"""Arithmetic of the metrics, kept apart so that tests can hold it."""
from __future__ import annotations

import math


def percentile(xs, p):
    """The p-th percentile of xs by the nearest rank (``bench_torch.py``'s
    rule): the smallest value with at least p% of the values at or below
    it."""
    if not xs:
        raise ValueError("percentile of no values")
    xs = sorted(xs)
    rank = max(1, math.ceil(p / 100.0 * len(xs)))
    return xs[min(len(xs), rank) - 1]


def union_length(intervals, lo, hi):
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    spans = sorted((max(a, lo), min(b, hi)) for a, b in intervals
                   if min(b, hi) > max(a, lo))
    total, cur_a, cur_b = 0.0, None, None
    for a, b in spans:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def gaps(intervals, lo, hi):
    """The idle gaps [a, b) of [lo, hi) that no interval covers, longest
    first."""
    spans = sorted((max(a, lo), min(b, hi)) for a, b in intervals
                   if min(b, hi) > max(a, lo))
    out, cur = [], lo
    for a, b in spans:
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return sorted(out, key=lambda g: g[0] - g[1])


def idle_share_percent(busy_s, window_s):
    """100 (1 - busy / window)."""
    return 100.0 * (1.0 - busy_s / window_s)


def mfu_percent(flops_per_solve, solves, window_s, peak_flops):
    """The whole step's share of the peak: counted operations of the
    solves completed over the window, against the peak rate, in %."""
    return 100.0 * flops_per_solve * solves / window_s / peak_flops
