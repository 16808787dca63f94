"""capsule_kernels_per_replan: kernel nodes a replan's graphs hold in the
search along a capsule's axis (``physics.capsule_search``), counted in
each graph at its capture between the span's stamps
(``yardstick/spans.py``); the mean over set-up's last settling replans
(``spans.replans``).  None where no replan stamped that span (a model
without capsule pairs, or a program without the span)."""
from yardstick import spans

SPAN = "physics.capsule_search"


def read(ctx):
    ops = spans.replans(ctx)
    if ops is None or not any(SPAN in op.span_ms for op in ops):
        return None
    return spans.mean_kernels(ops, SPAN)
