"""outside_regions_ms.replan: device ms between a replan's first stamp
(``mpc.replan_start``'s entry) and its last (``mpc.store``'s exit) that
lie in no captured region: the input copies into the graphs' static
buffers, the output clones, graph launch latency and the device waiting
for the host (``yardstick/spans.py``); the mean over set-up's last settling
replans, which no profiler preceded (``spans.replans``)."""
from yardstick import spans


def read(ctx):
    ops = spans.replans(ctx)
    if ops is None:
        return None
    return sum(op.outside_ms for op in ops) / len(ops)
