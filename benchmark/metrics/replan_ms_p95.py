"""replan_ms_p95: the 95th percentile, by the nearest rank, of every
window replan's latency, each from a CUDA event recorded before the replan
to one recorded once the host holds its control (device clock)."""
from yardstick import stats


def read(ctx):
    if ctx.kind != "replan" or not ctx.latencies_s:
        return None
    return 1e3 * stats.percentile(ctx.latencies_s, 95)
