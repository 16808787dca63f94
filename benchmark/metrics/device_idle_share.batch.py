"""device_idle_share.batch: the share of the traced stretch (whole calls,
from the first call's launch to the device's last operation) in which no
kernel, copy or fill ran on the device, 100 (1 - busy / stretch), from the
profiler trace.  A call runs for seconds, so the milliseconds the
profiler adds to its graph launches do not count here (they do in a
replan: device_idle_share.replan)."""
from yardstick import stats


def read(ctx):
    if ctx.kind != "batch" or ctx.trace is None:
        return None
    return stats.idle_share_percent(ctx.trace.busy_s, ctx.trace.window_s)
