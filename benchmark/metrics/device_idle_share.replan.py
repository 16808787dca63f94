"""device_idle_share.replan: the share of a replan's time in which no
kernel, copy or fill ran on the device: 100 (1 - busy / latency), with
busy the device's busy time per replan in the traced stretch (profiler
trace) and latency the mean of the replans' latencies after the stretch,
each from a CUDA event recorded before the replan to one recorded once
the host holds its control (both on the device's clock).  The profiler
adds milliseconds to each graph launch, about 40% of a replan on the
H100, so the traced replans' own length is not the program's."""
from yardstick import stats


def read(ctx):
    if ctx.kind != "replan" or ctx.trace is None or not ctx.rate_latencies_s:
        return None
    latency = sum(ctx.rate_latencies_s) / len(ctx.rate_latencies_s)
    return stats.idle_share_percent(ctx.trace.busy_s / ctx.trace.ops, latency)
