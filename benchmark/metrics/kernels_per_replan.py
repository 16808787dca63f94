"""kernels_per_replan: device kernels in the traced stretch over the
replans in it, from the profiler's device trace."""


def read(ctx):
    if ctx.kind != "replan" or ctx.trace is None or not ctx.trace.ops:
        return None
    return ctx.trace.kernels / ctx.trace.ops
