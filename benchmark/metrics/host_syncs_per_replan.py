"""host_syncs_per_replan: CUDA runtime calls that block the host (stream,
event and device synchronizations, blocking copies) in the traced stretch
over the replans in it, from the profiler's host trace."""


def read(ctx):
    if ctx.kind != "replan" or ctx.trace is None or not ctx.trace.ops:
        return None
    return ctx.trace.host_syncs / ctx.trace.ops
