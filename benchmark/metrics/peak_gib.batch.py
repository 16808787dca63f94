"""peak_gib.batch: torch.cuda.max_memory_allocated over set-up and the
window (its peak reset at the start, so the graphs' memory pools count),
in GiB."""


def read(ctx):
    if ctx.kind != "batch" or not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 2**30
