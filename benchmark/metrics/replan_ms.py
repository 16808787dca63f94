"""replan_ms: the window's length over the replans completed in it, each
ending when the host holds the new plan's first control (host clock over
the whole window)."""


def read(ctx):
    if ctx.kind != "replan":
        return None
    return 1e3 * ctx.window_s / ctx.ops
