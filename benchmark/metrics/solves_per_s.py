"""solves_per_s: scenario solves (one warm-started Gauss-Newton iteration
of one scenario) completed over the window, which ends on a call's
completion (host clock over the whole window)."""


def read(ctx):
    if ctx.kind != "batch":
        return None
    return ctx.solves / ctx.window_s
