"""setup_s: seconds from the process's start to the first timed operation:
the model build, mpc_initialize or the warm calls, and every graph capture
of the cell's own shapes (host clock)."""


def read(ctx):
    return ctx.setup_s
