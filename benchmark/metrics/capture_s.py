"""capture_s: seconds of eager warm-ups and CUDA graph captures in set-up,
the sum of the port's graphs.capture_seconds counter."""


def read(ctx):
    return ctx.capture_s
