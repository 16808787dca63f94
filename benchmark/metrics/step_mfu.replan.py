"""step_mfu.replan: the whole step's share of the card's FP64 tensor-core
peak (67 TFLOP/s, SXM data sheet): the configuration's frozen
flops_per_solve times the solves completed after the traced stretch, over
the seconds they took, in %."""
from yardstick import stats


def read(ctx):
    if ctx.kind != "replan" or ctx.rate_solves <= 0:
        return None
    return stats.mfu_percent(ctx.config["flops_per_solve"]["value"],
                             ctx.rate_solves, ctx.rate_window_s,
                             ctx.peak_flops)
