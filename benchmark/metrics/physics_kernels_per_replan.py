"""physics_kernels_per_replan: kernel nodes a replan's graphs hold in the
program's physics spans (``physics.*``), counted in each graph at its
capture between the span's stamps (``yardstick/spans.py``); the mean over
set-up's last settling replans (``spans.replans``)."""
from yardstick import spans


def read(ctx):
    ops = spans.replans(ctx)
    return None if ops is None else spans.mean_kernels(ops, "physics.")
