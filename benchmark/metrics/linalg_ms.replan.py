"""linalg_ms.replan: device ms a replan spends in the program's linear
algebra spans (``linalg.*``: gradient, Gauss-Newton Hessian and scaling,
the factorization, the constraint Jacobian, multipliers and Schur LU, the
Newton and Cauchy steps, the dogleg), from the device stamps of the
captured graphs (``yardstick/spans.py``); the mean over set-up's last
settling replans (``spans.replans``)."""
from yardstick import spans


def read(ctx):
    ops = spans.replans(ctx)
    return None if ops is None else spans.mean_ms(ops, "linalg.")
