"""physics_ms.replan: device ms a replan spends in the program's physics
spans (``physics.*``: the forces, the exact partials and the cost of
``solve.prepare``, the trial rollout of ``solve.advance``, the closing
forces of ``solve.finish``), each span's time under no named child, from
the device stamps of the captured graphs (``yardstick/spans.py``); the mean
over set-up's last settling replans (``spans.replans``)."""
from yardstick import spans


def read(ctx):
    ops = spans.replans(ctx)
    return None if ops is None else spans.mean_ms(ops, "physics.")
