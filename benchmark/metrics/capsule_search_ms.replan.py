"""capsule_search_ms.replan: device ms a replan spends in the search along
a capsule's axis (``physics.capsule_search``: against a box the bisection
on the distance's slope and its Newton correction, under the forces, the
exact partials and the trial rollout), under no named child, from the
device stamps of the captured graphs (``yardstick/spans.py``); the mean
over set-up's last settling replans (``spans.replans``).  None where no
replan stamped that span (a model without capsule pairs, or a program
without the span)."""
from yardstick import spans

SPAN = "physics.capsule_search"


def read(ctx):
    ops = spans.replans(ctx)
    if ops is None or not any(SPAN in op.span_ms for op in ops):
        return None
    return spans.mean_ms(ops, SPAN)
