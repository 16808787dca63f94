"""linalg_ms.batch: device ms a batch call spends in the program's linear
algebra spans (``linalg.*``), from the device stamps of the captured
graphs (``yardstick/spans.py``); the mean over the calls after the traced
stretch."""
from yardstick import spans


def read(ctx):
    ops = spans.calls(ctx)
    return None if ops is None else spans.mean_ms(ops, "linalg.")
