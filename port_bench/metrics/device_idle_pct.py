"""Percent of the traced window (first device record to last) that no
device record covers."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.records or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
