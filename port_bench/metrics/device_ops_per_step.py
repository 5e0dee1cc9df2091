"""Device records (kernels, copies, fills) of the profiler's active steps,
per step."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.steps or not trace.records:
        return None
    return len(trace.records) / trace.steps
