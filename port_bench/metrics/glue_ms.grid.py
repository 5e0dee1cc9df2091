"""Device ms of a grid pass outside the stack kernel (``_glue``)."""

from port_bench.metrics._glue import glue_ms


def read(ctx):
    return glue_ms(ctx, "grid")
