"""Device ms of a degrid pass outside the degrid kernel (``_glue``)."""

from port_bench.metrics._glue import glue_ms


def read(ctx):
    return glue_ms(ctx, "degrid")
