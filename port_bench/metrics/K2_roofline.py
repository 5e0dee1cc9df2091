"""K2's share of its roofline: least time (`_roofline`) over the mean
device time of its traced launches, in percent."""

from port_bench.metrics._roofline import share


def read(ctx):
    return share(ctx, "K2")
