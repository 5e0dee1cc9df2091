"""95th percentile of every step's host-clock time, from the step's first
call to the end of its synchronise, in milliseconds."""

import numpy as np


def read(ctx):
    steps = ctx["steps"]
    if not len(steps):
        return None
    return float(np.percentile((steps[:, 2] - steps[:, 0]) * 1e3, 95))
