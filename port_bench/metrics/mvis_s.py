"""Visibilities gridded or degridded over the whole window, in millions
a second (a visibility both degridded and gridded in a step counts
twice)."""


def read(ctx):
    steps = ctx["steps"]
    if not len(steps):
        return None
    return len(steps) * ctx["vis_per_step"] / ctx["window_s"] / 1e6
