"""Mean host-clock time of a step's calls into the drivers, from the
first call until the calls return (before the synchronise), in
milliseconds, over the window's untraced steps."""


def read(ctx):
    steps = ctx["steps"]
    if not len(steps):
        return None
    return float((steps[:, 1] - steps[:, 0]).mean() * 1e3)
