"""Device operations (kernels, copies, sets) launched per traced frame: the
host's launch work, which paces the frame where the device waits."""


def read(ctx):
    if ctx.unit != "frame" or not ctx.trace.ops:
        return None
    return len(ctx.trace.ops) / ctx.trace.n_units
