"""The device's idle share of a frame, in %: 1 - (busy ms per frame, the
union of the profiled frames' device intervals) / (wall ms per frame of the
same run's unprofiled window). The profiler's own host cost stays out of
the denominator."""


def read(ctx):
    if ctx.unit != "frame" or not ctx.trace.ops or not ctx.wall_ms_per_unit:
        return None
    busy_ms = ctx.trace.busy_us() / 1e3 / ctx.trace.n_units
    return 100.0 * (1.0 - busy_ms / ctx.wall_ms_per_unit)
