"""Share, in %, of their roofline that the fit step's hand-written kernels
(K1-K9) reach: the sum of every launch's bound (harness/roofline.py, the
bounds recorded over as many further steps as were profiled) over the sum
of the device time of the launches of hand-written kernels in the profiled
steps. A launch that no recorded wrapper covers adds time and no bound."""


def read(ctx):
    if ctx.unit != "step" or not ctx.bound_s:
        return None
    kernel_us = sum(o["dur"] for o in ctx.trace.ops
                    if ctx.is_kernel(o["name"]))
    if kernel_us <= 0:
        return None
    return 100.0 * ctx.bound_s / (kernel_us / 1e6)
