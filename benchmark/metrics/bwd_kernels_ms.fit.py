"""Device ms per fit step of the backward's hand-written kernels: K8, the
head composite's backward (`composite_bwd_kernel`, once a step), and K9,
the tail accumulate's backward (`tail_bwd_kernel`, once for the main stream
and once for the big tier)."""

import re

KERNELS = re.compile(r"(?<![A-Za-z_])(composite_bwd_kernel|tail_bwd_kernel)"
                     r"(?![a-z_])")


def read(ctx):
    if ctx.unit != "step":
        return None
    ops = [o for o in ctx.trace.ops if KERNELS.search(o["name"])]
    if not ops:
        return None
    return sum(o["dur"] for o in ops) / 1e3 / ctx.trace.n_units
