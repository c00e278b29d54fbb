"""Device ms per frame of the tail's plain set-up: operations launched with
`fourdgs::tail_setup` open (the splats' tile boxes, the band clip, the
depth bits, K3's sample, the band cuts and the kernels' constants), apart
from the tail's kernels K6 and K7 and its combine."""

RANGE = "fourdgs::tail_setup"


def read(ctx):
    if ctx.unit != "frame":
        return None
    ops = [o for o in ctx.trace.ops if RANGE in o["ranges"]]
    if not ops:
        return None
    return sum(o["dur"] for o in ops) / 1e3 / ctx.trace.n_units
