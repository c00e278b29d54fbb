"""Device ms per frame of the banded tail: operations inside
`fourdgs::tail` with its nested ranges (band cuts, K3, meta K5, prepass
K6, K7 over both streams, fold, upsample and blend)."""

RANGE = "fourdgs::tail"


def read(ctx):
    if ctx.unit != "frame":
        return None
    ops = [o for o in ctx.trace.ops if RANGE in o["ranges"]]
    if not ops:
        return None
    return sum(o["dur"] for o in ops) / 1e3 / ctx.trace.n_units
