"""Device ms per frame of the projection: operations launched with
`fourdgs::project` the innermost open range (the 4D slice and EWA
projection, exclusive of nested ranges)."""

RANGE = "fourdgs::project"


def read(ctx):
    if ctx.unit != "frame":
        return None
    ops = [o for o in ctx.trace.ops if o["ranges"]
           and o["ranges"][-1] == RANGE]
    if not ops:
        return None
    return sum(o["dur"] for o in ops) / 1e3 / ctx.trace.n_units
