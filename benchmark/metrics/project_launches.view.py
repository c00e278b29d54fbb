"""Device operations launched per frame by the projection: those with
`fourdgs::project` among the ranges open at their launch."""

RANGE = "fourdgs::project"


def read(ctx):
    if ctx.unit != "frame":
        return None
    n = sum(1 for o in ctx.trace.ops if RANGE in o["ranges"])
    return n / ctx.trace.n_units if n else None
