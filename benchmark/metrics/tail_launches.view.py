"""Device operations launched per frame by the banded tail: those with
`fourdgs::tail` open at their launch (its set-up, K6, K7 over both
streams and the combine)."""

RANGE = "fourdgs::tail"


def read(ctx):
    if ctx.unit != "frame":
        return None
    n = sum(1 for o in ctx.trace.ops if RANGE in o["ranges"])
    return n / ctx.trace.n_units if n else None
