"""Device operations launched per frame by the head composite: those with
`fourdgs::composite` open at their launch and `fourdgs::tail` not open."""

COMPOSITE, TAIL = "fourdgs::composite", "fourdgs::tail"


def read(ctx):
    if ctx.unit != "frame":
        return None
    n = sum(1 for o in ctx.trace.ops
            if COMPOSITE in o["ranges"] and TAIL not in o["ranges"])
    return n / ctx.trace.n_units if n else None
