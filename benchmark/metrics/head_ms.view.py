"""Device ms per frame of the head composite: operations inside
`fourdgs::composite` but not inside `fourdgs::tail` (the record matrix, K4,
the head gather, K1 and the final blend with the background)."""

COMPOSITE, TAIL = "fourdgs::composite", "fourdgs::tail"


def read(ctx):
    if ctx.unit != "frame":
        return None
    ops = [o for o in ctx.trace.ops if COMPOSITE in o["ranges"]
           and TAIL not in o["ranges"]]
    if not ops:
        return None
    return sum(o["dur"] for o in ops) / 1e3 / ctx.trace.n_units
