"""Device ms per fit step of the optimizer: operations launched inside
`fourdgs::optimizer`, inclusive of the ranges nested in it (zero_grad and
Adam's step)."""

RANGE = "fourdgs::optimizer"


def read(ctx):
    if ctx.unit != "step":
        return None
    ops = [o for o in ctx.trace.ops if RANGE in o["ranges"]]
    if not ops:
        return None
    return sum(o["dur"] for o in ops) / 1e3 / ctx.trace.n_units
