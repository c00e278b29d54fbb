"""Device ms per fit step of the forward: operations launched inside
`fourdgs::forward`, inclusive of the ranges nested in it (the
materialization of the splats, the render's `fourdgs::frame` and the loss
(`fourdgs::loss`))."""

RANGE = "fourdgs::forward"


def read(ctx):
    if ctx.unit != "step":
        return None
    ops = [o for o in ctx.trace.ops if RANGE in o["ranges"]]
    if not ops:
        return None
    return sum(o["dur"] for o in ops) / 1e3 / ctx.trace.n_units
