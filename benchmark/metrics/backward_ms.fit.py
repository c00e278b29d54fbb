"""Device ms per fit step of the backward: operations launched inside
`fourdgs::backward`, inclusive of the ranges nested in it
(`loss.backward()`: the VJPs of the loss, the tail (K9,
`fourdgs::tail_bwd`), the head composite (K8, `fourdgs::composite_bwd`),
the record pack (`fourdgs::pack_bwd`), the eager projection and the
materialization, all launched from autograd's thread while the step's
thread waits inside the range)."""

RANGE = "fourdgs::backward"


def read(ctx):
    if ctx.unit != "step":
        return None
    ops = [o for o in ctx.trace.ops if RANGE in o["ranges"]]
    if not ops:
        return None
    return sum(o["dur"] for o in ops) / 1e3 / ctx.trace.n_units
