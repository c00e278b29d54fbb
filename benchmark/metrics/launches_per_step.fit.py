"""Device operations (kernels, copies, sets) launched per traced fit step
inside the program's `fourdgs::fit_step`: the host's launch work, which
paces the step where the device waits. The backward's launches, which
autograd makes from its own thread while the step's thread waits inside
`fourdgs::backward`, count with the step. The loss's read-back, which the
caller makes after the step, does not. The launches under the four
ranges inside the step (`fourdgs::forward`, `backward`, `optimizer`,
`densify`) and those under `fourdgs::fit_step` alone partition it."""

RANGE = "fourdgs::fit_step"


def read(ctx):
    if ctx.unit != "step":
        return None
    n = sum(1 for o in ctx.trace.ops if RANGE in o["ranges"])
    return n / ctx.trace.n_units if n else None
