"""Device operations launched per frame by the entry and the host's glue:
those with none of the stage ranges (`fourdgs::project`, `bin_sort`,
`composite`, `tail`) open at their launch. In the program that is the
camera's copies (`fourdgs::camera`) and what the render call does between
its stages (`fourdgs::frame`): projection matrix, tile coordinates,
background, assembly and counters. With project_launches, bin_launches,
head_launches and tail_launches it partitions launches_per_frame."""

STAGES = ("fourdgs::project", "fourdgs::bin_sort", "fourdgs::composite",
          "fourdgs::tail")


def read(ctx):
    if ctx.unit != "frame":
        return None
    n = sum(1 for o in ctx.trace.ops
            if not any(s in o["ranges"] for s in STAGES))
    return n / ctx.trace.n_units if n else None
