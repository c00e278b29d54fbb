"""Device ms per frame of the binning: operations launched inside
`fourdgs::bin_sort`, with its nested ranges (emit, depth prune, row sort,
global sort, CSR and head re-cut)."""

RANGE = "fourdgs::bin_sort"


def read(ctx):
    if ctx.unit != "frame":
        return None
    ops = [o for o in ctx.trace.ops if RANGE in o["ranges"]]
    if not ops:
        return None
    return sum(o["dur"] for o in ops) / 1e3 / ctx.trace.n_units
