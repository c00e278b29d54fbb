"""Device operations launched per frame by the binning: those with
`fourdgs::bin_sort` open at their launch (emit, depth prune, row sort,
global sort, CSR and head re-cut)."""

RANGE = "fourdgs::bin_sort"


def read(ctx):
    if ctx.unit != "frame":
        return None
    n = sum(1 for o in ctx.trace.ops if RANGE in o["ranges"])
    return n / ctx.trace.n_units if n else None
