"""K16, the quantized binning's pair-slot emission (`ops/csrc/emit.cu`), two
launches a band. The main launch reads the 7 float32 fields of the bbox and
the depth bits (mx my depth v0x v0y l0 l1) and `valid` (one byte) of every
splat, and writes its `budget` slots (an int32 key and an int32 splat index
each) and, with the big tier, its is-big byte: 29 + 8 * budget + 1 B a
splat. The big-tier launch reads the kept ids and the 7 fields at each, and
writes `big_budget` slots an id and the overflow count. Its operations (the
bbox and a few a slot) lie well under the bytes' bound and are not
counted."""

from harness.roofline import nbytes

FIELDS = ("mx", "my", "depth", "v0x", "v0y", "l0", "l1")


def _emit_pair_keys(args, kw, out):
    proj, budget = args[0], args[7]
    n = proj.mx.numel()
    return (nbytes(*(getattr(proj, k) for k in FIELDS), proj.valid, out[3])
            + 8 * budget * n), 0


def _emit_big_pair_keys(args, kw, out):
    big_budget, ids = args[7], args[8]
    m = ids.numel()
    # The count is read and written once.
    return (nbytes(ids) + 2 * nbytes(out)
            + (4 * len(FIELDS) + 8 * big_budget) * m), 0


WRAPPERS = [
    ("fourdgs_torch.render.tiles", "emit_pair_keys", "K16", _emit_pair_keys),
    ("fourdgs_torch.render.tiles", "emit_big_pair_keys", "K16",
     _emit_big_pair_keys),
]
