"""K1, the head composite (`ops/csrc/composite.cu`), where the converged
frame calls it: the live records once, the counts, and 18 words a pixel
of each tile; a coverage test for each (live record, pixel) pair."""

from harness.roofline import PAIR_TEST_OPS, nbytes


def _composite_records(args, kw, out):
    records, counts, kx = args[0], args[1], args[2]
    n_rec = int(counts.sum())
    tiles, pix = records.shape[0], kx.shape[2]
    moved = (n_rec * records.shape[1] * 4 + nbytes(counts)
             + tiles * pix * 4 * (2 + 8 + 8))
    return moved, n_rec * pix * PAIR_TEST_OPS


WRAPPERS = [
    ("fourdgs_torch.render.pipeline", "composite_records", "K1",
     _composite_records),
]
