"""K8, the head composite's backward (`ops/csrc/composite_bwd.cu`), where
the converged fit step's backward calls it (inside the autograd Function's
backward): the live records read once and their gradients written once,
the counts, and 26 words a pixel of each tile (the pixel's two
coordinates, the carry in, the forward's carry out and the cotangent, 8
words each); a coverage test for each (live record, pixel) pair, as K1."""

from harness.roofline import PAIR_TEST_OPS, nbytes


def _composite_records_bwd(args, kw, out):
    records, counts, kx = args[0], args[1], args[3]
    n_rec = int(counts.sum())
    tiles, pix = records.shape[0], kx.shape[2]
    moved = (2 * n_rec * records.shape[1] * 4 + nbytes(counts)
             + tiles * pix * 4 * (2 + 8 + 8 + 8))
    return moved, n_rec * pix * PAIR_TEST_OPS


WRAPPERS = [
    ("fourdgs_torch.ops.composite_cuda", "composite_records_bwd", "K8",
     _composite_records_bwd),
]
