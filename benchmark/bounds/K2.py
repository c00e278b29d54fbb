"""K2, the row sort and keep (`ops/csrc/rowsort.cu`): a bitonic network
over each row's keys, and the kept slots written."""

from harness.roofline import CMPX_OPS, nbytes


def _rowsort_compact(args, kw, out):
    key, val, keep = args[:3]
    row_len = kw.get("row_len", args[3] if len(args) > 3 else 8192)
    cut = kw.get("cut", args[4] if len(args) > 4 else None)
    ok, ov, _ = out
    rows = ok.shape[1]
    stages = row_len.bit_length() * (row_len.bit_length() - 1) // 2
    # Every key and the cut table once, both outputs and the live counts,
    # and the kept slots' values read once.
    moved = nbytes(key, cut) + rows * 4 + 2 * nbytes(ok) + nbytes(ov)
    return moved, rows * (row_len // 2) * stages * CMPX_OPS


WRAPPERS = [
    ("fourdgs_torch.render.tiles", "rowsort_compact", "K2", _rowsort_compact),
]
