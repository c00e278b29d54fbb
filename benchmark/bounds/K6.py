"""K6, the tail prepass (`ops/csrc/tail_prepass.cu`)."""

from harness.roofline import nbytes


def _tail_prepass(args, kw, out):
    meta, cuts = args[0], args[1]
    # The span row, the cut table and the outputs.
    return meta.shape[1] * 4 + nbytes(cuts, *out), 0


WRAPPERS = [
    ("fourdgs_torch.ops.tail_cuda", "tail_prepass", "K6", _tail_prepass),
]
