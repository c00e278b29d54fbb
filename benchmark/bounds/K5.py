"""K5, the meta pack (`ops/csrc/pack.cu`): the six meta rows read and the
packed rows written."""

from harness.roofline import nbytes


def _pack_meta_rows(args, kw, out):
    return nbytes(*args[:6], out), 0


WRAPPERS = [
    ("fourdgs_torch.ops.pack_cuda", "pack_meta_rows", "K5", _pack_meta_rows),
]
