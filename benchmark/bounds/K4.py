"""K4, the record pack (`ops/csrc/pack.cu`): the ten record fields read and
the records written."""

from harness.roofline import nbytes


def _pack_record_fields(args, kw, out):
    return nbytes(*args[:10], out), 0


WRAPPERS = [
    ("fourdgs_torch.ops.pack_cuda", "pack_record_fields", "K4",
     _pack_record_fields),
]
