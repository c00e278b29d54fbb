"""K15, the packed frame's projection (`ops/csrc/project4d.cu`): the 16
float32 fields it reads, the 9 float32 fields it writes and `valid` (one
byte): 101 B a splat. The colours pass through unread and count nothing.
Its operations (the 4D covariance, the time slice and the EWA projection,
some hundreds a splat) lie well under the bytes' bound and are not
counted."""

from harness.roofline import nbytes

INPUT_FIELDS = ("px", "py", "pz", "pt", "qw", "qx", "qy", "qz", "sx", "sy",
                "sz", "lifetime", "fade", "vx", "vy", "vz")
OUTPUT_FIELDS = ("mx", "my", "depth", "view_z", "v0x", "v0y", "l0", "l1",
                 "opacity", "valid")


def _project_params4d(args, kw, out):
    params = args[0]
    return nbytes(*(params[k] for k in INPUT_FIELDS),
                  *(getattr(out, k) for k in OUTPUT_FIELDS)), 0


WRAPPERS = [
    ("fourdgs_torch.render.pipeline", "project_params4d", "K15",
     _project_params4d),
]
