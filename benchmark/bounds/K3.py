"""K3, the block sampler (`ops/csrc/sample_blocks.cu`), at both of its call
sites: the binning's and the tail's."""

from harness.roofline import nbytes


def _sample_blocks(args, kw, out):
    # The function reads only the sampled words and writes them.
    return 2 * nbytes(*out), 0


WRAPPERS = [
    ("fourdgs_torch.render.tiles", "sample_blocks", "K3", _sample_blocks),
    ("fourdgs_torch.render.pipeline", "sample_blocks", "K3", _sample_blocks),
]
