"""fourdgs_torch — the PyTorch/CUDA port of `fourdgs`.

The JAX package `fourdgs/` is the reference; this package mirrors its layout
(`core/`, `splats/`, `render/`, `ops/`) and names. Plain tensor code is
PyTorch; every kernel the reference wrote in Pallas for the TPU is a CUDA C++
kernel for Hopper (`ops/csrc/`), built with `nvcc` at first use. Each kernel
has a plain PyTorch version in the same module: a wrapper given a CPU tensor
runs that version, a wrapper given a CUDA tensor launches the kernel.

Entry points that make tensors (`Camera.create`, `build_cube_scene`,
`params4d_from_numpy`, `tile_pixel_ndc`) make them on `default_device()`, the
card, unless the caller names a device; CPU callers pass `device="cpu"`.

This package never imports JAX.
"""

import torch


def default_device() -> torch.device:
    """The device of tensors made without an explicit `device`: the card.
    Nothing looks for a GPU and falls back: on a machine without one the
    first allocation raises."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """`device`, or default_device() for None."""
    return default_device() if device is None else torch.device(device)
