"""fourdgs_torch — the PyTorch/CUDA port of `fourdgs`.

The JAX package `fourdgs/` is the reference; this package mirrors its layout
(`core/`, `splats/`, `render/`, `ops/`, `train/`, `scenes/`, `io/`,
`viewer/`, `utils/`, `parallel/`; the examples in `examples/`) and names. Plain tensor code is
PyTorch; every kernel the reference wrote in Pallas for the TPU is a CUDA C++
kernel for Hopper (`ops/csrc/`), built with `nvcc` at first use. Each kernel
has a plain PyTorch version in the same module: a wrapper given a CPU tensor
runs that version, a wrapper given a CUDA tensor launches the kernel.

Entry points that make tensors (`Camera.create`, `build_cube_scene`,
`params4d_from_numpy`, `params4d_from_arrays`, `tile_pixel_ndc`, the splat
makers of `splats.gaussians`, the scene generators, `splats_to_params`,
`load_checkpoint`, `densify.init_state`, the viewer CLI and the examples)
make them on `default_device()`, the card, unless the caller names a
device or hands them tensors; CPU callers pass `device="cpu"` (`--cpu` on
the command line).

This package never imports JAX.
"""

import numpy as np
import torch


def default_device() -> torch.device:
    """The device of tensors made without an explicit `device`: the card.
    Nothing looks for a GPU and falls back: on a machine without one the
    first allocation raises."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """`device`, or default_device() for None."""
    return default_device() if device is None else torch.device(device)


def as_tensors(*xs, device=None):
    """The inputs of a tensor maker as tensors. With `device`, all on it.
    Without, tensors stay where they are, and numpy arrays, lists and
    scalars become float32 tensors (as the reference's `jnp.asarray` makes
    them) on the device of the first tensor among the inputs, or on
    default_device() when none is a tensor."""
    if device is None:
        home = next((x.device for x in xs if isinstance(x, torch.Tensor)),
                    None) or default_device()
    else:
        home = torch.device(device)
    return tuple(
        (x if device is None else x.to(home)) if isinstance(x, torch.Tensor)
        else torch.from_numpy(np.array(x, np.float32)).to(home)
        for x in xs)


def __getattr__(name):
    # Lazy, as in the reference: importing the package pulls in no render
    # module.
    if name in ("RenderConfig", "render_splats4d", "render_splats3d",
                "render_splats2d", "render_params4d_packed"):
        from fourdgs_torch.render import pipeline
        return getattr(pipeline, name)
    if name == "auto_render_config":
        from fourdgs_torch.render.autoconfig import auto_render_config
        return auto_render_config
    raise AttributeError(name)
