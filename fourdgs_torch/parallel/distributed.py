"""The trainer's parameter dict and the splats it stands for (port of
fourdgs/parallel/distributed.py:533-552, `materialize_splats` and
`splats_to_params`).

The rest of the reference module, the sharded render and train step over a
("data", "tile") device mesh, is not ported yet (ROADMAP.md, Queue A item
6).
"""

from __future__ import annotations

from typing import Dict

import torch

from fourdgs_torch import as_tensors
from fourdgs_torch.splats.gaussians import Splats4D

PARAM_FIELDS = ("position4", "quat", "scale3", "lifetime", "fade",
                "velocity", "color")


def _abs(x: torch.Tensor) -> torch.Tensor:
    # jnp.abs's gradient at 0 is 1; torch.abs's is 0.
    return torch.where(x >= 0, x, -x)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    # jnp.clip's gradient at a bound is 0.5 (the tie of maximum / minimum);
    # torch.clamp's is 1. Tensor bounds in x's dtype make the same ties.
    lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def materialize_splats(params: Dict[str, torch.Tensor]) -> Splats4D:
    """Raw trainable parameter dict -> Splats4D (motion parameterization).
    Scales and lifetime are kept positive by abs + eps, fade and color are
    clipped, with the reference's gradients at the clip bounds and at 0."""
    scale = _abs(params["scale3"]) + 1e-4
    lifetime = _abs(params["lifetime"]) + 1e-4
    fade = _clip(params["fade"], 1e-3, 1.0 - 1e-3)
    color = _clip(params["color"], 0.0, 1.0)
    return Splats4D.from_motion(params["position4"], params["quat"], scale,
                                lifetime, fade, params["velocity"], color)


def splats_to_params(position4, quat, scale3, lifetime, fade, velocity,
                     color, device=None) -> Dict[str, torch.Tensor]:
    """The trainer's parameter dict (PARAM_FIELDS) from arrays or tensors:
    numpy arrays (the reference's trainer parameters) become float32
    tensors; with `device` (None: tensors stay where they are and arrays go
    beside them or to the card, fourdgs_torch.as_tensors) all go there."""
    return dict(zip(PARAM_FIELDS, as_tensors(
        position4, quat, scale3, lifetime, fade, velocity, color,
        device=device)))
