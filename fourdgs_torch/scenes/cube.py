"""The headline benchmark scene: n static 4D splats uniform in a 400^3 cube
(port of bench.py `build_cube_scene`).

The distributions are the reference's, drawn from a seeded
`torch.Generator` (which cannot give jax.random's numbers). The reference
draws cb from the same key as cr and ca from the same key as cg, so cb is an
affine function of cr and ca one of cg; this port keeps that.
"""

from __future__ import annotations

from typing import Dict

import torch

from fourdgs_torch import resolve_device
from fourdgs_torch.splats.packed import morton_order, pad_packed_params

# bench.py's camera for this scene (bench.py:148-150); width and height are
# the caller's.
CUBE_CAMERA = dict(position=(420.0, 300.0, 420.0),
                   orientation=(-1.0, -0.7, -1.0), far=5000.0)
# bench.py's dead-pad multiple for the converged scene (bench.py:139-145).
CONVERGED_PAD = 16384


def build_cube_scene(n: int, seed: int = 0,
                     device=None) -> Dict[str, torch.Tensor]:
    """Packed (N,) float32 parameter dict on `device`, by default the card
    (fourdgs_torch.default_device)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def u01():
        return torch.rand(n, generator=gen, device=device)

    def uniform(lo, hi):
        return u01() * (hi - lo) + lo

    def normal():
        return torch.randn(n, generator=gen, device=device)

    def zeros():       # one tensor a field: a shared one would sum their grads
        return torch.zeros(n, device=device)

    f_r, f_g = u01(), u01()
    return dict(
        px=uniform(-200.0, 200.0), py=uniform(-200.0, 200.0),
        pz=uniform(-200.0, 200.0), pt=zeros(),
        qw=normal(), qx=normal(), qy=normal(), qz=normal(),
        sx=uniform(3.0, 8.0), sy=uniform(3.0, 8.0), sz=uniform(3.0, 8.0),
        lifetime=torch.full((n,), 50.0, device=device),
        fade=torch.full((n,), 0.5, device=device),
        vx=zeros(), vy=zeros(), vz=zeros(),
        cr=f_r * 0.85 + 0.15, cg=f_g * 0.85 + 0.15,
        cb=(f_r * 0.85 + 0.15) * 0.5 + 0.3, ca=f_g * 0.4 + 0.6,
    )


def converged_cube_scene(params: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """The converged path's scene: Morton-ordered and dead-padded to a
    CONVERGED_PAD multiple, the one-time scene build bench.py does for the
    banded tail."""
    return pad_packed_params(morton_order(params), CONVERGED_PAD)
