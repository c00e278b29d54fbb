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


def build_cube_scene(n: int, seed: int = 0,
                     device="cpu") -> Dict[str, torch.Tensor]:
    """Packed (N,) float32 parameter dict on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def u01():
        return torch.rand(n, generator=gen, device=device)

    def uniform(lo, hi):
        return u01() * (hi - lo) + lo

    def normal():
        return torch.randn(n, generator=gen, device=device)

    z = torch.zeros(n, device=device)
    f_r, f_g = u01(), u01()
    return dict(
        px=uniform(-200.0, 200.0), py=uniform(-200.0, 200.0),
        pz=uniform(-200.0, 200.0), pt=z,
        qw=normal(), qx=normal(), qy=normal(), qz=normal(),
        sx=uniform(3.0, 8.0), sy=uniform(3.0, 8.0), sz=uniform(3.0, 8.0),
        lifetime=torch.full((n,), 50.0, device=device),
        fade=torch.full((n,), 0.5, device=device),
        vx=z, vy=z, vz=z,
        cr=f_r * 0.85 + 0.15, cg=f_g * 0.85 + 0.15,
        cb=(f_r * 0.85 + 0.15) * 0.5 + 0.3, ca=f_g * 0.4 + 0.6,
    )
