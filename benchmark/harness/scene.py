"""The cube scene's raw parameters, drawn on the device from a seed.

A frozen copy of the distributions of the upstream benchmark's cube scene
(n static 4D splats uniform in a cube): positions uniform in [-h, h]^3,
quaternions normal, scales uniform, lifetime and fade constant, velocities
zero, colours from two uniforms (blue an affine function of red, alpha one
of green). Every field is float32, made in a few large calls of one
`torch.Generator` on the device, so the same seed gives the same scene.
"""

from __future__ import annotations

from typing import Dict

import torch


def cube_params(scene: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The packed parameter dict (px ... ca, each (n,) float32) of the cube
    scene described by `scene` (a configuration's "scene" object)."""
    n = int(scene["n_splats"])
    half = float(scene["half_extent"])
    s_lo, s_hi = scene["scale_range"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand((8, n), generator=gen, device=device)
    q = torch.randn((4, n), generator=gen, device=device)
    pos = u[0:3] * (2.0 * half) - half
    scale = u[3:6] * (s_hi - s_lo) + s_lo
    f_r, f_g = u[6], u[7]
    zeros = torch.zeros((5, n), device=device)
    return dict(
        px=pos[0], py=pos[1], pz=pos[2], pt=zeros[0],
        qw=q[0], qx=q[1], qy=q[2], qz=q[3],
        sx=scale[0], sy=scale[1], sz=scale[2],
        lifetime=torch.full((n,), float(scene["lifetime"]), device=device),
        fade=torch.full((n,), float(scene["fade"]), device=device),
        vx=zeros[1], vy=zeros[2], vz=zeros[3],
        cr=f_r * 0.85 + 0.15, cg=f_g * 0.85 + 0.15,
        cb=(f_r * 0.85 + 0.15) * 0.5 + 0.3, ca=f_g * 0.4 + 0.6,
    )
