"""Render the headline 10M-splat cube from a camera orbit (port of
examples/render_cube_sweep.py), as frames on disk, under the shipped
converged configuration (exact head + streaming banded-OIT tail, zero
truncation), on the card.

    python -m fourdgs_torch.examples.render_cube_sweep [--frames 6] [--n 10000000]

Writes frame_XX.png and prints each frame's mean rgb and loss counters.
"""

from __future__ import annotations

import argparse
import math
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=544)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "gallery", "cube"))
    args = ap.parse_args(argv)

    import torch

    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.io.png import write_png
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.render.pipeline import render_params4d_packed
    from fourdgs_torch.scenes.cube import build_cube_scene
    from fourdgs_torch.splats.packed import morton_order, pad_packed_params

    os.makedirs(args.out, exist_ok=True)
    cfg = auto_render_config(args.n, args.width, args.height)
    params = pad_packed_params(morton_order(build_cube_scene(args.n)),
                               cfg.tail_chunk)

    for k in range(args.frames):
        ang = 2 * math.pi * k / args.frames
        r, y = 580.0, 300.0
        pos = (r * math.cos(ang), y, r * math.sin(ang))
        cam = Camera.create(position=pos,
                            orientation=(-pos[0], -y * 0.7, -pos[2]),
                            far=5000.0, width=args.width,
                            height=args.height)
        t0 = time.time()
        with torch.no_grad():
            img, aux = render_params4d_packed(params, cam, 0.0, cfg=cfg,
                                              return_aux=True)
        img = img.cpu().numpy()
        path = os.path.join(args.out, f"frame_{k:02d}.png")
        write_png(path, img)
        print(f"{path} mean_rgb={img[..., :3].mean():.4f} "
              f"resid={float(aux['resid_transmittance']):.1e} "
              f"overflow={int(aux['overflowed'])} "
              f"({time.time() - t0:.1f}s)", flush=True)


if __name__ == "__main__":
    main()
