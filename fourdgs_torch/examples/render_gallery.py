"""Render every demo scene to a PNG gallery (port of
examples/render_gallery.py): the visual-regression analog of the
reference's Screenshots/ directory.

    python -m fourdgs_torch.examples.render_gallery [--size 512] [--out DIR] [--cpu] [--capped]

By default each 4D scene renders under the converged configuration (exact
head + streaming banded-OIT tail, the CUDA kernels K1-K7); --capped uses
the fixed-capacity xla compositor instead. Prints one table row per scene.
"""

from __future__ import annotations

import argparse
import os
import time

# A mid-animation time per scene (where the 4D structure shows).
TIMES = {"linear": 20.0, "nonlinear": 30.0, "rotation": 30.0,
         "combined": 20.0, "clouds": 10.0, "broken": 30.0,
         "square": 30.0, "gaussians4d": 0.5}
# Closer viewpoints for the dotted surface scenes (the reference's "Cam_2"
# menu preset, Scenes.h:389-393).
CAM_OVERRIDE = {"linear": ((12.0, 40.0, 40.0), (0.0, -1.0, -1.0)),
                "broken": ((30.0, 40.0, 40.0), (0.0, -1.0, -1.0)),
                "square": ((0.0, 40.0, 40.0), (0.0, -1.0, -1.0))}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__),
                                                  "gallery"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--capped", action="store_true",
                    help="use the fixed-capacity compositor instead of "
                         "the converged exact-head + banded-tail stack")
    args = ap.parse_args(argv)

    import torch

    from fourdgs_torch import resolve_device
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.io.png import write_png
    from fourdgs_torch.render import dense, overlay, pipeline
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.render.pipeline import RenderConfig
    from fourdgs_torch.scenes.scenes import SCENES
    from fourdgs_torch.splats.gaussians import Splats2D, Splats3D

    dev = resolve_device("cpu" if args.cpu else None)
    os.makedirs(args.out, exist_ok=True)
    if args.capped:
        cfg = RenderConfig(max_splats_per_tile=1024, splat_chunk=64)
    else:
        cfg = auto_render_config(400_000, args.size, args.size,
                                 tail_chunk=1024)

    for name, fn in SCENES.items():
        t0 = time.time()
        splats, st = fn(device=dev)
        pos, ori = CAM_OVERRIDE.get(
            name, (st.camera_position, st.camera_orientation))
        cam = Camera.create(position=pos, orientation=ori,
                            width=args.size, height=args.size, device=dev)
        t = TIMES.get(name, 0.0)
        with torch.no_grad():
            if isinstance(splats, Splats2D):
                img = dense.render_splats2d(splats, cam)
            elif isinstance(splats, Splats3D):
                img = dense.render_splats3d(splats, cam, premultiplied=True)
            elif splats.count == 0:
                img = torch.zeros((args.size, args.size, 4), device=dev)
                img[..., 3] = 1.0
                img = overlay.draw_grid(img, cam, x_count=20, z_count=20)
                img = overlay.draw_axis(img, cam)
            else:
                img = pipeline.render_splats4d(
                    splats, cam, torch.tensor(t, device=dev),
                    st.min_opacity, cfg=cfg)
        img = img.cpu().numpy()
        write_png(os.path.join(args.out, f"{name}.png"), img)
        print(f"| {name} | {splats.count:,} | {t:.1f} | "
              f"{float(img[..., :3].mean()):.4f} |",
              f"({time.time()-t0:.1f}s)")


if __name__ == "__main__":
    main()
