"""Differentiable-rendering demo: recover splat motion from rendered frames
(port of examples/fit_motion.py).

Builds a ground-truth moving scene (a torus marching along +x, the
LinearMotion workload shape), renders target frames at several times, then
optimizes a *perturbed* splat set (wrong positions and zero velocity) to
match: gradients flow through temporal slicing, EWA projection and the
ordered composite. Writes before/after/target PNGs and a checkpoint, and
prints the fit's speed, the loss ratio and the recovered velocity.

    python -m fourdgs_torch.examples.fit_motion [--steps 300] [--cpu] [--out DIR]

The perturbation is drawn from a seeded torch.Generator (the reference's
from jax.random), so the numbers are not the reference's.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__),
                                                  "fit_out"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from fourdgs_torch import resolve_device
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.io.png import write_png
    from fourdgs_torch.parallel.distributed import materialize_splats
    from fourdgs_torch.render.pipeline import RenderConfig, render_splats4d
    from fourdgs_torch.scenes import models as M
    from fourdgs_torch.scenes.scenes import quat_look_at
    from fourdgs_torch.train import trainer

    dev = resolve_device("cpu" if args.cpu else None)
    os.makedirs(args.out, exist_ok=True)

    # Ground truth: a torus moving along +x at 1 unit/time.
    model = M.torus(24, 12, r_major=6.0, r_minor=2.5)
    n = model.count
    nrm = model.normal / np.maximum(
        np.linalg.norm(model.normal, axis=1, keepdims=True), 1e-9)
    nrm_t = torch.tensor(nrm, dtype=torch.float32, device=dev)
    gt = dict(
        position4=torch.tensor(np.concatenate(
            [model.position, np.zeros((n, 1), np.float32)], 1), device=dev),
        quat=torch.tensor(quat_look_at(nrm), device=dev),
        scale3=torch.full((n, 3), 3.0, device=dev),
        lifetime=torch.full((n,), 8.0, device=dev),
        fade=torch.full((n,), 0.5, device=dev),
        velocity=torch.tensor([[1.0, 0.0, 0.0]], device=dev).repeat(n, 1),
        color=torch.cat([torch.abs(nrm_t) * 0.7 + 0.3,
                         torch.full((n, 1), 0.9, device=dev)], 1),
    )

    cam = Camera.create(position=(0.0, 18.0, 45.0),
                        orientation=(0.1, -0.35, -1.0), width=192, height=128,
                        device=dev)
    cfg = RenderConfig(max_splats_per_tile=512, splat_chunk=64)
    ts = [0.0, 4.0, 8.0]

    @torch.no_grad()
    def render(p, t):
        return render_splats4d(materialize_splats(p), cam,
                               torch.tensor(t, device=dev), cfg=cfg)

    def save(name, img):
        write_png(os.path.join(args.out, name), img.cpu().numpy())

    frames = [(render(gt, t), t) for t in ts]
    for img, t in frames:
        save(f"target_t{t:.0f}.png", img)

    # Perturbed start: shifted positions, zero velocity, grey colors.
    gen = torch.Generator(device=dev).manual_seed(0)
    init = dict(gt)
    init["position4"] = gt["position4"] + torch.randn(
        (n, 4), generator=gen, device=dev) * torch.tensor(
            [1.5, 1.5, 1.5, 0.0], device=dev)
    init["velocity"] = torch.zeros((n, 3), device=dev)
    init["color"] = torch.full((n, 4), 0.5, device=dev)
    save("before_t8.png", render(init, 8.0))

    t0 = time.time()
    res = trainer.fit(init, frames, cam, steps=args.steps, learning_rate=1e-2,
                      cfg=cfg, log_every=max(args.steps // 10, 1))
    dt = time.time() - t0

    save("after_t8.png", render(res.params, 8.0))
    vel = res.params["velocity"].mean(dim=0).cpu().numpy()
    print(f"\nfit {args.steps} steps in {dt:.1f}s "
          f"({args.steps / dt:.1f} steps/s)")
    print(f"loss {res.losses[0]:.5f} -> {res.losses[-1]:.5f} "
          f"({res.losses[-1] / res.losses[0]:.1%} of initial)")
    print(f"recovered mean velocity {vel} (truth [1, 0, 0])")
    trainer.save_checkpoint(os.path.join(args.out, "fitted"), res.params)
    print(f"outputs in {args.out}")
    return res


if __name__ == "__main__":
    main()
