"""Headless scene viewer: render demo scenes to PNG frames (port of
fourdgs/viewer/cli.py).

Pick a scene, a time (or a time sweep), camera overrides, and get frames on
disk. Frames render on the card unless --cpu is given; nothing falls back.

    python -m fourdgs_torch.viewer.cli --scene linear --t 12 --out frame.png
    python -m fourdgs_torch.viewer.cli --scene linear --converged --out f.png
    python -m fourdgs_torch.viewer.cli --scene rotation --sweep 0:90:16 --out anim
    python -m fourdgs_torch.viewer.cli --list
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import os
import sys
import time

import numpy as np
import torch


def build_argparser():
    p = argparse.ArgumentParser(prog="fourdgs-torch-view",
                                description=__doc__)
    p.add_argument("--scene", default="linear",
                   help="scene name (see --list)")
    p.add_argument("--list", action="store_true", help="list scenes and exit")
    p.add_argument("--t", type=float, default=0.0, help="scene time")
    p.add_argument("--sweep", default=None,
                   help="render a sweep start:stop:frames instead of one t")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--out", default="frame.png",
                   help="output PNG (or directory prefix for sweeps)")
    p.add_argument("--backend", default="xla", choices=["xla", "pallas", "dense"],
                   help="xla: the plain-PyTorch tiled compositor; pallas: "
                        "the CUDA kernels (K1); dense: the golden renderer")
    p.add_argument("--converged", action="store_true",
                   help="composite EVERY pair (exact head + streaming "
                        "banded-OIT tail, the CUDA kernels K1-K7) - matches "
                        "the reference's no-depth-cap blend")
    p.add_argument("--min-opacity", type=float, default=0.0)
    p.add_argument("--no-sort", action="store_true",
                   help="draw in splat-index order (reference's sort toggle)")
    p.add_argument("--cam-pos", default=None, help="x,y,z camera override")
    p.add_argument("--cam-dir", default=None, help="x,y,z orientation override")
    p.add_argument("--background", default="0,0,0,1")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (the kernels' plain versions)")
    p.add_argument("--grid", action="store_true",
                   help="overlay the reference's ground grid (Scenes.h:303)")
    p.add_argument("--axis", action="store_true",
                   help="overlay the xyz axis cross (Scenes.h:304)")
    p.add_argument("--blend", default=None, metavar="SRC,DST",
                   help="blend-function explorer (DebugMenus.h:211-274): "
                        "any glBlendFunc factor pair, e.g. "
                        "'src_alpha,one_minus_src_alpha' or 'one,one'; "
                        "forces the dense back-to-front compositor. "
                        "See fourdgs_torch.render.dense.BLEND_FACTORS")
    p.add_argument("--set", action="append", default=[], metavar="FIELD=V[,V..]",
                   help="per-splat parameter override (the single-splat "
                        "editor analog, DebugMenus.h:75-208): e.g. "
                        "--set scale=2,0.5,1 --set color=1,0,0,0.8 "
                        "--set lifetime=5 --set position=0,1,-10,0 "
                        "--set quat=1,0,0.3,0 --set velocity=1,0,0. "
                        "Applies to all splats, or one with --splat-index")
    p.add_argument("--splat-index", type=int, default=None,
                   help="restrict --set overrides to one splat")
    return p


def apply_overrides(splats, sets, index):
    """Apply --set FIELD=values overrides to splats (any of Splats2D/3D/4D or
    a dict of tensors). Vector fields broadcast a single value;
    --splat-index restricts to one row."""
    aliases = {"scale": "scale3", "pos": "position", "dir": "velocity",
               "rot": "quat"}
    for spec in sets:
        if "=" not in spec:
            raise SystemExit(f"--set {spec!r}: expected FIELD=V[,V...]")
        field, _, raw = spec.partition("=")
        field = aliases.get(field.strip(), field.strip())
        vals = [float(v) for v in raw.split(",")]
        is_dc = dataclasses.is_dataclass(splats)
        names = ([f.name for f in dataclasses.fields(splats)] if is_dc
                 else list(splats.keys()))
        # Accept both exact names and common aliases across splat classes.
        cands = [n for n in names if n == field or n.rstrip("34") == field
                 or field.rstrip("34") == n.rstrip("34")]
        if not cands:
            raise SystemExit(f"--set: no field {field!r}; has {names}")
        name = cands[0]
        cur = getattr(splats, name) if is_dc else splats[name]
        vals = torch.tensor(vals, dtype=cur.dtype, device=cur.device)
        if vals.shape[0] == 1 and cur.ndim >= 1:
            newrow = torch.broadcast_to(vals, cur.shape[1:] or (1,))
        else:
            want = tuple(cur.shape[1:]) if cur.ndim > 1 else ()
            if want and tuple(vals.shape) != want:
                raise SystemExit(f"--set {name}: expected {want[0]} values, "
                                 f"got {vals.shape[0]}")
            newrow = vals if want else vals[0]
        if index is None:
            new = torch.broadcast_to(newrow, cur.shape).clone()
        else:
            new = cur.clone()
            new[index] = newrow
        splats = (dataclasses.replace(splats, **{name: new}) if is_dc
                  else {**splats, name: new})
    return splats


def _route_sets(gen, sets, splat_index):
    """Split --set specs into the generator's keyword parameters (the
    single-splat editor analog for the showcase scenes) and the rest,
    array-level edits, as the reference does."""
    sig_params = inspect.signature(gen).parameters
    aliases = {"scale": ("scale", "scale3"), "pos": ("position",),
               "dir": ("velocity",), "rot": ("quat",)}
    gen_kwargs, array_sets = {}, []
    for spec in sets:
        field = spec.partition("=")[0].strip()
        raw = spec.partition("=")[2]
        cands = aliases.get(field, (field,)) + (field,)
        hit = next((c for c in cands if c in sig_params and c != "device"),
                   None)
        if hit is not None and splat_index in (None, 0):
            vals = [float(v) for v in raw.split(",")]
            gen_kwargs[hit] = vals[0] if len(vals) == 1 and hit in (
                "lifetime", "fade") else tuple(vals)
        else:
            array_sets.append(spec)
    return gen_kwargs, array_sets


def viewer_config(args, bg):
    """The RenderConfig of the viewer's flags, as the reference builds it."""
    from fourdgs_torch.render.pipeline import RenderConfig
    if args.converged:
        # The library's auto-configuration with the small-scene,
        # viewer-friendly tile shape; every pair composited.
        from fourdgs_torch.render.autoconfig import auto_render_config
        return auto_render_config(400_000, args.width, args.height,
                                  background=bg, tile_h=8,
                                  max_splats_per_tile=256,
                                  max_tiles_per_splat=8,
                                  depth_prune_cap=256, tail_block=(4, 8),
                                  tail_chunk=1024)
    if args.backend == "pallas":
        return RenderConfig(tile_h=8, tile_w=128, backend="pallas",
                            background=bg)
    return RenderConfig(background=bg)


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from fourdgs_torch import resolve_device
    from fourdgs_torch.core.camera import Camera, pixel_centers_ndc
    from fourdgs_torch.io.png import write_png
    from fourdgs_torch.render import dense as dense_mod
    from fourdgs_torch.render import overlay
    from fourdgs_torch.render import pipeline as pipe_mod
    from fourdgs_torch.render.project import project_splats
    from fourdgs_torch.scenes.scenes import SCENES
    from fourdgs_torch.splats.gaussians import (Splats2D, Splats3D,
                                                mean_in_time_sortkey)

    if args.list:
        for name in SCENES:
            print(name)
        return 0

    if args.scene not in SCENES:
        print(f"unknown scene {args.scene!r}; use --list", file=sys.stderr)
        return 2

    device = resolve_device("cpu" if args.cpu else None)
    gen = SCENES[args.scene]
    gen_kwargs, array_sets = _route_sets(gen, args.set, args.splat_index)
    splats, st = gen(**gen_kwargs, device=device)
    if array_sets:
        splats = apply_overrides(splats, array_sets, args.splat_index)
    campos = tuple(map(float, args.cam_pos.split(","))) if args.cam_pos else st.camera_position
    camdir = tuple(map(float, args.cam_dir.split(","))) if args.cam_dir else st.camera_orientation
    bg = tuple(map(float, args.background.split(",")))
    cam = Camera.create(position=campos, orientation=camdir,
                        width=args.width, height=args.height, device=device)
    cfg = viewer_config(args, bg)

    blend = None
    if args.blend:
        parts = [b.strip() for b in args.blend.split(",")]
        if len(parts) != 2:
            print("--blend expects SRC,DST", file=sys.stderr)
            return 2
        blend = tuple(parts)
    bg_t = torch.tensor(bg, dtype=torch.float32, device=device)

    def render_blend(t):
        """Blend-function explorer path: dense back-to-front composite
        under the chosen glBlendFunc pair."""
        if isinstance(splats, Splats2D):
            proj, p00e, p11e = dense_mod.project_splats2d(splats, cam)
            proj = proj.map(lambda a: a.flip(0))
        else:
            if isinstance(splats, Splats3D):
                sliced, top, sm = splats, None, None
            else:
                sliced, top = splats.at_time(t, args.min_opacity)
                sm = mean_in_time_sortkey(splats.position, splats.cov, t)
            op = (torch.ones((sliced.count,), device=device) if top is None
                  else top)
            proj = project_splats(sliced.position, sliced.cov, sliced.color,
                                  op, cam, sort_mean3=sm)
            proj = dense_mod.sort_front_to_back(proj)
            pmat = cam.proj_matrix()
            p00e, p11e = pmat[0, 0], pmat[1, 1]
        px, py = pixel_centers_ndc(cam.width, cam.height, device=device)
        return dense_mod.composite_dense_blend(
            proj, px, py, p00e, p11e, bg_t,
            src_factor=blend[0], dst_factor=blend[1],
            premultiplied=isinstance(splats, Splats3D))

    @torch.no_grad()
    def render_at(t):
        t = torch.tensor(t, dtype=torch.float32, device=device)
        if blend is not None:
            img = render_blend(t)
        elif isinstance(splats, Splats2D):
            img = dense_mod.render_splats2d(splats, cam, background=bg)
        elif isinstance(splats, Splats3D):
            if args.backend == "dense":
                img = dense_mod.render_splats3d(splats, cam, background=bg,
                                                sort=not args.no_sort,
                                                premultiplied=True)
            else:
                img = pipe_mod.render_splats3d(splats, cam, cfg=cfg)
        elif args.backend == "dense":
            img = dense_mod.render_splats4d(splats, cam, t, args.min_opacity,
                                            background=bg,
                                            sort=not args.no_sort)
        else:
            img = pipe_mod.render_splats4d(splats, cam, t, args.min_opacity,
                                           cfg=cfg)
        if args.grid:
            img = overlay.draw_grid(img, cam)
        if args.axis:
            img = overlay.draw_axis(img, cam)
        return img.cpu().numpy()

    if args.sweep:
        start, stop, frames = args.sweep.split(":")
        ts = np.linspace(float(start), float(stop), int(frames))
        os.makedirs(args.out, exist_ok=True)
        for i, t in enumerate(ts):
            t0 = time.time()
            img = render_at(float(t))
            path = os.path.join(args.out, f"frame_{i:04d}.png")
            write_png(path, img)
            print(f"{path}  t={t:.2f}  {time.time()-t0:.3f}s")
    else:
        t0 = time.time()
        img = render_at(args.t)
        write_png(args.out, img)
        print(f"{args.out}  t={args.t:.2f}  {img.shape}  {time.time()-t0:.3f}s "
              f"(mean rgb {img[..., :3].mean():.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
