"""Where the tail accumulate's time goes, on one card.

    python3 -m fourdgs_torch.tools.tail_split [--json PATH]

Renders one converged frame of the headline scene (the 10M-splat cube,
Morton-ordered and dead-padded, 1920x1088, `auto_render_config`), records
what the frame hands `tail_accumulate` (main and big-tier stream), and on
those inputs

  * times the chunk-walk form of the accumulate (`tools/csrc/
    tail_chunk_walk.cu`: one block per chunk walking every (splat, slot,
    sample) item, shared atomics into the chunk's staged window) as it is
    and in the variants its source names: without the atomics, with the walk
    alone, as a grid of one block per 512-splat unit, and the last two
    combined with the first; the differences split its time into atomics,
    per-sample arithmetic, walk and grid shape;
  * times the port's `tail_accumulate` (K7: the wrapper, and its kernel
    alone as the chunk walk is launched) and, under a random cotangent,
    `tail_accumulate_bwd` (K9) in the same process, so the chunk walk and
    the kernels the port ships are compared on one card in one run;
  * counts with plain PyTorch, per 512-splat unit of the main stream: live
    (splat, slot) pairs, covered samples (alpha > 0), distinct tiles
    touched, and the share of groups of 4 consecutive splats of one slot (a
    warp of the chunk walk at 8 samples) whose live pairs fall in one tile.

Times are CUDA events around back-to-back launches after a warm-up.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

N_SPLATS, WIDTH, HEIGHT = 10_000_000, 1920, 1088
UNIT = 512
REPS = 10
WALK_SOURCE = str(Path(__file__).resolve().parent / "csrc"
                  / "tail_chunk_walk.cu")
VARIANTS = {
    "as it is": (),
    "no atomics": ("-DWALK_NO_ATOMICS",),
    "walk only": ("-DWALK_ONLY",),
    "unit grid": ("-DWALK_UNIT_GRID",),
    "unit grid, no atomics": ("-DWALK_UNIT_GRID", "-DWALK_NO_ATOMICS"),
    "unit grid, walk only": ("-DWALK_UNIT_GRID", "-DWALK_ONLY"),
}


def cuda_ms(fn, reps=REPS, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def capture_tail_calls(params, camera, cfg):
    """The (args, kwargs) of every `tail_accumulate` call of one frame."""
    from fourdgs_torch.ops import tail_cuda as TL
    from fourdgs_torch.render.pipeline import render_params4d_packed
    calls = []
    original = TL.tail_accumulate

    def recorder(*args, **kwargs):
        calls.append(([a.clone() for a in args],
                      {k: v.clone() if hasattr(v, "clone") else v
                       for k, v in kwargs.items()}))
        return original(*args, **kwargs)
    TL.tail_accumulate = recorder
    try:
        render_params4d_packed(params, camera, 0.0, cfg=cfg)
    finally:
        TL.tail_accumulate = original
    torch.cuda.synchronize()
    return calls


def walk_launcher(flags, args, kw):
    """A closure launching one variant of the chunk walk on a call's
    inputs (`flags` None: K7 itself, without its wrapper's PyTorch calls),
    and the accumulator it adds into."""
    import torch.nn.functional as F

    from fourdgs_torch.ops import tail_cuda as TL
    from fourdgs_torch.ops._build import CudaKernel
    walk = None if flags is None else CudaKernel(
        WALK_SOURCE, "fourdgs_tail_chunk_walk",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12,
        extra_flags=("-fmad=false",) + tuple(flags))
    fields, meta, band, rect, cut, params_row = args
    npts = meta.shape[1]
    fields = F.pad(fields, (0, npts - fields.shape[1])).contiguous()
    n_samp = kw["s_cy"] * kw["s_cx"]
    ny_pad = TL.ny_padded(kw["ny"])
    acc = torch.zeros((kw["k_bands"] * kw["nx"] * ny_pad,
                       TL.N_PLANES * n_samp), dtype=torch.float32,
                      device=meta.device)
    mask = kw.get("slot_mask")
    mask = None if mask is None else mask.contiguous()
    cut_t = TL._cut_table(cut).contiguous()      # the chunk walk's form
    band, rect = band.contiguous(), rect.contiguous()
    stream = torch.cuda.current_stream(meta.device).cuda_stream

    shape = (npts, npts // kw["chunk"], kw["chunk"], kw["budget"],
             kw.get("budget_lo", 0), kw["nx"], ny_pad, kw["s_cx"], n_samp,
             kw["k_bands"], int(kw["exact_clip"]))

    def launch():
        if walk is None:     # K7: no rect; band and mask strides, cut length
            TL.TAIL_ACCUMULATE(fields, meta, band, mask, cut_t, params_row,
                               acc, *shape, 1, 1, cut_t.shape[0],
                               stream=stream)
        else:
            walk(fields, meta, band, rect, mask, cut_t, params_row, acc,
                 *shape, TL.SUB, stream=stream)
    return launch, acc


def unit_counts(args, kw):
    """Per-unit counts of the live pairs of one stream (plain PyTorch)."""
    import torch.nn.functional as F

    from fourdgs_torch.ops import tail_cuda as TL
    fields, meta, band, _, cut, params_row = args
    npts = meta.shape[1]
    fields = F.pad(fields, (0, npts - fields.shape[1]))
    unit = min(UNIT, kw["chunk"])
    n_units = npts // unit
    dev = meta.device
    pairs = torch.zeros(n_units, dtype=torch.int64, device=dev)
    covered = torch.zeros(n_units, dtype=torch.int64, device=dev)
    tile_keys = []
    warps = warps_multi = one_tile = one_tile_multi = 0
    n_rows = kw["k_bands"] * kw["nx"] * TL.ny_padded(kw["ny"])
    for idx, row, _, pair in TL._live_pairs(
            fields, meta, band, cut, params_row, kw["nx"], kw["ny"],
            kw["chunk"], kw["budget"], kw["s_cy"], kw["s_cx"],
            kw.get("budget_lo", 0), kw["exact_clip"]):
        u = idx // unit
        pairs += torch.bincount(u, minlength=n_units)
        covered += torch.bincount(
            u, weights=(pair[-1] > 0).sum(dim=1).double(),
            minlength=n_units).long()
        tile_keys.append(torch.unique(u * n_rows + row))
        # Groups of 4 consecutive splats of this slot: one warp of the chunk
        # walk at 8 samples a pair.
        grp, inv = torch.unique(idx // 4, return_inverse=True)
        lo = torch.full((grp.shape[0],), n_rows, dtype=row.dtype, device=dev)
        hi = torch.full((grp.shape[0],), -1, dtype=row.dtype, device=dev)
        lo.scatter_reduce_(0, inv, row, "amin")
        hi.scatter_reduce_(0, inv, row, "amax")
        cnt = torch.bincount(inv, minlength=grp.shape[0])
        warps += grp.shape[0]
        one_tile += int((lo == hi).sum())
        warps_multi += int((cnt > 1).sum())
        one_tile_multi += int(((lo == hi) & (cnt > 1)).sum())
    tile_keys.append(torch.zeros(0, dtype=torch.int64, device=dev))
    tiles = torch.bincount(torch.unique(torch.cat(tile_keys)) // n_rows,
                           minlength=n_units)

    def stats(x):
        x = x.double()
        return dict(total=float(x.sum()), mean=float(x.mean()),
                    max=float(x.max()),
                    p50=float(x.quantile(0.5)), p99=float(x.quantile(0.99)))
    return dict(unit=unit, units=n_units,
                units_with_live_pairs=int((pairs > 0).sum()),
                slots_walked=npts * kw["budget"],
                live_pairs=stats(pairs), covered_samples=stats(covered),
                tiles_touched=stats(tiles),
                warps_with_a_live_pair=warps,
                share_of_them_in_one_tile=one_tile / max(warps, 1),
                warps_with_two_or_more=warps_multi,
                share_of_those_in_one_tile=one_tile_multi
                / max(warps_multi, 1))


def main(argv=None) -> int:
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.ops import tail_cuda as TL
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.scenes.cube import (CUBE_CAMERA, build_cube_scene,
                                           converged_cube_scene)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None,
                    help="also write the results to this file")
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--height", type=int, default=HEIGHT)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tail_split: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    report = dict(device=smi, width=opts.width, height=opts.height)
    params = converged_cube_scene(build_cube_scene(N_SPLATS, seed=0,
                                                   device=dev))
    camera = Camera.create(**CUBE_CAMERA, width=opts.width,
                           height=opts.height, device=dev)
    cfg = auto_render_config(N_SPLATS, opts.width, opts.height)
    calls = capture_tail_calls(params, camera, cfg)
    del params
    torch.cuda.empty_cache()

    report["streams"] = []
    for n_call, (args, kw) in enumerate(calls):
        label = (f"call {n_call}: {args[1].shape[1]:,} splats, chunk "
                 f"{kw['chunk']}, budget ({kw.get('budget_lo', 0)}, "
                 f"{kw['budget']}], samples {kw['s_cy']}x{kw['s_cx']}")
        print(label)
        entry = dict(label=label, walk_ms={})
        want = TL.tail_accumulate(*args, **kw)
        for name, flags in VARIANTS.items():
            launch, acc = walk_launcher(flags, args, kw)
            launch()
            torch.cuda.synchronize()
            if "atomics" not in name and "only" not in name:
                d = float((acc - want).abs().max())
                print(f"  chunk walk, {name}: max |d| against K7 {d:.3e}")
            entry["walk_ms"][name] = cuda_ms(launch)
            print(f"  chunk walk, {name}: {entry['walk_ms'][name]:.4f} ms")
        entry["k7_ms"] = cuda_ms(lambda: TL.tail_accumulate(*args, **kw))
        entry["k7_kernel_ms"] = cuda_ms(walk_launcher(None, args, kw)[0])
        print(f"  K7 tail_accumulate: {entry['k7_ms']:.4f} ms; its kernel "
              f"alone, launched as the chunk walk is: "
              f"{entry['k7_kernel_ms']:.4f} ms")
        fields, meta, band, rect, cut, params_row = args
        fields_p = torch.nn.functional.pad(
            fields, (0, meta.shape[1] - fields.shape[1]))
        gen = torch.Generator(device=dev).manual_seed(1)
        d_acc = torch.randn(want.shape, generator=gen, device=dev)
        bwd_kw = {k: kw[k] for k in ("k_bands", "nx", "ny", "chunk", "budget",
                                     "s_cy", "s_cx", "exact_clip")}
        bwd_kw["budget_lo"] = kw.get("budget_lo", 0)
        entry["k9_ms"] = cuda_ms(lambda: TL.tail_accumulate_bwd(
            fields_p, meta, band, cut, params_row, d_acc,
            kw.get("slot_mask"), **bwd_kw))
        print(f"  K9 tail_accumulate_bwd (random cotangent): "
              f"{entry['k9_ms']:.4f} ms")
        entry["units"] = unit_counts(args, kw)
        print("  per-unit counts: " + json.dumps(entry["units"]))
        report["streams"].append(entry)
    if opts.json:
        with open(opts.json, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
