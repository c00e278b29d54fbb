"""Where the sort kernels' time goes, on one card.

    python3 -m fourdgs_torch.tools.sort_split [--width W --height H]
                                              [--json PATH]

Renders one frame of the headline scene (the 10M-splat cube, 1920x1088
unless told otherwise) converged and, where the image is one band,
non-converged, records what each frame hands `rowsort_compact` (K2; a banded
frame such as 3840x2160 hands it one call a band), and on those inputs

  * counts, with plain PyTorch, the live keys a row holds before and after
    the fused prune cut: mean, p50, p99, p99.9, max, and the share of rows
    above 32, 64 and 128 (the capacities a row's list can have in K2);
  * times K2 beside the full-network form it replaced
    (`tools/csrc/rowsort_full_network.cu`, a measuring instrument) as that
    was and in the variants its source names: load, cut and count only, and
    16 and 32 rows a block. The differences separate the one read of the
    slot arrays from the network's barrier-separated stages;
  * times K2 without its cut (every row overflows its list).

Then, for the merge of 2^21 pairs (runs of 16,384 as K11 leaves them), the
launches after K11: the 28 single cross stages enqueued from Python one
foreign-function call each, the same 28 enqueued by one C call, the 10
grouped passes both ways, K13's 7 finishes, and the whole schedule in one
call. The differences separate the per-call cost of the foreign-function
interface from the device's launch cost and the kernels' own time.

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
REPS = 10
MERGE_PAIRS = 1 << 21
CSRC = Path(__file__).resolve().parent / "csrc"
FULL_NETWORK_SOURCE = str(CSRC / "rowsort_full_network.cu")
FULL_NETWORK_VARIANTS = {
    "as it was (8 rows a block)": (),
    "load + cut + count only": ("-DROWSORT_COUNT_ONLY",),
    "16 rows a block": ("-DROWSORT_G=16",),
    "32 rows a block": ("-DROWSORT_G=32",),
    "32 rows a block, load + cut + count only": ("-DROWSORT_G=32",
                                                 "-DROWSORT_COUNT_ONLY"),
}
THRESHOLDS = (32, 64, 128)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None,
                    help="also write the results to this file")
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--height", type=int, default=HEIGHT)
    ap.add_argument("--splats", type=int, default=N_SPLATS)
    return ap.parse_args(argv)


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


def _row_stats(live):
    x = live.double()
    # torch.quantile refuses inputs above 16M elements; rows are far fewer.
    q = torch.quantile(x, torch.tensor([0.5, 0.99, 0.999], dtype=x.dtype,
                                       device=x.device))
    out = dict(rows=int(x.numel()), total=int(x.sum()), mean=float(x.mean()),
               p50=float(q[0]), p99=float(q[1]), p999=float(q[2]),
               max=int(x.max()))
    for t in THRESHOLDS:
        out[f"share_above_{t}"] = float((live > t).double().mean())
    return out


def live_histogram(key, row_len, cut, key_shift):
    """Live keys a strided row of `rowsort_compact` holds before and after
    the prune cut (`cut` None: the two are equal), over the padded rows."""
    from fourdgs_torch.ops import sort_cuda as S
    zeros = torch.zeros_like(key)
    before, _ = S._cut_rows(key, zeros, row_len, None, key_shift)
    after, _ = S._cut_rows(key, zeros, row_len, cut, key_shift)
    return dict(row_len=row_len,
                before_cut=_row_stats((before != S.DEAD).sum(0)),
                after_cut=_row_stats((after != S.DEAD).sum(0)))


def capture_rowsort_calls(params, camera, cfg):
    """The (args, kwargs) of every `rowsort_compact` call of one frame."""
    from fourdgs_torch.render import tiles as TT
    from fourdgs_torch.render.pipeline import render_params4d_packed
    calls = []
    original = TT.rowsort_compact

    def recorder(*args, **kwargs):
        calls.append(([a.clone() if hasattr(a, "clone") else a for a in args],
                      {k: v.clone() if hasattr(v, "clone") else v
                       for k, v in kwargs.items()}))
        return original(*args, **kwargs)
    TT.rowsort_compact = recorder
    try:
        render_params4d_packed(params, camera, 0.0, cfg=cfg)
    finally:
        TT.rowsort_compact = original
    torch.cuda.synchronize()
    return calls


def full_network_launcher(flags, key, val, keep, row_len, cut, key_shift):
    """A closure launching one variant of the full-network form, and its
    (kept keys, live) outputs."""
    from fourdgs_torch.ops import sort_cuda as S
    from fourdgs_torch.ops._build import CudaKernel
    kernel = CudaKernel(
        FULL_NETWORK_SOURCE, "fourdgs_rowsort_full_network",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
        extra_flags=tuple(flags))
    rows = S.rowsort_rows(key.shape[0], row_len)
    ok = torch.empty((keep, rows), dtype=torch.int32, device=key.device)
    ov, live = torch.empty_like(ok), torch.empty_like(ok[0])
    stream = torch.cuda.current_stream(key.device).cuda_stream

    def launch():
        kernel(key, val, key.shape[0], rows, row_len, keep, cut,
               0 if cut is None else cut.shape[0], key_shift, ok, ov, live,
               stream=stream)
    return launch, ok, live


def split_rowsort(label, args, kw):
    """Histogram and timings of K2 and the full-network form at one call."""
    from fourdgs_torch.ops import sort_cuda as S
    key, val, keep = args
    row_len, cut, shift = kw["row_len"], kw["cut"], kw["key_shift"]
    cut = None if cut is None else cut.to(torch.int32).contiguous()
    print(f"{label}: {key.shape[0]:,} slots, row_len {row_len}, keep {keep}")
    entry = dict(label=label, slots=key.shape[0], row_len=row_len, keep=keep,
                 histogram=live_histogram(key, row_len, cut, shift))
    print("  live keys a row: " + json.dumps(entry["histogram"]))
    want_k, _, want_live = S.rowsort_compact_plain(key, val, keep, row_len,
                                                   cut, shift)
    ms = entry["ms"] = {}
    ms["K2"] = cuda_ms(lambda: S.rowsort_compact(key, val, keep, row_len,
                                                 cut, shift))
    ms["K2, no cut"] = cuda_ms(lambda: S.rowsort_compact(
        key, val, keep, row_len, None, shift))
    for name, flags in FULL_NETWORK_VARIANTS.items():
        launch, ok, live = full_network_launcher(flags, key, val, keep,
                                                 row_len, cut, shift)
        launch()
        torch.cuda.synchronize()
        if not torch.equal(live, want_live) or (
                "only" not in name and not torch.equal(ok, want_k)):
            raise RuntimeError(f"full network, {name}: differs from plain")
        ms[f"full network, {name}"] = cuda_ms(launch)
    launch = full_network_launcher((), key, val, keep, row_len, None,
                                   shift)[0]
    ms["full network, no cut"] = cuda_ms(launch)
    for name, t in ms.items():
        print(f"  {name}: {t:.4f} ms")
    return entry


def split_merge(dev, pairs=MERGE_PAIRS):
    """The launches after K11 at `pairs` pairs, enqueued from Python and
    from C."""
    from fourdgs_torch.ops import sort_cuda as S
    block = S.MERGE_BLOCK
    gen = torch.Generator(device=dev).manual_seed(2)
    key = torch.randint(0, 2 ** 31 - 1, (pairs,), generator=gen, device=dev,
                        dtype=torch.int32)
    val = torch.arange(pairs, dtype=torch.int32, device=dev)
    key, val = S.merge_tree_plain(key, val, 512, block, False)
    key, val = key.contiguous(), val.contiguous()
    want = torch.sort(key).values
    got = S.merge_levels(key.clone(), val.clone(), block)[0]
    if not torch.equal(got, want):
        raise RuntimeError("merge_levels: keys differ from torch.sort")
    single = S.merge_schedule(pairs, block)
    grouped = S.merge_schedule(pairs, block, S.CROSS_GROUP)
    cross1 = [st for st in single if st[0] == "cross"]
    cross4 = [st for st in grouped if st[0] == "cross"]
    finishes = [st for st in single if st[0] == "finish"]
    k, v = key.clone(), val.clone()      # in place, over and over: the
    #                                      time does not depend on the data

    def from_python(steps):
        for st in steps:
            if st[0] == "finish":
                S.merge_finish(k, v, st[1], block)
            else:
                S.merge_cross_stages(k, v, st[1],
                                     st[3] if len(st) > 3 else 1, st[2])

    def from_c(steps):
        return lambda: S._enqueue_levels(k, v, block, steps)
    out = {
        f"K12, {len(cross1)} single stages, a call each from Python":
            cuda_ms(lambda: from_python(cross1)),
        f"K12, {len(cross1)} single stages, one C call":
            cuda_ms(from_c(cross1)),
        f"K12, {len(cross4)} grouped passes, a call each from Python":
            cuda_ms(lambda: from_python(cross4)),
        f"K12, {len(cross4)} grouped passes, one C call":
            cuda_ms(from_c(cross4)),
        f"K13, {len(finishes)} finishes, a call each from Python":
            cuda_ms(lambda: from_python(finishes)),
        f"K13, {len(finishes)} finishes, one C call":
            cuda_ms(from_c(finishes)),
        f"whole schedule ({len(grouped)} launches), one C call":
            cuda_ms(from_c(grouped)),
        f"whole schedule ungrouped ({len(single)} launches), a call each "
        f"from Python": cuda_ms(lambda: from_python(single)),
        "one copy of the arrays (key.clone(), val.clone())":
            cuda_ms(lambda: (key.clone(), val.clone())),
        "torch.sort of the keys + gather of the values":
            cuda_ms(lambda: val[torch.sort(key).indices]),
    }
    print(f"merge, {pairs:,} pairs in runs of {block:,}:")
    for name, t in out.items():
        print(f"  {name}: {t:.4f} ms")
    return out


def main(argv=None) -> int:
    opts = parse_args(argv)
    if not torch.cuda.is_available():
        print("sort_split: no CUDA device", file=sys.stderr)
        return 2
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.render import tiles as TT
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.scenes.cube import (CUBE_CAMERA, build_cube_scene,
                                           converged_cube_scene)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    report = dict(device=smi, width=opts.width, height=opts.height,
                  splats=opts.splats, rowsort=[])
    camera = Camera.create(**CUBE_CAMERA, width=opts.width,
                           height=opts.height, device=dev)
    params = build_cube_scene(opts.splats, seed=0, device=dev)
    frames = [("converged", converged_cube_scene(params),
               auto_render_config(opts.splats, opts.width, opts.height))]
    cfg = auto_render_config(opts.splats, opts.width, opts.height,
                             converged=False)
    ny, nx = TT.tile_grid(opts.width, opts.height, cfg.tile_h, cfg.tile_w)
    if ny * nx < TT.TILE_LIMIT:                # one band
        frames.append(("non-converged", params, cfg))
    for mode, scene, cfg in frames:
        calls = capture_rowsort_calls(scene, camera, cfg)
        torch.cuda.empty_cache()
        for b, (args, kw) in enumerate(calls):
            label = f"{mode} {opts.width}x{opts.height}" + (
                f", band {b}" if len(calls) > 1 else "")
            report["rowsort"].append(split_rowsort(label, args, kw))
    del frames, params, calls
    torch.cuda.empty_cache()
    report["merge"] = split_merge(dev)
    if opts.json:
        with open(opts.json, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
