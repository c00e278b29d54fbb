"""Where the sort kernels' time goes, on one card.

    python3 -m fourdgs_torch.tools.sort_split [--width W --height H]
                                              [--merge-only]
                                              [--earlier-only] [--json PATH]

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

Then K11 (merge tree) and K13 (merge finish) on the frame's shapes: 2^21
pairs in rows of 512, alternating, merged into runs of 16,384 by K11; each
of K13's seven launches at the state the schedule leaves before it. Both
are timed in their shared-memory form (`tools/csrc/merge_shared_stages.cu`,
every stage a pass over shared memory with a barrier, a measuring
instrument) as that was and in its variants: load and store only, the
stages without their barriers, only the distances >= 32 (the variants but
the first are times only, not sorts); then the register-round kernels of
`ops/csrc/merge.cu` (not with --earlier-only), required bit-equal (keys and
values) to the earlier form at every launch; then the earlier form as it
was once more. K13 is timed net of the fresh copies it works on in place,
and in place on its own output, launch after launch, without copies (the
register rounds run the same operations on any data; the earlier form then
swaps nothing, so its time there is a lower bound).
`nvcc -Xptxas -v` of both sources gives each kernel's registers, spills
and shared memory. --merge-only skips the frames and K2.

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
SHARED_STAGES_SOURCE = str(CSRC / "merge_shared_stages.cu")
SHARED_STAGES_VARIANTS = {
    "as it was": (),
    "load + store only": ("-DMERGE_LOAD_STORE_ONLY",),
    "stages without barriers (time only)": ("-DMERGE_NO_BARRIER",),
    "distances >= 32 only (time only)": ("-DMERGE_MIN_DISTANCE=32",),
}
MERGE_ROW = 512          # the kernel-sorted 10M frame's rows (its keep)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None,
                    help="also write the results to this file")
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--height", type=int, default=HEIGHT)
    ap.add_argument("--splats", type=int, default=N_SPLATS)
    ap.add_argument("--merge-only", action="store_true",
                    help="only the merge's parts: no frame, no K2")
    ap.add_argument("--earlier-only", action="store_true",
                    help="time K11 and K13 in their earlier form only, "
                         "and launch no new merge kernel")
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


def shared_stage_kernels(flags=()):
    """K11 and K13 in their earlier, shared-memory form, built with the
    variant's `flags`: (tree, finish) CudaKernels."""
    from fourdgs_torch.ops._build import CudaKernel
    tree = CudaKernel(
        SHARED_STAGES_SOURCE, "fourdgs_merge_tree_shared",
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int],
        extra_flags=tuple(flags))
    finish = CudaKernel(
        SHARED_STAGES_SOURCE, "fourdgs_merge_finish_shared",
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_longlong],
        extra_flags=tuple(flags))
    return tree, finish


def earlier_merge_tree(kernel, key, val, c, block, rows_alternating):
    """`sort_cuda.merge_tree` through the earlier form's K11 `kernel`."""
    out_k, out_v = torch.empty_like(key), torch.empty_like(val)
    kernel(key, val, out_k, out_v, key.shape[0], c, block,
           int(rows_alternating),
           stream=torch.cuda.current_stream(key.device).cuda_stream)
    return out_k, out_v


def earlier_merge_finish(kernel, key, val, run_out, block):
    """`sort_cuda.merge_finish` (in place) through the earlier form's K13
    `kernel`."""
    kernel(key, val, key.shape[0], block, run_out,
           stream=torch.cuda.current_stream(key.device).cuda_stream)
    return key, val


def net_ms(fn, key, val, reps=REPS):
    """Time of `fn(key, val)`, in place, on fresh copies of the arrays, net
    of the copies."""
    run = cuda_ms(lambda: fn(key.clone(), val.clone()), reps)
    return max(0.0, run - cuda_ms(lambda: (key.clone(), val.clone()), reps))


def ptxas_report(sources, flags=()):
    """Registers, spill bytes and shared memory of every kernel of the
    given `.cu` files built with the extra nvcc `flags` (nvcc -Xptxas
    -v)."""
    import os
    import re

    from fourdgs_torch.ops import _build as B
    report = []
    base = [f for f in B.NVCC_FLAGS if f != "-shared"]
    for src in sources:
        proc = subprocess.run(
            [B._nvcc(), *base, *flags, "-Xptxas", "-v", "-c", "-o",
             os.devnull, str(src)], capture_output=True, text=True,
            timeout=600, check=True)
        entry = None
        for line in proc.stderr.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = dict(source=Path(src).name, kernel=m.group(1))
                if flags:
                    entry["flags"] = list(flags)
                report.append(entry)
            elif entry is not None and "spill stores" in line:
                st, ld = re.findall(r"(\d+) bytes spill", line)
                entry.update(spill_stores=int(st), spill_loads=int(ld))
            elif entry is not None and "registers" in line:
                entry["registers"] = int(
                    re.search(r"Used (\d+) registers", line).group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                entry["static_smem"] = int(smem.group(1)) if smem else 0
    return report


def merge_inputs(dev, pairs=MERGE_PAIRS, c=MERGE_ROW):
    """K11's input at the frame's shape (rows of c sorted, odd rows
    descending, from seeded random keys) and each K13's input, the state
    the schedule leaves before it (walked with the plain versions)."""
    from fourdgs_torch.ops import sort_cuda as S
    block = S.MERGE_BLOCK
    gen = torch.Generator(device=dev).manual_seed(3)
    key = torch.randint(0, 2 ** 31 - 1, (pairs,), generator=gen, device=dev,
                        dtype=torch.int32)
    val = torch.arange(pairs, dtype=torch.int32, device=dev)
    rows = S._sort_runs(key, val, c, alternate=True)
    k, v = S.merge_tree_plain(*rows, c, block, True)
    finishes = []
    for st in S.merge_schedule(pairs, block, S.CROSS_GROUP):
        if st[0] == "cross":
            k, v = S.merge_cross_stages_plain(k, v, st[1], st[3], st[2])
        else:
            finishes.append((st[1], k.contiguous(), v.contiguous()))
            k, v = S.merge_finish_plain(k, v, block, st[1])
    return rows, finishes


def split_merge_kernels(dev, new=True):
    """K11 and K13 in the earlier form and its variants and, with `new`,
    the register-round kernels, at the frame's shapes; the new kernels
    bit-equal to the earlier form."""
    from fourdgs_torch.ops import sort_cuda as S
    block, c = S.MERGE_BLOCK, MERGE_ROW
    (rk, rv), finishes = merge_inputs(dev)
    forms = {f"earlier form, {name}": shared_stage_kernels(flags)
             for name, flags in SHARED_STAGES_VARIANTS.items()}
    earlier = forms["earlier form, as it was"]

    def tree_of(kernels):
        if kernels is None:
            return lambda: S.merge_tree(rk, rv, c, block, True)
        return lambda: earlier_merge_tree(kernels[0], rk, rv, c, block, True)

    def finish_of(kernels, run_out):
        if kernels is None:
            return lambda k, v: S.merge_finish(k, v, run_out, block)
        return lambda k, v: earlier_merge_finish(kernels[1], k, v, run_out,
                                                 block)
    # The earlier form sorts as the plain versions do; the new kernels equal
    # it bit for bit.
    ek, ev = tree_of(earlier)()
    want = S.merge_tree_plain(rk, rv, c, block, True)[0]
    if not torch.equal(ek, want):
        raise RuntimeError("earlier K11: keys differ from plain")
    for run_out, k, v in finishes:
        got = finish_of(earlier, run_out)(k.clone(), v.clone())[0]
        if not torch.equal(got, S.merge_finish_plain(k, v, block,
                                                     run_out)[0]):
            raise RuntimeError(f"earlier K13 (run {run_out}): keys differ "
                               f"from plain")
    order = list(forms.items())
    if new:
        nk, nv = tree_of(None)()
        if not (torch.equal(nk, ek) and torch.equal(nv, ev)):
            raise RuntimeError("K11 differs from its earlier form")
        for run_out, k, v in finishes:
            a = finish_of(None, run_out)(k.clone(), v.clone())
            b = finish_of(earlier, run_out)(k.clone(), v.clone())
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise RuntimeError(f"K13 (run {run_out}) differs from its "
                                   f"earlier form")
        order.append(("register rounds (ops/csrc/merge.cu)", None))
    order.append(("earlier form, as it was, again", earlier))
    out = {}
    print(f"K11 and K13, {rk.shape[0]:,} pairs, rows of {c} -> runs of "
          f"{block:,}; K13 at run_out "
          f"{', '.join(f'{r:,}' for r, _, _ in finishes)}:")
    for name, kernels in order:
        k11 = cuda_ms(tree_of(kernels), 50)
        k13 = [net_ms(finish_of(kernels, run_out), k, v, 50)
               for run_out, k, v in finishes]
        in_place = []
        for run_out, k, v in finishes:
            k, v = k.clone(), v.clone()
            in_place.append(cuda_ms(
                lambda: finish_of(kernels, run_out)(k, v), 50))
        out[name] = dict(k11_ms=k11, k13_ms=k13, k13_total_ms=sum(k13),
                         k13_in_place_ms=in_place)
        print(f"  {name}: K11 {k11:.4f} ms; K13 "
              f"{', '.join(format(x, '.4f') for x in k13)} ms, "
              f"{sum(k13):.4f} for {len(k13)}; in place on its own output "
              f"{sum(in_place):.4f} for {len(k13)}")
    if new:
        print("  (the register-round kernels equal the earlier form bit for "
              "bit, keys and values, at K11 and every K13)")
    from fourdgs_torch.ops._build import CSRC as OPS_CSRC
    out["ptxas"] = ptxas_report([OPS_CSRC / "merge.cu",
                                 Path(SHARED_STAGES_SOURCE)])
    for e in out["ptxas"]:
        print("  ptxas: " + json.dumps(e))
    return out


def split_frames(opts, dev, report):
    """K2 at every call of the frames: live keys a row and its times."""
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.render import tiles as TT
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.scenes.cube import (CUBE_CAMERA, build_cube_scene,
                                           converged_cube_scene)
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


def main(argv=None) -> int:
    opts = parse_args(argv)
    if not torch.cuda.is_available():
        print("sort_split: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    report = dict(device=smi, width=opts.width, height=opts.height,
                  splats=opts.splats, rowsort=[])
    if not opts.merge_only:
        split_frames(opts, dev, report)
    report["merge_kernels"] = split_merge_kernels(
        dev, new=not opts.earlier_only)
    if not opts.earlier_only:              # it launches the new K13
        report["merge"] = split_merge(dev)
    if opts.json:
        with open(opts.json, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
