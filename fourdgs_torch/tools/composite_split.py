"""Where the composite kernels' time goes, on one card.

    python3 -m fourdgs_torch.tools.composite_split [--width W --height H]
                                                   [--json PATH]

Renders the headline scene (the 10M-splat cube) and records what the
frames hand the composite (K1) and its backward (K8): K1 at the converged
frame's pass 1, at the non-converged frame's pass 1 and each of its five
deepening passes, and at both bands of the 3840x2160 converged frame; K8 at a
converged and a non-converged grad step (pass 1 and each deepening pass, the
`sel` form). At each site, with plain PyTorch on the card:

  * records a tile and chunks run after the tile-wide early exit
    (histograms);
  * covered (record, pixel) pairs as a share of the pairs tested (K1: the
    records before the count in the chunks run; K8: every record of those
    chunks, as K8 writes the padding's cotangents too);
  * the share of (record, warp) pairs whose cull box (`composite_cuda.
    composite_cull_boxes`) misses the box of the warp's pixels, under three
    pixel-to-lane maps of the 16x128 tile: strided (thread t of 256 owns
    pixels t + 256 j: a warp holds 32 columns x every other row, the earlier
    kernels' map), compact 32 columns x 8 adjacent rows (K8's), 32 x 4
    (K1's) and 16 x 16; also the share of (record, warp) pairs with a
    covered pixel (in K8 those run the warp reduction);
  * the ragged tail of the grid: the end of a greedy schedule of the
    blocks over 132 SMs x 2 blocks, each block costing its chunks run, over
    the even share, in grid order and taking the deepest tiles first.

It prints what `nvcc -Xptxas -v` reports for every instance of K1 and K8
and of the earlier form (registers, spill bytes, static shared memory).
Then it times the port's K1 and K8 (taking the deepest tiles first, as the
wrappers launch them, and in tile order) beside the form they had before
the shared record walk (`tools/csrc/composite_loops.cu`, a measuring
instrument) as it was and in the variants its source names, and holds the
outputs against the earlier form's bit for bit.

Times are CUDA events around back-to-back launches after a warm-up.
"""

from __future__ import annotations

import argparse
import ctypes
import heapq
import json
import subprocess
import sys
from pathlib import Path

import torch

N_SPLATS, WIDTH, HEIGHT = 10_000_000, 1920, 1088
W_4K, H_4K = 3840, 2160
REPS = 20
SLOTS = 132 * 2            # SMs x resident blocks a kernel of 256 threads
BATCH = 64                 # tiles a step of the plain walk statistics
LOOPS_SOURCE = str(Path(__file__).resolve().parent / "csrc"
                   / "composite_loops.cu")
K1_VARIANTS = {
    "as it was": (),
    "coverage test only": ("-DLOOPS_COVER_ONLY",),
    "loops interchanged": ("-DLOOPS_INTERCHANGE",),
    "cull only, strided map": ("-DLOOPS_CULL",),
    "cull only, compact map": ("-DLOOPS_CULL", "-DLOOPS_COMPACT"),
    "interchanged + cull, compact map": ("-DLOOPS_INTERCHANGE",
                                         "-DLOOPS_CULL", "-DLOOPS_COMPACT"),
}
K8_VARIANTS = {
    "as it was": (),
    "coverage test only": ("-DLOOPS_COVER_ONLY",),
    "no warp reduction": ("-DLOOPS_NO_REDUCE",),
    "cull only, strided map": ("-DLOOPS_CULL",),
    "cull only, compact map": ("-DLOOPS_CULL", "-DLOOPS_COMPACT"),
}
# Variants whose output must equal the earlier form's bit for bit.
EXACT = ("as it was", "loops interchanged", "cull only, strided map",
         "cull only, compact map", "interchanged + cull, compact map")


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


def pixel_maps(p, tile_w):
    """The pixel-to-lane maps compared, each (warps, pixels a warp): the
    earlier kernels' strided map (256 threads), K8's and K1's compact maps,
    and square patches of 256 pixels."""
    from fourdgs_torch.ops import composite_cuda as C
    maps = {"strided": C.walk_pixel_map(p, 0, 8),
            "compact 32 x 8 (K8)": C.walk_pixel_map(p, tile_w, C.K8_PPT),
            "compact 32 x 4 (K1)": C.walk_pixel_map(p, tile_w, C.K1_PPT)}
    if p % 256 == 0 and tile_w % 16 == 0 and p // tile_w >= 16:
        per_row = tile_w // 16
        w = torch.arange(p // 256)[:, None]
        i = torch.arange(256)[None, :]
        maps["16 x 16"] = (((w // per_row) * 16 + i // 16) * tile_w
                           + (w % per_row) * 16 + i % 16)
    return maps


def capture(params, camera, cfg, targets, t=0.0, grad=False):
    """The cloned arguments of every call of the wrappers `targets`
    ((module, name) pairs) in one frame (or grad step), in call order."""
    from fourdgs_torch.render import pipeline as TP
    calls, originals = [], {}

    def wrap(owner, name):
        fn = getattr(owner, name)
        originals[(owner, name)] = fn

        def recorder(*args):
            calls.append((name, [a.clone() if hasattr(a, "clone") else a
                                 for a in args]))
            return fn(*args)
        setattr(owner, name, recorder)
    for owner, name in targets:
        wrap(owner, name)
    try:
        if grad:
            p = {k: v.detach().clone().requires_grad_(True)
                 for k, v in params.items()}
            img = TP.render_params4d_packed(p, camera, t, cfg=cfg)
            (img[..., :3] ** 2).mean().backward()
        else:
            TP.render_params4d_packed(params, camera, t, cfg=cfg)
    finally:
        for (owner, name), fn in originals.items():
            setattr(owner, name, fn)
    torch.cuda.synchronize()
    return calls


def _hist(x):
    x = x.double()
    q = torch.quantile(x, torch.tensor([0.5, 0.99], dtype=x.dtype,
                                       device=x.device))
    return dict(mean=float(x.mean()), p50=float(q[0]), p99=float(q[1]),
                max=float(x.max()), min=float(x.min()))


def ragged_tail(cost):
    """Makespan of a greedy schedule of the blocks over SLOTS, over the even
    share sum / SLOTS: in grid order, and taking the deepest first."""
    def makespan(order):
        slots = [0.0] * SLOTS
        for c in order:
            heapq.heappush(slots, heapq.heappop(slots) + c)
        return max(slots)
    even = float(cost.sum()) / SLOTS
    if even == 0:
        return dict(grid_order=1.0, deepest_first=1.0)
    return dict(grid_order=makespan(cost.tolist()) / even,
                deepest_first=makespan(sorted(cost.tolist(), reverse=True))
                / even)


def walk_stats(rec, counts, kx, ky, carry, tile_w, bwd):
    """The site's statistics (see the module docstring), by a plain walk of
    the chunks with the kernels' early exit."""
    from fourdgs_torch.ops import composite_cuda as C
    t_tiles, _, m = rec.shape
    p = kx.shape[-1]
    maps = pixel_maps(p, tile_w)
    n_chunks = (counts.long() + C.CHUNK - 1) // C.CHUNK
    trans = carry[:, 4].clone()                            # (T, P)
    run = torch.zeros(t_tiles, dtype=torch.long, device=rec.device)
    tested = covered = walked_records = 0
    missed = dict.fromkeys(maps, 0)
    with_cover = dict.fromkeys(maps, 0)
    for c in range(m // C.CHUNK):
        go = (c < n_chunks) & (trans.amax(dim=1) > 1e-6)
        idx_all = go.nonzero().squeeze(1)
        if idx_all.numel() == 0:
            break
        run[idx_all] += 1
        cols = slice(c * C.CHUNK, (c + 1) * C.CHUNK)
        for i0 in range(0, idx_all.numel(), BATCH):
            idx = idx_all[i0:i0 + BATCH]
            r = rec[idx, :, cols]
            step = C._chunk_alpha(r, kx[idx], ky[idx])
            cover, alpha = step[7], step[9]                  # (A, C, P)
            live = (torch.arange(C.CHUNK, device=rec.device)[None, :]
                    < (counts[idx].long() - c * C.CHUNK)[:, None])
            walked = torch.ones_like(live) if bwd else live   # (A, C)
            walked_records += int(walked.sum())
            tested += int(walked.sum()) * p
            covered += int((cover & walked[..., None]).sum())
            boxes = C.composite_cull_boxes(r)
            for name, pix in maps.items():
                hits = C.walk_warp_hits(boxes, kx[idx], ky[idx], pix)
                hits = hits & walked[..., None]
                missed[name] += int(walked.sum()) * pix.shape[0] \
                    - int(hits.sum())
                per_warp = cover[:, :, pix.to(rec.device)].any(-1)
                with_cover[name] += int((per_warp & walked[..., None]).sum())
            trans[idx] = trans[idx] * torch.cumprod(1.0 - alpha, dim=1)[:, -1]
    return dict(
        tiles=t_tiles, records_a_tile=_hist(counts),
        chunks_run=torch.bincount(run, minlength=m // C.CHUNK + 1).tolist(),
        pairs_tested=tested, covered_share=covered / max(tested, 1),
        records_walked=walked_records,
        culled_share={k: v / max(walked_records * maps[k].shape[0], 1)
                      for k, v in missed.items()},
        warp_pairs_with_a_covered_pixel={
            k: v / max(walked_records * maps[k].shape[0], 1)
            for k, v in with_cover.items()},
        ragged_tail=ragged_tail(run.double().cpu()))


def ptxas_report():
    """Registers, spill bytes and static shared memory of every instance of
    K1 and K8 and of the earlier form (nvcc -Xptxas -v), by kernel and P."""
    import os
    import re

    from fourdgs_torch.ops import _build as B
    report = []
    for src in (B.CSRC / "composite.cu", B.CSRC / "composite_bwd.cu",
                Path(LOOPS_SOURCE)):
        flags = [f for f in B.NVCC_FLAGS if f != "-shared"]
        proc = subprocess.run(
            [B._nvcc(), *flags, "-fmad=false", "-Xptxas", "-v", "-c", "-o",
             os.devnull, str(src)], capture_output=True, text=True,
            timeout=600, check=True)
        entry = None
        for line in proc.stderr.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
                p = re.search(r"ILi(\d+)E", name)
                kernel = "K8" if "bwd" in name else "K1"
                if src.name == Path(LOOPS_SOURCE).name:
                    kernel += ", earlier form"
                entry = dict(source=src.name, kernel=kernel,
                             p=int(p.group(1)) if p else 2048)
                report.append(entry)
            elif entry is not None and "spill stores" in line:
                st, ld = re.findall(r"(\d+) bytes spill", line)
                entry.update(spill_stores=int(st), spill_loads=int(ld))
            elif entry is not None and "registers" in line:
                entry["registers"] = int(re.search(r"Used (\d+) registers",
                                                   line).group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                entry["static_smem"] = int(sm.group(1)) if sm else 0
    return report


def loops_kernel(flags, bwd):
    """The earlier K1 (or, with `bwd`, K8) built with the switches `flags`."""
    from fourdgs_torch.ops._build import CudaKernel
    if bwd:
        return CudaKernel(LOOPS_SOURCE, "fourdgs_composite_bwd_loops",
                          [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4,
                          extra_flags=("-fmad=false",) + tuple(flags))
    return CudaKernel(LOOPS_SOURCE, "fourdgs_composite_loops",
                      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4,
                      extra_flags=("-fmad=false",) + tuple(flags))


def build_all():
    """Every variant of the earlier form and the port's kernels, one nvcc
    each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from fourdgs_torch.ops import composite_cuda as C
    kernels = [C.COMPOSITE, C.COMPOSITE_BWD]
    kernels += [loops_kernel(f, False) for f in K1_VARIANTS.values()]
    kernels += [loops_kernel(f, True) for f in K8_VARIANTS.values()]
    with ThreadPoolExecutor(len(kernels)) as ex:
        list(ex.map(lambda k: k.build(), kernels))


def time_k1(rec, counts, sel, kx, ky, carry):
    """K1 and the earlier form's variants on one site's inputs: ms, and
    whether each output equals the earlier form's bit for bit."""
    from fourdgs_torch.ops import composite_cuda as C
    stream = torch.cuda.current_stream().cuda_stream
    rec, counts = rec.contiguous(), counts.to(torch.int32).contiguous()
    sel = None if sel is None else sel.to(torch.int32).contiguous()
    rows = slice(None) if sel is None else sel.long()
    p = kx.shape[-1]
    outs, ms = {}, {}

    def launcher(kernel, out, *order):
        return lambda: kernel(rec, counts, sel, *order, kx, ky, carry, out,
                              rec.shape[0], C._F, rec.shape[2], p,
                              stream=stream)
    # The port's K1 as the wrapper launches it (deepest tiles first) and in
    # tile order; the earlier form in tile order.
    kernels = {"port's K1": (C.COMPOSITE, C.deepest_first(counts)),
               "port's K1, tile order": (C.COMPOSITE, None)}
    kernels.update({k: (loops_kernel(f, False),)
                    for k, f in K1_VARIANTS.items()})
    for name, kernel in kernels.items():
        out = torch.zeros_like(carry)
        launch = launcher(kernel[0], out, *kernel[1:])
        launch()
        torch.cuda.synchronize()
        outs[name] = out[rows].clone()
        ms[name] = cuda_ms(launch)
    ref = outs["as it was"]
    equal = {k: torch.equal(v, ref) for k, v in outs.items()
             if k.startswith("port's") or k in EXACT}
    return ms, equal


def time_k8(rec, counts, sel, kx, ky, carry, fout, g):
    """K8 and the earlier form's variants on one site's inputs: ms, whether
    each output equals the earlier form's bit for bit, and the port's
    largest difference relative to each field's max."""
    from fourdgs_torch.ops import composite_cuda as C
    stream = torch.cuda.current_stream().cuda_stream
    rec, counts = rec.contiguous(), counts.to(torch.int32).contiguous()
    sel = None if sel is None else sel.to(torch.int32).contiguous()
    p = kx.shape[-1]
    outs, ms = {}, {}
    kernels = {"port's K8": (C.COMPOSITE_BWD, C.deepest_first(counts)),
               "port's K8, tile order": (C.COMPOSITE_BWD, None)}
    kernels.update({k: (loops_kernel(f, True),)
                    for k, f in K8_VARIANTS.items()})
    for name, kernel in kernels.items():
        d = torch.zeros_like(rec)

        def launch(kernel=kernel, d=d):
            kernel[0](rec, counts, sel, *kernel[1:], kx, ky, carry, fout, g,
                      d, rec.shape[0], C._F, rec.shape[2], p, stream=stream)
        launch()
        torch.cuda.synchronize()
        outs[name] = d.clone()
        ms[name] = cuda_ms(launch)
    ref = outs["as it was"][:, :C.N_FIELDS].double()
    scale = ref.abs().amax(dim=(0, 2)).clamp(min=1e-30)[None, :, None]
    rel = float(((outs["port's K8"][:, :C.N_FIELDS].double() - ref).abs()
                 / scale).max())
    equal = {k: torch.equal(v, outs["as it was"]) for k, v in outs.items()
             if k.startswith("port's") or k in EXACT}
    equal["port's K8, the two orders alike"] = torch.equal(
        outs["port's K8"], outs["port's K8, tile order"])
    return ms, equal, rel


def k1_sites(params, camera, cfg, mode):
    from fourdgs_torch.render import pipeline as TP
    calls = capture(params, camera, cfg, [(TP, "composite_records"),
                                          (TP, "composite_records_at")])
    sites, n_at = [], 0
    for name, args in calls:
        if name == "composite_records":
            rec, counts, kx, ky, carry = args
            sites.append((f"{mode}, pass 1", rec, counts, None, kx, ky,
                          carry))
        else:
            n_at += 1
            rec, counts, sel, kx, ky, carry = args
            sites.append((f"{mode}, deepening pass {n_at}", rec, counts, sel,
                          kx, ky, carry))
    return sites


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None,
                    help="also write the results to this file")
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--height", type=int, default=HEIGHT)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("composite_split: no CUDA device", file=sys.stderr)
        return 2
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.ops import composite_cuda as C
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.scenes.cube import (CUBE_CAMERA, build_cube_scene,
                                           converged_cube_scene)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    build_all()
    report_ptxas = ptxas_report()
    for e in report_ptxas:
        print("ptxas: " + json.dumps(e))
    report = dict(device=smi, width=opts.width, height=opts.height,
                  ptxas=report_ptxas, k1=[], k8=[])
    params = build_cube_scene(N_SPLATS, seed=0, device=dev)
    conv = converged_cube_scene(params)
    cam = Camera.create(**CUBE_CAMERA, width=opts.width, height=opts.height,
                        device=dev)
    cam_4k = Camera.create(**CUBE_CAMERA, width=W_4K, height=H_4K,
                           device=dev)
    size = f"{opts.width}x{opts.height}"
    frames = [(f"converged {size}", conv, cam,
               auto_render_config(N_SPLATS, opts.width, opts.height)),
              (f"non-converged {size}", params, cam,
               auto_render_config(N_SPLATS, opts.width, opts.height,
                                  converged=False)),
              ("converged 4K band", conv, cam_4k,
               auto_render_config(N_SPLATS, W_4K, H_4K))]

    def show(kernel, label, st, ms, equal, extra=""):
        print(f"{kernel} {label}: " + json.dumps(st))
        print("  ms: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
        print("  bit-equal to the earlier form: " + json.dumps(equal) + extra)

    for mode, scene, camera, cfg in frames:
        sites = k1_sites(scene, camera, cfg, mode)
        for i, (label, rec, counts, sel, kx, ky, carry) in enumerate(sites):
            if "4K" in mode:
                label = f"{mode} {i}, pass 1"
            rows = slice(None) if sel is None else sel.long()
            st = walk_stats(rec, counts, kx[rows], ky[rows], carry[rows],
                            cfg.tile_w, bwd=False)
            ms, equal = time_k1(rec, counts, sel, kx, ky, carry)
            show("K1", label, st, ms, equal)
            report["k1"].append(dict(site=label, stats=st, ms=ms,
                                     bit_equal=equal))
        del sites
        torch.cuda.empty_cache()
    for mode, scene, cfg in (
            (f"converged grad step {size}", conv,
             auto_render_config(N_SPLATS, opts.width, opts.height)),
            (f"non-converged grad step {size}", params,
             auto_render_config(N_SPLATS, opts.width, opts.height,
                                converged=False))):
        calls = capture(scene, cam, cfg, [(C, "composite_records_bwd")],
                        t=0.37, grad=True)
        for i, (_, args) in enumerate(calls):
            rec, counts, sel, kx, ky, carry, fout, g = args
            # The backward meets the deepening passes last first.
            label = f"{mode}, " + ("pass 1" if sel is None
                                   else f"deepening pass {len(calls) - 1 - i}")
            rows = slice(None) if sel is None else sel.long()
            st = walk_stats(rec, counts, kx[rows], ky[rows], carry,
                            cfg.tile_w, bwd=True)
            ms, equal, rel = time_k8(rec, counts, sel, kx, ky, carry, fout, g)
            show("K8", label, st, ms, equal,
                 f"; port's K8 against the earlier form {rel:.3e} of a "
                 f"field's max")
            report["k8"].append(dict(site=label, stats=st, ms=ms,
                                     bit_equal=equal, rel_to_earlier=rel))
        del calls
        torch.cuda.empty_cache()
    if opts.json:
        with open(opts.json, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
