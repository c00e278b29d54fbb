#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`fourdgs_torch`) on one card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `fourdgs_torch/ops/csrc/` and
drives the port's main path, `render_params4d_packed` under
`auto_render_config(n, w, h, converged=False)`, on the headline scene: the
10M-splat 400^3 cube at 1920x1088. Phases, one line of output each:

  (a) the card, its power limit, the kernel builds;
  (b) K3 sample_blocks, (c) K2 rowsort_compact, (d) K1 composite — each on
      the inputs the main path hands it (captured from one frame), against
      its plain PyTorch version on the same card, plus both times;
  (e) a 20K-splat 512x256 frame on the card (kernels) against the CPU
      (plain versions): binning from one projection equal up to the order
      of tied pairs, the composite of one binning within 1e-5, and the
      whole frame from params within the tie-order tolerance;
  (f) the full frame: launch counts of one frame, then the median of timed
      frames, the aux counters, mean rgb and peak memory.

Any failed check raises, so the script exits non-zero. It prints a JSON
line of per-kernel numbers, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

N_FULL, W_FULL, H_FULL = 10_000_000, 1920, 1088
N_SMALL, W_SMALL, H_SMALL = 20_000, 512, 256
TIMED_FRAMES = 7
CAMERA = dict(position=(420.0, 300.0, 420.0), orientation=(-1.0, -0.7, -1.0),
              far=5000.0)
KERNEL_INFO = {
    "K1 composite": ("fourdgs_torch/ops/csrc/composite.cu",
                     "fourdgs/ops/composite_pallas.py:183"),
    "K2 rowsort_compact": ("fourdgs_torch/ops/csrc/rowsort.cu",
                           "fourdgs/ops/sort_pallas.py:299"),
    "K3 sample_blocks": ("fourdgs_torch/ops/csrc/sample_blocks.cu",
                         "fourdgs/ops/lookup_pallas.py:47"),
}


class SmokeFailure(AssertionError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds per call of `fn` over `reps` back-to-back calls,
    timed with CUDA events after `warmup` calls."""
    import torch
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


def capture_kernel_inputs(params, camera, cfg):
    """Render one frame with the kernel wrappers wrapped so that each
    records the (cloned) arguments of its first call: the inputs the main
    path really gives each kernel."""
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.render import tiles as TT

    seen = {}
    originals = {}

    def wrap(owner, name):
        fn = getattr(owner, name)
        originals[(owner, name)] = fn

        def recorder(*args, **kwargs):
            if name not in seen:
                seen[name] = (
                    [a.clone() if hasattr(a, "clone") else
                     [x.clone() for x in a] if isinstance(a, list) else a
                     for a in args],
                    {k: v.clone() if hasattr(v, "clone") else v
                     for k, v in kwargs.items()})
            return fn(*args, **kwargs)
        setattr(owner, name, recorder)

    wrap(TT, "sample_blocks")
    wrap(TT, "rowsort_compact")
    wrap(TP, "composite_records")
    wrap(TP, "composite_records_at")
    try:
        TP.render_params4d_packed(params, camera, 0.0, cfg=cfg)
    finally:
        for (owner, name), fn in originals.items():
            setattr(owner, name, fn)
    check(set(seen) == {"sample_blocks", "rowsort_compact",
                        "composite_records", "composite_records_at"},
          f"main path skipped a kernel wrapper: saw {sorted(seen)}")
    return seen


def phase_sample_blocks(captured):
    import torch
    from fourdgs_torch.ops import lookup_cuda as L
    (arrs,), kw = captured
    key = arrs[0]
    stride, take = kw["stride_rows"], kw["take_rows"]
    got, = L.sample_blocks([key], stride_rows=stride, take_rows=take)
    want = L.sample_blocks_plain(key, stride, take)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K3 sample_blocks differs from plain")
    ms = cuda_ms(lambda: L.sample_blocks([key], stride, take), reps=50)
    plain_ms = cuda_ms(lambda: L.sample_blocks_plain(key, stride, take),
                       reps=50)
    print(f"(b) K3 sample_blocks: {key.shape[0]:,} int32 keys, stride "
          f"{stride}, take {take} -> {got.shape[0]:,} samples; exact match; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms)


def _kept_pairs(ok, ov, live, boundary_only):
    """Per-row (key, val) pairs over live kept slots as an int64 (keep,
    rows) array with every row sorted (unkept slots -> int64 max). With
    boundary_only, rows that dropped pairs keep only keys below their last
    kept key: tied pairs at the keep boundary may be either."""
    import torch
    keep = ok.shape[0]
    mask = ok != 0x7FFFFFFF
    if boundary_only:
        full = live <= keep
        mask &= full[None, :] | (ok < ok[-1:, :])
    pairs = (ok.long() << 32) | (ov.long() & 0xFFFFFFFF)
    pairs = torch.where(mask, pairs, torch.iinfo(torch.int64).max)
    return torch.sort(pairs, dim=0).values


def phase_rowsort(captured):
    import torch
    from fourdgs_torch.ops import sort_cuda as S
    (key, val, keep), kw = captured
    row_len, cut, shift = kw["row_len"], kw["cut"], kw["key_shift"]
    lines, times = [], {}
    for label, c in (("cut", cut), ("no cut", None)):
        ok, ov, dropped = S.rowsort_compact(key, val, keep, row_len=row_len,
                                            cut=c, key_shift=shift)
        pk, pv, live = S.rowsort_compact_plain(key, val, keep, row_len, c,
                                               shift)
        p_dropped = live.sum() - (pk != S.DEAD).sum()
        torch.cuda.synchronize()
        check(torch.equal(ok, pk), f"K2 ({label}): kept keys differ")
        check(int(dropped) == int(p_dropped), f"K2 ({label}): dropped "
              f"{int(dropped)} vs plain {int(p_dropped)}")
        boundary_only = int(p_dropped) > 0
        check(torch.equal(_kept_pairs(ok, ov, live, boundary_only),
                          _kept_pairs(pk, pv, live, boundary_only)),
              f"K2 ({label}): kept (key, val) multisets differ")
        ms = cuda_ms(lambda: S.rowsort_compact(key, val, keep, row_len, c,
                                               shift), reps=20)
        def plain():
            k, _, n_live = S.rowsort_compact_plain(key, val, keep, row_len,
                                                   c, shift)
            return n_live.sum() - (k != S.DEAD).sum()
        plain_ms = cuda_ms(plain, reps=5)
        times[label] = (ms, plain_ms)
        lines.append(f"{label}: dropped {int(dropped):,}, live "
                     f"{int(live.sum()):,}, multisets "
                     f"{'below the boundary key' if boundary_only else 'all live'}"
                     f" equal, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    print(f"(c) K2 rowsort_compact: {key.shape[0]:,} slots, row_len "
          f"{row_len}, keep {keep}, {ok.shape[1]:,} rows, cut table "
          f"{cut.shape[0]} tiles; " + "; ".join(lines))
    return dict(max_abs_err=0.0, ms=times["cut"][0],
                plain_ms=times["cut"][1])


def _carry_err(got, want):
    """(max |d| over rows 0-3, max relative |d| of T, selection equal)."""
    import torch
    d03 = float((got[:, 0:4] - want[:, 0:4]).abs().max())
    dt = (got[:, 4] - want[:, 4]).abs()
    rel = float((dt / torch.clamp(want[:, 4].abs(), min=1e-30))
                [dt > 1e-12].max()) if bool((dt > 1e-12).any()) else 0.0
    same_sel = torch.equal(got[:, 4].amax(1) > 1e-6,
                           want[:, 4].amax(1) > 1e-6)
    zero_rows = bool((got[:, 5:8] == 0).all())
    return d03, rel, same_sel and zero_rows, float((got - want).abs().max())


def phase_composite(captured_first, captured_at):
    import torch
    from fourdgs_torch.ops import composite_cuda as C
    (rec, counts, kx, ky, carry), _ = captured_first
    got = C.composite_records(rec, counts, kx, ky, carry)
    want = C.composite_plain(rec, counts, kx, ky, carry)
    torch.cuda.synchronize()
    d03, rel, sel_ok, e1 = _carry_err(got, want)
    check(d03 <= 1e-5 and rel <= 1e-5 and sel_ok,
          f"K1 pass 1: rows 0-3 max |d| {d03:.3e}, T rel {rel:.3e}, "
          f"selection equal {sel_ok}")
    (rec_s, cnt_s, sel, kx_f, ky_f, carry_f), _ = captured_at
    got_at = C.composite_records_at(rec_s, cnt_s, sel, kx_f, ky_f,
                                    carry_f.clone())
    want_at = carry_f.clone()
    want_at[sel] = C.composite_plain(rec_s, cnt_s, kx_f[sel], ky_f[sel],
                                     carry_f[sel])
    torch.cuda.synchronize()
    d03s, rels, sel_ok_s, e2 = _carry_err(got_at, want_at)
    check(d03s <= 1e-5 and rels <= 1e-5 and sel_ok_s,
          f"K1 sel pass: rows 0-3 max |d| {d03s:.3e}, T rel {rels:.3e}, "
          f"selection equal {sel_ok_s}")
    ms = cuda_ms(lambda: C.composite_records(rec, counts, kx, ky, carry),
                 reps=20)
    plain_ms = cuda_ms(lambda: C.composite_plain(rec, counts, kx, ky, carry),
                       reps=3, warmup=1)

    def plain_at():
        out = carry_f.clone()
        out[sel] = C.composite_plain(rec_s, cnt_s, kx_f[sel], ky_f[sel],
                                     carry_f[sel])
    # Both sel-pass timings include one (T, 8, P) carry copy.
    at_ms = cuda_ms(lambda: C.composite_records_at(
        rec_s, cnt_s, sel, kx_f, ky_f, carry_f.clone()), reps=20)
    at_plain_ms = cuda_ms(plain_at, reps=3, warmup=1)
    print(f"(d) K1 composite: pass 1 T={rec.shape[0]}, M={rec.shape[2]}, "
          f"P={kx.shape[2]}, identity carry: rows 0-3 max |d| {d03:.3e}, "
          f"T max rel {rel:.3e}; sel pass of {sel.shape[0]} tiles "
          f"({int((cnt_s > 0).sum())} active): rows 0-3 max |d| "
          f"{d03s:.3e}, T max rel {rels:.3e}; deepening selection equal; "
          f"pass-1 kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; sel pass "
          f"kernel {at_ms:.3f} ms, plain {at_plain_ms:.3f} ms (each with a "
          f"carry copy)")
    return dict(max_abs_err=max(e1, e2), ms=ms, plain_ms=plain_ms)


def _pair_multiset(binning):
    import torch
    live = int(binning.tile_start[-1])
    t = binning.pair_tile[:live].long().cpu()
    s = binning.pair_splat[:live].long().cpu()
    return torch.sort(t << 32 | s).values


def phase_small_frame(dev):
    import dataclasses

    import torch
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.render import tiles as TT
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.scenes.cube import build_cube_scene

    cfg = auto_render_config(N_SMALL, W_SMALL, H_SMALL, converged=False)
    params = build_cube_scene(N_SMALL, seed=1, device=dev)
    params_cpu = {k: v.cpu() for k, v in params.items()}
    cam = Camera.create(**CAMERA, width=W_SMALL, height=H_SMALL, device=dev)
    cam_cpu = Camera.create(**CAMERA, width=W_SMALL, height=H_SMALL)

    # Binning of one projection on both devices.
    proj_cpu = TP.project_params4d(params_cpu, cam_cpu, 0.0)
    pm = cam_cpu.proj_matrix()
    bin_kw = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                  max_tiles_per_splat=cfg.max_tiles_per_splat,
                  compact_keep_cols=cfg.sort_compact_keep_cols,
                  big_splat_budget=cfg.big_splat_budget,
                  big_splat_keep_cols=cfg.big_splat_keep_cols,
                  pallas_compact=True, compact_row_len=cfg.compact_row_len,
                  depth_prune_cap=cfg.depth_prune_cap,
                  depth_prune_safety=cfg.depth_prune_safety)
    b_cpu = TT.bin_splats(proj_cpu, pm[0, 0], pm[1, 1], W_SMALL, H_SMALL,
                          **bin_kw)
    proj_gpu = proj_cpu.to(dev)
    b_gpu = TT.bin_splats(proj_gpu, pm[0, 0].to(dev), pm[1, 1].to(dev),
                          W_SMALL, H_SMALL, **bin_kw)
    for name in ("tile_start", "overflowed", "compact_dropped",
                 "prune_underkeep", "prune_cut", "tile_pruned", "big_ids"):
        check(torch.equal(getattr(b_gpu, name).cpu(), getattr(b_cpu, name)),
              f"(e) binning field {name} differs between card and CPU")
    check(torch.equal(_pair_multiset(b_gpu), _pair_multiset(b_cpu)),
          "(e) per-tile pair multisets differ between card and CPU")

    # Composite of ONE binning (the card's) on both devices.
    def composite(proj, binning, device, p00, p11):
        px, py, _ = TT.tile_pixel_ndc(W_SMALL, H_SMALL, cfg.tile_h,
                                      cfg.tile_w, device=device)
        tiles, _ = TP._composite_pallas_progressive(
            proj, binning, px, py, p00, p11,
            torch.tensor(cfg.background, device=device), cfg)
        return TT.assemble_image(tiles, W_SMALL, H_SMALL, cfg.tile_h,
                                 cfg.tile_w)
    b_moved = TT.TileBinning(**{
        f.name: None if getattr(b_gpu, f.name) is None
        else getattr(b_gpu, f.name).cpu()
        for f in dataclasses.fields(b_gpu)})
    img_k = composite(proj_gpu, b_gpu, dev, pm[0, 0].to(dev),
                      pm[1, 1].to(dev)).cpu()
    img_p = composite(proj_cpu, b_moved, "cpu", pm[0, 0], pm[1, 1])
    comp_err = float((img_k - img_p).abs().max())
    check(comp_err <= 1e-5, f"(e) composite of one binning: max |d| "
          f"{comp_err:.3e} > 1e-5")

    # The whole frame from params.
    img_g, aux_g = TP.render_params4d_packed(params, cam, 0.0, cfg=cfg,
                                             return_aux=True)
    img_c, aux_c = TP.render_params4d_packed(params_cpu, cam_cpu, 0.0,
                                             cfg=cfg, return_aux=True)
    img_g = img_g.cpu()
    check(tuple(img_g.shape) == (H_SMALL, W_SMALL, 4)
          and bool(torch.isfinite(img_g).all()), "(e) bad card image")
    for k in ("overflowed", "compact_dropped", "prune_underkeep",
              "live_pairs", "max_tile_pairs"):
        check(int(aux_g[k]) == int(aux_c[k]),
              f"(e) aux {k}: card {int(aux_g[k])} vs CPU {int(aux_c[k])}")
    err = (img_g - img_c).abs().amax(dim=-1)
    mean_err, frac = float(err.mean()), float((err > 1e-3).float().mean())
    check(mean_err < 1e-4 and frac < 0.01,
          f"(e) frame: mean |d| {mean_err:.3e}, share > 1e-3 {frac:.4f}")
    covered = float((img_c[..., :3].sum(-1) > 0.01).float().mean())
    print(f"(e) small frame {N_SMALL:,} splats {W_SMALL}x{H_SMALL}: binning "
          f"of one projection equal (tile_start, counters, cut, pair "
          f"multisets; {int(b_cpu.tile_start[-1]):,} live pairs); composite "
          f"of one binning max |d| {comp_err:.3e}; frame from params: aux "
          f"equal, mean |d| {mean_err:.3e}, max |d| {float(err.max()):.3e}, "
          f"share > 1e-3 {frac:.5f} (tied pairs blend in sort order); "
          f"covered share {covered:.3f}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.ops import composite_cuda, lookup_cuda, sort_cuda
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.scenes.cube import build_cube_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels = {"K1 composite": composite_cuda.COMPOSITE,
               "K2 rowsort_compact": sort_cuda.ROWSORT,
               "K3 sample_blocks": lookup_cuda.SAMPLE_BLOCKS}

    # (a) environment and builds.
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.time()
    for k in kernels.values():
        k.build()
    print(f"(a) {kind}, {torch.cuda.device_count()} visible, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; kernels built "
          f"in {time.time() - t0:.1f} s")
    print(smi)

    cfg = auto_render_config(N_FULL, W_FULL, H_FULL, converged=False)
    t0 = time.time()
    params = build_cube_scene(N_FULL, seed=0, device=dev)
    camera = Camera.create(**CAMERA, width=W_FULL, height=H_FULL, device=dev)
    captured = capture_kernel_inputs(params, camera, cfg)
    torch.cuda.synchronize()
    print(f"    scene + capture frame {time.time() - t0:.1f} s")

    # (b)-(d) each kernel against its plain version at the path's inputs.
    results = {
        "K3 sample_blocks": phase_sample_blocks(captured["sample_blocks"]),
        "K2 rowsort_compact": phase_rowsort(captured["rowsort_compact"]),
        "K1 composite": phase_composite(captured["composite_records"],
                                        captured["composite_records_at"]),
    }
    del captured
    # (e) card against CPU on a small frame.
    phase_small_frame(dev)
    torch.cuda.empty_cache()

    # (f) the full frame through the entry point a user calls.
    for k in kernels.values():
        k.launches = 0
    img, aux = TP.render_params4d_packed(params, camera, 0.0, cfg=cfg,
                                         return_aux=True)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path did not launch: {launches}")
    check(tuple(img.shape) == (H_FULL, W_FULL, 4)
          and bool(torch.isfinite(img).all()), "full frame not finite")
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(TIMED_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, aux = TP.render_params4d_packed(params, camera, 0.0, cfg=cfg,
                                             return_aux=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    med = statistics.median(times)
    aux = {k: float(v) for k, v in aux.items()}
    mean_rgb = float(img[..., :3].mean())
    print(f"(f) full frame {N_FULL:,} splats {W_FULL}x{H_FULL}: median "
          f"{med:.2f} ms ({1e3 / med:.2f} fps) over {TIMED_FRAMES} frames "
          f"[{', '.join(f'{t:.2f}' for t in times)}]; aux "
          f"{json.dumps(aux)}; mean rgb {mean_rgb:.4f}; launches per frame "
          f"{json.dumps(launches)}; peak memory {peak:.2f} GiB")
    check(aux["overflowed"] == 0 and aux["compact_dropped"] == 0
          and aux["prune_underkeep"] == 0,
          f"full frame lost pairs: {aux}")
    check(0.01 < mean_rgb < 1.0, f"full frame mean rgb {mean_rgb}")

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNEL_INFO[name][0],
             replaces=KERNEL_INFO[name][1], launches=launches[name],
             **results[name])
        for name in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
