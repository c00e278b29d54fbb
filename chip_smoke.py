#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`fourdgs_torch`) on one card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `fourdgs_torch/ops/csrc/` (one
nvcc per source, all in parallel) and drives the port's two render paths,
`render_params4d_packed` under `auto_render_config(n, w, h, converged=...)`,
on the headline scene: the 10M-splat 400^3 cube at 1920x1088. Each path
first renders one frame with every kernel wrapper it calls recording its
arguments, and every kernel is then held against its plain PyTorch version
on the same card at each of those call sites. Phases:

  (a) the card, its power limit, the kernel builds;
  non-converged path (exact head, progressive deepening):
  (b) K3 sample_blocks, (c) K2 rowsort_compact, (d) K1 composite (pass 1
      and one deepening pass), each with the kernel and plain times;
  (e) a 20K-splat 512x256 frame on the card (kernels) against the CPU
      (plain versions): binning from one projection equal up to the order
      of tied pairs, the composite of one binning within 1e-5, and the
      whole frame from params within the tie-order tolerance;
  (f) the full frame: launch counts of one frame, then the median of timed
      frames, the aux counters, mean rgb and peak memory;
  converged path (exact head + banded-OIT tail; the scene Morton-ordered
  and dead-padded to a multiple of 16384, as bench.py builds it):
  (g) every kernel of the path at its call sites: K3 (the depth prune's
      sample and the band-cut sample), K2, K1 pass 1, K4, K5, K6 (main and
      big-tier stream, and the main meta at a 1024-wide chunk, where the
      bands and slot masks are not trivial) and K7 (main and big-tier
      stream), each with the kernel and plain times;
  (h) the 20K-splat frame, converged, on the card against the CPU: binning
      (head re-cut included) equal, head + tail of one binning within 1e-5,
      the whole frame within the tie-order tolerance;
  (i) the full converged frame: launch counts of one frame (K1 once, K2,
      K3 twice, K4, K5, K6 twice, K7 twice), timed frames, aux counters
      (overflowed, compact_dropped and resid_transmittance 0; the prune's
      under-keep is informational, as pruned pairs go to the tail), mean
      rgb, peak memory.

Any failed check raises, so the script exits non-zero. It prints a JSON
line with one entry per kernel and path (launches per frame of that path;
ms, plain_ms summed over the path's call sites, one launch each, and
max_abs_err the largest over them; `calls` gives each site), then as its
last line
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
TIMED_FRAMES = 5
TIMED_FRAMES_CONVERGED = 7
KERNEL_INFO = {
    "K1 composite": ("fourdgs_torch/ops/csrc/composite.cu",
                     "fourdgs/ops/composite_pallas.py:183"),
    "K2 rowsort_compact": ("fourdgs_torch/ops/csrc/rowsort.cu",
                           "fourdgs/ops/sort_pallas.py:299"),
    "K3 sample_blocks": ("fourdgs_torch/ops/csrc/sample_blocks.cu",
                         "fourdgs/ops/lookup_pallas.py:47"),
    "K4 pack_record_fields": ("fourdgs_torch/ops/csrc/pack.cu",
                              "fourdgs/ops/pack_pallas.py:104"),
    "K5 pack_meta_rows": ("fourdgs_torch/ops/csrc/pack.cu",
                          "fourdgs/ops/pack_pallas.py:39"),
    "K6 tail_prepass": ("fourdgs_torch/ops/csrc/tail_prepass.cu",
                        "fourdgs/ops/tail_pallas.py:178"),
    "K7 tail_accumulate": ("fourdgs_torch/ops/csrc/tail.cu",
                           "fourdgs/ops/tail_pallas.py:425"),
}
# K7 against its plain version: the kernel adds each sample's planes with
# atomics in no fixed order, so sums of up to thousands of terms differ in
# rounding; every per-sample operation rounds alike (both are float32, and
# the kernel is built with -fmad=false).
K7_RTOL, K7_ATOL = 1e-4, 1e-5


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


def _clone(a):
    if hasattr(a, "clone"):
        return a.clone()
    if isinstance(a, (list, tuple)):
        return type(a)(_clone(x) for x in a)
    return a


def capture_kernel_inputs(params, camera, cfg, targets):
    """Render one frame with the kernel wrappers `targets` ((module, name)
    pairs) wrapped so that each records the cloned arguments of every call:
    the inputs the path really gives each kernel. Returns {"module.name":
    [(args, kwargs), ...]} (the calling module's last name) in call order."""
    from fourdgs_torch.render import pipeline as TP

    seen = {}
    originals = {}

    def wrap(owner, name):
        fn = getattr(owner, name)
        originals[(owner, name)] = fn
        label = f"{owner.__name__.rsplit('.', 1)[-1]}.{name}"

        def recorder(*args, **kwargs):
            seen.setdefault(label, []).append(
                (_clone(list(args)), {k: _clone(v) for k, v in kwargs.items()}))
            return fn(*args, **kwargs)
        setattr(owner, name, recorder)

    for owner, name in targets:
        wrap(owner, name)
    try:
        TP.render_params4d_packed(params, camera, 0.0, cfg=cfg)
    finally:
        for (owner, name), fn in originals.items():
            setattr(owner, name, fn)
    want = {f"{o.__name__.rsplit('.', 1)[-1]}.{n}" for o, n in targets}
    check(set(seen) == want, f"the path skipped a kernel wrapper: saw "
          f"{sorted(seen)}, want {sorted(want)}")
    return seen


def _sites(sites):
    """One kernel's result over its call sites in a path: times summed (one
    launch per site), the largest error."""
    return dict(max_abs_err=max(s["max_abs_err"] for s in sites),
                ms=sum(s["ms"] for s in sites),
                plain_ms=sum(s["plain_ms"] for s in sites), calls=sites)


def phase_sample_blocks(tag, calls, n_sites):
    """K3 at each of the path's `n_sites` call sites, in call order."""
    import torch
    from fourdgs_torch.ops import lookup_cuda as L
    check(len(calls) == n_sites, f"{tag} K3: {len(calls)} calls in one "
          f"frame, want {n_sites}")
    sites, lines = [], []
    for (arrs,), kw in calls:
        key = arrs[0]
        stride, take = kw["stride_rows"], kw["take_rows"]
        got, = L.sample_blocks([key], stride_rows=stride, take_rows=take)
        want = L.sample_blocks_plain(key, stride, take)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{tag} K3 sample_blocks (stride "
              f"{stride}, take {take}) differs from plain")
        ms = cuda_ms(lambda: L.sample_blocks([key], stride, take), reps=50)
        plain_ms = cuda_ms(lambda: L.sample_blocks_plain(key, stride, take),
                           reps=50)
        site = (f"{key.shape[0]:,} int32 keys, stride {stride}, take {take} "
                f"-> {got.shape[0]:,} samples")
        sites.append(dict(site=site, max_abs_err=0.0, ms=ms,
                          plain_ms=plain_ms))
        lines.append(f"{site}: exact match; kernel {ms:.4f} ms, plain "
                     f"{plain_ms:.4f} ms")
    print(f"{tag} K3 sample_blocks: " + "; ".join(lines))
    return _sites(sites)


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


def phase_rowsort(tag, calls, also_no_cut):
    """K2 at the path's one call site; with `also_no_cut`, also without its
    cut (the reference's second call form of the kernel)."""
    import torch
    from fourdgs_torch.ops import sort_cuda as S
    check(len(calls) == 1, f"{tag} K2: {len(calls)} calls in one frame")
    (key, val, keep), kw = calls[0]
    row_len, cut, shift = kw["row_len"], kw["cut"], kw["key_shift"]
    lines, sites = [], []
    forms = (("cut", cut),) + ((("no cut", None),) if also_no_cut else ())
    for label, c in forms:
        ok, ov, dropped = S.rowsort_compact(key, val, keep, row_len=row_len,
                                            cut=c, key_shift=shift)
        pk, pv, live = S.rowsort_compact_plain(key, val, keep, row_len, c,
                                               shift)
        p_dropped = live.sum() - (pk != S.DEAD).sum()
        torch.cuda.synchronize()
        check(torch.equal(ok, pk), f"{tag} K2 ({label}): kept keys differ")
        check(int(dropped) == int(p_dropped), f"{tag} K2 ({label}): dropped "
              f"{int(dropped)} vs plain {int(p_dropped)}")
        boundary_only = int(p_dropped) > 0
        check(torch.equal(_kept_pairs(ok, ov, live, boundary_only),
                          _kept_pairs(pk, pv, live, boundary_only)),
              f"{tag} K2 ({label}): kept (key, val) multisets differ")
        ms = cuda_ms(lambda: S.rowsort_compact(key, val, keep, row_len, c,
                                               shift), reps=20)
        def plain():
            k, _, n_live = S.rowsort_compact_plain(key, val, keep, row_len,
                                                   c, shift)
            return n_live.sum() - (k != S.DEAD).sum()
        plain_ms = cuda_ms(plain, reps=5)
        if c is not None:
            sites.append(dict(site=f"{key.shape[0]:,} slots, keep {keep}, "
                              f"cut", max_abs_err=0.0, ms=ms,
                              plain_ms=plain_ms))
        lines.append(f"{label}: dropped {int(dropped):,}, live "
                     f"{int(live.sum()):,}, multisets "
                     f"{'below the boundary key' if boundary_only else 'all live'}"
                     f" equal, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    print(f"{tag} K2 rowsort_compact: {key.shape[0]:,} slots, row_len "
          f"{row_len}, keep {keep}, {ok.shape[1]:,} rows, cut table "
          f"{cut.shape[0]} tiles; " + "; ".join(lines))
    return _sites(sites)


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


def phase_composite(tag, calls_first, calls_at=None):
    """K1 at pass 1 (one call per frame) and, given `calls_at`, at the first
    deepening pass (composite_records_at)."""
    import torch
    from fourdgs_torch.ops import composite_cuda as C
    check(len(calls_first) == 1, f"{tag} K1 pass 1: {len(calls_first)} "
          f"calls in one frame")
    (rec, counts, kx, ky, carry), _ = calls_first[0]
    got = C.composite_records(rec, counts, kx, ky, carry)
    want = C.composite_plain(rec, counts, kx, ky, carry)
    torch.cuda.synchronize()
    d03, rel, sel_ok, e1 = _carry_err(got, want)
    check(d03 <= 1e-5 and rel <= 1e-5 and sel_ok,
          f"{tag} K1 pass 1: rows 0-3 max |d| {d03:.3e}, T rel {rel:.3e}, "
          f"selection equal {sel_ok}")
    ms = cuda_ms(lambda: C.composite_records(rec, counts, kx, ky, carry),
                 reps=20)
    plain_ms = cuda_ms(lambda: C.composite_plain(rec, counts, kx, ky, carry),
                       reps=3, warmup=1)
    line = (f"{tag} K1 composite: pass 1 T={rec.shape[0]}, M={rec.shape[2]}, "
            f"P={kx.shape[2]}, {int(counts.sum()):,} records, identity "
            f"carry: rows 0-3 max |d| {d03:.3e}, T max rel {rel:.3e}, "
            f"selection equal; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    sites = [dict(site=f"pass 1, T={rec.shape[0]}, M={rec.shape[2]}",
                  max_abs_err=e1, ms=ms, plain_ms=plain_ms)]
    if calls_at is None:
        print(line)
        return _sites(sites)
    (rec_s, cnt_s, sel, kx_f, ky_f, carry_f), _ = calls_at[0]
    got_at = C.composite_records_at(rec_s, cnt_s, sel, kx_f, ky_f,
                                    carry_f.clone())
    want_at = carry_f.clone()
    want_at[sel] = C.composite_plain(rec_s, cnt_s, kx_f[sel], ky_f[sel],
                                     carry_f[sel])
    torch.cuda.synchronize()
    d03s, rels, sel_ok_s, e2 = _carry_err(got_at, want_at)
    check(d03s <= 1e-5 and rels <= 1e-5 and sel_ok_s,
          f"{tag} K1 sel pass: rows 0-3 max |d| {d03s:.3e}, T rel "
          f"{rels:.3e}, selection equal {sel_ok_s}")

    def plain_at():
        out = carry_f.clone()
        out[sel] = C.composite_plain(rec_s, cnt_s, kx_f[sel], ky_f[sel],
                                     carry_f[sel])
    # Both sel-pass timings include one (T, 8, P) carry copy.
    at_ms = cuda_ms(lambda: C.composite_records_at(
        rec_s, cnt_s, sel, kx_f, ky_f, carry_f.clone()), reps=20)
    at_plain_ms = cuda_ms(plain_at, reps=3, warmup=1)
    print(f"{line}; sel pass of {sel.shape[0]} tiles "
          f"({int((cnt_s > 0).sum())} active): rows 0-3 max |d| "
          f"{d03s:.3e}, T max rel {rels:.3e}, deepening selection equal; "
          f"kernel {at_ms:.3f} ms, plain {at_plain_ms:.3f} ms (each with a "
          f"carry copy)")
    sites.append(dict(site=f"deepening pass, {sel.shape[0]} tiles",
                      max_abs_err=e2, ms=at_ms, plain_ms=at_plain_ms))
    return _sites(sites)


def _pair_multiset(binning):
    import torch
    live = int(binning.tile_start[-1])
    t = binning.pair_tile[:live].long().cpu()
    s = binning.pair_splat[:live].long().cpu()
    return torch.sort(t << 32 | s).values


def phase_small_frame(dev, converged):
    import dataclasses

    import torch
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.render import tiles as TT
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.scenes.cube import (CUBE_CAMERA, build_cube_scene,
                                           converged_cube_scene)

    tag = "(h)" if converged else "(e)"
    cfg = auto_render_config(N_SMALL, W_SMALL, H_SMALL, converged=converged)
    params = build_cube_scene(N_SMALL, seed=1, device=dev)
    if converged:
        params = converged_cube_scene(params)
    params_cpu = {k: v.cpu() for k, v in params.items()}
    cam = Camera.create(**CUBE_CAMERA, width=W_SMALL, height=H_SMALL,
                        device=dev)
    cam_cpu = Camera.create(**CUBE_CAMERA, width=W_SMALL, height=H_SMALL)

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
                  depth_prune_safety=cfg.depth_prune_safety,
                  head_cap=cfg.max_splats_per_tile if converged else 0)
    b_cpu = TT.bin_splats(proj_cpu, pm[0, 0], pm[1, 1], W_SMALL, H_SMALL,
                          **bin_kw)
    proj_gpu = proj_cpu.to(dev)
    b_gpu = TT.bin_splats(proj_gpu, pm[0, 0].to(dev), pm[1, 1].to(dev),
                          W_SMALL, H_SMALL, **bin_kw)
    fields = ["tile_start", "overflowed", "compact_dropped", "prune_underkeep",
              "prune_cut", "tile_pruned", "big_ids"]
    if converged:
        fields.append("head_counts")
    for name in fields:
        check(torch.equal(getattr(b_gpu, name).cpu(), getattr(b_cpu, name)),
              f"{tag} binning field {name} differs between card and CPU")
    check(torch.equal(_pair_multiset(b_gpu), _pair_multiset(b_cpu)),
          f"{tag} per-tile pair multisets differ between card and CPU")

    # Composite (and tail) of ONE binning (the card's) on both devices.
    def composite(proj, binning, device, p00, p11):
        px, py, _ = TT.tile_pixel_ndc(W_SMALL, H_SMALL, cfg.tile_h,
                                      cfg.tile_w, device=device)
        tiles, resid = TP._composite_pallas_progressive(
            proj, binning, px, py, p00, p11,
            torch.tensor(cfg.background, device=device), cfg,
            image_size=(W_SMALL, H_SMALL))
        return TT.assemble_image(tiles, W_SMALL, H_SMALL, cfg.tile_h,
                                 cfg.tile_w), float(resid.max())
    b_moved = TT.TileBinning(**{
        f.name: None if getattr(b_gpu, f.name) is None
        else getattr(b_gpu, f.name).cpu()
        for f in dataclasses.fields(b_gpu)})
    img_k, resid_k = composite(proj_gpu, b_gpu, dev, pm[0, 0].to(dev),
                               pm[1, 1].to(dev))
    img_p, resid_p = composite(proj_cpu, b_moved, "cpu", pm[0, 0], pm[1, 1])
    comp_err = float((img_k.cpu() - img_p).abs().max())
    # The tail's atomic sums and the card's exp / log1p round apart from the
    # CPU's in the last bits; 1e-5 holds for the exact head alone.
    comp_tol = 1e-4 if converged else 1e-5
    check(comp_err <= comp_tol and resid_k == resid_p,
          f"{tag} composite of one binning: max |d| {comp_err:.3e} > "
          f"{comp_tol:g} or resid {resid_k} vs {resid_p}")

    # The whole frame from params.
    img_g, aux_g = TP.render_params4d_packed(params, cam, 0.0, cfg=cfg,
                                             return_aux=True)
    img_c, aux_c = TP.render_params4d_packed(params_cpu, cam_cpu, 0.0,
                                             cfg=cfg, return_aux=True)
    img_g = img_g.cpu()
    check(tuple(img_g.shape) == (H_SMALL, W_SMALL, 4)
          and bool(torch.isfinite(img_g).all()), f"{tag} bad card image")
    for k in ("overflowed", "compact_dropped", "prune_underkeep",
              "live_pairs", "max_tile_pairs"):
        check(int(aux_g[k]) == int(aux_c[k]),
              f"{tag} aux {k}: card {int(aux_g[k])} vs CPU {int(aux_c[k])}")
    if converged:
        check(float(aux_g["resid_transmittance"]) == 0.0
              == float(aux_c["resid_transmittance"]),
              f"{tag} resid_transmittance not 0")
    err = (img_g - img_c).abs().amax(dim=-1)
    mean_err, frac = float(err.mean()), float((err > 1e-3).float().mean())
    check(mean_err < 1e-4 and frac < 0.01,
          f"{tag} frame: mean |d| {mean_err:.3e}, share > 1e-3 {frac:.4f}")
    covered = float((img_c[..., :3].sum(-1) > 0.01).float().mean())
    print(f"{tag} small frame{' (converged)' if converged else ''} "
          f"{N_SMALL:,} splats {W_SMALL}x{H_SMALL}: binning of one "
          f"projection equal (tile_start, counters, cut"
          f"{', head_counts' if converged else ''}, pair multisets; "
          f"{int(b_cpu.tile_start[-1]):,} live pairs); composite "
          f"{'+ tail ' if converged else ''}of one binning max |d| "
          f"{comp_err:.3e}; frame from params: aux equal, resid "
          f"{float(aux_g['resid_transmittance']):g}, mean |d| "
          f"{mean_err:.3e}, max |d| {float(err.max()):.3e}, share > 1e-3 "
          f"{frac:.5f} (tied pairs blend in sort order); covered share "
          f"{covered:.3f}")


def phase_converged_kernels(captured):
    """K4-K7 at every call site of one converged 10M frame, against their
    plain versions on the card."""
    import torch
    import torch.nn.functional as F
    from fourdgs_torch.ops import pack_cuda as PK
    from fourdgs_torch.ops import tail_cuda as TL

    results = {}

    # K4: the shared record matrix.
    (args, _), = captured["pack_cuda.pack_record_fields"]
    rows, (p00, p11, pad_to) = args[:10], args[10:]

    def k4_plain():
        return PK.pack_record_fields_plain(rows, PK._inv_p(p00, p11, rows[0]),
                                           pad_to)
    got, want = PK.pack_record_fields(*args), k4_plain()
    torch.cuda.synchronize()
    check(torch.equal(got, want), "(g) K4 pack_record_fields differs from "
          "plain")
    ms = cuda_ms(lambda: PK.pack_record_fields(*args), 20)
    plain_ms = cuda_ms(k4_plain, 5)
    site = f"{rows[0].shape[0]:,} -> 10 x {pad_to:,}"
    results["K4 pack_record_fields"] = _sites([dict(
        site=site, max_abs_err=0.0, ms=ms, plain_ms=plain_ms)])
    print(f"(g) K4 pack_record_fields: {site}, exact; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")

    # K5: the tail meta matrix.
    (args, _), = captured["pack_cuda.pack_meta_rows"]
    got, want = PK.pack_meta_rows(*args), PK.pack_meta_rows_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "(g) K5 pack_meta_rows differs from plain")
    ms = cuda_ms(lambda: PK.pack_meta_rows(*args), 20)
    plain_ms = cuda_ms(lambda: PK.pack_meta_rows_plain(*args), 5)
    site = f"6 x {args[-1]:,}"
    results["K5 pack_meta_rows"] = _sites([dict(
        site=site, max_abs_err=0.0, ms=ms, plain_ms=plain_ms)])
    print(f"(g) K5 pack_meta_rows: {site}, exact; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")

    # K6: the main and the big-tier stream, then the main meta at a chunk
    # of 1024 (two sub-blocks, no int32 wrap of the depth sum), where the
    # bands and the slot masks must come out non-trivial.
    calls = captured["tail_cuda.tail_prepass"]
    check(len(calls) == 2, f"(g) K6: {len(calls)} calls in one frame, want 2")
    (meta_main, cuts_main, _, budget_main), kw_main = calls[0]
    probe = ((meta_main, cuts_main, 1024, budget_main), kw_main)
    sites, lines = [], []
    for label, (args, kw) in zip(("main", "big", "main at chunk 1024"),
                                 calls + [probe]):
        meta, cuts, chunk, budget = args
        budget_lo = kw.get("budget_lo", 0)

        def k6_plain():
            band, rect = TL.step_bands_rects(meta, chunk, cuts, budget_lo,
                                             budget)
            return band, rect, TL.step_slot_masks(meta, chunk, budget,
                                                  budget_lo)
        got, want = TL.tail_prepass(*args, **kw), k6_plain()
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("band", "rect", "slot mask")):
            check(torch.equal(g, w), f"(g) K6 {label}: {what} differs from "
                  f"plain")
        band, rect, mask = got
        bands = torch.bincount(band, minlength=kw["k_bands"]).tolist()
        n_mask = int((mask != 0).sum())
        if label.startswith("main at"):
            check(sum(b > 0 for b in bands) > 1 and n_mask > 0,
                  f"(g) K6 {label}: trivial output, chunks per band {bands}, "
                  f"{n_mask} non-zero slot masks")
        ms = cuda_ms(lambda: TL.tail_prepass(*args, **kw), 20)
        plain_ms = cuda_ms(k6_plain, 5)
        site = (f"{label}: {meta.shape[1] // chunk:,} chunks of {chunk}, "
                f"budget ({budget_lo}, {budget}]")
        if not label.startswith("main at"):
            sites.append(dict(site=site, max_abs_err=0.0, ms=ms,
                              plain_ms=plain_ms))
        lines.append(f"{site}: exact, chunks per band {bands}, {n_mask:,} "
                     f"non-zero slot masks, window passes per chunk max "
                     f"{int((rect[:, 2] * rect[:, 3]).max())}; kernel "
                     f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    results["K6 tail_prepass"] = _sites(sites)
    print("(g) K6 tail_prepass: " + "; ".join(lines))

    # K7: the main stream, then the big-tier stream.
    calls = captured["tail_cuda.tail_accumulate"]
    check(len(calls) == 2, f"(g) K7: {len(calls)} calls in one frame, want 2")
    sites, lines = [], []
    for label, (args, kw) in zip(("main", "big"), calls):
        fields, meta, band, rect, cut, params_row = args
        npts = meta.shape[1]
        fields_p = F.pad(fields, (0, npts - fields.shape[1]))
        plain_kw = {k: kw[k] for k in ("k_bands", "nx", "ny", "chunk",
                                       "budget", "s_cy", "s_cx",
                                       "exact_clip")}
        plain_kw["budget_lo"] = kw.get("budget_lo", 0)

        def k7_plain():
            return TL.tail_accumulate_plain(fields_p, meta, band, cut,
                                            params_row, **plain_kw)
        got, want = TL.tail_accumulate(*args, **kw), k7_plain()
        torch.cuda.synchronize()
        d = (got - want).abs()
        bad = d > K7_ATOL + K7_RTOL * want.abs()
        check(not bool(bad.any()), f"(g) K7 {label} stream: {int(bad.sum())} "
              f"entries outside {K7_RTOL:g} rel + {K7_ATOL:g}, max |d| "
              f"{float(d.max()):.3e}")
        check(label == "big" or float(want.abs().sum()) > 0,
              f"(g) K7 {label}: nothing accumulated")
        nz = want != 0
        rel = float((d / want.abs().clamp(min=1e-30))[nz].max()) \
            if bool(nz.any()) else 0.0
        ms = cuda_ms(lambda: TL.tail_accumulate(*args, **kw), 10)
        plain_ms = cuda_ms(k7_plain, 2, warmup=1)
        site = (f"{label}: {npts:,} splats, chunk {plain_kw['chunk']}, "
                f"budget ({plain_kw['budget_lo']}, {plain_kw['budget']}]")
        sites.append(dict(site=site, max_abs_err=float(d.max()), ms=ms,
                          plain_ms=plain_ms))
        lines.append(f"{site}: max |d| {float(d.max()):.3e}, max rel "
                     f"{rel:.3e}, |acc| max {float(want.abs().max()):.3f}; "
                     f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    results["K7 tail_accumulate"] = _sites(sites)
    print(f"(g) K7 tail_accumulate (tolerance {K7_RTOL:g} rel + {K7_ATOL:g}): "
          + "; ".join(lines))
    return results


def phase_full_frame(tag, params, camera, cfg, kernels, expect, timed):
    """Launch counts of one frame through the entry point a user calls
    (every count set to 0 just before, read just after), then `timed`
    frames. `expect` maps a kernel name to its launches per frame, or to
    None for "at least one". Returns (launches, aux)."""
    import torch
    from fourdgs_torch.render import pipeline as TP

    dev = params["px"].device
    for k in kernels.values():
        k.launches = 0
    img, aux = TP.render_params4d_packed(params, camera, 0.0, cfg=cfg,
                                         return_aux=True)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    for name, n in expect.items():
        check(launches[name] > 0 if n is None else launches[name] == n,
              f"{tag} {name}: {launches[name]} launches per frame, want "
              f"{'> 0' if n is None else n}")
    check(tuple(img.shape) == (H_FULL, W_FULL, 4)
          and bool(torch.isfinite(img).all()), f"{tag} full frame not finite")
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(timed):
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
    print(f"{tag} full frame {params['px'].shape[0]:,} splats "
          f"{W_FULL}x{H_FULL}, {cfg.tail_mode=}: median {med:.2f} ms "
          f"({1e3 / med:.2f} fps) over {timed} frames "
          f"[{', '.join(f'{t:.2f}' for t in times)}]; aux "
          f"{json.dumps(aux)}; mean rgb {mean_rgb:.4f}; launches per frame "
          f"{json.dumps(launches)}; peak memory {peak:.2f} GiB")
    # With the banded tail, pairs beyond the prune cut are composited by the
    # tail, not dropped: prune_underkeep is informational there (as the
    # reference's bench.py prints it), and no loss means resid 0.
    tail = cfg.tail_mode == "banded"
    lost = ["overflowed", "compact_dropped"] + (
        ["resid_transmittance"] if tail else ["prune_underkeep"])
    check(all(aux[k] == 0 for k in lost), f"{tag} full frame lost pairs: "
          f"{aux}")
    check(0.01 < mean_rgb < 1.0, f"{tag} full frame mean rgb {mean_rgb}")
    return launches, aux


def build_kernels(kernels):
    """Build every kernel: one nvcc per source file, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from fourdgs_torch.ops._build import load_library
    sources = {(k.source, k.extra_flags) for k in kernels}
    with ThreadPoolExecutor(len(sources)) as ex:
        list(ex.map(lambda sf: load_library(*sf), sources))
    for k in kernels:
        k.build()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.ops import (composite_cuda, lookup_cuda, pack_cuda,
                                   sort_cuda, tail_cuda)
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.render import tiles as TT
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.scenes.cube import (CONVERGED_PAD, CUBE_CAMERA,
                                           build_cube_scene,
                                           converged_cube_scene)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels = {"K1 composite": composite_cuda.COMPOSITE,
               "K2 rowsort_compact": sort_cuda.ROWSORT,
               "K3 sample_blocks": lookup_cuda.SAMPLE_BLOCKS,
               "K4 pack_record_fields": pack_cuda.PACK_RECORD_FIELDS,
               "K5 pack_meta_rows": pack_cuda.PACK_META_ROWS,
               "K6 tail_prepass": tail_cuda.TAIL_PREPASS,
               "K7 tail_accumulate": tail_cuda.TAIL_ACCUMULATE}

    # (a) environment and builds.
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.time()
    build_kernels(list(kernels.values()))
    print(f"(a) {kind}, {torch.cuda.device_count()} visible, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; kernels built "
          f"in {time.time() - t0:.1f} s")
    print(smi)

    # Non-converged path.
    cfg = auto_render_config(N_FULL, W_FULL, H_FULL, converged=False)
    t0 = time.time()
    params = build_cube_scene(N_FULL, seed=0, device=dev)
    camera = Camera.create(**CUBE_CAMERA, width=W_FULL, height=H_FULL,
                           device=dev)
    captured = capture_kernel_inputs(
        params, camera, cfg,
        [(TT, "sample_blocks"), (TT, "rowsort_compact"),
         (TP, "composite_records"), (TP, "composite_records_at")])
    torch.cuda.synchronize()
    print(f"    scene + capture frame {time.time() - t0:.1f} s")

    # (b)-(d) each kernel against its plain version at the path's inputs.
    results = {"non-converged": {
        "K3 sample_blocks": phase_sample_blocks(
            "(b)", captured["tiles.sample_blocks"], 1),
        "K2 rowsort_compact": phase_rowsort(
            "(c)", captured["tiles.rowsort_compact"], also_no_cut=True),
        "K1 composite": phase_composite(
            "(d)", captured["pipeline.composite_records"],
            captured["pipeline.composite_records_at"]),
    }}
    del captured
    # (e) card against CPU on a small frame.
    phase_small_frame(dev, converged=False)
    torch.cuda.empty_cache()
    # (f) the full frame through the entry point a user calls.
    launches = {"non-converged": phase_full_frame(
        "(f)", params, camera, cfg, kernels,
        {"K1 composite": None, "K2 rowsort_compact": 1,
         "K3 sample_blocks": 1, "K4 pack_record_fields": 0,
         "K5 pack_meta_rows": 0, "K6 tail_prepass": 0,
         "K7 tail_accumulate": 0}, TIMED_FRAMES)[0]}

    # Converged path.
    cfg = auto_render_config(N_FULL, W_FULL, H_FULL)
    t0 = time.time()
    params = converged_cube_scene(params)
    captured = capture_kernel_inputs(
        params, camera, cfg,
        [(TT, "sample_blocks"), (TT, "rowsort_compact"),
         (TP, "composite_records"), (TP, "sample_blocks"),
         (pack_cuda, "pack_record_fields"), (pack_cuda, "pack_meta_rows"),
         (tail_cuda, "tail_prepass"), (tail_cuda, "tail_accumulate")])
    torch.cuda.synchronize()
    print(f"    converged scene (Morton order, pad to {CONVERGED_PAD}) + "
          f"capture frame {time.time() - t0:.1f} s")
    # (g) every kernel of the path against its plain version at the path's
    # inputs; K3 at both of its call sites (the binning's prune sample,
    # then the tail's band-cut sample).
    conv = {
        "K3 sample_blocks": phase_sample_blocks(
            "(g)", captured["tiles.sample_blocks"]
            + captured["pipeline.sample_blocks"], 2),
        "K2 rowsort_compact": phase_rowsort(
            "(g)", captured["tiles.rowsort_compact"], also_no_cut=False),
        "K1 composite": phase_composite(
            "(g)", captured["pipeline.composite_records"]),
    }
    conv.update(phase_converged_kernels(captured))
    results["converged"] = conv
    del captured
    torch.cuda.empty_cache()
    # (h) card against CPU on a small converged frame.
    phase_small_frame(dev, converged=True)
    torch.cuda.empty_cache()
    # (i) the full converged frame.
    launches["converged"] = phase_full_frame(
        "(i)", params, camera, cfg, kernels,
        {"K1 composite": 1, "K2 rowsort_compact": 1, "K3 sample_blocks": 2,
         "K4 pack_record_fields": 1, "K5 pack_meta_rows": 1,
         "K6 tail_prepass": 2, "K7 tail_accumulate": 2},
        TIMED_FRAMES_CONVERGED)[0]

    print(json.dumps({"kernels": [
        dict(name=f"{name} [{path}]", path=path, route="cuda",
             source=KERNEL_INFO[name][0], replaces=KERNEL_INFO[name][1],
             launches=launches[path][name], **res)
        for path, by_kernel in results.items()
        for name, res in sorted(by_kernel.items())]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
