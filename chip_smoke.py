#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`fourdgs_torch`) on one card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `fourdgs_torch/ops/csrc/` (one
nvcc per source, all in parallel) and drives the port's render paths,
`render_params4d_packed` under `auto_render_config(n, w, h, converged=...)`,
on the headline scene: the 10M-splat 400^3 cube at 1920x1088 (and, for the
banded frame, at 3840x2160). Each path
first renders one frame with every kernel wrapper it calls recording its
arguments, and every kernel is then held against its plain PyTorch version
on the same card at each of those call sites. Phases:

  (a) the card, its power limit, the kernel builds;
  non-converged path (exact head, progressive deepening):
  (b) K3 sample_blocks, (c) K2 rowsort_compact, (d) K1 composite (pass 1
      and each of the five deepening passes, each launched twice and
      required bit-equal), each with the kernel and plain times; K1 and K8
      also on synthetic records made from a seed (an empty tile, count = M,
      the early exit mid-tile, il = 0 and v0 = 0, a tile-covering record,
      cull boxes on a warp patch's edge, ragged counts) at every P template
      instance, in both call forms, against plain and bit-equal across two
      launches. K2 is
      held against its plain version exactly (kept keys, values, live
      counts, dropped) here and at every later site, with the share of rows
      that outgrew their list and took the full network, and launched twice
      to show bit-for-bit equality; in (c) also without its cut, and on
      synthetic rows made from a seed that force every branch (0, keep - 1,
      keep, keep + 1, capacity, capacity + 1 and row_len live keys, rows of
      equal keys, a ragged slot count, row_len 256 and 8192, a wide keep);
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
      stream), each with the kernel and plain times; K3 and K6 (here, in
      (b) and in (p)) also bit-equal to their earlier forms
      (`fourdgs_torch/tools/csrc/sample_blocks_word.cu`,
      `tail_prepass_block_chunk.cu`) and timed beside them in turns, K3
      also alone (launches replayed from a CUDA graph) and alone with the
      L2 flushed before each launch, beside an empty kernel launched the
      same ways; K6 at PREPASS_ODD_SHAPES (chunks 50-16384, budget_lo > 0,
      an all-dead chunk, chunk 100 at Np = 200, metas 1-3 words off 16
      bytes) and on the C-R8 wrap, K3 on views 1-3
      words off, both bit-equal to plain and the earlier form; then K7 and K9 where
      the frame's own sites do not reach: the main stream under 32 and 64
      samples a tile (tail blocks 8x8 and 4x8: the kernels' second unrolled
      instance and their run-time loops) and the big-tier stream re-chunked
      to a chunk of 200 (ragged units), K9 under a random cotangent;
  (h) the 20K-splat frame, converged, on the card against the CPU: binning
      (head re-cut included) equal, head + tail of one binning within 1e-5,
      the whole frame within the tie-order tolerance;
  (i) the full converged frame: launch counts of one frame (K1 once, K2,
      K3 twice, K4, K5, K6 twice, K7 twice), timed frames, aux counters
      (overflowed, compact_dropped and resid_transmittance 0; the prune's
      under-keep is informational, as pruned pairs go to the tail), mean
      rgb, peak memory;
  training (the gradient of a loss of the frame with respect to the packed
  params, at t = 0.37 so that every field's gradient is nonzero):
  (j) the backward kernels against their plain versions at the inputs one
      10M grad step gives them: non-converged (K8 at pass 1 and the five
      deepening passes, the `sel` form; K1 and K8 launched six times a step)
      and converged (K8 once, K9 for the main and the big-tier stream), K8
      launched twice at each site and required bit-equal; and K8's `sel`
      form at a 20K non-converged grad step;
  (k) the 20K-splat frames, both modes, card gradients against CPU
      gradients: from one binning (1e-4 of each field's max |g|) and from
      params (the tie-order tolerance of tests/test_torch_train.py); then
      four Adam steps on the card toward a target from another seed, and
      the loss falls;
  (l) the full 10M converged grad step, mean(img[..., :3]^2) as the
      reference's bench_full.py takes it: launch counts of one step (K8
      once, K9 twice, and the forward's), finite and nonzero gradients for
      every field, the forward and forward+backward medians, their ratio,
      and peak memory;
  the kernel-sorted frame (`sort_backend="pallas"` with a power-of-two keep
  of 512: the prune as its own pass, a row sort that compacts the slots
  into 4,096 alternating rows, the rows merged by kernels):
  (m) K10 apply_cutkeys and K11-K13 (merge tree, every cross pass, every
      finishing pass) against their plain versions at the inputs one such
      10M frame gives them, keys exact and (key, value) multisets equal;
      K11 and every K13 also bit-equal (keys and values) to their earlier
      shared-memory form (`fourdgs_torch/tools/csrc/merge_shared_stages.cu`),
      timed beside it; every multi-stage pass of K12 exactly equal to its
      single stages and each single stage (the kernel with one stage) to
      plain; the whole `merge_sorted_rows`, its launches after K11
      enqueued by one host call, against `torch.sort` (keys, multisets,
      sortedness, live count) in both row-direction forms, timed beside
      `torch.sort` + gather; the compacting row sort timed on its own;
      then adversarial inputs made on the card, in both row forms (all
      keys equal, all DEAD, presorted, rows of 256 and of 16,384, an array
      of one block, whose final run is ascending): K11 and every K13
      bit-equal to the earlier form, the merge's keys equal to
      `torch.sort`'s and its (key, value) multiset equal;
  (n) the 20K-splat converged frame under the merge kernels, card against
      CPU, and on the card against the default sort backend: integer
      binning outputs and per-tile pair multisets equal, the image within
      the tie-order tolerance;
  (o) the full kernel-sorted frame: launch counts (K10 1, K11 1, K12 10,
      K13 7, K2 0, the rest as (i)), counters 0, the median beside (i)'s;
  the 4K frame (3840x2160: 135 x 30 = 4,050 tiles in two bands of tile
  rows, each band through the whole converged path with band-relative ids):
  (p) every kernel of the path against plain at each band's inputs; the
      full frame: launch counts twice (i)'s, counters 0, time and peak
      memory, and the rows at the band seam no more apart from their
      neighbours than rows at other tile-row boundaries; a 20K-splat frame
      of 4,224 tiles of 8x64 (three bands), both modes, card against CPU;
  the public row pack:
  (q) `pack_rows` of ten float32 rows of 10,010,624 against `torch.stack`,
      exact; its backward launches K14 once and returns the cotangent's
      rows exactly; both bit-equal to their earlier form (one thread per
      column, `fourdgs_torch/tools/csrc/pack_rows_scalar.cu`) there and,
      with their plain versions, at PACK_ODD_SHAPES (R 1 to 16, n = 0,
      n % 4 != 0, n = pad_to, pad_to % 4 != 0, views 1-3 words off 16 bytes,
      int32); both timed beside the earlier form and the PyTorch call, in
      three turns of alternating order (medians);
  the exact-order paths (`render_splats4d`, `render_splats3d`,
  `render_splats2d`: the splats in front-to-back order, the pairs sorted by
  (tile, splat index)), under EXACT_CFGS: the default config (xla backend,
  plain PyTorch, 32x32 tiles), the viewer's pallas config (8x128, K1) and
  the pallas backend at 32x32 with three deepening passes of 128:
  (r) 20K-splat scenes made from a seed (4D, its 3D slice, 2D) at 512x256,
      card against CPU: the front-to-back permutation and the exact binning
      of one projection equal bit for bit at 32x32 and 8x128 tiles; each
      frame's launch counts (K1 once a pass with pallas, nothing with xla);
      the composite of one binning within EDGE_TOL and the frame from the
      splats within the frame tolerance; K1 (pass 1 and its `sel` form) and
      K8 (a grad step) against their plain versions at every captured
      input, on the 2D path too; the dense renderer on the card against the
      CPU (2,000 of the 4D splats at 256x128);
  (s) the viewer's full-width frame, the reference's `linear` scene at its
      size on the reference's fallback model (182,400 motion splats,
      `scenes.linear_motion(models.torus(76, 48))`), at 800x800 and
      1920x1080 under the viewer's and the default config at t = 20: the
      binning of the frame's projection equal on card and CPU
      (`overflowed` included), launch counts, the
      median ms, peak memory and aux of each frame, K1 against plain at its
      inputs (the frame is black: M = 1,024 keeps only faded pairs); the
      xla frame at 800x800 with the chunk's color sum as a matmul
      (`pipeline._color_sum`) and as a broadcast product and sum, timed in
      turns; a pallas grad step at 1920x1080 (K8 against plain) and an xla
      grad step at 800x800, each timed with its peak memory; then the lit
      frame: the viewer's pallas config at the viewer's default t = 0,
      800x800, with M = LINEAR_M_LIT so that no tile is truncated, its
      binning equal on card and CPU, its image lit and within the parity
      tolerances of the dense renderer on the card, K1 and K8 (a grad step)
      against plain at its inputs, K8 and plain against plain in float64.

  the fitting path (`train.trainer.fit` through `materialize_splats` and
  `render_splats4d`, with adaptive density control and checkpoints):
  (t1) `densify_step` and `reset_opt_slots` on the card against the CPU,
      from one 20K-slot state with one set of draws: `changed`, the counts,
      every parameter and the reset moments bit-equal;
  (t2) `fit`, 3 steps of the 20K cube at 512x256 on the card and on the
      CPU, under the viewer's pallas config and a converged config: losses
      step by step within FIT_LOSS_RTOL, launches per step;
  (t3) the full-width fit: the cube at 1,000,000 splats, Morton-ordered,
      padded with `densify.pad_params` to 1,048,576 slots, at 1920x1088
      under `auto_render_config(1_048_576, 1920, 1088)`: K1-K9 against
      their plain versions at one fit step's inputs; 9 steps with densify
      events after steps 3 and 6 and a `MetricsLogger` in chiprun_out/
      (launches per step, step and event times, peak memory, the counts);
      the counters 0 on one frame; a checkpoint saved and loaded on the
      card, bit-equal;
  (t4) `examples.fit_motion`, 300 steps on the card: the loss falls;
  the viewer path:
  (u) `viewer.cli.main` on the card on the `linear` scene (182,400 splats)
      at 800x800 with --backend xla, pallas, dense and --converged (each
      frame timed; K1, and K1-K7 for --converged, against plain at the
      frame's inputs; the converged frame lit, its counters 0, its mean and
      p99 |d| against the dense frame), --grid --axis, a 4-frame --sweep,
      and every scene of SCENES at 256x256; every image finite and written
      as a PNG under chiprun_out/viewer/;
  the within-band weighting, K2's alternating rows, the sharded layer:
  (v1) after (l), the 10M converged frame at tail_depth_beta = 8: K7 (both
      streams, every entry within K7's tolerance) and K9 (its grad step)
      against plain; K7's L plane equal to the unweighted K7's at the same
      inputs; 20K frames at tail_alpha_power 1 and tail_depth_beta 8 card
      against CPU as in (h); the frame and the grad step timed beside (i);
  (v2) K2's alternating form at that frame's keys exactly against plain;
  (v3) at the end, in a process group of one rank (gloo and NCCL, TCP on
      127.0.0.1, ended after): the 1M-splat cube at 1920x1088 through
      render_splats4d_sharded (the viewer's pallas config) and
      render_splats4d_sharded_alltoall, non-converged and converged at
      tail_depth_beta = 8, each against render_splats4d at the same config
      (3e-5; the converged mode at the reference's bounds, its p99 at
      CONVERGED_P99, and at all of them with the single chip's band cuts),
      nothing dropped under required_send_budget, K1 and K7 against plain
      at their inputs;
  (v4) the three sharded train steps (K8, K9 against plain at a step's
      inputs; step times, peak memory), a 5-step fit_sharded (converged,
      beta 8) and fourdgs_torch.entry.dryrun_multichip(1);
  (v5) 20K frames, losses and gradients of the three sharded modes and
      the single-chip gradients of the same configs, card against CPU under
      the tie tolerances, over the splats that the conditioning rule of
      fourdgs_torch.tools.eigen_condition does not name (a footprint
      eigenvector of fewer than 64 rounding errors, whose float32
      gradient is noise in the reference's formula, ROADMAP C-R15; the
      count is printed). One card runs world size 1
      only: the multi-rank semantics are held by the CPU tests
      (tests/test_torch_parallel*.py, four gloo processes);
  the certification (fourdgs_torch.tools.validate_kernels, the port of the
  repo's validate_kernels.py):
  (w) its checks on the card under its gate (the reference's bounds): K1
      and K8 on the record fixtures against float64 ground truth, the
      3,000-splat frame and gradients under the pallas configs against the
      xla config, K10 / K2 / K11-K13 on 4M keys against their invariants,
      and the shipped converged 1M frame (1024x512) against its exact
      composite (80 deepening passes of 512), and the 10M frame
      (1920x1088) so, reported; each check driven with the launch counts
      set to 0 just before it, and every kernel it launched then held
      against its plain version at its inputs (K1 and K8 at the fixtures
      and at the pipeline check's pallas renders, K10, K2 and K11-K13 at
      the sort check's, K1 at each exact composite's pass 1 and 79
      deepening passes and K1-K7 at each converged frame); then each
      frame with the tail's bands from an int64 depth sum (ROADMAP C-R8's
      wrap undone), K7 held at those bands, reported with the band
      histograms; its seconds.

Any failed check raises, so the script exits non-zero. It prints a JSON
line with one entry per kernel and path (launches per frame or grad step of
that path; ms, plain_ms summed over the path's call sites, one launch each,
and max_abs_err the largest over them; bound_ms the least time the card
could take for the same inputs and outputs, the larger of their bytes over
3.35 TB/s and the function's operations over 67 TFLOP/s, with bound_by
naming which; library_ms the time of the one PyTorch call that computes the
same function, where there is one, else null; `calls` gives each site) and
the grad step's numbers of (l) under "grad_step", then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
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
    "K8 composite_bwd": ("fourdgs_torch/ops/csrc/composite_bwd.cu",
                         "fourdgs/ops/composite_pallas.py:363"),
    "K9 tail_accumulate_bwd": ("fourdgs_torch/ops/csrc/tail_bwd.cu",
                               "fourdgs/ops/tail_pallas.py:904"),
    "K10 apply_cutkeys": ("fourdgs_torch/ops/csrc/cutkeys.cu",
                          "fourdgs/ops/lookup_pallas.py:34"),
    "K11 merge_tree": ("fourdgs_torch/ops/csrc/merge.cu",
                       "fourdgs/ops/sort_pallas.py:159"),
    "K12 merge_cross_stage": ("fourdgs_torch/ops/csrc/merge.cu",
                              "fourdgs/ops/sort_pallas.py:208"),
    "K13 merge_finish": ("fourdgs_torch/ops/csrc/merge.cu",
                         "fourdgs/ops/sort_pallas.py:264"),
    "K5 pack_rows": ("fourdgs_torch/ops/csrc/pack.cu",
                     "fourdgs/ops/pack_pallas.py:39"),
    "K14 unpack_rows": ("fourdgs_torch/ops/csrc/pack.cu",
                        "fourdgs/ops/pack_pallas.py:45"),
}
# K7 against its plain version: the kernel adds each covered sample's planes
# with atomics in no fixed order, so sums of up to thousands of terms differ
# in rounding; every per-sample operation rounds alike (both are float32,
# and the kernel is built with -fmad=false).
K7_RTOL, K7_ATOL = 1e-4, 1e-5
# K8 and K9 against their plain versions, relative to each field's max |d|:
# each field's cotangent is a sum over a tile's pixels (K8) or a pair's
# samples and slots (K9), taken in another order by the kernel. K9 sums a
# splat's terms in one thread in a fixed order (slot after slot, sample
# after sample), so it repeats itself bit for bit, but it is not expected to
# equal the plain version's batched sums bit for bit.
BWD_TOL = 1e-4
# Other sample grids and a ragged chunk for K7 and K9: (tail_block, what the
# kernels run for it) on the 16x128 tile, and the chunk below 512.
TAIL_VARIANT_BLOCKS = (((8, 8), "2 x 16 = 32 samples, unrolled"),
                       ((4, 8), "4 x 16 = 64 samples, run-time loops"))
RAGGED_CHUNK, RAGGED_SPLATS = 200, 1000
T_GRAD = 0.37            # at t = pt the temporal fields get no gradient
TIMED_STEPS = 5
# The card's peaks for a kernel's bound (NVIDIA's H100 SXM data sheet): HBM3
# bandwidth, and the float32 rate outside the tensor cores, which also stands
# for integer compare-exchanges (the data sheet's only non-tensor rate).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations counted for a bound, the least the function needs:
PAIR_TEST_OPS = 12       # K1, K7-K9: the coverage test of one (record or
#                          slot, pixel or sample): two differences, two
#                          rotated and scaled dot products, two compares;
#                          the blend of the covered ones is data-dependent
#                          and not counted
CMPX_OPS = 4             # K2, K11-K13: one compare-exchange of a (key,
#                          value) pair: a compare and three selects
# The kernel-sorted frame (sort_backend="pallas"): a power-of-two keep that
# loses no pair at the 10M frame; and the 4K frame.
MERGE_KEEP = 512
MERGE_ROWS = 4096        # rows the 40M slots of that frame compact into
W_4K, H_4K = 3840, 2160
W_BAND, H_BAND = 1408, 1536      # 8x64 tiles: 4,224 tiles, three bands
# Card against CPU, composite of one binning, over that image's 2.2M pixels
# (16 times phase (e)'s): measured max |d| 1.4e-4 at isolated pixels, while
# on the card the kernel stays within 2e-7 of its plain version on the same
# frame, so the gap is the two devices' arithmetic, not the kernel. A
# coverage test (|n| <= 0.5, w >= 1e-4) that falls the other way for one
# (pixel, record) at a footprint's edge moves the pixel by at most the edge
# weight exp(-8) = 3.4e-4 times the record's alpha: that is the tolerance.
EDGE_TOL = 4e-4
TIMED_FRAMES_NEW = 5
# The exact-order paths (r, s): the default config (xla backend, 32x32
# tiles), the viewer's pallas config, and the pallas backend at 32x32 with
# three deepening passes over every tile, in slabs of 128 pairs so that the
# passes after the first find pairs left; the tile shapes of their binnings.
EXACT_CFGS = (("xla 32x32", {}),
              ("viewer pallas 8x128", dict(tile_h=8, tile_w=128,
                                           backend="pallas")),
              ("pallas 32x32 deepening 3x128", dict(
                  backend="pallas", max_splats_per_tile=128,
                  deepening_passes=3, deepening_fraction=1.0)))
EXACT_TILES = ((32, 32), (8, 128))
N_DENSE, W_DENSE, H_DENSE = 2_000, 256, 128
# The viewer's full-width scene: the reference's `linear` scene on its
# fallback model (the torus grid of models.teapot, 76 x 48 vertices) x 50
# steps, at t = 20 from the scene's camera, at the viewer's 800x800 and at
# 1920x1080; and at the viewer's default t = 0, where the frame is lit.
LINEAR_GRID, LINEAR_STEPS, LINEAR_T, LINEAR_T_LIT = (76, 48), 50, 20.0, 0.0
# The lit frame's capacity, above its deepest tile (68,600 pairs at
# 800x800, 8x128 tiles, t = 0), and the tiled path's tolerances against the
# dense model at a capacity that truncates nothing (tests/test_parity.py):
# mean and max |d| over rgba.
LINEAR_M_LIT = 1 << 17
PARITY_MEAN, PARITY_MAX = 5e-4, 0.02
LINEAR_CAMERA = dict(position=(60.0, 90.0, 90.0),
                     orientation=(0.0, -1.0, -1.0))
VIEWER_SIZES = ((800, 800), (1920, 1080))
TIMED_FRAMES_EXACT = 5
# Odd shapes of the row pack (q): (R, n, pad_to, the rows' storage offset
# in words, dtype). n % 4 != 0 and pad_to % 4 != 0 put the word-by-word edge
# of a vector and rows off 16 bytes (every other packed row at pad_to % 4 ==
# 2) on the card; an offset puts every row on the scalar path.
PACK_ODD_SHAPES = (
    (1, 1_000_003, 1_000_005, 0, "float32"),
    (16, 262_145, 262_148, 1, "int32"),
    (3, 99_999, 100_002, 2, "float32"),
    (10, 65_536, 65_536, 3, "int32"),
    (16, 0, 1_024, 0, "float32"),
    (7, 5_000, 5_000, 0, "int32"),
    (10, 40_961, 49_152, 0, "float32"),
)


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


def turns_ms(fns, reps, rounds=3):
    """Median milliseconds a call of each of `fns` (name -> callable), timed
    with cuda_ms in `rounds` turns whose order alternates, so that no
    version is always timed first."""
    names = list(fns)
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            times[name].append(cuda_ms(fns[name], reps))
    return {name: statistics.median(t) for name, t in times.items()}


def _clone(a):
    # Detached: a clone of a tensor that requires grad would keep its step's
    # autograd graph (and every tensor it saved) alive with the capture.
    if hasattr(a, "clone"):
        return a.detach().clone()
    if isinstance(a, (list, tuple)):
        return type(a)(_clone(x) for x in a)
    return a


def grad_loss(img):
    """The grad step's loss, as the reference's bench_full.py takes it."""
    return (img[..., :3] ** 2).mean()


def capture_calls(frame, targets, optional=()):
    """Run `frame()` with the wrappers `targets` and `optional` ((module,
    name) pairs) wrapped so that each records the cloned arguments of every
    call. Returns {"module.name": [(args, kwargs), ...]} (the calling
    module's last name) in call order; every target must have been called,
    an optional one may not have been."""
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

    for owner, name in list(targets) + list(optional):
        wrap(owner, name)
    try:
        frame()
    finally:
        for (owner, name), fn in originals.items():
            setattr(owner, name, fn)
    want = {f"{o.__name__.rsplit('.', 1)[-1]}.{n}" for o, n in targets}
    check(want <= set(seen), f"the path skipped a kernel wrapper: saw "
          f"{sorted(seen)}, want {sorted(want)}")
    return seen


def capture_kernel_inputs(params, camera, cfg, targets, t=0.0, grad=False):
    """Render one frame of the packed params with the kernel wrappers
    `targets` recording their arguments (capture_calls): the inputs the path
    really gives each kernel. With `grad`, the frame is a grad step:
    grad_loss of the frame at `t`, backward to the params."""
    from fourdgs_torch.render import pipeline as TP

    def frame():
        if grad:
            p = {k: v.detach().clone().requires_grad_(True)
                 for k, v in params.items()}
            grad_loss(TP.render_params4d_packed(p, camera, t, cfg=cfg)
                      ).backward()
        else:
            TP.render_params4d_packed(params, camera, t, cfg=cfg)
    return capture_calls(frame, targets)


def nbytes(*tensors):
    """Bytes of the given tensors (None and non-tensors count nothing)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if hasattr(t, "element_size"))


def site(label, err, ms, plain_ms, moved, ops, library_ms=None):
    """One call site of a kernel: its error against plain, the times, and
    its bound, the larger of `moved` bytes (every input read once, every
    output written once) over the card's memory rate and `ops` operations
    over its float32 rate."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return dict(site=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms)


# Times a site may carry beside `ms`, summed over a path's sites where every
# site has them: the earlier form's time (a redesigned kernel), and for K3 and
# K6 the kernel alone (`device_ms`, launches replayed from a CUDA graph), for
# K3 also alone with the L2 flushed before each launch (`cold_ms`), each also
# for the earlier form.
EXTRA_MS = ("earlier_ms", "device_ms", "cold_ms", "earlier_device_ms",
            "earlier_cold_ms")


def _sites(sites):
    """One kernel's result over its call sites in a path: times and bounds
    summed (one launch per site), the largest error, the limit of the site
    with the largest bound; a library time only if every site has one."""
    lib = [s["library_ms"] for s in sites]
    res = dict(max_abs_err=max(s["max_abs_err"] for s in sites),
               ms=sum(s["ms"] for s in sites),
               plain_ms=sum(s["plain_ms"] for s in sites),
               bound_ms=sum(s["bound_ms"] for s in sites),
               bound_by=max(sites, key=lambda s: s["bound_ms"])["bound_by"],
               library_ms=None if None in lib else sum(lib), calls=sites)
    for key in EXTRA_MS:
        if all(key in s for s in sites):
            res[key] = sum(s[key] for s in sites)
    return res


def merge_results(parts):
    """Per-kernel results of several parts of one path (the bands of a
    frame) as one: the call sites of every part in order."""
    names = {}
    for part in parts:
        for name, res in part.items():
            names.setdefault(name, []).extend(res["calls"])
    return {name: _sites(calls) for name, calls in names.items()}


def phase_sample_blocks(tag, calls, n_sites):
    """K3 at each of the path's `n_sites` call sites, in call order: bit-equal
    to plain and to its earlier form (`tools/csrc/sample_blocks_word.cu`),
    timed beside it through the wrapper (back to back, in turns), alone
    (launches replayed from a CUDA graph) and alone with the L2 flushed
    before each launch, beside an empty kernel launched the same ways."""
    import torch
    from fourdgs_torch.ops import lookup_cuda as L
    from fourdgs_torch.tools import prepass_split as PS
    check(len(calls) == n_sites, f"{tag} K3: {len(calls)} calls in one "
          f"frame, want {n_sites}")
    word, _, empty = PS.word_kernels()
    flush = torch.empty(PS.FLUSH_BYTES // 4, dtype=torch.int32,
                        device=calls[0][0][0][0].device)
    def stream():      # at launch: a graph captures on a stream of its own
        return torch.cuda.current_stream().cuda_stream
    floor_device = PS.graph_ms(lambda: empty(1, 32, 1, stream=stream()))
    floor_cold = PS.cold_ms(lambda: empty(1, 32, 1, stream=stream()), flush)
    sites, lines = [], []
    for (arrs,), kw in calls:
        key = arrs[0]
        stride, take = kw["stride_rows"], kw["take_rows"]
        got, = L.sample_blocks([key], stride_rows=stride, take_rows=take)
        want = L.sample_blocks_plain(key, stride, take)
        earlier = PS.earlier_sample_blocks(word, key, stride, take)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{tag} K3 sample_blocks (stride "
              f"{stride}, take {take}) differs from plain")
        check(torch.equal(got, earlier), f"{tag} K3 sample_blocks (stride "
              f"{stride}, take {take}) differs from its earlier form")
        ms, earlier_ms = turns_ms({
            "kernel": lambda: L.sample_blocks([key], stride, take),
            "earlier": lambda: PS.earlier_sample_blocks(word, key, stride,
                                                        take)}, 50).values()
        plain_ms = cuda_ms(lambda: L.sample_blocks_plain(key, stride, take),
                           reps=50)
        # The kernels alone, on a preallocated output.
        nblocks = L.num_sample_blocks(key.shape[0], stride)
        out = torch.empty_like(want)
        alone = {
            "": lambda: L.SAMPLE_BLOCKS(key, out, nblocks, stride, take,
                                        stream=stream()),
            "earlier_": lambda: PS.earlier_sample_blocks(word, key, stride,
                                                         take, out)}
        extra = dict(earlier_ms=earlier_ms)
        for pre, fn in alone.items():
            extra[f"{pre}device_ms"] = PS.graph_ms(fn)
            extra[f"{pre}cold_ms"] = PS.cold_ms(fn, flush)
        label = (f"{key.shape[0]:,} int32 keys, stride {stride}, take "
                 f"{take} -> {got.shape[0]:,} samples")
        # The function reads only the sampled words.
        sites.append(dict(site(label, 0.0, ms, plain_ms, 2 * nbytes(got), 0),
                          **extra, empty_device_ms=floor_device,
                          empty_cold_ms=floor_cold))
        lines.append(
            f"{label}: exact match, bit-equal to the earlier form; through "
            f"the wrapper {ms:.4f} ms (earlier form {earlier_ms:.4f}), the "
            f"kernel alone {extra['device_ms']:.4f} ms (earlier "
            f"{extra['earlier_device_ms']:.4f}), alone with the L2 flushed "
            f"{extra['cold_ms']:.4f} ms (earlier "
            f"{extra['earlier_cold_ms']:.4f}); plain {plain_ms:.4f} ms")
    del flush
    print(f"{tag} K3 sample_blocks: " + "; ".join(lines) + f"; an empty "
          f"kernel alone {floor_device:.4f} ms, after a flush "
          f"{floor_cold:.4f} ms")
    return _sites(sites)


def phase_sample_offsets(dev):
    """(g): K3 on views 1-3 words off 16 bytes (the scalar path) and at an
    aligned base, bit-equal to plain and to its earlier form."""
    import torch
    from fourdgs_torch.ops import lookup_cuda as L
    from fourdgs_torch.tools import prepass_split as PS
    word = PS.word_kernels()[0]
    gen = torch.Generator(device=dev).manual_seed(10)
    shapes = ((1 << 22, 134, 2, 1), (1 << 22, 64, 1, 2), (1 << 20, 7, 8, 3),
              (1024, 1, 8, 1), (1 << 20, 9, 3, 0))
    for n, stride, take, offset in shapes:
        buf = torch.randint(-2 ** 31, 2 ** 31 - 1, (n + offset,),
                            generator=gen, device=dev, dtype=torch.int32)
        x = buf[offset:]
        got, = L.sample_blocks([x], stride, take)
        want = L.sample_blocks_plain(x, stride, take)
        earlier = PS.earlier_sample_blocks(word, x, stride, take)
        torch.cuda.synchronize()
        check(torch.equal(got, want) and torch.equal(got, earlier),
              f"(g) K3 at n {n:,}, stride {stride}, take {take}, offset "
              f"{offset}: differs from plain or its earlier form")
    print(f"(g) K3 sample_blocks at {len(shapes)} odd shapes (views 1-3 "
          f"words off 16 bytes, take 1-8, one sample block): bit-equal to "
          f"plain and to the earlier form")


def _k2_exact(tag, key, val, keep, row_len, cut, shift):
    """K2 against its plain version on one input: kept keys, values, live
    counts and dropped all exactly equal, and a second launch equal to the
    first bit for bit. Returns (kept keys, live, dropped)."""
    import torch
    from fourdgs_torch.ops import sort_cuda as S
    ok, ov, live, dropped = S._rowsort_compact_live(key, val, keep, row_len,
                                                    cut, shift)
    pk, pv, p_live = S.rowsort_compact_plain(key, val, keep, row_len, cut,
                                             shift)
    p_dropped = int(torch.clamp(p_live - keep, min=0).sum())
    ok2, ov2, live2, dropped2 = S._rowsort_compact_live(key, val, keep,
                                                        row_len, cut, shift)
    torch.cuda.synchronize()
    check(torch.equal(ok, pk), f"{tag}: kept keys differ from plain")
    check(torch.equal(ov, pv), f"{tag}: kept values differ from plain")
    check(torch.equal(live, p_live), f"{tag}: live counts differ from plain")
    check(int(dropped) == p_dropped, f"{tag}: dropped {int(dropped)} vs "
          f"plain {p_dropped}")
    check(torch.equal(ok, ok2) and torch.equal(ov, ov2)
          and torch.equal(live, live2) and int(dropped) == int(dropped2),
          f"{tag}: a second launch differs from the first")
    return ok, live, int(dropped)


def _k2_moved(key, keep, row_len, cut, shift, ok, live):
    """Bytes K2's function must move on this input: every key, the cut
    table, both outputs and the live counts once, and of the values only
    the kept slots', counted as the distinct 32-byte sectors that hold them
    (the least a read of device memory moves)."""
    import torch
    from fourdgs_torch.ops import sort_cuda as S
    k2, _ = S._cut_rows(key, key, row_len, cut, shift)
    order = torch.sort(k2, dim=0, stable=True).indices[:keep]
    kept = torch.gather(k2, 0, order) != S.DEAD
    rows = k2.shape[1]
    at = (order * rows + torch.arange(rows, device=key.device))[kept]
    sectors = int(torch.unique(at >> 3).numel())
    return nbytes(key, cut, live) + 2 * nbytes(ok) + 32 * sectors, sectors


def _overflow_share(live, keep):
    """Share of rows whose live slots exceed K2's list (the rows that take
    the full network), and the list's capacity."""
    from fourdgs_torch.ops import sort_cuda as S
    cap = S._list_cap(keep)
    return (1.0 if cap is None else float((live > cap).float().mean())), cap


def phase_rowsort(tag, calls, also_no_cut):
    """K2 at the path's one call site; with `also_no_cut`, also without its
    cut (the reference's second call form of the kernel)."""
    from fourdgs_torch.ops import sort_cuda as S
    check(len(calls) == 1, f"{tag} K2: {len(calls)} calls in one frame")
    (key, val, keep), kw = calls[0]
    row_len, cut, shift = kw["row_len"], kw["cut"], kw["key_shift"]
    lines, sites = [], []
    forms = (("cut", cut),) + ((("no cut", None),) if also_no_cut else ())
    for label, c in forms:
        ok, live, dropped = _k2_exact(f"{tag} K2 ({label})", key, val, keep,
                                      row_len, c, shift)
        share, cap = _overflow_share(live, keep)
        ms = cuda_ms(lambda: S.rowsort_compact(key, val, keep, row_len, c,
                                               shift), reps=20)
        def plain():
            _, _, n_live = S.rowsort_compact_plain(key, val, keep, row_len,
                                                   c, shift)
            return (n_live - keep).clamp(min=0).sum()
        plain_ms = cuda_ms(plain, reps=5)
        stages = row_len.bit_length() * (row_len.bit_length() - 1) // 2
        moved, sectors = _k2_moved(key, keep, row_len, c, shift, ok, live)
        form = site(f"{key.shape[0]:,} slots, keep {keep}, {label}", 0.0, ms,
                    plain_ms, moved,
                    ok.shape[1] * (row_len // 2) * stages * CMPX_OPS)
        if c is not None:           # the form the path launches
            sites.append(form)
        lines.append(f"{label}: keys, values, live and dropped "
                     f"({dropped:,}) equal plain exactly, live "
                     f"{int(live.sum()):,} (most in a row {int(live.max())}), "
                     f"{share:.4%} of rows above the list's {cap} take the "
                     f"full network, a second launch bit-equal; kernel "
                     f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                     f"{form['bound_ms']:.3f} ms ({form['bound_by']}: "
                     f"{moved / 1e6:.1f} MB, the keys, the outputs and the "
                     f"{sectors:,} sectors of the kept slots' values)")
    print(f"{tag} K2 rowsort_compact: {key.shape[0]:,} slots, row_len "
          f"{row_len}, keep {keep}, {ok.shape[1]:,} rows, cut table "
          f"{cut.shape[0]} tiles; " + "; ".join(lines))
    return _sites(sites)


def phase_rowsort_branches(dev):
    """(c) K2 on rows made with numpy from a seed so that every branch of
    the kernel runs: rows of 0, keep - 1, keep, keep + 1, cap, cap + 1 and
    row_len live keys (the list, its three register depths, the overflow
    path), rows of equal keys, a slot count that is no multiple of the
    rows, row_len 256 and 8192, a keep too wide for lists, with and without
    a cut. Everything is held against plain exactly."""
    import numpy as np
    import torch
    from fourdgs_torch.ops import sort_cuda as S
    rng = np.random.default_rng(6)
    n_tiles, shift = 40, 20
    cut = torch.from_numpy(((np.arange(n_tiles) << shift)
                            | (1 << 19)).astype(np.int32)).to(dev)
    lines = []
    for row_len, keep, s_short in ((512, 32, 0), (512, 48, 777),
                                   (512, 100, 5), (256, 32, 0),
                                   (8192, 32, 12345), (256, 192, 3)):
        cap = S._list_cap(keep) or row_len
        rows = 256
        counts = [0, 1, keep - 1, keep, keep + 1, 33, 64, 65, cap, cap + 1,
                  row_len]
        counts = np.array([min(c, row_len) for c in counts])
        per_row = counts[np.arange(rows) % len(counts)]
        key2 = np.full((row_len, rows), S.DEAD, dtype=np.int32)
        for r in range(rows):
            at = rng.choice(row_len, per_row[r], replace=False)
            tile = rng.integers(0, n_tiles, per_row[r])
            # Rows 0-63 hold equal keys (one tile, one depth); the others
            # depths below the cut (kept) and, every other row, above it.
            depth = np.full(per_row[r], 7) if r < 64 else rng.integers(
                0, (1 << 19) if r % 2 else (1 << 20), per_row[r])
            key2[at, r] = ((tile if r >= 64 else 3) << shift) | depth
        key = key2.reshape(-1)[:row_len * rows - s_short]
        val = rng.permutation(key.shape[0]).astype(np.int32)
        k, v = torch.from_numpy(key.copy()).to(dev), \
            torch.from_numpy(val).to(dev)
        for label, c in (("cut", cut), ("no cut", None)):
            tag = (f"(c) K2 synthetic rows (row_len {row_len}, keep {keep}, "
                   f"{key.shape[0]:,} slots, {label})")
            _, live, dropped = _k2_exact(tag, k, v, keep, row_len, c, shift)
            share, _ = _overflow_share(live, keep)
            got = set(live.unique().tolist())
            if c is None:
                want = set(np.unique(per_row[:live.shape[0]]).tolist())
                check(s_short or got == want, f"{tag}: live counts "
                      f"{sorted(got)} are not the rows' {sorted(want)}")
            lines.append(f"row_len {row_len} keep {keep} {label}: "
                         f"{len(got)} distinct live counts up to "
                         f"{max(got)}, dropped {dropped:,}, {share:.1%} of "
                         f"rows through the full network")
    print("(c) K2 synthetic rows, keys, values, live and dropped equal plain "
          "exactly and a second launch bit-equal: " + "; ".join(lines))


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


def _k1_site(label, err, t_ms, t_plain, recs, cnt, pix, tiles,
             extra_bytes=0):
    """A call site of K1: the records the counts name, the pixel
    coordinates, and the carry in and out of the `tiles` tiles
    composited."""
    n_rec = int(cnt.sum())
    moved = (n_rec * recs.shape[1] * 4 + nbytes(cnt)
             + tiles * pix * 4 * (2 + 8 + 8) + extra_bytes)
    return site(label, err, t_ms, t_plain, moved, n_rec * pix * PAIR_TEST_OPS)


def phase_composite(tag, calls_first, calls_at=(), quiet=False):
    """K1 at pass 1 (one call per frame) and at every deepening pass
    (composite_records_at, `calls_at`), each against its plain version and
    launched twice for bit equality; `quiet` prints the passes' sums in
    place of a line a pass."""
    import torch
    from fourdgs_torch.ops import composite_cuda as C
    check(len(calls_first) == 1, f"{tag} K1 pass 1: {len(calls_first)} "
          f"calls in one frame")
    (rec, counts, kx, ky, carry), _ = calls_first[0]
    got = C.composite_records(rec, counts, kx, ky, carry)
    again = C.composite_records(rec, counts, kx, ky, carry)
    want = C.composite_plain(rec, counts, kx, ky, carry)
    torch.cuda.synchronize()
    d03, rel, sel_ok, e1 = _carry_err(got, want)
    check(d03 <= 1e-5 and rel <= 1e-5 and sel_ok,
          f"{tag} K1 pass 1: rows 0-3 max |d| {d03:.3e}, T rel {rel:.3e}, "
          f"selection equal {sel_ok}")
    check(torch.equal(got, again), f"{tag} K1 pass 1: a second launch "
          f"differs from the first")
    ms = cuda_ms(lambda: C.composite_records(rec, counts, kx, ky, carry),
                 reps=20)
    plain_ms = cuda_ms(lambda: C.composite_plain(rec, counts, kx, ky, carry),
                       reps=3, warmup=1)
    lines = [f"pass 1 T={rec.shape[0]}, M={rec.shape[2]}, P={kx.shape[2]}, "
             f"{int(counts.sum()):,} records, identity carry: rows 0-3 max "
             f"|d| {d03:.3e}, T max rel {rel:.3e}, selection equal; kernel "
             f"{ms:.3f} ms, plain {plain_ms:.3f} ms"]
    sites = [_k1_site(f"pass 1, T={rec.shape[0]}, M={rec.shape[2]}", e1, ms,
                      plain_ms, rec, counts, kx.shape[2], rec.shape[0])]
    for i, ((rec_s, cnt_s, sel, kx_f, ky_f, carry_f), _) in enumerate(
            calls_at, 1):
        got_at = C.composite_records_at(rec_s, cnt_s, sel, kx_f, ky_f,
                                        carry_f.clone())
        again = C.composite_records_at(rec_s, cnt_s, sel, kx_f, ky_f,
                                       carry_f.clone())
        want_at = carry_f.clone()
        want_at[sel] = C.composite_plain(rec_s, cnt_s, kx_f[sel], ky_f[sel],
                                         carry_f[sel])
        torch.cuda.synchronize()
        d03s, rels, sel_ok_s, e2 = _carry_err(got_at, want_at)
        check(d03s <= 1e-5 and rels <= 1e-5 and sel_ok_s,
              f"{tag} K1 deepening pass {i}: rows 0-3 max |d| {d03s:.3e}, T "
              f"rel {rels:.3e}, selection equal {sel_ok_s}")
        check(torch.equal(got_at, again), f"{tag} K1 deepening pass {i}: a "
              f"second launch differs from the first")

        def plain_at():
            out = carry_f.clone()
            out[sel] = C.composite_plain(rec_s, cnt_s, kx_f[sel], ky_f[sel],
                                         carry_f[sel])
        # Both timings include one (T, 8, P) carry copy.
        at_ms = cuda_ms(lambda: C.composite_records_at(
            rec_s, cnt_s, sel, kx_f, ky_f, carry_f.clone()), reps=20)
        at_plain_ms = cuda_ms(plain_at, reps=3, warmup=1)
        lines.append(f"deepening pass {i} of {sel.shape[0]} tiles "
                     f"({int((cnt_s > 0).sum())} active, "
                     f"{int(cnt_s.sum()):,} records): rows 0-3 max |d| "
                     f"{d03s:.3e}, T max rel {rels:.3e}, deepening selection "
                     f"equal; kernel {at_ms:.3f} ms, plain {at_plain_ms:.3f} "
                     f"ms (each with a carry copy)")
        sites.append(_k1_site(
            f"deepening pass {i}, {sel.shape[0]} tiles", e2, at_ms,
            at_plain_ms, rec_s, cnt_s, kx_f.shape[2], sel.shape[0],
            nbytes(sel) + 2 * nbytes(carry_f)))
    if quiet and len(sites) > 1:
        at = sites[1:]
        lines[1:] = [
            f"{len(at)} deepening passes, {sum(x['ms'] for x in at):.3f} ms "
            f"together (each with a carry copy; the slowest "
            f"{max(x['ms'] for x in at):.3f}), plain "
            f"{sum(x['plain_ms'] for x in at):.3f} ms, bound "
            f"{sum(x['bound_ms'] for x in at):.3f} ms, largest |d| "
            f"{max(x['max_abs_err'] for x in at):.3e}"]
    print(f"{tag} K1 composite (tolerance 1e-5 on rows 0-3 and T relative; "
          f"two launches bit-equal at every site): " + "; ".join(lines))
    return _sites(sites)


def _branch_records(rng, kx, ky, m):
    """(T, 16, m) records and counts (T,) made with numpy from `rng` for
    the tiles kx, ky (T, 1, P) (T = 8), one case a tile: 0 records; m
    records of small footprints (count = M); an opaque tile-covering first
    chunk (the tile-wide early exit mid-tile); il = 0 and v0 = 0 records
    (unbounded boxes) among small ones; one record covering the whole tile;
    axis-aligned records whose box edge meets a warp patch's edge; a ragged
    count; a count of 1. a_eff is 0 past the count, as the pack makes it."""
    import numpy as np
    import torch
    t_tiles, _, p = kx.shape
    x, y = kx[:, 0].cpu().numpy(), ky[:, 0].cpu().numpy()
    step = float(np.diff(np.unique(x[0]))[0])          # pixel spacing
    f = np.zeros((t_tiles, 16, m), np.float32)
    f[:, 0] = rng.uniform(x.min(1, keepdims=True) - 4 * step,
                          x.max(1, keepdims=True) + 4 * step, (t_tiles, m))
    f[:, 1] = rng.uniform(y.min(1, keepdims=True) - 4 * step,
                          y.max(1, keepdims=True) + 4 * step, (t_tiles, m))
    ang = rng.uniform(0, 2 * np.pi, (t_tiles, m))
    f[:, 2], f[:, 3] = np.cos(ang), np.sin(ang)
    f[:, 4:6] = 1.0 / (step * rng.uniform(0.5, 6.0, (t_tiles, 2, m)))
    f[:, 6:9] = rng.uniform(0.0, 1.0, (t_tiles, 3, m))
    f[:, 9] = rng.uniform(0.3, 0.9, (t_tiles, m))
    counts = np.array([0, m, m, m * 2 // 3, 160, 140, rng.integers(1, m),
                       1], np.int32)
    # Tile 2: an opaque first chunk over the whole tile.
    f[2, 0:2, :128] = np.array([x[2].mean(), y[2].mean()])[:, None]
    f[2, 4:6, :128] = 0.25 / (x[2].max() - x[2].min())
    f[2, 9, :128] = 0.99
    # Tile 3: il = 0 on one axis or both, and v0 = 0, among small ones.
    f[3, 4, 0:40:2] = 0.0
    f[3, 5, 1:40:2] = 0.0
    f[3, 2:4, 40:60] = 0.0
    f[3, 9, 0:60] = 0.05
    # Tile 4: one record covering the whole tile, early in the list.
    f[4, 0:2, 3] = np.array([x[4].mean(), y[4].mean()])
    f[4, 4:6, 3] = 0.2 / (x[4].max() - x[4].min())
    f[4, 9, 3] = 0.5
    # Tile 5: axis-aligned footprints whose left edge lands on the right
    # edge of a warp's patch (32 columns), on a pixel row of that patch.
    cols = np.sort(np.unique(x[5]))
    edge = cols[31::32][:-1] if cols.size > 32 else cols[-1:]
    for i in range(100):
        l0 = step * (1 + i % 4)
        f[5, 2, i], f[5, 3, i] = 1.0, 0.0
        f[5, 4, i] = 1.0 / l0
        f[5, 0, i] = edge[i % edge.size] + np.float32(0.5) * np.float32(l0)
        f[5, 1, i] = y[5][rng.integers(0, p)]
    f[:, 9] *= np.arange(m)[None] < counts[:, None]
    return (torch.from_numpy(f).to(kx.device),
            torch.from_numpy(counts).to(kx.device))


def phase_composite_branches(dev):
    """(d) K1 and K8 against their plain versions on records made with numpy
    from a seed, one case a tile (`_branch_records`), at every P template
    instance (P = 256, 512, 1024, 2048, 4096 on tiles of 16x16, 8x64, 16x64,
    16x128, 32x128 pixels), in both call forms (`sel` None and a deepening
    pass over a permutation of the tiles); each launched twice, bit-equal."""
    import numpy as np
    import torch
    from fourdgs_torch.ops import composite_cuda as C
    from fourdgs_torch.render import tiles as TT
    rng = np.random.default_rng(7)
    lines = []
    for tile_h, tile_w in ((16, 16), (8, 64), (16, 64), (16, 128),
                           (32, 128)):
        p, m = tile_h * tile_w, 384
        px, py, _ = TT.tile_pixel_ndc(4 * tile_w, 2 * tile_h, tile_h, tile_w,
                                      device=dev)
        kx = (px / 1.4)[:, None].contiguous()
        ky = (py / 2.3)[:, None].contiguous()
        rec, counts = _branch_records(rng, kx, ky, m)
        carry = C.identity_carry(8, p, device=dev)
        tag = f"(d) K1 / K8 synthetic records, P={p} ({tile_h}x{tile_w})"
        got = C.composite_records(rec, counts, kx, ky, carry)
        again = C.composite_records(rec, counts, kx, ky, carry)
        want = C.composite_plain(rec, counts, kx, ky, carry)
        sel = torch.tensor([5, 2, 7, 0, 3, 6, 1, 4], dtype=torch.int32,
                           device=dev)
        base = want.clone()
        got_at = C.composite_records_at(rec, counts, sel, kx, ky,
                                        base.clone())
        want_at = base.clone()
        want_at[sel.long()] = C.composite_plain(
            rec, counts, kx[sel.long()], ky[sel.long()], base[sel.long()])
        g = torch.randn(carry.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(p))
        d8 = C.composite_records_bwd(rec, counts, None, kx, ky, carry, want, g)
        d8b = C.composite_records_bwd(rec, counts, None, kx, ky, carry, want,
                                      g)
        d8_want = C.composite_bwd_plain(rec, counts, kx, ky, carry, want, g)
        s8 = C.composite_records_bwd(rec, counts, sel, kx, ky,
                                     base[sel.long()], want_at[sel.long()], g)
        s8_want = C.composite_bwd_plain(
            rec, counts, kx[sel.long()], ky[sel.long()], base[sel.long()],
            want_at[sel.long()], g[sel.long()])
        torch.cuda.synchronize()
        for label, a, b in (("K1", got, want), ("K1 sel", got_at, want_at)):
            d03, rel, sel_ok, _ = _carry_err(a, b)
            check(d03 <= 1e-5 and rel <= 1e-5 and sel_ok,
                  f"{tag} {label}: rows 0-3 max |d| {d03:.3e}, T rel "
                  f"{rel:.3e}, selection equal {sel_ok}")
        check(torch.equal(got, again), f"{tag} K1: two launches differ")
        check(float(want[0, 4].min()) == 1.0
              and float(want[2, 4].max()) <= 1e-6
              and float(want[1, 3].max()) > 0.1,
              f"{tag}: the cases did not come out as built (empty tile "
              f"transmittance, early exit, coverage)")
        for label, a, b in (("K8", d8, d8_want), ("K8 sel", s8, s8_want)):
            rel, _ = _field_err(a[:, :C.N_FIELDS], b[:, :C.N_FIELDS], 1)
            check(rel <= BWD_TOL and bool((a[:, C.N_FIELDS:] == 0).all()),
                  f"{tag} {label}: {rel:.3e} of a field's max |d| > "
                  f"{BWD_TOL:g}")
        check(torch.equal(d8, d8b), f"{tag} K8: two launches differ")
        lines.append(f"P={p}: K1 rows 0-3 max |d| "
                     f"{float((got - want)[:, :4].abs().max()):.2e}, K8 "
                     f"{_field_err(d8[:, :10], d8_want[:, :10], 1)[0]:.2e} of "
                     f"a field's max")
    print("(d) K1 and K8 on synthetic records (empty tile, count = M, early "
          "exit mid-tile, il = 0 and v0 = 0, a tile-covering record, boxes on "
          "a warp patch's edge, ragged counts), both call forms, every P "
          "instance, against plain and bit-equal across two launches: "
          + "; ".join(lines))


def _pair_multiset(binning):
    import torch
    live = int(binning.tile_start[-1])
    t = binning.pair_tile[:live].long().cpu()
    s = binning.pair_splat[:live].long().cpu()
    return torch.sort(t << 32 | s).values


def phase_small_frame(dev, converged, tag=None, w=W_SMALL, h=H_SMALL,
                      comp_tol=None, **overrides):
    """A 20K-splat frame on the card (kernels) against the CPU (plain
    versions) under auto_render_config(..., converged=converged,
    **overrides): the binning of one projection, the composite of one
    binning (max |d| within comp_tol, by default 1e-5 for the head and 1e-4
    with the tail), the frame from params. Returns the card's (binning,
    image, aux)."""
    import dataclasses

    import torch
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.render import tiles as TT
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.scenes.cube import (CUBE_CAMERA, build_cube_scene,
                                           converged_cube_scene)

    tag = tag or ("(h)" if converged else "(e)")
    cfg = auto_render_config(N_SMALL, w, h, converged=converged,
                             **overrides)
    params = build_cube_scene(N_SMALL, seed=1, device=dev)
    if converged:
        params = converged_cube_scene(params)
    params_cpu = {k: v.cpu() for k, v in params.items()}
    cam = Camera.create(**CUBE_CAMERA, width=w, height=h,
                        device=dev)
    cam_cpu = Camera.create(**CUBE_CAMERA, width=w, height=h,
                            device="cpu")

    # Binning of one projection on both devices.
    proj_cpu = TP.project_params4d(params_cpu, cam_cpu, 0.0)
    pm = cam_cpu.proj_matrix()
    bin_kw = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                  max_tiles_per_splat=cfg.max_tiles_per_splat,
                  quantized_depth=True,
                  compact_keep_cols=cfg.sort_compact_keep_cols,
                  big_splat_budget=cfg.big_splat_budget,
                  big_splat_keep_cols=cfg.big_splat_keep_cols,
                  pallas_sort=cfg.sort_backend == "pallas",
                  pallas_compact=True, compact_row_len=cfg.compact_row_len,
                  depth_prune_cap=cfg.depth_prune_cap,
                  depth_prune_safety=cfg.depth_prune_safety,
                  head_cap=cfg.max_splats_per_tile if converged else 0)
    ny, nx = TT.tile_grid(w, h, cfg.tile_h, cfg.tile_w)
    if ny * nx >= TT.TILE_LIMIT:
        # A banded image: compare the binning of its first band.
        bin_kw["tile_row_band"] = (0, TT.TILE_LIMIT // nx)
    b_cpu = TT.bin_splats(proj_cpu, pm[0, 0], pm[1, 1], w, h,
                          **bin_kw)
    proj_gpu = proj_cpu.to(dev)
    b_gpu = TT.bin_splats(proj_gpu, pm[0, 0].to(dev), pm[1, 1].to(dev),
                          w, h, **bin_kw)
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
    band = bin_kw.get("tile_row_band")
    n_tiles = (band[1] if band else ny) * nx

    def composite(proj, binning, device, p00, p11):
        px, py, _ = TT.tile_pixel_ndc(w, h, cfg.tile_h,
                                      cfg.tile_w, device=device)
        tiles, resid = TP._composite_pallas_progressive(
            proj, binning, px[:n_tiles], py[:n_tiles], p00, p11,
            torch.tensor(cfg.background, device=device), cfg,
            image_size=(w, h), tile_row_band=band)
        return tiles, float(resid.max())
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
    comp_tol = comp_tol or (1e-4 if converged else 1e-5)
    check(comp_err <= comp_tol and resid_k == resid_p,
          f"{tag} composite of one binning: max |d| {comp_err:.3e} > "
          f"{comp_tol:g} or resid {resid_k} vs {resid_p}")

    # The whole frame from params.
    img_g, aux_g = TP.render_params4d_packed(params, cam, 0.0, cfg=cfg,
                                             return_aux=True)
    img_c, aux_c = TP.render_params4d_packed(params_cpu, cam_cpu, 0.0,
                                             cfg=cfg, return_aux=True)
    img_g = img_g.cpu()
    check(tuple(img_g.shape) == (h, w, 4)
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
          f"{N_SMALL:,} splats {w}x{h}"
          f"{', ' + json.dumps(overrides) if overrides else ''}"
          f"{', first band ' + str(band) if band else ''}: binning of one "
          f"projection equal (tile_start, counters, cut"
          f"{', head_counts' if converged else ''}, pair multisets; "
          f"{int(b_cpu.tile_start[-1]):,} live pairs); composite "
          f"{'+ tail ' if converged else ''}of one binning max |d| "
          f"{comp_err:.3e}; frame from params: aux equal, resid "
          f"{float(aux_g['resid_transmittance']):g}, mean |d| "
          f"{mean_err:.3e}, max |d| {float(err.max()):.3e}, share > 1e-3 "
          f"{frac:.5f} (tied pairs blend in sort order); covered share "
          f"{covered:.3f}")
    return b_gpu, img_g, aux_g


def weighting_kw(kw):
    """The tail's within-band weighting knobs among a wrapper call's
    keywords (wd_ab, alpha_pow), for its plain version."""
    return {k: kw[k] for k in ("wd_ab", "alpha_pow") if k in kw}


def tail_slots(meta, budget_lo, budget):
    """Pair slots the tail kernels must walk: per splat, its tile span
    (meta row 5, 0 for a dead splat) within the budget window."""
    return int((meta[5].clamp(max=budget) - budget_lo).clamp(min=0).sum())


def tail_reps(npts):
    """Timed launches of K7 or K9 at a stream of npts splats: the big-tier
    stream's few thousand take ~0.05 ms, mostly the wrapper's host time, so
    one hiccup of the host in ten launches would double the reading."""
    return 10 if npts >= 1_000_000 else 100


def phase_converged_kernels(captured, tag="(g)"):
    """K4-K7 at every call site of one converged frame (or of one band of
    it), against their plain versions on the card."""
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
    check(torch.equal(got, want), f"{tag} K4 pack_record_fields differs "
          f"from plain")
    ms = cuda_ms(lambda: PK.pack_record_fields(*args), 20)
    plain_ms = cuda_ms(k4_plain, 5)
    label = f"{rows[0].shape[0]:,} -> 10 x {pad_to:,}"
    results["K4 pack_record_fields"] = _sites([site(
        label, 0.0, ms, plain_ms, nbytes(*rows, got), 0)])
    print(f"{tag} K4 pack_record_fields: {label}, exact; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")

    # K5: the tail meta matrix.
    (args, _), = captured["pack_cuda.pack_meta_rows"]
    got, want = PK.pack_meta_rows(*args), PK.pack_meta_rows_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, want),
          f"{tag} K5 pack_meta_rows differs from plain")
    ms = cuda_ms(lambda: PK.pack_meta_rows(*args), 20)
    plain_ms = cuda_ms(lambda: PK.pack_meta_rows_plain(*args), 5)
    # The one PyTorch call nearest to it stacks six finished rows (the span
    # made beforehand, outside the timing).
    alive, tx0, tx1, ty0, ty1, dbits = args[:6]
    span = torch.where(alive, (tx1 - tx0 + 1) * (ty1 - ty0 + 1), 0)
    lib_ms = cuda_ms(lambda: torch.stack([tx0, tx1, ty0, ty1, dbits, span]),
                     20)
    label = f"6 x {args[-1]:,}"
    results["K5 pack_meta_rows"] = _sites([site(
        label, 0.0, ms, plain_ms, nbytes(*args[:6], got), 0, lib_ms)])
    print(f"{tag} K5 pack_meta_rows: {label}, exact; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, torch.stack of six finished rows "
          f"{lib_ms:.4f} ms")

    # K6: the main and the big-tier stream, then the main meta at a chunk
    # of 1024 (two sub-blocks, no int32 wrap of the depth sum), where the
    # bands and the slot masks must come out non-trivial; bit-equal to
    # plain and to the earlier form (one block a chunk,
    # `tools/csrc/tail_prepass_block_chunk.cu`), timed beside it.
    from fourdgs_torch.tools import prepass_split as PS
    earlier_k6 = PS.block_chunk_kernel()
    calls = captured["tail_cuda.tail_prepass"]
    check(len(calls) == 2,
          f"{tag} K6: {len(calls)} calls in one frame, want 2")
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
        def k6_earlier():
            return PS.earlier_tail_prepass(earlier_k6, *args, **kw)
        got, want, earlier = (TL.tail_prepass(*args, **kw), k6_plain(),
                              k6_earlier())
        torch.cuda.synchronize()
        for g, w, e, what in zip(got, want, earlier,
                                 ("band", "rect", "slot mask")):
            check(torch.equal(g, w), f"{tag} K6 {label}: {what} differs from "
                  f"plain")
            check(torch.equal(g, e), f"{tag} K6 {label}: {what} differs from "
                  f"the earlier form")
        band, rect, mask = got
        bands = torch.bincount(band, minlength=kw["k_bands"]).tolist()
        n_mask = int((mask != 0).sum())
        if label.startswith("main at"):
            check(sum(b > 0 for b in bands) > 1 and n_mask > 0,
                  f"{tag} K6 {label}: trivial output, chunks per band {bands}, "
                  f"{n_mask} non-zero slot masks")
        ms, earlier_ms = turns_ms({
            "kernel": lambda: TL.tail_prepass(*args, **kw),
            "earlier": k6_earlier}, 20).values()
        plain_ms = cuda_ms(k6_plain, 5)
        # Both kernels alone, from a CUDA graph: the device's time.
        steps, k_bands = meta.shape[1] // chunk, kw["k_bands"]
        rows = torch.empty((steps, 6), dtype=torch.int32, device=meta.device)
        cuts32 = cuts.to(torch.int32).contiguous()
        device_ms = PS.graph_ms(lambda: TL.TAIL_PREPASS(
            meta, cuts32, rows, meta.shape[1], chunk, budget, budget_lo,
            k_bands - 1, steps,
            stream=torch.cuda.current_stream().cuda_stream), reps=20)
        earlier_device_ms = PS.graph_ms(lambda: PS.earlier_tail_prepass(
            earlier_k6, meta, cuts32, chunk, budget, budget_lo, k_bands, rows),
            reps=20)
        where = (f"{label}: {meta.shape[1] // chunk:,} chunks of {chunk}, "
                 f"budget ({budget_lo}, {budget}]")
        if not label.startswith("main at"):
            sites.append(dict(site(where, 0.0, ms, plain_ms,
                                   PS.prepass_bytes(meta, budget_lo, budget)
                                   + nbytes(cuts, *got), 0),
                              earlier_ms=earlier_ms, device_ms=device_ms,
                              earlier_device_ms=earlier_device_ms))
        lines.append(f"{where}: exact, bit-equal to the earlier form, chunks "
                     f"per band {bands}, {n_mask:,} non-zero slot masks, "
                     f"window passes per chunk max "
                     f"{int((rect[:, 2] * rect[:, 3]).max())}; kernel "
                     f"{ms:.4f} ms (earlier form {earlier_ms:.4f}), alone "
                     f"{device_ms:.4f} ms (earlier {earlier_device_ms:.4f}), "
                     f"plain {plain_ms:.4f} ms")
    results["K6 tail_prepass"] = _sites(sites)
    print(f"{tag} K6 tail_prepass: " + "; ".join(lines))

    # K7: the main stream, then the big-tier stream.
    calls = captured["tail_cuda.tail_accumulate"]
    check(len(calls) == 2,
          f"{tag} K7: {len(calls)} calls in one frame, want 2")
    sites, lines = [], []
    for label, (args, kw) in zip(("main", "big"), calls):
        fields, meta, band, rect, cut, params_row = args
        npts = meta.shape[1]
        fields_p = F.pad(fields, (0, npts - fields.shape[1]))
        plain_kw = {k: kw[k] for k in ("k_bands", "nx", "ny", "chunk",
                                       "budget", "s_cy", "s_cx",
                                       "exact_clip")}
        plain_kw["budget_lo"] = kw.get("budget_lo", 0)
        plain_kw.update(weighting_kw(kw))

        def k7_plain():
            return TL.tail_accumulate_plain(fields_p, meta, band, cut,
                                            params_row, **plain_kw)
        got, want = TL.tail_accumulate(*args, **kw), k7_plain()
        torch.cuda.synchronize()
        d = (got - want).abs()
        bad = d > K7_ATOL + K7_RTOL * want.abs()
        check(not bool(bad.any()), f"{tag} K7 {label} stream: {int(bad.sum())} "
              f"entries outside {K7_RTOL:g} rel + {K7_ATOL:g}, max |d| "
              f"{float(d.max()):.3e}")
        check(label == "big" or float(want.abs().sum()) > 0,
              f"{tag} K7 {label}: nothing accumulated")
        nz = want != 0
        rel = float((d / want.abs().clamp(min=1e-30))[nz].max()) \
            if bool(nz.any()) else 0.0
        ms = cuda_ms(lambda: TL.tail_accumulate(*args, **kw),
                     tail_reps(npts))
        plain_ms = cuda_ms(k7_plain, 2, warmup=1)
        where = (f"{label}: {npts:,} splats, chunk {plain_kw['chunk']}, "
                 f"budget ({plain_kw['budget_lo']}, {plain_kw['budget']}]")
        sites.append(site(
            where, float(d.max()), ms, plain_ms,
            nbytes(fields, meta, band, rect, cut, params_row,
                   kw.get("slot_mask"), got),
            tail_slots(meta, plain_kw["budget_lo"], plain_kw["budget"])
            * kw["s_cy"] * kw["s_cx"] * PAIR_TEST_OPS))
        lines.append(f"{where}: max |d| {float(d.max()):.3e}, max rel "
                     f"{rel:.3e}, |acc| max {float(want.abs().max()):.3f}; "
                     f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    results["K7 tail_accumulate"] = _sites(sites)
    print(f"{tag} K7 tail_accumulate (tolerance {K7_RTOL:g} rel + {K7_ATOL:g}): "
          + "; ".join(lines))
    return results


# Odd shapes of the tail prepass (g): (chunk, chunks, budget, budget_lo, the
# meta's storage offset in words, what the shape puts on the card). Chunk
# 100 (Np = 200) is 16-byte aligned, chunk 50 is not and takes the scalar
# path, as does every meta at an offset of 1-3 words.
PREPASS_ODD_SHAPES = (
    (128, 300, 4, 0, 0, "chunk 128"),
    (256, 200, 16, 4, 0, "chunk 256, budget_lo 4"),
    (512, 100, 9, 3, 0, "chunk 512, budget_lo 3"),
    (1024, 60, 4, 0, 0, "chunk 1024"),
    (4096, 20, 9, 2, 0, "chunk 4096, masks set"),
    (100, 2, 4, 0, 0, "Np = 200, chunk 100"),
    (50, 3, 4, 0, 0, "chunk 50, off 16 bytes"),
    (16384, 20, 4, 0, 1, "chunk 16384, meta 1 word off"),
    (512, 40, 16, 4, 3, "chunk 512, meta 3 words off"),
    (2048, 30, 4, 0, 2, "chunk 2048, meta 2 words off"),
)


def phase_prepass_odd_shapes(dev):
    """(g): K6 at PREPASS_ODD_SHAPES, each with an all-dead chunk, and on
    the C-R8 wrap (one chunk of 16384 all live at dbits 250000, which wraps
    the int32 depth sum), bit-equal to plain and to its earlier form."""
    import torch
    from fourdgs_torch.ops import tail_cuda as TL
    from fourdgs_torch.tools import prepass_split as PS
    earlier_k6 = PS.block_chunk_kernel()
    gen = torch.Generator(device=dev).manual_seed(11)

    def meta_at(chunk, steps, offset):
        n = chunk * steps
        buf = torch.empty(6 * n + offset, dtype=torch.int32, device=dev)
        meta = buf[offset:].view(6, n)

        def ints(lo, hi):
            return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                                 dtype=torch.int32)
        meta[0], meta[2] = ints(0, 120), ints(0, 68)
        meta[1], meta[3] = meta[0] + ints(0, 3), meta[2] + ints(0, 3)
        meta[4] = torch.sort(ints(0, 1 << 20)).values
        meta[5] = ints(1, 12) * (ints(0, 2) == 1)
        meta[5, chunk:2 * chunk] = 0              # chunk 1: all dead
        return meta
    wrap = torch.zeros((6, 16384), dtype=torch.int32, device=dev)
    wrap[4], wrap[5] = 250000, 1
    cases = [(meta_at(chunk, steps, off), chunk, budget, lo, what)
             for chunk, steps, budget, lo, off, what in PREPASS_ODD_SHAPES]
    cases.append((wrap, 16384, 4, 0, "C-R8: one chunk, the depth sum wraps"))
    for meta, chunk, budget, lo, what in cases:
        cuts = torch.quantile(-meta[4].double(), torch.arange(
            1, 8, device=dev, dtype=torch.float64) / 8).to(torch.int32)
        if what.startswith("C-R8"):
            cuts = -torch.tensor([280000, 260000, 240000, 230000, 220000,
                                  210000, 200000], device=dev,
                                 dtype=torch.int32)
        got = TL.tail_prepass(meta, cuts, chunk, budget, lo)
        band, rect = TL.step_bands_rects(meta, chunk, cuts, lo, budget)
        want = (band, rect, TL.step_slot_masks(meta, chunk, budget, lo))
        earlier = PS.earlier_tail_prepass(earlier_k6, meta, cuts, chunk,
                                          budget, lo)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"(g) K6 {what}: differs from plain")
        check(all(torch.equal(g, e) for g, e in zip(got, earlier)),
              f"(g) K6 {what}: differs from its earlier form")
        if what.startswith("C-R8"):
            check(int(got[0][0]) == 7, "(g) K6 C-R8: band is not the "
                  "reference's 7")
        else:
            check(got[1][1].tolist() == [0, 0, 1, 1],
                  f"(g) K6 {what}: the all-dead chunk's rect is not empty")
    print(f"(g) K6 tail_prepass at {len(cases)} odd shapes (chunks 50-16384, "
          f"budget_lo > 0, an all-dead chunk each, chunk 100 at Np = 200, "
          f"chunk 50 and metas 1-3 words off on the scalar path, the C-R8 "
          f"wrap): bit-equal to plain and to the earlier form")


def phase_tail_variants(tag, captured, camera, cfg):
    """K7 and K9 against their plain versions where the frame's own call
    sites do not reach: the main stream's splats under the sample grids of
    two other tail blocks (the kernels' second unrolled instance and their
    run-time loops; params_row made for the block, everything else as the
    frame gave it), and the big-tier stream's first splats re-chunked to a
    chunk below 512, one ragged unit a chunk. K9 runs under a seeded random
    cotangent. Times are printed; the `kernels` line keeps the frame's own
    sites."""
    import torch
    import torch.nn.functional as F
    from fourdgs_torch.ops import tail_cuda as TL

    main, big = captured["tail_cuda.tail_accumulate"]
    pmat = camera.proj_matrix()
    cases = []
    (fields, meta, band, rect, cut, _), kw = main
    for block, what in TAIL_VARIANT_BLOCKS:
        s_cy, s_cx = cfg.tile_h // block[0], cfg.tile_w // block[1]
        prm = TL.tail_params_row(cfg.tile_h, cfg.tile_w, block, camera.width,
                                 camera.height, pmat[0, 0], pmat[1, 1])
        cases.append((f"main stream, tail_block {block}: {what}",
                      (fields, meta, band, rect, cut, prm),
                      dict(kw, s_cy=s_cy, s_cx=s_cx)))
    (fields, meta, _, _, cut, prm), kw = big
    meta_r = meta[:, :RAGGED_SPLATS].contiguous()
    check(meta_r.shape[1] == RAGGED_SPLATS
          and RAGGED_CHUNK < TL.SUB and RAGGED_SPLATS % RAGGED_CHUNK == 0,
          f"{tag} the big-tier stream has fewer than {RAGGED_SPLATS} ids")
    cuts = TL.global_band_cuts(
        torch.where(meta_r[5] > 0, meta_r[4], 2 ** 31 - 1), kw["k_bands"])
    band_r, rect_r, mask_r = TL.tail_prepass(
        meta_r, cuts, RAGGED_CHUNK, kw["budget"], budget_lo=kw["budget_lo"],
        k_bands=kw["k_bands"])
    cases.append((f"big-tier stream's first {RAGGED_SPLATS} ids at chunk "
                  f"{RAGGED_CHUNK} (ragged units)",
                  (fields[:, :RAGGED_SPLATS].contiguous(), meta_r, band_r,
                   rect_r, cut, prm),
                  dict(kw, chunk=RAGGED_CHUNK, slot_mask=mask_r)))
    gen = torch.Generator(device=meta.device).manual_seed(5)
    for label, args, kw in cases:
        fields, meta, band, rect, cut, prm = args
        fields_p = F.pad(fields, (0, meta.shape[1] - fields.shape[1]))
        plain_kw = {k: kw[k] for k in ("k_bands", "nx", "ny", "chunk",
                                       "budget", "s_cy", "s_cx",
                                       "exact_clip")}
        plain_kw["budget_lo"] = kw.get("budget_lo", 0)
        got = TL.tail_accumulate(*args, **kw)
        want = TL.tail_accumulate_plain(fields_p, meta, band, cut, prm,
                                        **plain_kw)
        torch.cuda.synchronize()
        d = (got - want).abs()
        bad = d > K7_ATOL + K7_RTOL * want.abs()
        check(not bool(bad.any()) and float(want.abs().sum()) > 0,
              f"{tag} K7 {label}: {int(bad.sum())} entries outside "
              f"{K7_RTOL:g} rel + {K7_ATOL:g}, max |d| {float(d.max()):.3e}, "
              f"sum |acc| {float(want.abs().sum()):.3e}")
        d_acc = torch.randn(want.shape, generator=gen, device=meta.device)

        def k9():
            return TL.tail_accumulate_bwd(fields_p, meta, band, cut, prm,
                                          d_acc, kw.get("slot_mask"),
                                          **plain_kw)
        got_b = k9()
        want_b = TL.tail_accumulate_bwd_plain(fields_p, meta, band, cut, prm,
                                              d_acc, **plain_kw)
        torch.cuda.synchronize()
        rel, _ = _field_err(got_b, want_b, 0)
        check(rel <= BWD_TOL and float(want_b.abs().max()) > 0
              and torch.equal(got_b, k9()),
              f"{tag} K9 {label}: {rel:.3e} of a field's max |d| > "
              f"{BWD_TOL:g}, or two launches differ")
        ms7 = cuda_ms(lambda: TL.tail_accumulate(*args, **kw), 10)
        ms9 = cuda_ms(k9, 10)
        print(f"{tag} K7 and K9 at {label}: K7 max |d| {float(d.max()):.3e} "
              f"(tolerance {K7_RTOL:g} rel + {K7_ATOL:g}), {ms7:.3f} ms; K9 "
              f"{rel:.3e} of max |d| (tolerance {BWD_TOL:g}; equal bit for "
              f"bit between two launches, not to the plain version), "
              f"{ms9:.3f} ms")


def phase_full_frame(tag, params, camera, cfg, kernels, expect, timed):
    """Launch counts of one frame through the entry point a user calls
    (every count set to 0 just before, read just after), then `timed`
    frames. `expect` maps a kernel name to its launches per frame, or to
    None for "at least one". Returns (launches, aux, median ms, image)."""
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
    w, h = camera.width, camera.height
    check(tuple(img.shape) == (h, w, 4)
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
          f"{w}x{h}, {cfg.tail_mode=}, {cfg.sort_backend=}: median "
          f"{med:.2f} ms "
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
    return launches, aux, med, img


def _field_err(got, want, dim):
    """Largest |d| over each field (index `dim`) relative to that field's
    max |want|, and the largest |d| overall."""
    import torch
    got, want = got.double(), want.double()
    dims = [d for d in range(want.dim()) if d != dim]
    scale = want.abs().amax(dim=dims).clamp(min=1e-30)
    err = (got - want).abs().amax(dim=dims) / scale
    return float(err.max()), float((got - want).abs().max())


def phase_backward_kernels(tag, calls_c, calls_t):
    """K8 at each composite backward call (pass 1 and, for the
    non-converged path, the deepening passes with `sel`) and K9 at each
    tail backward call, each against its plain version on the card."""
    import torch
    from fourdgs_torch.ops import composite_cuda as C
    from fourdgs_torch.ops import tail_cuda as TL

    results, lines = {}, []
    sites = []
    # The backward meets the deepening passes last first.
    n_sel = sum(c[0][2] is not None for c in calls_c)
    for (records, counts, sel, kx, ky, carry, fout, g), _ in calls_c:
        def k8():
            return C.composite_records_bwd(records, counts, sel, kx, ky,
                                           carry, fout, g)

        def plain():
            if sel is None:
                return C.composite_bwd_plain(records, counts, kx, ky, carry,
                                             fout, g)
            s = sel.long()
            return C.composite_bwd_plain(records, counts, kx[s], ky[s],
                                         carry, fout, g[s])
        got, again, want = k8(), k8(), plain()
        torch.cuda.synchronize()
        name = f"deepening pass {n_sel}" if sel is not None else "pass 1"
        n_sel -= sel is not None
        rel, err = _field_err(got[:, :C.N_FIELDS], want[:, :C.N_FIELDS], 1)
        check(rel <= BWD_TOL and bool((got[:, C.N_FIELDS:] == 0).all()),
              f"{tag} K8 ({name}): {rel:.3e} of a field's max |d| > "
              f"{BWD_TOL:g}")
        check(torch.equal(got, again), f"{tag} K8 ({name}): a second launch "
              f"differs from the first")
        ms = cuda_ms(k8, reps=10)
        plain_ms = cuda_ms(plain, reps=2, warmup=1)
        where = (f"{name}, T={records.shape[0]}, M={records.shape[2]}, "
                 f"P={kx.shape[2]}, {int(counts.sum()):,} records")
        # The named records read and their cotangents written, the pixel
        # coordinates, and the carry, output and cotangent of each tile.
        n_rec, tiles, pix = int(counts.sum()), records.shape[0], kx.shape[2]
        sites.append(site(
            where, err, ms, plain_ms,
            2 * n_rec * records.shape[1] * 4 + nbytes(counts, sel)
            + tiles * pix * 4 * (2 + 8 + 8 + 8),
            n_rec * pix * PAIR_TEST_OPS))
        lines.append(f"{where}: {rel:.3e} of max |d|; kernel {ms:.3f} ms, "
                     f"plain {plain_ms:.3f} ms")
    results["K8 composite_bwd"] = _sites(sites)
    print(f"{tag} K8 composite_bwd (tolerance {BWD_TOL:g} of each field's "
          f"max |d|; two launches bit-equal at every site): "
          + "; ".join(lines))
    if not calls_t:
        return results
    sites, lines = [], []
    for args, kw in calls_t:
        # The backward meets the streams in reverse order: big tier first.
        label = "big" if kw["budget_lo"] > 0 else "main"
        fields, meta, band, cut, params_row, d_acc, mask = args
        plain_kw = {k: kw[k] for k in ("k_bands", "nx", "ny", "chunk",
                                       "budget", "s_cy", "s_cx", "budget_lo",
                                       "exact_clip")}
        plain_kw.update(weighting_kw(kw))

        def k9():
            return TL.tail_accumulate_bwd(*args, **kw)

        def plain():
            return TL.tail_accumulate_bwd_plain(fields, meta, band, cut,
                                                params_row, d_acc, **plain_kw)
        got, want = k9(), plain()
        torch.cuda.synchronize()
        check(label == "big" or float(want.abs().max()) > 0,
              f"{tag} K9 {label}: no cotangent")
        rel, err = _field_err(got, want, 0) if float(want.abs().max()) > 0 \
            else (float(got.abs().max()), float(got.abs().max()))
        check(rel <= BWD_TOL, f"{tag} K9 {label}: {rel:.3e} of a field's max "
              f"|d| > {BWD_TOL:g}")
        ms = cuda_ms(k9, reps=tail_reps(meta.shape[1]))
        plain_ms = cuda_ms(plain, reps=2, warmup=1)
        where = (f"{label}: {meta.shape[1]:,} splats, chunk "
                 f"{plain_kw['chunk']}, budget ({plain_kw['budget_lo']}, "
                 f"{plain_kw['budget']}]")
        sites.append(site(
            where, err, ms, plain_ms,
            nbytes(fields, meta, band, cut, params_row, d_acc, mask, got),
            tail_slots(meta, plain_kw["budget_lo"], plain_kw["budget"])
            * kw["s_cy"] * kw["s_cx"] * PAIR_TEST_OPS))
        lines.append(f"{where}: {rel:.3e} of max |d|; kernel {ms:.3f} ms, "
                     f"plain {plain_ms:.3f} ms")
    results["K9 tail_accumulate_bwd"] = _sites(sites)
    print(f"{tag} K9 tail_accumulate_bwd (tolerance {BWD_TOL:g} of each "
          f"field's max |d|; one thread sums a splat's terms in a fixed "
          f"order, so K9 is not expected bit-equal to the plain version's "
          f"batched sums): " + "; ".join(lines))
    return results


def _grad_scales(grads):
    """Per field: max |g|, floored at 1e-4 of the largest over all fields."""
    top = max(float(g.abs().max()) for g in grads.values())
    check(top > 0.0, "all gradients are zero")
    return {k: max(float(g.abs().max()), 1e-4 * top) for k, g in grads.items()}


def phase_small_grads(dev, converged, kernels):
    """(k): card gradients against CPU gradients of the 20K-splat frame,
    from one binning and from params, then four Adam steps on the card.
    For the non-converged path it also returns the K8 inputs and launch
    counts of one grad step (phase j's `sel` form)."""
    import dataclasses

    import torch
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.ops import composite_cuda as C
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.render import tiles as TT
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.render.project import Projected
    from fourdgs_torch.scenes.cube import (CUBE_CAMERA, build_cube_scene,
                                           converged_cube_scene)
    from fourdgs_torch.train import loss as LOSS

    tag = f"(k) {'converged' if converged else 'non-converged'}"
    fields = ("mx", "my", "v0x", "v0y", "l0", "l1", "r", "g", "b", "a",
              "opacity")

    def scene(seed):
        p = build_cube_scene(N_SMALL, seed=seed, device=dev)
        return converged_cube_scene(p) if converged else p
    params = scene(1)
    cfg = auto_render_config(params["px"].shape[0], W_SMALL, H_SMALL,
                             converged=converged)
    params_cpu = {k: v.cpu() for k, v in params.items()}
    cam = Camera.create(**CUBE_CAMERA, width=W_SMALL, height=H_SMALL,
                        device=dev)
    cam_cpu = Camera.create(**CUBE_CAMERA, width=W_SMALL, height=H_SMALL,
                            device="cpu")
    wts_cpu = torch.rand((H_SMALL, W_SMALL, 3),
                         generator=torch.Generator().manual_seed(3)) * 2 - 1
    pm = cam_cpu.proj_matrix()

    # One binning (the card's, of the CPU projection) on both devices.
    proj_cpu = TP.project_params4d(params_cpu, cam_cpu, T_GRAD)
    b_gpu = TT.bin_splats(
        proj_cpu.to(dev), pm[0, 0].to(dev), pm[1, 1].to(dev), W_SMALL,
        H_SMALL, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
        max_tiles_per_splat=cfg.max_tiles_per_splat, quantized_depth=True,
        compact_keep_cols=cfg.sort_compact_keep_cols,
        big_splat_budget=cfg.big_splat_budget,
        big_splat_keep_cols=cfg.big_splat_keep_cols, pallas_compact=True,
        compact_row_len=cfg.compact_row_len,
        depth_prune_cap=cfg.depth_prune_cap,
        depth_prune_safety=cfg.depth_prune_safety,
        head_cap=cfg.max_splats_per_tile if converged else 0)

    def binning_grads(device, binning):
        proj = Projected(**{
            f.name: getattr(proj_cpu, f.name).detach().to(device).clone()
            .requires_grad_(f.name in fields)
            for f in dataclasses.fields(proj_cpu)})
        px, py, _ = TT.tile_pixel_ndc(W_SMALL, H_SMALL, cfg.tile_h,
                                      cfg.tile_w, device=device)
        tiles, _ = TP._composite_pallas_progressive(
            proj, binning, px, py, pm[0, 0].to(device), pm[1, 1].to(device),
            torch.tensor(cfg.background, device=device), cfg,
            image_size=(W_SMALL, H_SMALL))
        img = TT.assemble_image(tiles, W_SMALL, H_SMALL, cfg.tile_h,
                                cfg.tile_w)
        (img[..., :3] * wts_cpu.to(device)).sum().backward()
        return {f: getattr(proj, f).grad.cpu() for f in fields}
    b_cpu = TT.TileBinning(**{
        f.name: None if getattr(b_gpu, f.name) is None
        else getattr(b_gpu, f.name).cpu() for f in dataclasses.fields(b_gpu)})
    g_card, g_cpu = binning_grads(dev, b_gpu), binning_grads("cpu", b_cpu)
    one = max(float((g_card[k] - g_cpu[k]).abs().max()) / s
              for k, s in _grad_scales(g_cpu).items())
    check(one <= 1e-4, f"{tag} grads of one binning: {one:.3e} of a field's "
          f"max |g| > 1e-4")

    # The whole frame from params, counting the card's launches of the step.
    def param_grads(p, camera):
        p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
        img = TP.render_params4d_packed(p, camera, T_GRAD, cfg=cfg)
        (img[..., :3] * wts_cpu.to(img.device)).sum().backward()
        return {k: v.grad.cpu() for k, v in p.items()}
    for k in kernels.values():
        k.launches = 0
    captured = None
    if converged:
        gp_card = param_grads(params, cam)
    else:
        captured = {}
        orig = C.composite_records_bwd

        def recorder(*args):
            captured.setdefault("c", []).append(
                (_clone(list(args)), {}))
            return orig(*args)
        C.composite_records_bwd = recorder
        try:
            gp_card = param_grads(params, cam)
        finally:
            C.composite_records_bwd = orig
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    check(launches["K8 composite_bwd"] > 0, f"{tag}: K8 never launched")
    gp_cpu = param_grads(params_cpu, cam_cpu)
    worst_mean, worst_share = 0.0, 0.0
    for k, s in _grad_scales(gp_cpu).items():
        err = (gp_card[k] - gp_cpu[k]).abs().double() / s
        worst_mean = max(worst_mean, float(err.mean()))
        worst_share = max(worst_share, float((err > 1e-3).double().mean()))
        check(bool(torch.isfinite(gp_card[k]).all()),
              f"{tag} gradient of {k} not finite")
    check(worst_mean < 3e-4 and worst_share < 0.02,
          f"{tag} grads from params: mean {worst_mean:.3e}, share > 1e-3 "
          f"{worst_share:.4f} (tie tolerance: 3e-4, 0.02)")

    # Four Adam steps on the card toward a target from another seed.
    with torch.no_grad():
        target = TP.render_params4d_packed(scene(2), cam, 0.0, cfg=cfg)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.Adam(p.values(), lr=5e-2)
    losses = []
    for _ in range(4):
        opt.zero_grad()
        loss = LOSS.l2(TP.render_params4d_packed(p, cam, 0.0, cfg=cfg),
                       target)
        loss.backward()
        check(all(bool(torch.isfinite(v.grad).all()) for v in p.values()),
              f"{tag} Adam: a gradient is not finite")
        opt.step()
        losses.append(loss.item())
    check(losses[-1] < losses[0], f"{tag} Adam: the loss did not fall: "
          f"{losses}")
    print(f"{tag} {params['px'].shape[0]:,} splats {W_SMALL}x{H_SMALL} at "
          f"t={T_GRAD}: grads of one binning within {one:.3e} of each "
          f"field's max |g|; from params mean {worst_mean:.3e}, share > 1e-3 "
          f"{worst_share:.5f} (tied pairs); K8 launches per step "
          f"{launches['K8 composite_bwd']}; Adam lr 5e-2 losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}")
    return captured, launches


def phase_grad_step(params, camera, cfg, kernels, expect, timed, tag="(l)"):
    """(l): one 10M converged grad step with every launch count set to 0
    just before and read just after, then `timed` forward and forward +
    backward steps in turns. Returns (launches, step numbers)."""
    import torch
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.splats.packed import PARAM4D_FIELDS

    dev = params["px"].device
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}

    def forward():
        return grad_loss(TP.render_params4d_packed(p, camera, T_GRAD,
                                                   cfg=cfg))

    def step():
        for v in p.values():
            v.grad = None
        loss = forward()
        loss.backward()
        return loss
    for k in kernels.values():
        k.launches = 0
    loss = step()
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    for name, n in expect.items():
        check(launches[name] == n, f"{tag} {name}: {launches[name]} "
              f"launches per grad step, want {n}")
    check(bool(torch.isfinite(loss)), f"{tag} loss not finite")
    gmax = {}
    for k in PARAM4D_FIELDS:
        g = p[k].grad
        check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
              f"{tag} gradient of {k} not finite or zero")
        gmax[k] = float(g.abs().max())
    torch.cuda.reset_peak_memory_stats(dev)
    fwd, both = [], []
    for _ in range(timed):
        for fn, out in ((forward, fwd), (step, both)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            del loss
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    f_med, b_med = statistics.median(fwd), statistics.median(both)
    ratio = (b_med - f_med) / f_med
    print(f"{tag} grad step {params['px'].shape[0]:,} splats {W_FULL}x"
          f"{H_FULL} converged"
          f"{f', tail_depth_beta {cfg.tail_depth_beta:g}' if cfg.tail_depth_beta else ''}, "
          f"mean(img[..., :3]^2) at t={T_GRAD}: forward median "
          f"{f_med:.2f} ms [{', '.join(f'{t:.2f}' for t in fwd)}], forward + "
          f"backward median {b_med:.2f} ms "
          f"[{', '.join(f'{t:.2f}' for t in both)}], backward / forward "
          f"{ratio:.3f}; launches per step {json.dumps(launches)}; every "
          f"field's gradient finite and nonzero (max |g| "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in gmax.items()})}); "
          f"peak memory {peak:.2f} GiB")
    return launches, dict(fwd_ms=f_med, fwd_bwd_ms=b_med, bwd_over_fwd=ratio,
                          peak_gib=peak)


def _same_pairs(k1, v1, k2, v2, run=None):
    """Equal (key, value) multisets over the whole arrays or, with `run`,
    within every run of that many elements."""
    import torch

    def pairs(k, v):
        x = (k.long() << 32) | (v.long() & 0xFFFFFFFF)
        return torch.sort(x.reshape(-1, run) if run else x, dim=-1).values
    return torch.equal(pairs(k1, v1), pairs(k2, v2))


def _net_ms(kernel, args, reps):
    """Time of an in-place kernel on fresh copies of its (key, value)
    arrays, net of the copies."""
    key, val = args[:2]

    def run():
        kernel(key.clone(), val.clone(), *args[2:])

    def copies():
        key.clone(), val.clone()
    return max(0.0, cuda_ms(run, reps) - cuda_ms(copies, reps))


def phase_sort_kernels(captured):
    """(m): K10 and K11-K13 against their plain versions at the inputs of
    one kernel-sorted 10M frame, and the whole merge against torch.sort."""
    import torch
    from fourdgs_torch.ops import lookup_cuda as L
    from fourdgs_torch.ops import sort_checks as SC
    from fourdgs_torch.ops import sort_cuda as S
    from fourdgs_torch.render import tiles as TT
    from fourdgs_torch.tools import sort_split as SS

    e_tree, e_finish = SS.shared_stage_kernels()
    results = {}
    # K10: the standalone cut.
    check(len(captured["tiles.apply_cutkeys"]) == 1, "(m) K10: not one call")
    (key, cut), _ = captured["tiles.apply_cutkeys"][0]
    got, want = L.apply_cutkeys(key, cut), L.apply_cutkeys_plain(key, cut)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "(m) K10 apply_cutkeys differs from plain")
    live_in, live_out = int((key != S.DEAD).sum()), int((got != S.DEAD).sum())
    check(0 < live_out < live_in, f"(m) K10 cut nothing: {live_in:,} -> "
          f"{live_out:,}")
    ms = cuda_ms(lambda: L.apply_cutkeys(key, cut), 20)
    plain_ms = cuda_ms(lambda: L.apply_cutkeys_plain(key, cut), 5)
    label = f"{key.shape[0]:,} keys, {cut.shape[0]} tiles"
    results["K10 apply_cutkeys"] = _sites([site(
        label, 0.0, ms, plain_ms, nbytes(key, cut, got), 0)])
    print(f"(m) K10 apply_cutkeys: {label}, {live_in:,} live -> "
          f"{live_out:,}: exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    del got, want

    # The row sort that compacts the slots (plain PyTorch, as the
    # reference's is plain XLA), on its own.
    calls = [c for c in captured["tiles.compact_pairs"]
             if c[1].get("alternating")]
    check(len(calls) == 1, f"(m) compact_pairs: {len(calls)} alternating "
          f"calls in one frame")
    c_args, c_kw = calls[0]
    k2, v2, dropped = TT.compact_pairs(*c_args, **c_kw)
    torch.cuda.synchronize()
    check(tuple(k2.shape) == (MERGE_ROWS, MERGE_KEEP) and int(dropped) == 0,
          f"(m) compact_pairs gave {tuple(k2.shape)} rows, dropped "
          f"{int(dropped)} (want {MERGE_ROWS} x {MERGE_KEEP}, 0)")
    compact_ms = cuda_ms(lambda: TT.compact_pairs(*c_args, **c_kw), 3,
                         warmup=1)
    row_live = (k2 != S.DEAD).sum(1)
    print(f"(m) compact_pairs (torch.sort of {MERGE_ROWS:,} strided rows of "
          f"{-(-c_args[0].shape[0] // MERGE_ROWS):,} slots, keep "
          f"{MERGE_KEEP}, odd "
          f"rows reversed): {compact_ms:.3f} ms; live per row mean "
          f"{float(row_live.float().mean()):.1f}, max {int(row_live.max())}")
    del k2, v2

    # The whole merge, in both row-direction forms, against torch.sort.
    (k2, v2), m_kw = captured["tiles.merge_sorted_rows"][0]
    check(m_kw.get("rows_alternating") is True,
          "(m) merge_sorted_rows: the frame did not hand it alternating rows")
    n = S.merged_rows(*k2.shape) * k2.shape[1]

    def library():
        ks, order = torch.sort(k2.reshape(-1))
        return ks, v2.reshape(-1)[order]
    wk, wv = S.merge_sorted_rows_plain(k2, v2)
    asc_k, asc_v = k2.clone(), v2.clone()
    asc_k[1::2], asc_v[1::2] = k2[1::2].flip(1), v2[1::2].flip(1)
    forms = ((True, k2, v2), (False, asc_k, asc_v))
    whole = {}
    for alt, rk, rv in forms:
        gk, gv = S.merge_sorted_rows(rk, rv, rows_alternating=alt)
        torch.cuda.synchronize()
        what = f"(m) merge_sorted_rows (rows_alternating={alt})"
        check(torch.equal(gk, wk), f"{what}: keys differ from torch.sort")
        check(_same_pairs(gk, gv, wk, wv), f"{what}: (key, value) multisets "
              f"differ")
        check(bool(SC.is_sorted(gk)[0]), f"{what}: not sorted")
        check(int((gk != S.DEAD).sum()) == int((rk != S.DEAD).sum()),
              f"{what}: live count not conserved")
        whole[alt] = cuda_ms(lambda: S.merge_sorted_rows(
            rk, rv, rows_alternating=alt), 10)
    lib_ms = cuda_ms(library, 10)
    steps = S.merge_schedule(n, S.MERGE_BLOCK, S.CROSS_GROUP)
    single = S.merge_schedule(n, S.MERGE_BLOCK)
    n_cross = sum(st[0] == "cross" for st in steps)
    n_stages = sum(st[0] == "cross" for st in single)
    check(sum(st[3] for st in steps if st[0] == "cross") == n_stages,
          "(m) the grouped schedule does not hold the single stages")
    print(f"(m) merge_sorted_rows: {k2.shape[0]:,} rows x {k2.shape[1]} = "
          f"{n:,} pairs, {int((k2 != S.DEAD).sum()):,} live: keys equal "
          f"torch.sort, (key, value) multisets equal, sorted, live count "
          f"conserved, in both row forms; 1 + {n_cross} + "
          f"{len(steps) - n_cross} launches ({n_stages} cross stages), the "
          f"ones after K11 enqueued by one host call, {whole[True]:.4f} ms "
          f"(all-ascending rows {whole[False]:.4f} ms); torch.sort + gather "
          f"{lib_ms:.4f} ms")
    del asc_k, asc_v, gk, gv, wk, wv

    # K11 at its one call.
    check(len(captured["sort_cuda.merge_tree"]) == 1, "(m) K11: not one call")
    t_args, _ = captured["sort_cuda.merge_tree"][0]
    t_key, t_val, c, block, alt = t_args
    gk, gv = S.merge_tree(*t_args)
    pk, pv = S.merge_tree_plain(*t_args)
    torch.cuda.synchronize()
    check(torch.equal(gk, pk), "(m) K11 merge_tree: keys differ from plain")
    check(_same_pairs(gk, gv, pk, pv, run=block), "(m) K11 merge_tree: a "
          "block's (key, value) multiset differs from plain")
    ek, ev = SS.earlier_merge_tree(e_tree, *t_args)
    torch.cuda.synchronize()
    check(torch.equal(gk, ek) and torch.equal(gv, ev), "(m) K11 merge_tree "
          "differs from its earlier form")
    ms = cuda_ms(lambda: S.merge_tree(*t_args), 20)
    earlier_ms = cuda_ms(lambda: SS.earlier_merge_tree(e_tree, *t_args), 20)
    plain_ms = cuda_ms(lambda: S.merge_tree_plain(*t_args), 5)
    levels = range(c.bit_length(), block.bit_length())    # log2(run_out)
    label = f"{n:,} pairs, rows of {c} -> runs of {block:,}"
    k11 = results["K11 merge_tree"] = _sites([dict(site(
        label, 0.0, ms, plain_ms, 2 * nbytes(t_key, t_val),
        n // 2 * sum(levels) * CMPX_OPS), earlier_ms=earlier_ms)])
    k11["earlier_ms"] = earlier_ms
    print(f"(m) K11 merge_tree: {label} ({sum(levels)} stages in register "
          f"rounds), keys exact, blocks' multisets equal, bit-equal to the "
          f"earlier form; kernel {ms:.4f} ms (earlier form {earlier_ms:.4f} "
          f"ms), plain {plain_ms:.4f} ms")
    del gk, gv, pk, pv

    # K12 and K13 at every launch of the schedule, walked from what the
    # frame handed merge_levels (K11's output). A pass of K12 is held
    # against its single stages run by the plain version one after the
    # other, and each of those against the kernel with one stage (the plain
    # version swaps strictly too, so keys and values are exact); K13 against
    # its plain version, keys exact and every block's multiset equal.
    check(len(captured["sort_cuda.merge_levels"]) == 1, "(m) merge_levels: "
          "not one call")
    (key, val, lv_block), _ = captured["sort_cuda.merge_levels"][0]
    check(lv_block == block, f"(m) merge_levels block {lv_block}")
    k12_sites, k13_sites, single_ms, worst = [], [], 0.0, None
    for st in steps:
        if st[0] == "cross":
            _, d_hi, run_out, size = st
            gk, gv = S.merge_cross_stages(key.clone(), val.clone(), d_hi,
                                          size, run_out)
            pk, pv = key, val
            for i in range(size):
                d = d_hi >> i
                sk, sv = S.merge_cross_stage(pk.clone(), pv.clone(), d,
                                             run_out)
                pk, pv = S.merge_cross_stage_plain(pk, pv, d, run_out)
                torch.cuda.synchronize()
                check(torch.equal(sk, pk) and torch.equal(sv, pv),
                      f"(m) K12 merge_cross_stage (d {d}, run {run_out}) "
                      f"differs from plain")
                single_ms += _net_ms(S.merge_cross_stage,
                                     (key, val, d, run_out), 10)
            check(torch.equal(gk, pk) and torch.equal(gv, pv),
                  f"(m) K12 merge_cross_stages (d {d_hi}, {size} stages, run "
                  f"{run_out}) differs from its {size} single stages")
            args = (key, val, d_hi, size, run_out)
            ms = _net_ms(S.merge_cross_stages, args, 10)
            plain_ms = cuda_ms(lambda: S.merge_cross_stages_plain(*args), 3)
            k12_sites.append(site(
                f"d {d_hi:,}, {size} stages, run {run_out:,}", 0.0, ms,
                plain_ms, 2 * nbytes(key, val), n // 2 * size * CMPX_OPS))
            if worst is None or ms > worst[0]:
                worst = (ms, d_hi, size)
            key, val = pk, pv
        else:
            run_out = st[1]
            gk, gv = S.merge_finish(key.clone(), val.clone(), run_out, block)
            pk, pv = S.merge_finish_plain(key, val, block, run_out)
            torch.cuda.synchronize()
            check(torch.equal(gk, pk), f"(m) K13 merge_finish (run "
                  f"{run_out}): keys differ from plain")
            check(_same_pairs(gk, gv, pk, pv, run=block), f"(m) K13 "
                  f"merge_finish (run {run_out}): a block's multiset differs "
                  f"from plain")
            ek, ev = SS.earlier_merge_finish(e_finish, key.clone(),
                                             val.clone(), run_out, block)
            torch.cuda.synchronize()
            check(torch.equal(gk, ek) and torch.equal(gv, ev), f"(m) K13 "
                  f"merge_finish (run {run_out}) differs from its earlier "
                  f"form")
            args = (key, val, run_out, block)
            ms = _net_ms(S.merge_finish, args, 10)
            earlier_ms = _net_ms(
                lambda k, v, r, b: SS.earlier_merge_finish(e_finish, k, v, r,
                                                           b), args, 10)
            plain_ms = cuda_ms(lambda: S.merge_finish_plain(
                key, val, block, run_out), 3)
            k13_sites.append(dict(site(
                f"run {run_out:,}", 0.0, ms, plain_ms, 2 * nbytes(key, val),
                n // 2 * (block.bit_length() - 1) * CMPX_OPS),
                earlier_ms=earlier_ms))
            key, val = gk, gv
    check(bool(SC.is_sorted(key)[0]), "(m) the walked schedule did not sort")
    k12 = results["K12 merge_cross_stage"] = _sites(k12_sites)
    # The path enqueues the passes from C: the kernel's time is theirs so,
    # the sum of the sites' (a host call each) rides along.
    (key, val, _), _ = captured["sort_cuda.merge_levels"][0]
    k12["ms_a_call_each"] = k12["ms"]
    crosses = [st for st in steps if st[0] == "cross"]
    k12["ms"] = _net_ms(S._enqueue_levels, (key, val, block, crosses), 10)
    # The passes of one merge work on one pair of arrays that fits the
    # card's L2: from device memory they must together move one read and
    # one write of it, not one a pass (a site's bound is its launch alone).
    once = site("", 0.0, 0.0, 0.0, 2 * nbytes(key, val),
                n // 2 * n_stages * CMPX_OPS)
    k12["bound_ms"], k12["bound_by"] = once["bound_ms"], once["bound_by"]
    print(f"(m) K12 merge_cross_stage: {len(k12_sites)} passes "
          f"({', '.join(str(st[3]) for st in steps if st[0] == 'cross')} "
          f"stages), each exactly equal to its single stages, and each of "
          f"the {n_stages} single stages exactly equal to plain (keys and "
          f"values); slowest pass {worst[0]:.4f} ms (d {worst[1]:,}, "
          f"{worst[2]} stages); all passes enqueued by one host call "
          f"{k12['ms']:.4f} ms, a host call each {k12['ms_a_call_each']:.4f} "
          f"ms (the {n_stages} single stages so: {single_ms:.4f} ms), plain "
          f"{k12['plain_ms']:.4f} ms, bound {k12['bound_ms']:.4f} ms (one "
          f"read and one write of the arrays from device memory; they stay "
          f"in L2 between the passes)")
    k13 = results["K13 merge_finish"] = _sites(k13_sites)
    k13["earlier_ms"] = sum(x["earlier_ms"] for x in k13_sites)
    print(f"(m) K13 merge_finish: {len(k13_sites)} calls "
          f"({block.bit_length() - 1} stages in register rounds each), keys "
          f"exact, blocks' multisets equal, each bit-equal to the earlier "
          f"form; {', '.join(format(x['ms'], '.4f') for x in k13_sites)} ms, "
          f"all {k13['ms']:.4f} ms (earlier form "
          f"{', '.join(format(x['earlier_ms'], '.4f') for x in k13_sites)}, "
          f"all {k13['earlier_ms']:.4f} ms), plain {k13['plain_ms']:.4f} ms")
    # The launches after K11 as the path enqueues them: one host call.
    levels_ms = _net_ms(S.merge_levels, (key, val, block), 10)
    print(f"(m) merge_levels: the {len(steps)} launches after K11 enqueued "
          f"by one host call {levels_ms:.4f} ms (a host call each: K12 "
          f"{k12['ms_a_call_each']:.4f} + K13 {k13['ms']:.4f} ms)")
    # The whole function's numbers ride on K11's entry.
    results["K11 merge_tree"]["merge_sorted_rows"] = dict(
        ms=whole[True], all_ascending_ms=whole[False], library_ms=lib_ms,
        library="torch.sort of the keys + gather of the values",
        compact_pairs_ms=compact_ms, merge_levels_ms=levels_ms,
        single_stages_ms=single_ms)
    for name in ("K11 merge_tree", "K12 merge_cross_stage",
                 "K13 merge_finish"):
        # One PyTorch call computes the whole merge, none a part of it.
        results[name]["library_ms"] = None
    return results, dict(merge_ms=whole[True], library_ms=lib_ms,
                         compact_pairs_ms=compact_ms)


def _rows_of(kind, r, c, gen):
    """(r, c) int32 key rows, each sorted ascending, and the values 0 ...
    r * c - 1, for one adversarial case of phase (m)."""
    import torch
    dev = gen.device
    if kind == "all keys equal":
        k = torch.full((r, c), 5, dtype=torch.int32, device=dev)
    elif kind == "all DEAD":
        k = torch.full((r, c), 2 ** 31 - 1, dtype=torch.int32, device=dev)
    elif kind == "presorted":
        k = torch.arange(r * c, dtype=torch.int32, device=dev).reshape(r, c)
    else:
        k = torch.sort(torch.randint(0, 1 << 20, (r, c), generator=gen,
                                     device=dev, dtype=torch.int32),
                       dim=1).values
    v = torch.arange(r * c, dtype=torch.int32, device=dev).reshape(r, c)
    return k, v


def phase_merge_adversarial(dev):
    """(m) K11 and every K13 on adversarial inputs made on the card, in both
    row forms: bit-equal (keys and values) to the earlier form, and the
    whole merge's keys equal to torch.sort's, its multiset equal."""
    import torch
    from fourdgs_torch.ops import sort_cuda as S
    from fourdgs_torch.tools import sort_split as SS

    e_tree, e_finish = SS.shared_stage_kernels()
    gen = torch.Generator(device=dev).manual_seed(11)
    block = S.MERGE_BLOCK
    cases = (("all keys equal", 512, 512), ("all DEAD", 512, 512),
             ("presorted", 512, 512), ("rows of 256", 1024, 256),
             ("rows of 16,384", 16, 16384), ("one block", 32, 512))
    n_finish = 0
    for kind, r, c in cases:
        k2, v2 = _rows_of(kind, r, c, gen)
        for alt in (True, False):
            rk, rv = k2.clone(), v2.clone()
            if alt:
                rk[1::2], rv[1::2] = k2[1::2].flip(1), v2[1::2].flip(1)
            fk, fv = (rk.reshape(-1), rv.reshape(-1)) if kind == "one block" \
                else S._pad_rows(rk, rv)
            n = fk.shape[0]
            blk = min(block, n)
            what = f"(m) {kind}, rows_alternating={alt}"
            gk, gv = S.merge_tree(fk, fv, c, blk, alt)
            ek, ev = SS.earlier_merge_tree(e_tree, fk, fv, c, blk, alt)
            torch.cuda.synchronize()
            check(torch.equal(gk, ek) and torch.equal(gv, ev),
                  f"{what}: K11 differs from its earlier form")
            check(torch.equal(gk, S.merge_tree_plain(fk, fv, c, blk,
                                                     alt)[0]),
                  f"{what}: K11 keys differ from plain")
            finishes = []
            if kind == "one block":
                # K13 on the whole array (its run ascending): the bitonic
                # input of two half-array runs.
                hk, hv = S.merge_tree(fk, fv, c, n // 2, alt)
                finishes.append((hk, hv, n, n))
            k, v = gk, gv
            for st in S.merge_schedule(n, blk, S.CROSS_GROUP):
                if st[0] == "cross":
                    k, v = S.merge_cross_stages(k, v, st[1], st[3], st[2])
                else:
                    finishes.append((k.clone(), v.clone(), st[1], blk))
                    k, v = S.merge_finish(k, v, st[1], blk)
            for hk, hv, run_out, fb in finishes:
                a = S.merge_finish(hk.clone(), hv.clone(), run_out, fb)
                b = SS.earlier_merge_finish(e_finish, hk.clone(), hv.clone(),
                                            run_out, fb)
                torch.cuda.synchronize()
                check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                      f"{what}: K13 (run {run_out}) differs from its "
                      f"earlier form")
                n_finish += 1
            check(torch.equal(k, torch.sort(fk).values),
                  f"{what}: keys differ from torch.sort")
            check(_same_pairs(k, v, fk, fv), f"{what}: (key, value) "
                  f"multisets differ")
    print(f"(m) adversarial inputs ({', '.join(c[0] for c in cases)}; both "
          f"row forms): K11 and {n_finish} K13 launches bit-equal to the "
          f"earlier form, keys equal torch.sort's, multisets equal")


def phase_sorted_small_frame(dev, default):
    """(n): the 20K-splat converged frame under sort_backend="pallas" on
    the card against the CPU, and on the card against the default sort
    backend (`default`: phase (h)'s binning, image and aux)."""
    import torch
    b_def, img_def, aux_def = default
    b_srt, img_srt, aux_srt = phase_small_frame(
        dev, converged=True, tag="(n)", sort_backend="pallas",
        sort_compact_keep_cols=4096)
    for name in ("tile_start", "overflowed", "compact_dropped",
                 "prune_underkeep", "prune_cut", "tile_pruned", "big_ids",
                 "head_counts"):
        check(torch.equal(getattr(b_srt, name), getattr(b_def, name)),
              f"(n) binning field {name} differs between the sort backends")
    live = int(b_def.tile_start[-1])
    check(torch.equal(b_srt.pair_tile[:live], b_def.pair_tile[:live]),
          "(n) sorted keys' tile ids differ over the live prefix")
    check(torch.equal(_pair_multiset(b_srt), _pair_multiset(b_def)),
          "(n) per-tile pair multisets differ between the sort backends")
    for k in aux_def:
        check(float(aux_srt[k]) == float(aux_def[k]), f"(n) aux {k}: "
              f"{float(aux_srt[k])} vs default {float(aux_def[k])}")
    err = (img_srt - img_def).abs().amax(dim=-1)
    mean_err, frac = float(err.mean()), float((err > 1e-3).float().mean())
    check(mean_err < 1e-4 and frac < 0.01, f"(n) against the default sort "
          f"backend: mean |d| {mean_err:.3e}, share > 1e-3 {frac:.4f}")
    print(f"(n) against the default sort backend on the card: tile_start, "
          f"cut, head_counts and counters equal, tile ids of the "
          f"{live:,} live pairs equal, per-tile pair multisets equal; merged "
          f"arrays hold {b_srt.pair_splat.shape[0]:,} slots (default "
          f"{b_def.pair_splat.shape[0]:,}); image mean |d| {mean_err:.3e}, "
          f"share > 1e-3 {frac:.5f}")


def band_slice(captured, b):
    """The calls of band `b` out of the captured calls of a two-band
    converged frame (per band: one call of each wrapper, two of the tail's
    prepass and accumulate)."""
    two = ("tail_cuda.tail_prepass", "tail_cuda.tail_accumulate")
    return {name: calls[2 * b:2 * b + 2] if name in two else calls[b:b + 1]
            for name, calls in captured.items()}


def phase_seam(img, tile_h, seam_tile_rows):
    """(p): the image rows on both sides of a band seam differ from the mean
    of their neighbours by no more than rows at the other tile-row
    boundaries do (the reference's test_band_seams_consistent criterion,
    held against the rest of the image)."""
    rows = img[..., :3].mean(dim=(1, 2)).cpu()
    jump = (rows[1:-1] - 0.5 * (rows[:-2] + rows[2:])).abs()
    check(bool((jump < 0.05 + 0.25 * (rows[:-2] + rows[2:])).all()),
          "(p) a row differs from its neighbours by more than 0.05 + half "
          "their mean")
    at = {r: float(jump[r * tile_h - 2:r * tile_h + 1].max())
          for r in range(1, img.shape[0] // tile_h)}
    seam = max(at[r] for r in seam_tile_rows)
    other = max(v for r, v in at.items() if r not in seam_tile_rows)
    check(seam <= other, f"(p) rows at the band seam jump by {seam:.3e}, "
          f"rows at other tile-row boundaries by at most {other:.3e}")
    return seam, other


def _bits(x):
    """A 4-byte tensor's words as int32, for comparisons bit for bit."""
    import torch
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _pack_odd_shapes(dev, e_pack, e_unpack):
    """(q): K5's general form and K14 at PACK_ODD_SHAPES, bit-equal to their
    plain versions and to their earlier form."""
    import torch
    from fourdgs_torch.ops import pack_cuda as PK
    from fourdgs_torch.tools import pack_split as PS
    gen = torch.Generator(device=dev).manual_seed(9)
    for r, n, pad_to, offset, dtype in PACK_ODD_SHAPES:
        def words(size):
            if dtype == "int32":
                w = torch.randint(-2 ** 31, 2 ** 31 - 1, (size + offset,),
                                  generator=gen, device=dev,
                                  dtype=torch.int32)
            else:
                w = torch.randn(size + offset, generator=gen, device=dev)
            return w[offset:]
        rows = [words(n) for _ in range(r)]
        cot = words(r * pad_to).view(r, pad_to)
        what = f"(q) R {r}, n {n:,}, pad_to {pad_to:,}, offset {offset}, {dtype}"
        got = PK.pack_rows(rows, pad_to)
        want = PK.pack_rows_plain(rows, pad_to)
        earlier = PS.earlier_pack_rows(e_pack, rows, pad_to)
        back = PK.unpack_rows(cot, n)
        back_plain = PK.unpack_rows_plain(cot, n)
        back_earlier = PS.earlier_unpack_rows(e_unpack, cot, n)
        torch.cuda.synchronize()
        check(torch.equal(_bits(got), _bits(want)),
              f"{what}: K5 pack_rows differs from plain")
        check(torch.equal(_bits(got), _bits(earlier)),
              f"{what}: K5 pack_rows differs from its earlier form")
        check(all(torch.equal(_bits(g), _bits(w)) and torch.equal(
            _bits(g), _bits(e)) for g, w, e in zip(back, back_plain,
                                                   back_earlier)),
              f"{what}: K14 unpack_rows differs from plain or its earlier "
              f"form")
    print(f"(q) pack_rows and unpack_rows at {len(PACK_ODD_SHAPES)} odd "
          f"shapes (R 1-16, n = 0, n % 4 != 0, n = pad_to, pad_to % 4 != 0, "
          f"pad_to % 1024 == 0, views 1-3 words off, int32 and float32): "
          f"bit-equal to plain and to the earlier form")


def phase_pack_rows(dev, kernels):
    """(q): pack_rows of ten float32 rows of the converged scene's length
    against torch.stack, and its backward (K14) against the cotangent's
    rows; both bit-equal to their earlier form there and at the odd shapes,
    and timed beside it. Returns (results, launches)."""
    import torch
    from fourdgs_torch.ops import pack_cuda as PK
    from fourdgs_torch.scenes.cube import CONVERGED_PAD
    from fourdgs_torch.tools import pack_split as PS

    n = -(-N_FULL // CONVERGED_PAD) * CONVERGED_PAD
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = [torch.randn(n, device=dev, generator=gen).requires_grad_(True)
            for _ in range(10)]
    cot = torch.randn((10, n), device=dev, generator=gen)
    for k in kernels.values():
        k.launches = 0
    out = PK.pack_rows(rows, n)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    check(launches["K5 pack_rows"] == 1 and launches["K14 unpack_rows"] == 1,
          f"(q) launches {launches}")
    detached = [r.detach() for r in rows]
    check(torch.equal(out.detach(), torch.stack(detached)),
          "(q) pack_rows differs from torch.stack")
    check(all(torch.equal(r.grad, cot[i]) for i, r in enumerate(rows)),
          "(q) a row's gradient differs from its row of the cotangent")
    e_pack, e_unpack = PS.scalar_kernels()
    earlier = PS.earlier_pack_rows(e_pack, detached, n)
    torch.cuda.synchronize()
    check(torch.equal(_bits(out.detach()), _bits(earlier)),
          "(q) pack_rows differs from its earlier form")
    # A padded call, against the plain version.
    short = [r[:n - 1000] for r in detached[:3]]
    check(torch.equal(PK.pack_rows(short, n), PK.pack_rows_plain(short, n)),
          "(q) padded pack_rows differs from plain")
    _pack_odd_shapes(dev, e_pack, e_unpack)
    results = {}
    ms, earlier_ms, lib_ms = turns_ms({
        "kernel": lambda: PK.pack_rows(detached, n),
        "earlier": lambda: PS.earlier_pack_rows(e_pack, detached, n),
        "library": lambda: torch.stack(detached)}, 50).values()
    plain_ms = cuda_ms(lambda: PK.pack_rows_plain(detached, n), 5)
    label = f"10 x {n:,} float32"
    results["K5 pack_rows"] = _sites([dict(site(
        label, 0.0, ms, plain_ms, 2 * nbytes(cot), 0, lib_ms),
        earlier_ms=earlier_ms)])
    line = (f"(q) pack_rows {label}: forward exact against torch.stack and "
            f"bit-equal to the earlier form; kernel {ms:.4f} ms (earlier "
            f"form {earlier_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"torch.stack {lib_ms:.4f} ms")
    got = PK.unpack_rows(cot, n)
    want = PK.unpack_rows_plain(cot, n)
    back_earlier = PS.earlier_unpack_rows(e_unpack, cot, n)
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "(q) K14 unpack_rows differs from plain")
    check(all(torch.equal(_bits(g), _bits(e))
              for g, e in zip(got, back_earlier)),
          "(q) K14 unpack_rows differs from its earlier form")
    ms, earlier_ms, lib_ms = turns_ms({
        "kernel": lambda: PK.unpack_rows(cot, n),
        "earlier": lambda: PS.earlier_unpack_rows(e_unpack, cot, n),
        "library": lambda: cot[:, :n].clone()}, 50).values()
    # The plain version returns views; its copy is what moves the bytes.
    plain_ms = cuda_ms(lambda: [w.clone() for w in
                                PK.unpack_rows_plain(cot, n)], 5)
    results["K14 unpack_rows"] = _sites([dict(site(
        label, 0.0, ms, plain_ms, 2 * nbytes(cot), 0, lib_ms),
        earlier_ms=earlier_ms)])
    print(f"{line}; backward launches K14 once, gradients equal the "
          f"cotangent's rows, bit-equal to the earlier form; K14 {ms:.4f} ms "
          f"(earlier form {earlier_ms:.4f} ms), plain (a copy of each row "
          f"view) {plain_ms:.4f} ms, one copy of the (10, n) cotangent "
          f"{lib_ms:.4f} ms")
    return results, launches


# ---------------------------------------------------------------------------
# The exact-order paths: render_splats4d / 3d / 2d (phases (r) and (s))
# ---------------------------------------------------------------------------

def exact_kind(splats):
    return {"Splats4D": "4d", "Splats3D": "3d",
            "Splats2D": "2d"}[type(splats).__name__]


def render_exact(splats, camera, cfg, t=T_GRAD, return_aux=False):
    """One frame of the entry point of `splats`' kind: render_splats4d at
    time t (a 0-d tensor on the splats' device), render_splats3d,
    render_splats2d."""
    import torch
    from fourdgs_torch.render import pipeline as TP
    kind = exact_kind(splats)
    if kind == "4d":
        t = torch.tensor(t, device=splats.position.device)
        return TP.render_splats4d(splats, camera, t, cfg=cfg,
                                  return_aux=return_aux)
    if kind == "3d":
        return TP.render_splats3d(splats, camera, cfg=cfg,
                                  return_aux=return_aux)
    return TP.render_splats2d(splats, camera, cfg=cfg, return_aux=return_aux)


def exact_grad_step(splats, camera, cfg, t=T_GRAD):
    """grad_loss of one frame at time t, backward to the splats' position,
    covariance and color. Returns their gradients."""
    leaves = {k: getattr(splats, k).detach().clone().requires_grad_(True)
              for k in ("position", "color", "cov")}
    grad_loss(render_exact(type(splats)(**leaves), camera, cfg, t)).backward()
    return {k: v.grad for k, v in leaves.items()}


def small_exact_scenes(seed=11):
    """(r)'s scenes, made on the CPU from a seed: 20K 4D splats (the 20K
    cube's positions, rotations, scales and colors, with random velocities
    and time centres), their slice at t = 0 as 3D splats, and 20K 2D splats
    spread over the 2D scene's view."""
    import math

    import torch
    from fourdgs_torch.scenes.cube import build_cube_scene
    from fourdgs_torch.splats import gaussians as G

    p = build_cube_scene(N_SMALL, seed=1, device="cpu")
    g = torch.Generator().manual_seed(seed)
    n = N_SMALL

    def cols(*keys):
        return torch.stack([p[k] for k in keys], -1)
    s4 = G.Splats4D.from_motion(
        position4=torch.cat([cols("px", "py", "pz"),
                             torch.rand((n, 1), generator=g) * 2 - 1], -1),
        quat=cols("qw", "qx", "qy", "qz"), scale3=cols("sx", "sy", "sz"),
        lifetime=p["lifetime"], fade=p["fade"],
        velocity=torch.randn((n, 3), generator=g) * 20.0,
        color=cols("cr", "cg", "cb", "ca"))
    sliced, _ = s4.at_time(0.0)
    s3 = G.Splats3D(position=sliced.position, color=s4.color, cov=sliced.cov)
    ang = torch.rand(n, generator=g) * (2 * math.pi)
    scale = torch.rand((n, 2), generator=g) * 0.35 + 0.05
    s2 = G.Splats2D(
        position=(torch.rand((n, 2), generator=g) * 2 - 1)
        * torch.tensor([5.5, 1.4]),
        color=torch.cat([torch.rand((n, 3), generator=g),
                         torch.rand((n, 1), generator=g) * 0.7 + 0.3], -1),
        cov=G.build_cov2d(torch.stack([torch.cos(ang), torch.sin(ang)], -1),
                          scale[:, 0] ** 2, scale[:, 1] ** 2))
    return {"4d": s4, "3d": s3, "2d": s2}


def exact_binning_check(tag, splats, cam_cpu, dev, tiles, t=T_GRAD):
    """The exact binning of one projection, the CPU's, on the card and on
    the CPU: the projection and the depth keys of a CPU frame of `splats`
    as the pipeline hands them on (captured), the front-to-back permutation
    of the keys on both devices, and at each tile shape the binning of the
    CPU-permuted projection on both devices; every integer equal,
    `overflowed` included. Returns (a line for the log, the permuted
    projection, p00, p11)."""
    import torch
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.render import sort as TS
    from fourdgs_torch.render import tiles as TT

    # Only the binning's inputs are wanted: a capacity of 0 leaves the
    # frame's composite nothing to do.
    cap = capture_calls(lambda: render_exact(
        splats, cam_cpu, TP.RenderConfig(max_splats_per_tile=0), t),
        [(TP, "front_to_back_order"), (TP, "bin_splats")])
    (depth,), _ = cap["pipeline.front_to_back_order"][0]
    (proj, p00, p11, w, h), _ = cap["pipeline.bin_splats"][0]
    order = TS.front_to_back_order(depth)
    order_gpu = TS.front_to_back_order(depth.to(dev))
    check(torch.equal(order_gpu.cpu(), order),
          f"{tag} the front-to-back permutation differs between card and CPU")
    check(torch.equal(proj.depth, depth[order]),
          f"{tag} the captured projection is not the permuted one")
    proj_gpu = proj.to(dev)
    lines = []
    for tile_h, tile_w in tiles:
        b_cpu = TT.bin_splats(proj, p00, p11, w, h, tile_h, tile_w)
        b_gpu = TT.bin_splats(proj_gpu, p00.to(dev), p11.to(dev), w, h,
                              tile_h, tile_w)
        for f in ("pair_splat", "pair_tile", "tile_start", "overflowed"):
            check(torch.equal(getattr(b_gpu, f).cpu(), getattr(b_cpu, f)),
                  f"{tag} exact binning {tile_h}x{tile_w}: {f} differs "
                  f"between card and CPU")
        counts = b_cpu.tile_start[1:] - b_cpu.tile_start[:-1]
        lines.append(f"{tile_h}x{tile_w}: {int(b_cpu.tile_start[-1]):,} "
                     f"pairs, deepest tile {int(counts.max()):,}, "
                     f"overflowed {int(b_cpu.overflowed):,}")
    line = (f"front-to-back permutation of {depth.shape[0]:,} splats equal; "
            f"binning equal (pair_splat, pair_tile, tile_start, overflowed) "
            f"at " + "; ".join(lines))
    return line, proj, p00, p11


def composite_of_binning(proj, binning, cfg, w, h, p00, p11):
    """The composite of one binning on the projection's device, as
    render_projected runs it for cfg's backend: (T, P, 4) tiles."""
    import torch
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.render import tiles as TT
    dev = proj.mx.device
    px, py, _ = TT.tile_pixel_ndc(w, h, cfg.tile_h, cfg.tile_w, device=dev)
    bg = torch.tensor(cfg.background, device=dev)
    if cfg.backend == "pallas":
        return TP._composite_pallas_progressive(
            proj, binning, px, py, p00, p11, bg, cfg, image_size=(w, h))[0]
    tile_splat, tile_live = TP._gather_tile_lists(binning, cfg)
    return TP._composite_tiles_xla(proj, tile_splat, tile_live, px, py, p00,
                                   p11, bg, cfg.splat_chunk)


def frame_err(got, want):
    """(mean |d|, share of pixels with |d| > 1e-3, max |d|) over rgba."""
    err = (got.cpu() - want.cpu()).abs().amax(dim=-1)
    return (float(err.mean()), float((err > 1e-3).float().mean()),
            float(err.max()))


def phase_exact_small(dev, kernels):
    """(r): the exact paths at 20K splats and 512x256, card against CPU.
    For each entry point (render_splats4d, 3d, 2d): the exact binning of one
    projection equal on both devices (exact_binning_check); under each of
    EXACT_CFGS, the frame (launch counts of the card's frame, the composite
    of the CPU's binning on both devices, the frame from the splats), and for
    the pallas configs K1 (pass 1 and the `sel` passes) against its plain
    version at every captured input, and K8 at the inputs of a grad step;
    then the dense renderer on the card against the CPU. Returns (results,
    launches) keyed by path."""
    import dataclasses

    import torch
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.ops import composite_cuda
    from fourdgs_torch.render import dense as TD
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.render import tiles as TT
    from fourdgs_torch.scenes.cube import CUBE_CAMERA

    scenes = small_exact_scenes()
    results, launches = {}, {}
    for kind, s_cpu in scenes.items():
        s_gpu = s_cpu.to(dev)
        cam_kw = CUBE_CAMERA if kind != "2d" else {}
        cam = Camera.create(**cam_kw, width=W_SMALL, height=H_SMALL,
                            device=dev)
        cam_cpu = Camera.create(**cam_kw, width=W_SMALL, height=H_SMALL,
                                device="cpu")
        tag = f"(r) exact {kind}"
        line, proj, p00, p11 = exact_binning_check(tag, s_cpu, cam_cpu, dev,
                                                   EXACT_TILES)
        print(f"{tag} {N_SMALL:,} splats {W_SMALL}x{H_SMALL}: {line}")
        w, h = W_SMALL, H_SMALL
        for label, kw in EXACT_CFGS:
            cfg = TP.RenderConfig(**kw)
            path = f"exact {kind}, {label}, {W_SMALL}x{H_SMALL}"
            for k in kernels.values():
                k.launches = 0
            img_g, aux_g = render_exact(s_gpu, cam, cfg, return_aux=True)
            torch.cuda.synchronize()
            launches[path] = {n: k.launches for n, k in kernels.items()}
            passes = cfg.deepening_passes if cfg.backend == "pallas" else 0
            check(launches[path]["K1 composite"] == passes
                  and sum(launches[path].values()) == passes,
                  f"{tag} {label}: launches {launches[path]}, want K1 "
                  f"{passes} and nothing else")
            img_c, aux_c = render_exact(s_cpu, cam_cpu, cfg, return_aux=True)
            mean, share, mx = frame_err(img_g, img_c)
            check(tuple(img_g.shape) == (H_SMALL, W_SMALL, 4)
                  and bool(torch.isfinite(img_g).all())
                  and mean < 1e-4 and share < 0.01,
                  f"{tag} {label} frame: mean |d| {mean:.3e}, share > 1e-3 "
                  f"{share:.4f}")
            b_cpu = TT.bin_splats(proj, p00, p11, w, h, cfg.tile_h,
                                  cfg.tile_w)
            b_gpu = TT.TileBinning(**{
                f.name: None if getattr(b_cpu, f.name) is None
                else getattr(b_cpu, f.name).to(dev)
                for f in dataclasses.fields(b_cpu)})
            t_k = composite_of_binning(proj.to(dev), b_gpu, cfg, w, h,
                                       p00.to(dev), p11.to(dev))
            t_p = composite_of_binning(proj, b_cpu, cfg, w, h, p00, p11)
            comp = float((t_k.cpu() - t_p).abs().max())
            check(comp <= EDGE_TOL, f"{tag} {label} composite of one "
                  f"binning: max |d| {comp:.3e} > {EDGE_TOL:g}")
            aux = {k: float(v) for k, v in aux_g.items()}
            aux_same = all(float(aux_c[k]) == v for k, v in aux.items())
            print(f"{tag} {label}: launches K1 {passes}, nothing else; "
                  f"composite of one binning max |d| {comp:.3e}; frame from "
                  f"the splats mean |d| {mean:.3e}, max |d| {mx:.3e}, share "
                  f"> 1e-3 {share:.5f}; aux {json.dumps(aux)} "
                  f"({'equal to' if aux_same else 'differs from'} the CPU's "
                  f"{json.dumps({k: float(v) for k, v in aux_c.items()})})")
            if cfg.backend != "pallas":
                continue
            cap = capture_calls(
                lambda: render_exact(s_gpu, cam, cfg),
                [(TP, "composite_records")]
                + [(TP, "composite_records_at")] * (passes > 1))
            results[path] = {"K1 composite": phase_composite(
                f"{tag} {label}", cap["pipeline.composite_records"],
                cap.get("pipeline.composite_records_at", ()))}
            del cap
            step = f"exact {kind} grad step, {label}, {W_SMALL}x{H_SMALL}"
            for k in kernels.values():
                k.launches = 0
            cap = capture_calls(
                lambda: exact_grad_step(s_gpu, cam, cfg),
                [(composite_cuda, "composite_records_bwd")])
            torch.cuda.synchronize()
            launches[step] = {n: k.launches for n, k in kernels.items()}
            check(launches[step]["K1 composite"] == passes
                  and launches[step]["K8 composite_bwd"] == passes,
                  f"{tag} {label} grad step: launches {launches[step]}")
            results[step] = phase_backward_kernels(
                f"{tag} {label} grad step",
                cap["composite_cuda.composite_records_bwd"], [])
            del cap
            torch.cuda.empty_cache()

    # The dense renderer, card against CPU, on the first N_DENSE splats of
    # the 4D scene (one splat at a time against every pixel: the full 20K
    # at 512x256 is minutes on the CPU).
    s4 = scenes["4d"]
    part = type(s4)(**{k: getattr(s4, k)[:N_DENSE]
                       for k in ("position", "color", "cov")})
    cam = Camera.create(**CUBE_CAMERA, width=W_DENSE, height=H_DENSE,
                        device=dev)
    cam_cpu = Camera.create(**CUBE_CAMERA, width=W_DENSE, height=H_DENSE,
                            device="cpu")
    img_g = TD.render_splats4d(part.to(dev), cam, T_GRAD)
    img_c = TD.render_splats4d(part, cam_cpu, T_GRAD)
    mean, share, mx = frame_err(img_g, img_c)
    check(bool(torch.isfinite(img_g).all()) and mean < 1e-4 and share < 0.01,
          f"(r) dense renderer: mean |d| {mean:.3e}, share > 1e-3 "
          f"{share:.4f}")
    sliced, top = part.at_time(T_GRAD)
    proj = TD.sort_front_to_back(TD.project_splats(
        sliced.position, sliced.cov, part.color, top, cam_cpu))
    px, py = TD.pixel_centers_ndc(W_DENSE, H_DENSE, device="cpu")
    pm = cam_cpu.proj_matrix()
    bg = torch.tensor([0.0, 0.0, 0.0, 1.0])
    d_c = TD.composite_dense(proj, px, py, pm[0, 0], pm[1, 1], bg)
    d_g = TD.composite_dense(proj.to(dev), px.to(dev), py.to(dev),
                             pm[0, 0].to(dev), pm[1, 1].to(dev), bg.to(dev))
    comp = float((d_g.cpu() - d_c).abs().max())
    check(comp <= EDGE_TOL, f"(r) dense composite of one projection: max "
          f"|d| {comp:.3e} > {EDGE_TOL:g}")
    print(f"(r) dense renderer, {N_DENSE:,} of the 4D splats at "
          f"{W_DENSE}x{H_DENSE}, card against CPU: composite of one "
          f"projection max |d| {comp:.3e}; frame from the splats mean |d| "
          f"{mean:.3e}, max |d| {mx:.3e}, share > 1e-3 {share:.5f}; mean rgb "
          f"{float(img_c[..., :3].mean()):.4f}")
    return results, launches


def _timed_ms(fn, reps):
    """Median host milliseconds of `reps` calls of fn after one untimed
    call, each ended by a synchronize (the clock of phase_full_frame), and
    the peak memory of those calls in GiB."""
    import torch
    dev = torch.device("cuda", 0)
    out = fn()
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del out
    return (statistics.median(times), times,
            torch.cuda.max_memory_allocated(dev) / 2 ** 30)


def phase_exact_full(dev, kernels):
    """(s): the viewer's full-width exact frame, the `linear` scene's 182,400
    motion splats (scenes.linear_motion on models.torus(76, 48)) at t = 20
    from the scene's camera, at 800x800 and 1920x1080, under the viewer's
    pallas config and the default config: the exact binning of the frame's
    projection equal on card and CPU
    (`overflowed` included) at both tile shapes; per frame the launch
    counts, the median ms, peak memory and aux (overflowed and the
    truncation residual printed: the exact path has no big-splat tier and
    M = 1024 truncates deep tiles, as in the reference); K1 against its
    plain version at the pallas frame's inputs; the xla frame's color sum
    in both forms (color_sum_forms). Then one grad step of the pallas
    backend at 1920x1080 (K8 against its plain version at its inputs) and
    one of the xla backend at 800x800, each with its launch counts, time
    and peak memory; and the lit frame (lit_frame). Returns (results,
    launches)."""
    import torch
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.ops import composite_cuda
    from fourdgs_torch.render import pipeline as TP

    from fourdgs_torch.scenes import models as TM
    from fourdgs_torch.scenes import scenes as TSC

    t0 = time.time()
    s_cpu = TSC.linear_motion(TM.torus(*LINEAR_GRID), steps=LINEAR_STEPS,
                              device="cpu")[0]
    s_gpu = s_cpu.to(dev)
    print(f"(s) linear scene {s_cpu.count:,} motion splats "
          f"({s_cpu.count // LINEAR_STEPS:,} vertices x {LINEAR_STEPS} "
          f"steps) built in {time.time() - t0:.1f} s")
    results, launches = {}, {}
    for w, h in VIEWER_SIZES:
        cam = Camera.create(**LINEAR_CAMERA, width=w, height=h, device=dev)
        cam_cpu = Camera.create(**LINEAR_CAMERA, width=w, height=h,
                                device="cpu")
        tag = f"(s) {w}x{h}"
        print(f"{tag}: " + exact_binning_check(
            tag, s_cpu, cam_cpu, dev, EXACT_TILES, LINEAR_T)[0])
        for label, kw in EXACT_CFGS[:2]:
            cfg = TP.RenderConfig(**kw)
            path = f"exact 4d, {label}, {w}x{h}"
            for k in kernels.values():
                k.launches = 0
            img, aux = render_exact(s_gpu, cam, cfg, LINEAR_T,
                                    return_aux=True)
            torch.cuda.synchronize()
            launches[path] = {n: k.launches for n, k in kernels.items()}
            want = 1 if cfg.backend == "pallas" else 0
            check(launches[path]["K1 composite"] == want
                  and sum(launches[path].values()) == want,
                  f"{tag} {label}: launches {launches[path]}")
            check(tuple(img.shape) == (h, w, 4)
                  and bool(torch.isfinite(img).all()),
                  f"{tag} {label}: frame not finite")
            # Not required to be lit: M = 1,024 keeps each deep tile's
            # nearest pairs, of time slices faded out at the frame's time,
            # as in the reference (its own frame of this scene is black
            # too); lit_frame renders it lit.
            mean_rgb = float(img[..., :3].mean())
            del img
            med, times, peak = _timed_ms(
                lambda: render_exact(s_gpu, cam, cfg, LINEAR_T),
                TIMED_FRAMES_EXACT)
            print(f"{tag} {label}: median {med:.2f} ms ({1e3 / med:.2f} "
                  f"fps) over {TIMED_FRAMES_EXACT} frames "
                  f"[{', '.join(f'{x:.2f}' for x in times)}]; peak memory "
                  f"{peak:.2f} GiB; aux "
                  f"{json.dumps({k: float(v) for k, v in aux.items()})}; "
                  f"mean rgb {mean_rgb:.4f}; launches per frame "
                  f"{json.dumps(launches[path])}")
            if cfg.backend == "pallas":
                cap = capture_calls(
                    lambda: render_exact(s_gpu, cam, cfg, LINEAR_T),
                    [(TP, "composite_records")])
                results[path] = {"K1 composite": phase_composite(
                    f"{tag} {label}", cap["pipeline.composite_records"])}
                del cap
            elif (w, h) == VIEWER_SIZES[0]:
                color_sum_forms(tag, s_gpu, cam, cfg)
            torch.cuda.empty_cache()

    for (w, h), (label, kw) in (((1920, 1080), EXACT_CFGS[1]),
                                ((800, 800), EXACT_CFGS[0])):
        cfg = TP.RenderConfig(**kw)
        cam = Camera.create(**LINEAR_CAMERA, width=w, height=h, device=dev)
        tag = f"(s) grad step {w}x{h}, {label}"
        path = f"exact 4d grad step, {label}, {w}x{h}"
        for k in kernels.values():
            k.launches = 0
        targets = ([(composite_cuda, "composite_records_bwd")]
                   if cfg.backend == "pallas" else [])
        grads = {}
        cap = capture_calls(
            lambda: grads.update(exact_grad_step(s_gpu, cam, cfg, LINEAR_T)),
            targets)
        torch.cuda.synchronize()
        launches[path] = {n: k.launches for n, k in kernels.items()}
        want = 1 if cfg.backend == "pallas" else 0
        check(launches[path]["K1 composite"] == want
              and launches[path]["K8 composite_bwd"] == want
              and sum(launches[path].values()) == 2 * want,
              f"{tag}: launches {launches[path]}")
        for k, g in grads.items():
            check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
                  f"{tag}: gradient of {k} not finite or zero")
        if targets:
            results[path] = phase_backward_kernels(
                tag, cap["composite_cuda.composite_records_bwd"], [])
        del cap, grads
        torch.cuda.empty_cache()
        med, times, peak = _timed_ms(
            lambda: exact_grad_step(s_gpu, cam, cfg, LINEAR_T), 3)
        print(f"{tag}: mean(img[..., :3]^2) at t={LINEAR_T}, forward + "
              f"backward median {med:.2f} ms over 3 steps "
              f"[{', '.join(f'{x:.2f}' for x in times)}]; peak memory "
              f"{peak:.2f} GiB; launches per step "
              f"{json.dumps(launches[path])}; every gradient finite and "
              f"nonzero")
        torch.cuda.empty_cache()
    lit_res, lit_launches = lit_frame(s_cpu, s_gpu, dev, kernels)
    results.update(lit_res)
    launches.update(lit_launches)
    return results, launches


def color_sum_forms(tag, s_gpu, cam, cfg):
    """The xla frame with the chunk's color sum as shipped (the reference's
    einsum, a batched matmul: pipeline._color_sum) and as a broadcast
    product and sum over the chunk, which makes a (T, C, P, 3) tensor:
    CUDA-event ms a frame in three turns of alternating order, and the two
    images' largest difference."""
    import torch
    from fourdgs_torch.render import pipeline as TP

    matmul = TP._color_sum

    def broadcast(wgt, rgb):
        return (wgt[..., None] * rgb[:, :, None, :]).sum(dim=1)

    def frame(form):
        def run():
            TP._color_sum = form
            try:
                return render_exact(s_gpu, cam, cfg, LINEAR_T)
            finally:
                TP._color_sum = matmul
        return run
    img_m, img_b = frame(matmul)(), frame(broadcast)()
    err = float((img_m - img_b).abs().max())
    check(err <= 1e-5, f"{tag} xla color sum: the two forms differ by "
          f"{err:.3e}")
    del img_m, img_b
    ms = turns_ms({"matmul": frame(matmul), "broadcast": frame(broadcast)},
                  reps=3)
    print(f"{tag} xla frame by its color sum (CUDA events, medians of three "
          f"alternating turns of 3 frames): matmul (shipped) "
          f"{ms['matmul']:.2f} ms, broadcast product and sum "
          f"{ms['broadcast']:.2f} ms; images max |d| {err:.3e}")


def lit_frame(s_cpu, s_gpu, dev, kernels):
    """(s)'s lit frame: the `linear` scene at the viewer's default t = 0,
    800x800, under the viewer's pallas config with M = LINEAR_M_LIT, which
    truncates no tile. Its binning equal on card and CPU; one frame's
    launches (K1 once); the image finite, lit, and within PARITY_MEAN /
    PARITY_MAX of the dense renderer on the card; K1 against plain at the
    frame's inputs; a grad step's launches (K1 and K8 once), its gradients
    finite and nonzero, K8 against plain at its inputs, and K8 and plain
    each against the plain version run in float64; frame and step timed
    with their peak memory. Returns (results, launches)."""
    import torch
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.ops import composite_cuda
    from fourdgs_torch.render import dense as TD
    from fourdgs_torch.render import pipeline as TP

    w, h = VIEWER_SIZES[0]
    t = LINEAR_T_LIT
    cfg = TP.RenderConfig(**dict(EXACT_CFGS[1][1],
                                 max_splats_per_tile=LINEAR_M_LIT))
    cam = Camera.create(**LINEAR_CAMERA, width=w, height=h, device=dev)
    cam_cpu = Camera.create(**LINEAR_CAMERA, width=w, height=h, device="cpu")
    label = f"{EXACT_CFGS[1][0]} M={LINEAR_M_LIT:,}"
    tag = f"(s) lit {w}x{h} t={t:g}"
    print(f"{tag}: " + exact_binning_check(
        tag, s_cpu, cam_cpu, dev, ((cfg.tile_h, cfg.tile_w),), t)[0])
    path = f"exact 4d, {label}, t={t:g}, {w}x{h}"
    step = f"exact 4d grad step, {label}, t={t:g}, {w}x{h}"
    for k in kernels.values():
        k.launches = 0
    img, aux = render_exact(s_gpu, cam, cfg, t, return_aux=True)
    torch.cuda.synchronize()
    launches = {path: {n: k.launches for n, k in kernels.items()}}
    check(launches[path]["K1 composite"] == 1
          and sum(launches[path].values()) == 1,
          f"{tag}: launches {launches[path]}")
    aux = {k: float(v) for k, v in aux.items()}
    check(aux["overflowed"] == 0 and aux["max_tile_pairs"] <= LINEAR_M_LIT,
          f"{tag}: a tile is truncated, aux {aux}")
    mean_rgb = float(img[..., :3].mean())
    lit = float((img[..., :3].amax(-1) > 0.01).float().mean())
    check(tuple(img.shape) == (h, w, 4) and bool(torch.isfinite(img).all())
          and mean_rgb > 1e-3,
          f"{tag}: frame not finite or black (mean rgb {mean_rgb:.3e})")
    t0 = time.time()
    want = TD.render_splats4d(s_gpu, cam, t)
    torch.cuda.synchronize()
    dense_s = time.time() - t0
    d = (img - want).abs()
    mean_d, max_d = float(d.mean()), float(d.max())
    check(mean_d < PARITY_MEAN and max_d < PARITY_MAX,
          f"{tag} against the dense renderer: mean |d| {mean_d:.3e}, max "
          f"|d| {max_d:.3e}")
    del img, want, d
    med, times, peak = _timed_ms(lambda: render_exact(s_gpu, cam, cfg, t),
                                 TIMED_FRAMES_EXACT)
    print(f"{tag} {label}: mean rgb {mean_rgb:.5f}, {lit:.4f} of pixels "
          f"above 0.01; against the dense renderer on the card ({dense_s:.1f}"
          f" s) mean |d| {mean_d:.3e}, max |d| {max_d:.3e}; median {med:.2f}"
          f" ms over {TIMED_FRAMES_EXACT} frames "
          f"[{', '.join(f'{x:.2f}' for x in times)}]; peak memory "
          f"{peak:.2f} GiB; aux {json.dumps(aux)}; launches per frame "
          f"{json.dumps(launches[path])}")
    cap = capture_calls(lambda: render_exact(s_gpu, cam, cfg, t),
                        [(TP, "composite_records")])
    results = {path: {"K1 composite": phase_composite(
        f"{tag} {label}", cap["pipeline.composite_records"])}}
    del cap
    torch.cuda.empty_cache()

    for k in kernels.values():
        k.launches = 0
    grads = {}
    cap = capture_calls(
        lambda: grads.update(exact_grad_step(s_gpu, cam, cfg, t)),
        [(composite_cuda, "composite_records_bwd")])
    torch.cuda.synchronize()
    launches[step] = {n: k.launches for n, k in kernels.items()}
    check(launches[step]["K1 composite"] == 1
          and launches[step]["K8 composite_bwd"] == 1
          and sum(launches[step].values()) == 2,
          f"{tag} grad step: launches {launches[step]}")
    for k, g in grads.items():
        check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
              f"{tag} grad step: gradient of {k} not finite or zero")
    results[step] = phase_backward_kernels(
        f"{tag} {label} grad step",
        cap["composite_cuda.composite_records_bwd"], [])
    # K8 and its plain version against the plain version in float64 (its
    # forward too) at the same inputs: both within BWD_TOL of each field's
    # max, so that K8 is as close to the exact result as the plain version.
    (records, counts, sel, kx, ky, carry, fout, g), _ = cap[
        "composite_cuda.composite_records_bwd"][0]
    got = composite_cuda.composite_records_bwd(records, counts, sel, kx, ky,
                                               carry, fout, g)
    plain = composite_cuda.composite_bwd_plain(records, counts, kx, ky,
                                               carry, fout, g)
    del cap, grads, fout
    f64 = [x.double() for x in (records, kx, ky, carry, g)]
    del records
    fout64 = composite_cuda.composite_plain(f64[0], counts, *f64[1:4])
    exact = composite_cuda.composite_bwd_plain(f64[0], counts, *f64[1:4],
                                               fout64, f64[4])
    del f64, fout64
    n = composite_cuda.N_FIELDS
    k8_rel = _field_err(got[:, :n], exact[:, :n], 1)[0]
    plain_rel = _field_err(plain[:, :n], exact[:, :n], 1)[0]
    check(k8_rel <= BWD_TOL and plain_rel <= BWD_TOL,
          f"{tag} grad step against float64: K8 {k8_rel:.3e}, plain "
          f"{plain_rel:.3e} of a field's max > {BWD_TOL:g}")
    print(f"{tag} {label} grad step, against the plain version in float64 "
          f"(forward and backward): K8 {k8_rel:.3e}, the plain version "
          f"{plain_rel:.3e} of a field's max |d|")
    del got, plain, exact
    torch.cuda.empty_cache()
    med, times, peak = _timed_ms(
        lambda: exact_grad_step(s_gpu, cam, cfg, t), 3)
    print(f"{tag} {label} grad step: forward + backward median {med:.2f} ms"
          f" over 3 steps [{', '.join(f'{x:.2f}' for x in times)}]; peak "
          f"memory {peak:.2f} GiB; launches per step "
          f"{json.dumps(launches[step])}; every gradient finite and nonzero")
    torch.cuda.empty_cache()
    return results, launches


# ---------------------------------------------------------------------------
# The fitting path: trainer.fit with densify, checkpoints (phase (t))
# ---------------------------------------------------------------------------

def trainer_params(packed):
    """The trainer's parameter dict (parallel.distributed.PARAM_FIELDS) of a
    packed scene (the cube's 20 component fields), on its device."""
    import torch

    def cols(*keys):
        return torch.stack([packed[k] for k in keys], -1)
    return dict(position4=cols("px", "py", "pz", "pt"),
                quat=cols("qw", "qx", "qy", "qz"),
                scale3=cols("sx", "sy", "sz"),
                lifetime=packed["lifetime"].clone(),
                fade=packed["fade"].clone(),
                velocity=cols("vx", "vy", "vz"),
                color=cols("cr", "cg", "cb", "ca"))


def cube_trainer_params(n, seed, dev):
    """The bench's cube scene of n splats, Morton-ordered, in the trainer's
    layout on `dev` (made on the card's generator when dev is the card)."""
    from fourdgs_torch.scenes.cube import build_cube_scene
    from fourdgs_torch.splats.packed import morton_order
    return trainer_params(morton_order(build_cube_scene(n, seed=seed,
                                                        device=dev)))


@contextlib.contextmanager
def handed_draws(draws):
    """Densify's normal draws are `draws` (made once on the CPU), moved to
    the device of the call: one set of draws for the card and the CPU."""
    from fourdgs_torch.train import densify as D
    orig = D.normal_draws
    D.normal_draws = lambda gen, shape, like: draws.to(like.device)
    try:
        yield
    finally:
        D.normal_draws = orig


# (t1): a split child's position on card and CPU, relative to the largest
# position: the offset (~10 at the cube's scales, positions up to ~200)
# rounds differently through torch.rsqrt, a few ulp of the offset.
SPLIT_POS_RTOL = 1e-6


def phase_densify_devices(dev):
    """(t1): densify_step and reset_opt_slots on the card against the CPU,
    from one state (the 20K cube in the trainer's layout, every seventh
    splat below the prune alpha, accumulated gradient norms made from a
    seed, 3 steps) with one set of draws: `changed`, the counts and every
    parameter bit-equal (a split child's position within SPLIT_POS_RTOL:
    its offset goes through torch.rsqrt); Adam's moments after reset_opt_slots
    bit-equal and the step count kept. densify_step timed on the card."""
    import torch
    from fourdgs_torch.train import densify as D

    n = N_SMALL
    gen = torch.Generator().manual_seed(21)
    base = cube_trainer_params(n, 1, "cpu")
    base["color"][::7, 3] = 1e-3
    base["scale3"][::3] *= 0.25         # below the split scale: clones
    acc = torch.rand(n, generator=gen) * 4e-5 * (
        torch.rand(n, generator=gen) < 0.1)
    draws = torch.randn((n, 3), generator=gen)
    out = {}
    for d in ("cpu", dev):
        p = {k: v.clone().to(d) for k, v in base.items()}
        state = D.DensifyState(acc.to(d), torch.tensor(3, dtype=torch.int32,
                                                       device=d))
        with handed_draws(draws):
            p, new_state, info = D.densify_step(p, state, None)
        leaves = {k: torch.zeros_like(v, requires_grad=True)
                  for k, v in p.items()}
        opt = torch.optim.Adam(list(leaves.values()), lr=1e-2)
        g2 = torch.Generator().manual_seed(22)
        for k, v in leaves.items():
            opt.state[v] = {
                "step": torch.tensor(2.0),
                "exp_avg": torch.randn(v.shape, generator=g2).to(d),
                "exp_avg_sq": torch.rand(v.shape, generator=g2).to(d)}
        D.reset_opt_slots(opt, info["changed"], n)
        out[str(d)] = (p, info, {k: opt.state[v] for k, v in leaves.items()})
    (p_c, i_c, s_c), (p_g, i_g, s_g) = out["cpu"], out[str(dev)]
    counts = {k: int(i_c[k]) for k in ("n_pruned", "n_placed", "n_split",
                                       "n_cloned")}
    check(counts == {k: int(i_g[k]) for k in counts},
          f"(t1) densify counts differ: card {i_g}, CPU {counts}")
    check(torch.equal(i_g["changed"].cpu(), i_c["changed"]),
          "(t1) densify `changed` differs between card and CPU")
    check(counts["n_split"] > 0 and counts["n_cloned"] > 0
          and counts["n_pruned"] > counts["n_placed"] > 0,
          f"(t1) the state does not exercise every branch: {counts}")
    # A split child's offset is the draw turned by the parent's rotation,
    # normalized with torch.rsqrt, which CUDA's rsqrtf (within 2 ulp) and
    # the CPU's 1 / sqrt round differently: those rows may differ by a few
    # ulp of the offset, held against the largest position.
    changed = i_c["changed"]
    split_rows, split_rel = 0, 0.0
    for k in p_c:
        g = p_g[k].cpu()
        if k == "position4" and not torch.equal(g, p_c[k]):
            rows = (g != p_c[k]).any(dim=1)
            split_rows = int(rows.sum())
            split_rel = float((g - p_c[k]).abs().max()
                              / p_c[k].abs().max())
            check(not bool((rows & ~changed).any()),
                  f"(t1) densified position4 differs outside `changed`")
            check(split_rel <= SPLIT_POS_RTOL,
                  f"(t1) densified position4: {split_rows} rows differ by up "
                  f"to {split_rel:.3e} of the largest position")
        else:
            check(torch.equal(g, p_c[k]), f"(t1) densified {k} is not "
                  f"bit-equal on card and CPU (max |d| "
                  f"{float((g - p_c[k]).abs().max()):.3e})")
        for name in ("exp_avg", "exp_avg_sq"):
            check(torch.equal(s_g[k][name].cpu(), s_c[k][name]),
                  f"(t1) reset {name} of {k} differs between card and CPU")
        check(float(s_g[k]["step"]) == 2.0, "(t1) reset changed the step")
    equal = ("every parameter bit-equal" if not split_rows else
             f"every parameter bit-equal but position4 at {split_rows:,} "
             f"refilled slots, within {split_rel:.2e} of the largest "
             f"position")

    p = {k: v.clone().to(dev) for k, v in base.items()}
    state = D.DensifyState(acc.to(dev), torch.tensor(3, dtype=torch.int32,
                                                     device=dev))
    with handed_draws(draws):
        ms = cuda_ms(lambda: D.densify_step(
            {k: v.clone() for k, v in p.items()}, state, None), reps=10)
    print(f"(t1) densify_step + reset_opt_slots, {n:,} slots: counts "
          f"{json.dumps(counts)}, `changed` ({int(i_c['changed'].sum()):,} "
          f"slots), {equal}, Adam's reset moments bit-equal on card and "
          f"CPU; densify_step on the card {ms:.3f} ms (with a copy of the "
          f"parameters)")


# Card against CPU, a fit's loss at each step: the frames of one step agree
# within the tie tolerance (mean |d| < 1e-4, PERF.md section 2), which moves
# an L2 loss of ~1e-2 by ~1e-6 relative; Adam turns the sign of a gradient
# that rounding decides (tied pairs, edge pixels) into a full step of the
# learning rate at that entry, so later steps drift further.
FIT_LOSS_RTOL = 1e-3
FIT_TIMES = (T_GRAD, 0.8)


def _fit_cfgs(n, w, h):
    """The fit phases' configs: the viewer's pallas config and a converged
    config of the scene's size."""
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.render.autoconfig import auto_render_config
    return (("viewer pallas 8x128", TP.RenderConfig(**EXACT_CFGS[1][1])),
            ("converged", auto_render_config(n, w, h, converged=True)))


def _targets(params, cam, cfg, times):
    import torch
    from fourdgs_torch.parallel.distributed import materialize_splats
    from fourdgs_torch.render import pipeline as TP
    with torch.no_grad():
        s = materialize_splats(params)
        return [(TP.render_splats4d(s, cam, torch.tensor(
            t, device=cam.device), cfg=cfg), t) for t in times]


def phase_fit_devices(dev, kernels):
    """(t2): trainer.fit, 3 steps (lr 5e-3, frames at t = 0.37 and 0.8
    toward the seed-1 scene, rendered on the CPU), of the 20K cube at
    512x256 on the card and on the CPU, under the viewer's pallas config
    and a converged config: losses step by step within FIT_LOSS_RTOL,
    parameters finite; each kernel's launches per step."""
    import torch
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.scenes.cube import CUBE_CAMERA
    from fourdgs_torch.train import trainer as TR

    steps = 3
    params = cube_trainer_params(N_SMALL, 0, "cpu")
    cams = {d: Camera.create(**CUBE_CAMERA, width=W_SMALL, height=H_SMALL,
                             device=d) for d in ("cpu", dev)}
    launches = {}
    for label, cfg in _fit_cfgs(N_SMALL, W_SMALL, H_SMALL):
        tag = f"(t2) {label}"
        frames = _targets(cube_trainer_params(N_SMALL, 1, "cpu"),
                          cams["cpu"], cfg, FIT_TIMES)
        res = {}
        for d in ("cpu", dev):
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            res[str(d)] = TR.fit({k: v.to(d) for k, v in params.items()},
                                 [(img.to(d), t) for img, t in frames],
                                 cams[d], steps=steps, learning_rate=5e-3,
                                 cfg=cfg)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if d is dev:
                total = {name: k.launches for name, k in kernels.items()}
                check(all(v % steps == 0 for v in total.values()),
                      f"{tag}: launches {total} differ between steps")
                launches[label] = {name: v // steps
                                   for name, v in total.items() if v}
            for v in res[str(d)].params.values():
                check(bool(torch.isfinite(v).all()),
                      f"{tag} on {d}: a parameter is not finite")
            print(f"{tag} on {d}: {steps} steps in {secs:.2f} s, losses "
                  f"{', '.join(f'{x:.6f}' for x in res[str(d)].losses)}")
        got, want = res[str(dev)].losses, res["cpu"].losses
        rel = max(abs(a - b) / b for a, b in zip(got, want))
        check(rel <= FIT_LOSS_RTOL, f"{tag}: card losses {got} against CPU "
              f"{want}: {rel:.3e} relative > {FIT_LOSS_RTOL:g}")
        check(want[-1] < want[0], f"{tag}: the loss did not fall: {want}")
        print(f"{tag}: {N_SMALL:,} splats {W_SMALL}x{H_SMALL}, card against "
              f"CPU losses within {rel:.3e} relative (tolerance "
              f"{FIT_LOSS_RTOL:g}); launches per fit step "
              f"{json.dumps(launches[label])}")
    return launches


FIT_N, FIT_CAPACITY, FIT_STEPS, FIT_EVERY = 1_000_000, 1 << 20, 9, 3
FIT_FULL_TIMES = (0.0, T_GRAD)


def _fit_step_targets():
    """Every kernel wrapper of a converged fit step (capture_calls)."""
    from fourdgs_torch.ops import composite_cuda, pack_cuda, tail_cuda
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.render import tiles as TT
    return [(TT, "sample_blocks"), (TT, "rowsort_compact"),
            (TP, "composite_records"), (TP, "sample_blocks"),
            (pack_cuda, "pack_record_fields"), (pack_cuda, "pack_meta_rows"),
            (tail_cuda, "tail_prepass"), (tail_cuda, "tail_accumulate"),
            (composite_cuda, "composite_records_bwd"),
            (tail_cuda, "tail_accumulate_bwd")]


def _converged_kernels(tag, cap, n_k3):
    """K1-K7 at one converged frame's captured inputs against plain; K3 at
    its n_k3 call sites (the depth prune samples its keys with K3 only
    from 2.2M pair slots on, tiles.depth_prune_cutkeys)."""
    res = {
        "K3 sample_blocks": phase_sample_blocks(
            tag, cap.get("tiles.sample_blocks", [])
            + cap["pipeline.sample_blocks"], n_k3),
        "K2 rowsort_compact": phase_rowsort(
            tag, cap["tiles.rowsort_compact"], also_no_cut=False),
        "K1 composite": phase_composite(tag,
                                        cap["pipeline.composite_records"]),
    }
    res.update(phase_converged_kernels(cap, tag))
    return res


def phase_fit_full(dev, kernels):
    """(t3): the full-width fit. The bench's cube at 1,000,000 splats,
    Morton-ordered, in the trainer's layout, padded with densify.pad_params
    to 1,048,576 slots (512 chunks of 2048), the bench camera at 1920x1088
    under auto_render_config(1_048_576, 1920, 1088); targets the seed-1
    scene at t = 0 and 0.37. One captured fit step: K1-K9 against their
    plain versions at its inputs. Then 9 steps, lr 5e-3, densify every 3
    (events after steps 3 and 6; opt_reset "slots"), a MetricsLogger in
    chiprun_out/: launches per step, the median step time of steps with no
    event and each event's time (from the logger's wall clock), peak
    memory, losses and parameters finite, the densify counts; the counters
    0 on one frame of the config; a checkpoint saved and loaded on the
    card, bit-equal. Returns (results, launches)."""
    import os

    import torch
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.parallel.distributed import materialize_splats
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.scenes.cube import CUBE_CAMERA
    from fourdgs_torch.train import densify as D
    from fourdgs_torch.train import trainer as TR

    tag = "(t3)"
    t0 = time.time()
    params = D.pad_params(cube_trainer_params(FIT_N, 0, dev), FIT_CAPACITY)
    cam = Camera.create(**CUBE_CAMERA, width=W_FULL, height=H_FULL,
                        device=dev)
    cfg = auto_render_config(FIT_CAPACITY, W_FULL, H_FULL, converged=True)
    frames = _targets(cube_trainer_params(FIT_N, 1, dev), cam, cfg,
                      FIT_FULL_TIMES)
    with torch.no_grad():
        img, aux = TP.render_splats4d(materialize_splats(params), cam,
                                      torch.tensor(0.0, device=dev), cfg=cfg,
                                      return_aux=True)
    aux = {k: float(v) for k, v in aux.items()}
    check(all(aux[k] == 0 for k in ("overflowed", "compact_dropped",
                                    "resid_transmittance")),
          f"{tag} one frame of the config lost pairs: {aux}")
    mean_rgb = float(img[..., :3].mean())
    check(0.01 < mean_rgb < 1.0, f"{tag} frame mean rgb {mean_rgb}")
    del img
    torch.cuda.synchronize()
    print(f"{tag} {FIT_N:,} splats padded to {FIT_CAPACITY:,} slots, "
          f"{W_FULL}x{H_FULL}, targets at t={FIT_FULL_TIMES}: scene and "
          f"targets {time.time() - t0:.1f} s; one frame of the config: aux "
          f"{json.dumps(aux)}, mean rgb {mean_rgb:.4f}")

    cap = capture_calls(lambda: TR.fit(params, frames, cam, steps=1,
                                       learning_rate=5e-3, cfg=cfg),
                        _fit_step_targets())
    path = f"fit step, converged, {FIT_CAPACITY:,} slots, {W_FULL}x{H_FULL}"
    results = {path: _converged_kernels(f"{tag} fit step", cap, 2)}
    results[path].update(phase_backward_kernels(
        f"{tag} fit step", cap["composite_cuda.composite_records_bwd"],
        cap["tail_cuda.tail_accumulate_bwd"]))
    del cap
    gc.collect()
    torch.cuda.empty_cache()

    os.makedirs("chiprun_out", exist_ok=True)
    log_path = os.path.join("chiprun_out", "fit_1m_metrics.jsonl")
    if os.path.exists(log_path):
        os.remove(log_path)
    metrics = TR.MetricsLogger(log_path)
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev) / 2 ** 30
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = TR.fit(params, frames, cam, steps=FIT_STEPS, learning_rate=5e-3,
                 cfg=cfg, densify_cfg=D.DensifyConfig(opt_reset="slots"),
                 densify_every=FIT_EVERY, densify_until=1.0, seed=0,
                 metrics=metrics)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    metrics.close()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    total = {name: k.launches for name, k in kernels.items()}
    check(all(v % FIT_STEPS == 0 for v in total.values()),
          f"{tag} launches {total} differ between steps")
    launches = {path: {name: v // FIT_STEPS for name, v in total.items()}}
    check(all(launches[path][name] > 0 for name in (
        "K1 composite", "K2 rowsort_compact", "K3 sample_blocks",
        "K4 pack_record_fields", "K5 pack_meta_rows", "K6 tail_prepass",
        "K7 tail_accumulate", "K8 composite_bwd", "K9 tail_accumulate_bwd")),
          f"{tag} a kernel of the fit step never launched: {total}")
    check(all(x == x and abs(x) != float("inf") for x in res.losses),
          f"{tag} a loss is not finite: {res.losses}")
    for k, v in res.params.items():
        check(bool(torch.isfinite(v).all()), f"{tag} {k} is not finite")

    with open(log_path) as f:
        lines = [json.loads(line) for line in f]
    steps = [r for r in lines if r["event"] == "train_step"]
    events = [r for r in lines if r["event"] == "densify"]
    check(len(steps) == FIT_STEPS and [e["step"] for e in events] == [
        FIT_EVERY - 1, 2 * FIT_EVERY - 1], f"{tag} logged {lines}")
    check(events[0]["n_pruned"] >= FIT_CAPACITY - FIT_N,
          f"{tag} the {FIT_CAPACITY - FIT_N:,} dead slots were not freed: "
          f"{events}")
    event_at = {e["step"]: e for e in events}
    plain_steps, event_ms = [], []
    for i in range(1, FIT_STEPS):
        dt = (steps[i]["wall_s"] - steps[i - 1]["wall_s"]) * 1e3
        if i - 1 in event_at:       # step i follows an event
            ev = event_at[i - 1]
            event_ms.append((ev["wall_s"] - steps[i - 1]["wall_s"]) * 1e3)
            continue
        plain_steps.append(dt)
    med = statistics.median(plain_steps)
    print(f"{tag} fit: {FIT_STEPS} steps in {secs:.2f} s; losses "
          f"{', '.join(f'{x:.6f}' for x in res.losses)}; densify events "
          + "; ".join(f"after step {int(e['step']) + 1}: pruned "
                      f"{int(e['n_pruned']):,}, placed {int(e['n_placed']):,}"
                      f", split {int(e['n_split']):,}" for e in events)
          + f"; median step time (steps with no event, logger wall clock, "
          f"1 ms resolution) {med:.0f} ms over {len(plain_steps)} "
          f"[{', '.join(f'{x:.0f}' for x in plain_steps)}]; event times "
          f"(accumulate, densify_step, reset_opt_slots, the counts' host "
          f"read) {', '.join(f'{x:.0f}' for x in event_ms)} ms; peak memory "
          f"{peak:.2f} GiB ({before:.2f} GiB allocated before the fit); "
          f"launches per step {json.dumps(launches[path])}; "
          f"metrics in {log_path}")

    # Where the peak comes from: one frame without and with autograd, and
    # the step's backward.
    loss_fn = TR.make_loss_fn(cam, cfg)
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in res.params.items()}
    peaks = {}
    for label in ("frame, no grad", "frame with autograd", "step",
                  "densify event"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base_mem = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        if label == "densify event":
            gen = torch.Generator(device=dev).manual_seed(0)
            loss = D.densify_step(p, D.init_state(FIT_CAPACITY, device=dev),
                                  gen)
        elif label == "frame, no grad":
            with torch.no_grad():
                loss = loss_fn(p, frames[0][0], torch.tensor(0.0, device=dev))
        else:
            loss = loss_fn(p, frames[0][0], torch.tensor(0.0, device=dev))
            if label == "step":
                loss.backward()
        torch.cuda.synchronize()
        peaks[label] = (torch.cuda.max_memory_allocated(dev)
                        - base_mem) / 2 ** 30
        del loss
    print(f"{tag} peak memory above the parameters: " + ", ".join(
        f"{k} {v:.2f} GiB" for k, v in peaks.items()))
    del p

    ckpt = os.path.join("chiprun_out", "fit_1m_ckpt")
    TR.save_checkpoint(ckpt, res.params, step=FIT_STEPS)
    back = TR.load_checkpoint(ckpt, device=dev)
    check(set(back) == set(res.params) and all(
        back[k].device == res.params[k].device
        and torch.equal(back[k], res.params[k]) for k in back),
          f"{tag} the checkpoint did not load back bit-equal")
    size = os.path.getsize(ckpt + ".npz")
    os.remove(ckpt + ".npz")
    print(f"{tag} checkpoint ({size / 2 ** 20:.1f} MiB npz) saved and loaded "
          f"on the card, bit-equal")
    return results, launches


def phase_fit_example():
    """(t4): fourdgs_torch.examples.fit_motion, 300 steps on the card: its
    printed lines, and the last loss below the first."""
    from fourdgs_torch.examples import fit_motion
    res = fit_motion.main(["--steps", "300", "--out",
                           "chiprun_out/fit_motion"])
    check(res.losses[-1] < res.losses[0], f"(t4) fit_motion: the loss did "
          f"not fall: {res.losses[0]} -> {res.losses[-1]}")
    print(f"(t4) fit_motion: loss {res.losses[0]:.5f} -> "
          f"{res.losses[-1]:.5f} over 300 steps on the card")


# ---------------------------------------------------------------------------
# The viewer path: viewer.cli.main (phase (u))
# ---------------------------------------------------------------------------

VIEWER_OUT = "chiprun_out/viewer"
VIEWER_BASE = ["--scene", "linear"]
VIEWER_BACKENDS = (("xla", ["--backend", "xla"]),
                   ("pallas", ["--backend", "pallas"]),
                   ("dense", ["--backend", "dense"]),
                   ("converged", ["--converged"]))
VIEWER_SCENE_SIZE = 256


def run_viewer(args, kernels, targets=()):
    """viewer.cli.main(args) on the card with every kernel count 0 just
    before and read just after, its printed lines captured, and each image
    it writes recorded as a float array before it becomes a PNG. With
    `targets`, every call of those wrappers is captured (capture_calls).
    Returns (lines, images, launches, captured)."""
    import io

    import numpy as np
    from fourdgs_torch.io import png
    from fourdgs_torch.viewer import cli

    images = []
    write_png = png.write_png

    def record(path, img):
        images.append((path, np.array(img)))
        write_png(path, img)
    out = io.StringIO()
    png.write_png = record
    captured = {}
    for k in kernels.values():
        k.launches = 0
    try:
        with contextlib.redirect_stdout(out):
            if targets:
                captured = capture_calls(
                    lambda: check(cli.main(args) == 0, f"(u) {args} failed"),
                    targets)
            else:
                check(cli.main(args) == 0, f"(u) {args} failed")
    finally:
        png.write_png = write_png
    import torch
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items() if k.launches}
    for path, img in images:
        check(np.isfinite(img).all(), f"(u) {path}: not finite")
        check(os.path.exists(path), f"(u) {path} was not written")
    return out.getvalue().splitlines(), images, launches, captured


def phase_viewer(dev, kernels):
    """(u): viewer.cli.main on the card on the `linear` scene (182,400
    splats) at 800x800: --backend xla, pallas, dense and --converged (each
    run twice, the second timed by the CLI's own clock; K1 at the pallas
    frame's and K1-K7 at the converged frame's captured inputs against
    plain), --grid --axis, a 4-frame --sweep; every image finite and
    written as a PNG. The converged frame lit, its counters 0 (the same
    config rendered once with return_aux=True), its mean and p99 |d|
    against the dense frame. Then every scene of SCENES once at 256x256
    (xla; `empty`, whose 0 splats the tiled path cannot bin, here as in the
    reference, with the dense backend and the grid and axis). Returns
    (results, launches)."""
    import numpy as np
    import torch
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.scenes import scenes as TSC
    from fourdgs_torch.viewer import cli

    os.makedirs(VIEWER_OUT, exist_ok=True)
    base = list(VIEWER_BASE)
    results, launches, frames = {}, {}, {}
    for label, flags in VIEWER_BACKENDS:
        args = base + flags + ["--out", f"{VIEWER_OUT}/linear_{label}.png"]
        targets = ()
        if label == "pallas":
            targets = [(TP, "composite_records")]
        elif label == "converged":
            # 1.46M pair slots: the depth prune samples without K3.
            targets = [t for t in _fit_step_targets()[:8]
                       if t[1] != "sample_blocks" or t[0] is TP]
        _, images, first, cap = run_viewer(args, kernels, targets)
        lines, images, lau, _ = run_viewer(args, kernels)
        check(lau == first, f"(u) {label}: launches {lau}, first run {first}")
        want = {"xla": {}, "dense": {}, "pallas": {"K1 composite": 1}}.get(
            label)
        check(want is None or lau == want, f"(u) {label}: launches {lau}")
        check(want is not None or all(lau.get(n, 0) > 0 for n in (
            "K1 composite", "K2 rowsort_compact", "K3 sample_blocks",
            "K4 pack_record_fields", "K5 pack_meta_rows", "K6 tail_prepass",
            "K7 tail_accumulate")), f"(u) {label}: launches {lau}")
        path = f"viewer --backend {label}, linear 800x800" if label != \
            "converged" else "viewer --converged, linear 800x800"
        launches[path] = {n: lau.get(n, 0) for n in kernels}
        frames[label] = images[0][1]
        secs = lines[-1].split()[-4]
        print(f"(u) {label}: {lines[-1]}; frame {secs} by the CLI's clock "
              f"(second run); launches per frame {json.dumps(lau)}")
        if label == "pallas":
            results[path] = {"K1 composite": phase_composite(
                "(u) pallas", cap["pipeline.composite_records"])}
        elif label == "converged":
            results[path] = _converged_kernels("(u) converged", cap, 1)
        del cap
        torch.cuda.empty_cache()

    conv, dense = frames["converged"], frames["dense"]
    check(conv[..., :3].mean() > 1e-3, f"(u) the converged frame is black")
    d = np.abs(conv - dense)
    splats, st = TSC.linear_motion(device=dev)
    args = cli.build_argparser().parse_args(base + ["--converged"])
    cam = Camera.create(position=st.camera_position,
                        orientation=st.camera_orientation, width=args.width,
                        height=args.height, device=dev)
    cfg = cli.viewer_config(args, (0.0, 0.0, 0.0, 1.0))
    with torch.no_grad():
        _, aux = TP.render_splats4d(splats, cam, torch.tensor(0.0, device=dev),
                                    cfg=cfg, return_aux=True)
    aux = {k: float(v) for k, v in aux.items()}
    check(all(aux[k] == 0 for k in ("overflowed", "compact_dropped",
                                    "resid_transmittance")),
          f"(u) the converged frame lost pairs: {aux}")
    print(f"(u) converged frame: mean rgb {conv[..., :3].mean():.5f}, "
          f"{(conv[..., :3].max(-1) > 0.01).mean():.4f} of pixels above 0.01;"
          f" against the dense frame mean |d| {d.mean():.3e}, p99 |d| "
          f"{np.quantile(d, 0.99):.3e}, max |d| {d.max():.3e} (no limit); "
          f"aux {json.dumps(aux)}")
    del splats

    for label, extra in (("grid axis", ["--grid", "--axis"]),
                         ("sweep", ["--sweep", "0:30:4"])):
        out = f"{VIEWER_OUT}/linear_{label.replace(' ', '_')}"
        lines, images, lau, _ = run_viewer(
            base + extra + ["--out", out + ("" if label == "sweep" else
                                            ".png")], kernels)
        check(len(images) == (4 if label == "sweep" else 1),
              f"(u) {label}: {len(images)} images")
        print(f"(u) {label} (xla): " + "; ".join(lines))

    size = ["--width", str(VIEWER_SCENE_SIZE), "--height",
            str(VIEWER_SCENE_SIZE)]
    lines = []
    for name in TSC.SCENES:
        flags = (["--backend", "dense", "--grid", "--axis"] if name == "empty"
                 else ["--backend", "xla"])
        out, images, _, _ = run_viewer(
            ["--scene", name] + flags + size
            + ["--out", f"{VIEWER_OUT}/scene_{name}.png"], kernels)
        lines.append(f"{name} {out[-1].split('  ')[-1]}")
    print(f"(u) every scene at {VIEWER_SCENE_SIZE}x{VIEWER_SCENE_SIZE}: "
          + "; ".join(lines))
    return results, launches


# ---------------------------------------------------------------------------
# (v): the within-band weighting, K2's alternating rows and the sharded layer
# ---------------------------------------------------------------------------

BETA = 8.0               # the reference's multichip gate's tail_depth_beta
# The sharded configurations of (v3)-(v5): the viewer's pallas config
# through the all_gather exchange; the quantized non-converged head through
# the all_to_all exchange (no prune, no compaction: the exchange has
# neither); the converged config at tail_depth_beta = 8. A budget of 16
# tiles a splat holds every splat of the cube (the single-chip path's big
# tier takes spans of 5-16 there; the exchange has no big tier).
SHARD_N = 1_000_000
SHARD_BUDGET = 16


def shard_cfgs(n, w, h):
    import dataclasses

    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.render.pipeline import RenderConfig
    return {
        "allgather": ("allgather", RenderConfig(tile_h=8, tile_w=128,
                                                backend="pallas")),
        "alltoall": ("alltoall", RenderConfig(
            tile_h=16, tile_w=128, backend="pallas", max_splats_per_tile=384,
            max_tiles_per_splat=SHARD_BUDGET, splat_chunk=128,
            quantized_depth_sort=True, deepening_passes=6,
            deepening_fraction=0.34)),
        "converged": ("alltoall", dataclasses.replace(
            auto_render_config(n, w, h), max_tiles_per_splat=SHARD_BUDGET,
            big_splat_budget=0, tail_depth_beta=BETA)),
    }


def k7_outside(got, want):
    """Entries of a K7 accumulator outside K7's tolerance of `want`, each
    held to its own magnitude (the weighted planes span e^0..e^25)."""
    return (got - want).abs() > K7_ATOL + K7_RTOL * want.abs()


def phase_weighted_tail(tag, calls_fwd, calls_bwd):
    """K7 at the weighted frame's two streams and K9 at its grad step's,
    against their plain versions (K7's and K9's tolerances, every entry
    against its own magnitude); K7's L plane (unweighted by design) within
    K7's tolerance of the unweighted K7's at the same inputs, and its
    A..A2 planes changed by the weights."""
    import torch
    import torch.nn.functional as F
    from fourdgs_torch.ops import tail_cuda as TL
    results, lines, sites = {}, [], []
    check(len(calls_fwd) == 2, f"{tag} K7: {len(calls_fwd)} calls, want 2")
    for label, (args, kw) in zip(("main", "big"), calls_fwd):
        fields, meta, band, rect, cut, params_row = args
        check(kw.get("wd_ab") is not None, f"{tag} K7 {label}: no weights")
        npts = meta.shape[1]
        fields_p = F.pad(fields, (0, npts - fields.shape[1]))
        st = {k: kw[k] for k in ("k_bands", "nx", "ny", "chunk", "budget",
                                 "s_cy", "s_cx", "exact_clip")}
        st["budget_lo"] = kw.get("budget_lo", 0)

        def k7():
            return TL.tail_accumulate(*args, **kw)

        def k7_plain():
            return TL.tail_accumulate_plain(fields_p, meta, band, cut,
                                            params_row, **st,
                                            **weighting_kw(kw))
        got, want = k7(), k7_plain()
        unw = TL.tail_accumulate(*args, **dict(kw, wd_ab=None, alpha_pow=0))
        torch.cuda.synchronize()
        n_samp = st["s_cy"] * st["s_cx"]
        planes = got.reshape(got.shape[0], TL.N_PLANES, n_samp)
        planes_u = unw.reshape(unw.shape[0], TL.N_PLANES, n_samp)
        for what, g, w in (("weighted vs plain", got, want),
                           ("L plane vs unweighted K7", planes[:, 5],
                            planes_u[:, 5])):
            bad = k7_outside(g, w)
            check(not bool(bad.any()), f"{tag} K7 {label} {what}: "
                  f"{int(bad.sum())} entries outside {K7_RTOL:g} rel + "
                  f"{K7_ATOL:g}, max |d| {float((g - w).abs().max()):.3e}")
        check(label == "big" or float((planes[:, :5] - planes_u[:, :5])
                                      .abs().max()) > 0,
              f"{tag} K7 {label}: the weights changed no A..A2 plane")
        err = float((got - want).abs().max())
        ms = cuda_ms(k7, tail_reps(npts))
        unw_ms = cuda_ms(lambda: TL.tail_accumulate(
            *args, **dict(kw, wd_ab=None, alpha_pow=0)), tail_reps(npts))
        plain_ms = cuda_ms(k7_plain, 2, warmup=1)
        where = f"{label}: {npts:,} splats, chunk {st['chunk']}"
        sites.append(dict(site(
            where, err, ms, plain_ms,
            nbytes(fields, meta, band, rect, cut, params_row,
                   kw.get("slot_mask"), kw.get("wd_ab"), got),
            tail_slots(meta, st["budget_lo"], st["budget"])
            * st["s_cy"] * st["s_cx"] * PAIR_TEST_OPS), unweighted_ms=unw_ms))
        lines.append(f"{where}: max |d| {err:.3e} (|acc| max "
                     f"{float(want.abs().max()):.3e}); kernel {ms:.3f} ms, "
                     f"unweighted {unw_ms:.3f} ms, plain {plain_ms:.3f} ms")
    results["K7 tail_accumulate"] = _sites(sites)
    print(f"{tag} K7 tail_accumulate at tail_depth_beta {BETA:g} (every "
          f"entry within {K7_RTOL:g} rel + {K7_ATOL:g} of plain; the L plane "
          f"within it of the unweighted K7's): " + "; ".join(lines))
    sites, lines = [], []
    for (args, kw) in calls_bwd:
        fields, meta, band, cut, params_row, d_acc, mask = args
        label = "big" if kw["budget_lo"] > 0 else "main"
        st = {k: kw[k] for k in ("k_bands", "nx", "ny", "chunk", "budget",
                                 "s_cy", "s_cx", "budget_lo", "exact_clip")}

        def k9():
            return TL.tail_accumulate_bwd(*args, **kw)

        def k9_plain():
            return TL.tail_accumulate_bwd_plain(
                fields, meta, band, cut, params_row, d_acc, **st,
                **weighting_kw(kw))
        got, again, want = k9(), k9(), k9_plain()
        torch.cuda.synchronize()
        check(label == "big" or float(want.abs().max()) > 0,
              f"{tag} K9 {label}: no cotangent")
        if float(want.abs().max()) > 0:
            rel, err = _field_err(got, want, 0)
        else:
            rel = err = float(got.abs().max())
        check(rel <= BWD_TOL, f"{tag} K9 {label}: {rel:.3e} of a field's "
              f"max |d| > {BWD_TOL:g}")
        check(torch.equal(got, again), f"{tag} K9 {label}: a second launch "
              f"differs from the first")
        ms = cuda_ms(k9, tail_reps(meta.shape[1]))
        plain_ms = cuda_ms(k9_plain, 2, warmup=1)
        where = f"{label}: {meta.shape[1]:,} splats, chunk {st['chunk']}"
        sites.append(site(where, err, ms, plain_ms,
                          nbytes(fields, meta, band, cut, params_row, d_acc,
                                 mask, kw.get("wd_ab"), got),
                          tail_slots(meta, st["budget_lo"], st["budget"])
                          * st["s_cy"] * st["s_cx"] * PAIR_TEST_OPS))
        lines.append(f"{where}: {rel:.3e} of max |d| (|d| max "
                     f"{float(want.abs().max()):.3e}, max |d - plain| "
                     f"{err:.3e}, {int((got != want).sum()):,} of "
                     f"{got.numel():,} entries differ); kernel {ms:.3f} ms, "
                     f"plain {plain_ms:.3f} ms")
    results["K9 tail_accumulate_bwd"] = _sites(sites)
    print(f"{tag} K9 tail_accumulate_bwd at tail_depth_beta {BETA:g} "
          f"(tolerance {BWD_TOL:g} of each field's max |d|; two launches "
          f"bit-equal): " + "; ".join(lines))
    return results


def phase_rowsort_alternating(tag, calls, kernels):
    """K2 at the weighted frame's keys: the alternating form exactly against
    plain (keys, values, live, dropped; a second launch bit-equal); the
    alternating form
    driven once through the public rowsort_compact with every count set to
    0 just before and read just after. Returns (results, launches)."""
    import torch
    from fourdgs_torch.ops import sort_cuda as S
    (key, val, keep), kw = calls[0]
    row_len, cut, shift = kw["row_len"], kw["cut"], kw["key_shift"]
    got = S._rowsort_compact_live(key, val, keep, row_len, cut, shift,
                                  alternating=True)
    again = S._rowsort_compact_live(key, val, keep, row_len, cut, shift,
                                    alternating=True)
    pk, pv, plive = S.rowsort_compact_plain(key, val, keep, row_len, cut,
                                            shift, alternating=True)
    torch.cuda.synchronize()
    check(torch.equal(got[0], pk) and torch.equal(got[1], pv)
          and torch.equal(got[2], plive)
          and int(got[3]) == int(torch.clamp(plive - keep, min=0).sum()),
          f"{tag} K2 alternating differs from plain")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{tag} K2 alternating: a second launch differs")
    odd = got[0][:, 1::2].long()
    check(bool((odd[1:] <= odd[:-1]).all()), f"{tag} K2: odd rows not "
          f"descending")
    for k in kernels.values():
        k.launches = 0
    S.rowsort_compact(key, val, keep, row_len, cut, shift, alternating=True)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    check(launches["K2 rowsort_compact"] == 1, f"{tag} K2: "
          f"{launches['K2 rowsort_compact']} launches, want 1")
    ms = cuda_ms(lambda: S.rowsort_compact(key, val, keep, row_len, cut,
                                           shift, alternating=True), 20)
    asc_ms = cuda_ms(lambda: S.rowsort_compact(key, val, keep, row_len, cut,
                                               shift), 20)
    plain_ms = cuda_ms(lambda: S.rowsort_compact_plain(
        key, val, keep, row_len, cut, shift, alternating=True), 5)
    stages = row_len.bit_length() * (row_len.bit_length() - 1) // 2
    moved, _ = _k2_moved(key, keep, row_len, cut, shift, got[0], got[2])
    res = site(f"{key.shape[0]:,} slots, keep {keep}, cut, alternating", 0.0,
               ms, plain_ms, moved,
               got[0].shape[1] * (row_len // 2) * stages * CMPX_OPS)
    res["ascending_ms"] = asc_ms
    print(f"{tag} K2 rowsort_compact(alternating=True) at the frame's "
          f"{key.shape[0]:,} slots (row_len {row_len}, keep {keep}): keys, "
          f"values, live and dropped ({int(got[3]):,}) equal plain exactly, "
          f"odd rows descending, a second launch bit-equal; kernel "
          f"{ms:.3f} ms, "
          f"ascending {asc_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{res['bound_ms']:.3f} ms ({res['bound_by']})")
    return {"K2 rowsort_compact": _sites([res])}, launches


def phase_beta_frame(dev, params, camera, kernels, converged_frame,
                     med_default):
    """(v1), (v2): the 10M converged 1080p frame at tail_depth_beta = 8.
    K7 (both streams) and K9 at its inputs, K2's alternating form at its
    keys; 20K frames at tail_alpha_power 1 and at tail_depth_beta 8, card
    against CPU; the frame and the grad step timed."""
    import dataclasses

    import torch
    from fourdgs_torch.ops import tail_cuda
    from fourdgs_torch.render import tiles as TT
    from fourdgs_torch.render.autoconfig import auto_render_config

    cfg = dataclasses.replace(auto_render_config(N_FULL, W_FULL, H_FULL),
                              tail_depth_beta=BETA)
    t0 = time.time()
    cap = capture_kernel_inputs(params, camera, cfg,
                                [(tail_cuda, "tail_accumulate"),
                                 (TT, "rowsort_compact")])
    cap_b = capture_kernel_inputs(params, camera, cfg,
                                  [(tail_cuda, "tail_accumulate_bwd")],
                                  t=T_GRAD, grad=True)
    torch.cuda.synchronize()
    print(f"    tail_depth_beta {BETA:g} captures {time.time() - t0:.1f} s")
    path = f"converged, tail_depth_beta {BETA:g}"
    results = {path: phase_weighted_tail(
        "(v1)", cap["tail_cuda.tail_accumulate"],
        cap_b["tail_cuda.tail_accumulate_bwd"])}
    step_path = f"converged grad step, tail_depth_beta {BETA:g}"
    results[step_path] = {"K9 tail_accumulate_bwd":
                          results[path].pop("K9 tail_accumulate_bwd")}
    alt_path = "rowsort_compact(alternating=True)"
    results[alt_path], alt_launches = phase_rowsort_alternating(
        "(v2)", cap["tiles.rowsort_compact"], kernels)
    del cap, cap_b
    torch.cuda.empty_cache()
    for over in (dict(tail_alpha_power=1), dict(tail_depth_beta=BETA)):
        phase_small_frame(dev, converged=True, tag="(v1)", **over)
    torch.cuda.empty_cache()
    launches = {alt_path: alt_launches}
    launches[path], _, med, _ = phase_full_frame(
        "(v1)", params, camera, cfg, kernels, converged_frame,
        TIMED_FRAMES_CONVERGED)
    print(f"(v1) the tail_depth_beta {BETA:g} frame median {med:.2f} ms "
          f"beside phase (i)'s unweighted frame {med_default:.2f} ms in this "
          f"run")
    launches[step_path], step = phase_grad_step(
        params, camera, cfg, kernels,
        dict(converged_frame, **{"K8 composite_bwd": 1,
                                 "K9 tail_accumulate_bwd": 2}),
        TIMED_STEPS, tag="(v1)")
    torch.cuda.empty_cache()
    return results, launches, dict(frame_ms=med, **step)


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _driven(kernels, fn):
    """fn() with every launch count set to 0 just before; (its result, the
    counts just after)."""
    import torch
    for k in kernels.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: k.launches for name, k in kernels.items()}


def _shard_render(D, exchange, splats, cam, t, mesh, cfg, budget):
    if exchange == "allgather":
        return D.render_splats4d_sharded(splats, cam, t, mesh, cfg=cfg), {}
    return D.render_splats4d_sharded_alltoall(
        splats, cam, t, mesh, cfg=cfg, send_budget=budget, return_aux=True)


def _converged_bounds(tag, img_sh, img_ref, th, tw, p99_max=0.05,
                      mask=None):
    """The reference's bounds of the sharded converged frame against the
    single-chip one (tests/test_parallel.py): means, mean |d|, the per-pixel
    p99 (the reference's 0.05 unless p99_max says otherwise), seams; with an
    (H, W) mask, over its pixels and without the seams (a masked-out
    neighbour's tail reaches across the border)."""
    import torch
    d = (img_sh[..., :3] - img_ref[..., :3]).abs()
    dm = d.mean(-1)
    sel = (slice(None),) if mask is None else (mask,)
    m_sh = float(img_sh[sel][..., :3].mean())
    m_ref = float(img_ref[sel][..., :3].mean())
    p99 = float(torch.quantile(dm[sel].flatten().float()[::7], 0.99))
    seams = ""
    ok = True
    if mask is None:
        ys = torch.arange(dm.shape[0], device=dm.device)[:, None]
        xs = torch.arange(dm.shape[1], device=dm.device)[None, :]
        border = ((ys % th == 0) | (ys % th == th - 1) | (xs % tw == 0)
                  | (xs % tw == tw - 1))
        b_err, i_err = float(dm[border].mean()), float(dm[~border].mean())
        ok = b_err < 2.0 * i_err + 1e-4
        seams = f", border {b_err:.3e} vs interior {i_err:.3e}"
    mean_d = float(d[sel].mean())
    how = (f"means {m_sh:.5f} / {m_ref:.5f}, mean |d| {mean_d:.3e}, p99 "
           f"{p99:.3e} (bound {p99_max:g}){seams}")
    check(ok and abs(m_sh - m_ref) < 0.01 * max(m_ref, 0.01) + 1e-4
          and mean_d < 0.01 and p99 < p99_max,
          f"{tag} converged sharded vs single chip: {how}")
    return how


def _single_chip_parts(single, sharded):
    """(the single-chip frame single(), the (args, kwargs, result) of its
    bin_splats call, sharded() with the band cuts and depth extremes the
    single-chip frame took from its own sample in place of those of its
    2,048-entry shard sample)."""
    from fourdgs_torch.ops import tail_cuda as TL
    from fourdgs_torch.render import pipeline as TP
    orig = TL.global_band_cuts, TL.global_band_extremes, TP.bin_splats
    seen = {}

    def record(name, fn):
        def wrapped(*args, **kwargs):
            check(name not in seen, f"{name}: called twice in one frame")
            seen[name] = fn(*args, **kwargs)
            if name == "bin_splats":
                seen["bin_call"] = (args, kwargs, seen[name])
            return seen[name]
        return wrapped
    try:
        TL.global_band_cuts = record("global_band_cuts", orig[0])
        TL.global_band_extremes = record("global_band_extremes", orig[1])
        TP.bin_splats = record("bin_splats", orig[2])
        ref = single()
        check("global_band_cuts" in seen and "bin_call" in seen,
              "the single-chip frame took no band cuts or no binning")
        TP.bin_splats = orig[2]
        TL.global_band_cuts = lambda samp, k: seen["global_band_cuts"]
        TL.global_band_extremes = lambda samp: seen["global_band_extremes"]
        return ref, seen["bin_call"], sharded()
    finally:
        TL.global_band_cuts, TL.global_band_extremes, TP.bin_splats = orig


def _heads_differ(bin_call, head_cap, shape, th, tw):
    """(H, W) bool: the pixels of the tiles whose single-chip head (its
    binning: depth prune, then at most head_cap nearest) holds other pairs
    than the sharded route's (no prune: the head_cap nearest of all, the
    same tie rule), from the binning call recorded by _single_chip_parts
    rebinned with a prune that keeps every pair."""
    from fourdgs_torch.render import tiles as TT
    args, kwargs, pruned = bin_call
    whole = TT.bin_splats(*args, **dict(kwargs, depth_prune_cap=1 << 24,
                                        compact_keep_cols=0))
    check(int(whole.prune_underkeep) == 0 and int(whole.overflowed)
          == int(pruned.overflowed), "the rebinning without a prune lost "
          "pairs")
    differ = pruned.head_counts != whole.head_counts
    ny, nx = TT.tile_grid(shape[1], shape[0], th, tw)
    return (differ.reshape(ny, nx).repeat_interleave(th, 0)
            .repeat_interleave(tw, 1)[:shape[0], :shape[1]])


def phase_sharded(dev, kernels):
    """(v3)-(v5): the sharded layer at world size 1, in a process group of
    one rank (gloo for CPU tensors, NCCL for the card's) made here and
    ended after. Returns (results, launches, numbers)."""
    import torch.distributed as dist
    from fourdgs_torch.parallel.mesh import make_mesh

    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        out = _sharded_full(dev, kernels, mesh)
        _sharded_small(dev, mesh)
        return out
    finally:
        dist.destroy_process_group()


# The per-pixel p99 bound of the whole sharded converged 1M frame against
# the single-chip one: the readings of that frame on an H100 80GB HBM3 at
# 700 W (0.0598 at beta 0, 0.0607 at beta 8; PERF.md) with a third of
# headroom, in place of the reference's 0.05 for its 1,024-splat scene,
# as 6% of its pixels lie in tiles whose heads differ by design (ROADMAP
# C-R14); the other tiles are held at 0.05.
CONVERGED_P99 = 0.08


def _sharded_full(dev, kernels, mesh):
    import dataclasses

    import torch
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.ops import composite_cuda, tail_cuda
    from fourdgs_torch.parallel import distributed as D
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.scenes.cube import CUBE_CAMERA
    from fourdgs_torch.entry import dryrun_multichip

    results, launches, numbers = {}, {}, {}
    t0 = time.time()
    params = cube_trainer_params(SHARD_N, 0, dev)
    cam = Camera.create(**CUBE_CAMERA, width=W_FULL, height=H_FULL,
                        device=dev)
    cfgs = shard_cfgs(SHARD_N, W_FULL, H_FULL)
    splats = D.materialize_splats(params)
    print(f"(v3) world size 1 (one rank, gloo for CPU tensors and NCCL for "
          f"the card's), mesh {tuple(mesh.mesh.shape)}; {SHARD_N:,}-splat "
          f"cube {W_FULL}x{H_FULL}: scene {time.time() - t0:.1f} s")
    t = torch.tensor(0.0, device=dev)
    for mode, (exchange, cfg) in cfgs.items():
        tag = f"(v3) {mode}"
        budget = None
        if exchange == "alltoall":
            budget = D.required_send_budget(splats, cam, mesh, cfg, t=0.0)
        def render(c=cfg):
            return _shard_render(D, exchange, splats, cam, t, mesh, c,
                                 budget)
        with torch.no_grad():
            (img, aux), lau = _driven(kernels, render)
            want_k = {"K1 composite"}
            if mode == "converged":
                want_k |= {"K5 pack_meta_rows", "K7 tail_accumulate"}
            for name in want_k:
                check(lau[name] > 0, f"{tag}: {name} not launched")
            aux = {k: int(v) for k, v in aux.items()}
            check(aux.get("pairs_dropped", 0) == 0
                  and aux.get("overflowed", 0) == 0,
                  f"{tag}: pairs lost under the required budget: {aux}")
            ref = TP.render_splats4d(splats, cam, t, cfg=cfg)
            check(bool(torch.isfinite(img).all())
                  and float(img[..., :3].mean()) > 0.01, f"{tag}: bad image")
            if mode == "converged":
                # The routes differ by design where the single chip's depth
                # prune left a tile's head short of the head_cap nearest
                # pairs, which the sharded route (no prune, as the
                # reference's) keeps (ROADMAP C-R14). The whole frame at the
                # reference's bounds of its 1,024-splat scene, the p99 at
                # CONVERGED_P99; the pixels of the other tiles at all of
                # them. The sharded frame again with the single chip's band
                # cuts and depth extremes shows what the samples add; beta 0
                # shows the gap is not the weight's.
                parts = []
                for label, c in (
                        ("beta 0", dataclasses.replace(cfg,
                                                       tail_depth_beta=0.0)),
                        (f"beta {BETA:g}", cfg)):
                    mine = render(c)[0]
                    single, bin_call, handed = _single_chip_parts(
                        lambda c=c: TP.render_splats4d(splats, cam, t,
                                                       cfg=c),
                        lambda c=c: render(c)[0])
                    differ = _heads_differ(bin_call, c.max_splats_per_tile,
                                           single.shape, c.tile_h, c.tile_w)
                    whole = _converged_bounds(
                        f"{tag} {label}", mine, single, c.tile_h, c.tile_w,
                        CONVERGED_P99)
                    rest = _converged_bounds(
                        f"{tag} {label}, tiles of equal heads", mine,
                        single, c.tile_h, c.tile_w, mask=~differ)
                    samp = _converged_bounds(
                        f"{tag} {label}, the single chip's band cuts",
                        handed, single, c.tile_h, c.tile_w, CONVERGED_P99)
                    d_in = (mine[differ][..., :3]
                            - single[differ][..., :3]).abs().mean(-1)
                    share = float(differ.float().mean())
                    parts.append(
                        f"{label}: {whole}; the {share:.3f} of the pixels "
                        f"in tiles of other heads: mean |d| "
                        f"{float(d_in.mean()):.3e}, p99 "
                        f"{float(torch.quantile(d_in[::7].float(), 0.99)):.3e};"
                        f" the rest: {rest}; with the single chip's band "
                        f"cuts: {samp}, max |d| to the route's own "
                        f"{float((handed - mine).abs().max()):.3e}")
                how = "; ".join(parts)
            else:
                err = float((img - ref).abs().max())
                check(err <= 3e-5, f"{tag}: max |d| {err:.3e} against the "
                      f"single-chip frame > 3e-5")
                how = f"max |d| {err:.3e} (bound 3e-5)"
            targets = [(TP, "composite_records")]
            if cfg.deepening_passes > 1:
                targets.append((TP, "composite_records_at"))
            if mode == "converged":
                targets.append((tail_cuda, "tail_accumulate"))
            cap = capture_calls(render, targets)
            ms = statistics.median(cuda_ms(render, 1, 1) for _ in range(3))
        path = f"sharded {mode}, world size 1"
        res = {"K1 composite": phase_composite(
            tag, cap["pipeline.composite_records"],
            cap.get("pipeline.composite_records_at", ()))}
        if mode == "converged":
            res["K7 tail_accumulate"] = _k7_sites(
                tag, cap["tail_cuda.tail_accumulate"])
        results[path], launches[path] = res, lau
        numbers[f"{mode}_frame_ms"] = ms
        print(f"{tag}: {how} against render_splats4d at the same config; aux "
              f"{json.dumps(aux)}"
              f"{f', send budget {budget}' if budget else ''}"
              f"; frame median {ms:.2f} ms; launches {json.dumps(lau)}")
        del cap
        torch.cuda.empty_cache()

    # (v4) the three sharded train steps, then fit_sharded.
    target = torch.zeros((H_FULL, W_FULL, 4), device=dev)
    for mode, (exchange, cfg) in cfgs.items():
        tag = f"(v4) {mode}"
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        budget = None
        if exchange == "alltoall":
            budget = D.required_send_budget(splats, cam, mesh, cfg,
                                            t=T_GRAD)
        step = D.make_sharded_train_step(cam, mesh, D.adam(p, 1e-3), cfg,
                                         exchange=exchange,
                                         send_budget=budget)
        targets = [(composite_cuda, "composite_records_bwd")]
        if mode == "converged":
            targets.append((tail_cuda, "tail_accumulate_bwd"))
        cap = capture_calls(lambda: step(p, target, T_GRAD), targets)
        loss, lau = _driven(kernels, lambda: step(p, target, T_GRAD))
        check(bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(v).all()) for v in p.values()),
            f"{tag}: loss or parameters not finite")
        check(lau["K8 composite_bwd"] > 0 and (
            mode != "converged" or lau["K9 tail_accumulate_bwd"] == 1),
            f"{tag}: launches {lau}")
        path = f"sharded {mode} train step, world size 1"
        results[path] = phase_backward_kernels(
            tag, cap["composite_cuda.composite_records_bwd"],
            cap.get("tail_cuda.tail_accumulate_bwd", []))
        launches[path] = lau
        del cap
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(p, target, T_GRAD)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        numbers[f"{mode}_step_ms"] = statistics.median(times)
        numbers[f"{mode}_step_peak_gib"] = peak
        print(f"{tag}: loss {float(loss):.6f}, step median "
              f"{statistics.median(times):.2f} ms "
              f"[{', '.join(f'{x:.2f}' for x in times)}], peak memory "
              f"{peak:.2f} GiB; launches {json.dumps(lau)}")
        del p, step
        torch.cuda.empty_cache()
    exchange, cfg = cfgs["converged"]
    t0 = time.time()
    _, losses, budget = D.fit_sharded(
        params, cam, mesh, target, steps=5, t=T_GRAD, cfg=cfg,
        learning_rate=5e-3, check_every=5,
        send_budget=D.required_send_budget(splats, cam, mesh, cfg,
                                           t=T_GRAD))
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    check(len(losses) == 5 and all(x == x and abs(x) < 1e30 for x in losses),
          f"(v4) fit_sharded losses {losses}")
    numbers["fit_sharded_5_steps_s"] = fit_s
    print(f"(v4) fit_sharded, converged at tail_depth_beta {BETA:g}, 5 steps "
          f"(budget {budget}): losses {[round(x, 6) for x in losses]}, "
          f"{fit_s:.2f} s with its budget probe")
    del splats
    torch.cuda.empty_cache()
    t0 = time.time()
    dry = dryrun_multichip(1)
    check(len(dry) == 3, f"(v4) dryrun_multichip(1): {dry}")
    print(f"(v4) fourdgs_torch.entry.dryrun_multichip(1): {json.dumps(dry)} "
          f"in {time.time() - t0:.1f} s")
    return results, launches, numbers


def _k7_sites(tag, calls):
    """K7 at each of `calls` (a sharded converged frame's: my own chunks)
    against its plain version."""
    import torch
    import torch.nn.functional as F
    from fourdgs_torch.ops import tail_cuda as TL
    sites = []
    for args, kw in calls:
        fields, meta, band, rect, cut, params_row = args
        st = {k: kw[k] for k in ("k_bands", "nx", "ny", "chunk", "budget",
                                 "s_cy", "s_cx", "exact_clip")}
        st["budget_lo"] = kw.get("budget_lo", 0)
        fields_p = F.pad(fields, (0, meta.shape[1] - fields.shape[1]))

        def plain():
            return TL.tail_accumulate_plain(fields_p, meta, band, cut,
                                            params_row, **st,
                                            **weighting_kw(kw))
        got, want = TL.tail_accumulate(*args, **kw), plain()
        torch.cuda.synchronize()
        d = (got - want).abs()
        bad = k7_outside(got, want)
        # A frame's big-tier stream (budget_lo > 0) may hold no live pair.
        check(not bool(bad.any()) and (st["budget_lo"] > 0
                                       or float(want.abs().sum()) > 0),
              f"{tag} K7: {int(bad.sum())} entries outside tolerance, max "
              f"|d| {float(d.max()):.3e}, |acc| sum "
              f"{float(want.abs().sum()):.3e}")
        ms = cuda_ms(lambda: TL.tail_accumulate(*args, **kw),
                     tail_reps(meta.shape[1]))
        plain_ms = cuda_ms(plain, 2, warmup=1)
        sites.append(site(
            f"{meta.shape[1]:,} splats, chunk {st['chunk']}",
            float(d.max()), ms, plain_ms,
            nbytes(fields, meta, band, rect, cut, params_row,
                   kw.get("slot_mask"), kw.get("wd_ab"), got),
            tail_slots(meta, st["budget_lo"], st["budget"])
            * st["s_cy"] * st["s_cx"] * PAIR_TEST_OPS))
        print(f"{tag} K7 tail_accumulate ({meta.shape[1]:,} splats, "
              f"tail_depth_beta "
              f"{kw.get('wd_ab') is not None and BETA}): max |d| "
              f"{float(d.max()):.3e}; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms")
    return _sites(sites)


def _sharded_small(dev, mesh):
    """(v5): 20K frames and gradients of the three sharded modes at world
    size 1. Card against CPU: frames under the tie tolerance (mean < 1e-4,
    fewer than 1% of pixels above 1e-3), losses within 1e-5 relative, and
    the gradients of the sharded path and of the single-chip path of the
    same config under the tie rule (per field, relative to its max: fewer
    than 2% of splats above 1e-3 and a mean below 3e-4), over the splats
    whose footprint eigenvector the conditioning rule of
    fourdgs_torch.tools.eigen_condition does not name on either device (fewer
    than EIGVEC_MIN_CONDITION rounding errors in it: its float32 direction
    and gradient are noise in the reference's formula too, ROADMAP C-R15);
    the count named is printed. On the card, the non-converged modes'
    sharded loss and gradients against the single-chip ones of the same
    config, within 1e-5 and 1e-4 of each field's max (the same
    arithmetic)."""
    import torch
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.parallel import distributed as D
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.scenes.cube import CUBE_CAMERA
    from fourdgs_torch.tools.eigen_condition import (
        EIGVEC_MIN_CONDITION, footprint_inputs, ill_conditioned)

    params = cube_trainer_params(N_SMALL, 1, dev)
    params_c = {k: v.cpu() for k, v in params.items()}
    cams = {str(d): Camera.create(**CUBE_CAMERA, width=W_SMALL,
                                  height=H_SMALL, device=d)
            for d in (dev, "cpu")}
    npx = H_SMALL * W_SMALL * 3

    def grads(p0, d, fn):
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        loss = fn(p, torch.full((H_SMALL, W_SMALL, 4), 0.05, device=d))
        loss.backward()
        return float(loss.detach()), {k: v.grad.cpu() for k, v in p.items()}

    def splat_errs(got, want):
        """{field: (N,) the largest |d| of each splat over its max |g|}."""
        out = {}
        for k in want:
            scale = float(want[k].abs().max())
            check(scale > 0, f"(v5) zero gradient of {k}")
            out[k] = ((got[k] - want[k]).abs().reshape(want[k].shape[0], -1)
                      .amax(1) / scale)
        return out

    def field_errs(got, want):
        return {k: (float(e.mean()), float((e > 1e-3).float().mean()),
                    float(e.max()))
                for k, e in splat_errs(got, want).items()}

    # The conditioning rule, from each device's own projection of the
    # splats (the same for every mode: the same splats and camera).
    named = (ill_conditioned(*footprint_inputs(params, cams[str(dev)],
                                               T_GRAD)).cpu()
             | ill_conditioned(*footprint_inputs(params_c, cams["cpu"],
                                                 T_GRAD)))
    kept = ~named

    def held(tag, what, got, want):
        """The tie rule over the splats the rule does not name; returns
        {field: mean} for the printed line."""
        out = {}
        for k, e in splat_errs(got, want).items():
            share = float((e[kept] > 1e-3).float().mean())
            mean = float(e[kept].mean())
            check(share < 0.02 and mean < 3e-4, f"{tag}: {what} gradient of "
                  f"{k} card vs CPU: {share:.2e} of splats above 1e-3 of its "
                  f"max, mean {mean:.3e}, over the {int(kept.sum())} splats "
                  f"the conditioning rule keeps")
            out[k] = float(f"{mean:.3e}")
        return out
    lines = []
    for mode, (exchange, cfg) in shard_cfgs(N_SMALL, W_SMALL,
                                            H_SMALL).items():
        tag = f"(v5) {mode}"
        out = {}
        for d, p0 in ((dev, params), ("cpu", params_c)):
            d = str(d)
            with torch.no_grad():
                img, aux = _shard_render(D, exchange,
                                         D.materialize_splats(p0), cams[d],
                                         T_GRAD, mesh, cfg, None)
            loss_fn = D.make_sharded_loss(cams[d], mesh, cfg,
                                          exchange=exchange)
            out[d] = (img.cpu(), {k: int(v) for k, v in aux.items()},
                      *grads(p0, d, lambda p, tg: loss_fn(p, tg, T_GRAD)))
        (ig, ag, lg, gg), (ic, ac, lc, gc_) = out[str(dev)], out["cpu"]
        err = (ig - ic).abs().amax(-1)
        check(float(err.mean()) < 1e-4 and float((err > 1e-3).float()
                                                  .mean()) < 0.01,
              f"{tag}: frame card vs CPU mean |d| {float(err.mean()):.3e}")
        check(ag == ac, f"{tag}: aux card {ag} vs CPU {ac}")
        check(abs(lg - lc) <= 1e-5 * abs(lc), f"{tag}: loss card {lg} vs "
              f"CPU {lc}")
        def single_on(d):
            def single(p, tg):
                img = TP.render_splats4d(D.materialize_splats(p), cams[d],
                                         T_GRAD, cfg=cfg)
                return ((img[..., :3] - tg[..., :3]) ** 2).sum() / npx
            return single
        ls, gs = grads(params, dev, single_on(str(dev)))
        _, gs_c = grads(params_c, "cpu", single_on("cpu"))
        single_errs = field_errs(gs, gs_c)
        dev_errs = field_errs(gg, gc_)
        held_sh = held(tag, "sharded", gg, gc_)
        held_single = held(tag, "single-chip", gs, gs_c)
        if mode != "converged":
            # The converged routes differ by design (the head's prune,
            # the samples of the band cuts and depth extremes; C-R14):
            # their losses and gradients are not compared.
            check(abs(lg - ls) <= 1e-5 * abs(ls), f"{tag}: sharded loss "
                  f"{lg} vs single chip {ls}")
            for k, (_, _, mx) in field_errs(gg, gs).items():
                check(mx <= 1e-4, f"{tag}: gradient of {k}, sharded vs "
                      f"single chip on the card: {mx:.3e} of its max")
        lines.append(
            f"{mode}: frame mean |d| {float(err.mean()):.3e}, loss rel "
            f"{abs(lg - lc) / abs(lc):.2e}, sharded vs single-chip loss rel "
            f"{abs(lg - ls) / abs(ls):.2e}; the conditioning rule (fewer "
            f"than {EIGVEC_MIN_CONDITION} rounding errors in the footprint "
            f"eigenvector on either device) names {int(named.sum())} of "
            f"{named.numel()} splats ({torch.nonzero(named).flatten().tolist()}"
            f"); gradients card vs CPU, the mean over the rest, held below "
            f"3e-4: sharded {json.dumps(held_sh)}, single chip "
            f"{json.dumps(held_single)}; per field over all splats (mean, "
            f"share > 1e-3, max of a splat / field max): sharded "
            + json.dumps({k: [float(f"{x:.3e}") for x in v]
                          for k, v in dev_errs.items()})
            + ", single chip "
            + json.dumps({k: [float(f"{x:.3e}") for x in v]
                          for k, v in single_errs.items()}))
    print(f"(v5) {N_SMALL:,} splats {W_SMALL}x{H_SMALL} at t={T_GRAD}, "
          f"target 0.05: " + "; ".join(lines))

# ---------------------------------------------------------------------------
# (w): the on-card certification (fourdgs_torch.tools.validate_kernels)
# ---------------------------------------------------------------------------

# The converged 1M frame's error against the exact composite is held to the
# tool's gate (the reference's bounds); the 10M readings, shipped and with
# the int64 bands, are reported, as the reference reports its own.


def _merge_sites(tag, captured):
    """K11 at its one call and K12 / K13 at every launch of merge_levels'
    schedule, walked from what merge_sorted_rows handed it, each against
    its plain version: keys exact and (key, value) multisets equal within
    a block (K11, K13), keys and values exact (K12)."""
    import torch
    from fourdgs_torch.ops import sort_checks as SC
    from fourdgs_torch.ops import sort_cuda as S
    check(len(captured["sort_cuda.merge_tree"]) == 1,
          f"{tag} K11: not one call")
    t_args, _ = captured["sort_cuda.merge_tree"][0]
    t_key, t_val, c, block, _ = t_args
    gk, gv = S.merge_tree(*t_args)
    pk, pv = S.merge_tree_plain(*t_args)
    torch.cuda.synchronize()
    check(torch.equal(gk, pk) and _same_pairs(gk, gv, pk, pv, run=block),
          f"{tag} K11 merge_tree differs from plain")
    n = t_key.shape[0]
    levels = range(c.bit_length(), block.bit_length())
    res = {"K11 merge_tree": _sites([site(
        f"{n:,} pairs, rows of {c} -> runs of {block:,}", 0.0,
        cuda_ms(lambda: S.merge_tree(*t_args), 20),
        cuda_ms(lambda: S.merge_tree_plain(*t_args), 5),
        2 * nbytes(t_key, t_val), n // 2 * sum(levels) * CMPX_OPS)])}
    (key, val, lv_block), _ = captured["sort_cuda.merge_levels"][0]
    k12, k13 = [], []
    for st in S.merge_schedule(n, lv_block, S.CROSS_GROUP):
        if st[0] == "cross":
            _, d_hi, run_out, size = st
            args = (key, val, d_hi, size, run_out)
            gk, gv = S.merge_cross_stages(key.clone(), val.clone(), d_hi,
                                          size, run_out)
            pk, pv = S.merge_cross_stages_plain(*args)
            torch.cuda.synchronize()
            check(torch.equal(gk, pk) and torch.equal(gv, pv), f"{tag} K12 "
                  f"(d {d_hi}, {size} stages, run {run_out}) differs from "
                  f"plain")
            k12.append(site(f"d {d_hi:,}, {size} stages, run {run_out:,}",
                            0.0, _net_ms(S.merge_cross_stages, args, 10),
                            cuda_ms(lambda: S.merge_cross_stages_plain(
                                *args), 3),
                            2 * nbytes(key, val), n // 2 * size * CMPX_OPS))
        else:
            run_out = st[1]
            args = (key, val, run_out, lv_block)
            gk, gv = S.merge_finish(key.clone(), val.clone(), run_out,
                                    lv_block)
            pk, pv = S.merge_finish_plain(key, val, lv_block, run_out)
            torch.cuda.synchronize()
            check(torch.equal(gk, pk) and _same_pairs(gk, gv, pk, pv,
                                                      run=lv_block),
                  f"{tag} K13 (run {run_out}) differs from plain")
            k13.append(site(f"run {run_out:,}", 0.0,
                            _net_ms(S.merge_finish, args, 10),
                            cuda_ms(lambda: S.merge_finish_plain(
                                key, val, lv_block, run_out), 3),
                            2 * nbytes(key, val),
                            n // 2 * (lv_block.bit_length() - 1) * CMPX_OPS))
        key, val = gk, gv
    check(bool(SC.is_sorted(key)[0]), f"{tag} the walked schedule did not "
          f"sort")
    res["K12 merge_cross_stage"] = _sites(k12)
    res["K13 merge_finish"] = _sites(k13)
    return res


def _validate_sort(tag, captured):
    """K10 and K2 at check_sort's 4M keys, K11-K13 at its merge, each
    against its plain version."""
    import torch
    from fourdgs_torch.ops import lookup_cuda as L
    from fourdgs_torch.ops import sort_cuda as S
    (key, cut), _ = captured["lookup_cuda.apply_cutkeys"][0]
    got = L.apply_cutkeys(key, cut)
    torch.cuda.synchronize()
    check(torch.equal(got, L.apply_cutkeys_plain(key, cut)),
          f"{tag} K10 apply_cutkeys differs from plain")
    res = {"K10 apply_cutkeys": _sites([site(
        f"{key.shape[0]:,} keys, {cut.shape[0]} tiles", 0.0,
        cuda_ms(lambda: L.apply_cutkeys(key, cut), 20),
        cuda_ms(lambda: L.apply_cutkeys_plain(key, cut), 5),
        nbytes(key, cut, got), 0)])}
    (k, v, keep), kw = captured["sort_cuda.rowsort_compact"][0]
    row_len = kw["row_len"]
    ok, live, dropped = _k2_exact(f"{tag} K2", k, v, keep, row_len, None, 20)
    stages = row_len.bit_length() * (row_len.bit_length() - 1) // 2
    moved, _ = _k2_moved(k, keep, row_len, None, 20, ok, live)
    res["K2 rowsort_compact"] = _sites([site(
        f"{k.shape[0]:,} slots, keep {keep}, rows of {row_len}, no cut", 0.0,
        cuda_ms(lambda: S.rowsort_compact(k, v, keep, row_len), 20),
        cuda_ms(lambda: S.rowsort_compact_plain(k, v, keep, row_len, None,
                                                20), 5),
        moved, ok.shape[1] * (row_len // 2) * stages * CMPX_OPS)])
    res.update(_merge_sites(tag, captured))
    return res


def _validate_tail(tag, spec, dev, kernels, readings, size):
    """check_tail_parity at `spec` as one path: the exact composite and the
    shipped converged frame, driven with every launch count set to 0 just
    before; K1 at the exact composite's pass 1 and each deepening pass and
    at the converged frame's head, K2-K7 at the converged frame's inputs,
    each against its plain version. Then the same frame with the int64
    bands (the instrument of ROADMAP C-R8's cost), K7 held at the bands it
    is handed there (every other kernel's inputs are the shipped frame's).
    The readings go to readings["tail_parity_<size>"] and
    ["tail_parity_<size>_int64"]; returns (results, launches)."""
    import torch
    from fourdgs_torch.ops import tail_cuda as TL
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.render import tiles as TT
    from fourdgs_torch.tools import validate_kernels as V

    key, out = f"tail_parity_{size}", {}
    targets = [t for t in _fit_step_targets()[:8] if t[1] != "sample_blocks"]
    # K3 runs where the frame's sizes ask for it (the depth prune's sample,
    # the tail's band sample); every launch is held.
    cap, lau = _driven(kernels, lambda: capture_calls(
        lambda: readings.update({key: V.check_tail_parity(
            dev, **spec, outputs=out)}),
        targets + [(TP, "composite_records_at")],
        optional=[(TT, "sample_blocks"), (TP, "sample_blocks")]))
    cap.setdefault("pipeline.sample_blocks", [])
    check(len(cap["pipeline.composite_records_at"])
          == spec["deepening_passes"] - 1,
          f"{tag} the exact composite did not run every deepening pass")
    first = cap.pop("pipeline.composite_records")
    check(len(first) == 2, f"{tag} K1 pass 1: {len(first)} calls, want the "
          f"exact composite's and the converged frame's")
    exact = {"K1 composite": phase_composite(
        f"{tag} exact composite", first[:1],
        cap.pop("pipeline.composite_records_at"), quiet=True)}
    cap["pipeline.composite_records"] = first[1:]
    results = merge_results([exact, _converged_kernels(
        f"{tag} converged", cap, lau["K3 sample_blocks"])])
    del cap
    torch.cuda.empty_cache()
    cap = capture_calls(lambda: readings.update({
        f"{key}_int64": V.check_tail_parity(
            dev, **spec, int64_bands=True, exact=out["exact"])}),
        [(TL, "tail_accumulate")])
    del out
    _k7_sites(f"{tag} int64 bands", cap["tail_cuda.tail_accumulate"])
    return results, lau


def _short(res):
    """A check's readings, floats to four significant digits."""
    return {k: float(f"{v:.4g}") if isinstance(v, float) else v
            for k, v in res.items()}


def phase_validate(dev, kernels):
    """(w): the checks of fourdgs_torch.tools.validate_kernels on the card,
    under its gate (the reference's bounds). Each check is driven with
    every launch count set to 0 just before it, and every kernel it
    launched is then held against its plain version at the inputs it gave
    it: K1 and K8 at the record fixtures and at the pipeline check's pallas
    renders, K10 and K2 at the sort check's 4M keys and K11-K13 at its
    merge, and at the 1M and 10M tail parity K1 at the exact composite's
    pass 1 and 79 deepening passes and K1-K7 at the shipped converged
    frame (_validate_tail); then each tail parity again with the int64
    bands (the instrument of ROADMAP C-R8's cost), K7 held there. The 1M
    tail parity is gated, the 10M one and the int64 ones are reported, as
    the reference reports its 10M one. Returns (results, launches,
    readings)."""
    import torch
    from fourdgs_torch.ops import composite_cuda as C
    from fourdgs_torch.ops import lookup_cuda as L
    from fourdgs_torch.ops import sort_cuda as S
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.tools import validate_kernels as V

    t_w = time.time()
    secs, readings, results, launches = {}, {}, {}, {}
    path = "validate: record fixtures"
    parts = []
    for name, (p, seed) in zip(("records_8x128", "records_16x128"),
                               V.FIXTURES):
        cap, lau = _driven(kernels, lambda: capture_calls(
            lambda: readings.update({name: V.check_records(p, seed, dev)}),
            [(C, "composite_records"), (C, "composite_records_bwd")]))
        launches[path] = {k: launches.get(path, {}).get(k, 0) + n
                          for k, n in lau.items()}
        tag = f"(w) records P={p}"
        part = {"K1 composite": phase_composite(
            tag, cap["composite_cuda.composite_records"])}
        part.update(phase_backward_kernels(
            tag, cap["composite_cuda.composite_records_bwd"], []))
        parts.append(part)
    results[path] = merge_results(parts)
    secs["records"] = time.time() - t_w

    t0 = time.time()
    path = "validate: pipeline, 3,000 splats"
    parts = []
    for name, deep in (("pipeline_single", False),
                       ("pipeline_deepening", True)):
        cap, lau = _driven(kernels, lambda: capture_calls(
            lambda: readings.update({name: V.check_pipeline(deep, dev)}),
            [(TP, "composite_records"), (C, "composite_records_bwd")],
            optional=[(TP, "composite_records_at")]))
        launches[path] = {k: launches.get(path, {}).get(k, 0) + n
                          for k, n in lau.items()}
        # Each pallas render (the grad step's, and with deepening the
        # counters' render) runs pass 1 and its deepening passes.
        first = cap["pipeline.composite_records"]
        at = cap.get("pipeline.composite_records_at", [])
        per = len(at) // len(first)
        check(per * len(first) == len(at), f"(w) {name}: {len(at)} "
              f"deepening passes over {len(first)} renders")
        part = merge_results([{"K1 composite": phase_composite(
            f"(w) {name} render {i + 1}", first[i:i + 1],
            at[i * per:(i + 1) * per])} for i in range(len(first))])
        part.update(phase_backward_kernels(
            f"(w) {name}", cap["composite_cuda.composite_records_bwd"], []))
        parts.append(part)
    results[path] = merge_results(parts)
    del cap
    secs["pipeline"] = time.time() - t0

    t0 = time.time()
    path = "validate: sort, 4M keys"
    cap, launches[path] = _driven(kernels, lambda: capture_calls(
        lambda: readings.update(sort=V.check_sort(dev)),
        [(L, "apply_cutkeys"), (S, "rowsort_compact"), (S, "merge_tree"),
         (S, "merge_levels")]))
    results[path] = _validate_sort("(w) sort", cap)
    del cap
    secs["sort"] = time.time() - t0

    for size, spec in (("1m", V.TAIL_1M), ("10m", V.TAIL_10M)):
        t0 = time.time()
        path = f"validate: exact composite {size.upper()}"
        results[path], launches[path] = _validate_tail(
            f"(w) {size.upper()}", spec, dev, kernels, readings, size)
        secs[f"tail_parity_{size}"] = time.time() - t0
        torch.cuda.empty_cache()
    readings["pass"] = V.gate(readings)
    secs["all"] = time.time() - t_w
    print("(w) validate_kernels readings (the reference's gate on the "
          "records, the pipeline, the sort and the 1M tail parity; the "
          "int64-band and 10M ones reported): " + json.dumps(
              {k: _short(v) if isinstance(v, dict) else v
               for k, v in readings.items()}))
    print("(w) seconds: " + json.dumps({k: round(v, 1)
                                        for k, v in secs.items()}))
    check(readings["pass"], "(w) the validate_kernels gate failed")
    return results, launches, readings


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

    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels = {"K1 composite": composite_cuda.COMPOSITE,
               "K2 rowsort_compact": sort_cuda.ROWSORT,
               "K3 sample_blocks": lookup_cuda.SAMPLE_BLOCKS,
               "K4 pack_record_fields": pack_cuda.PACK_RECORD_FIELDS,
               "K5 pack_meta_rows": pack_cuda.PACK_META_ROWS,
               "K6 tail_prepass": tail_cuda.TAIL_PREPASS,
               "K7 tail_accumulate": tail_cuda.TAIL_ACCUMULATE,
               "K8 composite_bwd": composite_cuda.COMPOSITE_BWD,
               "K9 tail_accumulate_bwd": tail_cuda.TAIL_ACCUMULATE_BWD,
               "K10 apply_cutkeys": lookup_cuda.APPLY_CUTKEYS,
               "K11 merge_tree": sort_cuda.MERGE_TREE,
               "K12 merge_cross_stage": sort_cuda.MERGE_CROSS_STAGE,
               "K13 merge_finish": sort_cuda.MERGE_FINISH,
               "K5 pack_rows": pack_cuda.PACK_ROWS,
               "K14 unpack_rows": pack_cuda.UNPACK_ROWS}
    # Launches per frame of each path; a kernel not named launches never.
    never = dict.fromkeys(kernels, 0)
    converged_frame = dict(never, **{
        "K1 composite": 1, "K2 rowsort_compact": 1, "K3 sample_blocks": 2,
        "K4 pack_record_fields": 1, "K5 pack_meta_rows": 1,
        "K6 tail_prepass": 2, "K7 tail_accumulate": 2})

    # (a) environment and builds.
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.time()
    # With the earlier forms that (g) holds K3 and K6 to and (m) K11 and K13.
    from fourdgs_torch.tools.prepass_split import (block_chunk_kernel,
                                                   word_kernels)
    from fourdgs_torch.tools.sort_split import shared_stage_kernels
    build_kernels(list(kernels.values()) + list(shared_stage_kernels())
                  + [block_chunk_kernel(), *word_kernels()])
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
    check(len(captured["pipeline.composite_records_at"])
          == cfg.deepening_passes - 1, "(d) K1: not one call a deepening pass")
    results = {"non-converged": {
        "K3 sample_blocks": phase_sample_blocks(
            "(b)", captured["tiles.sample_blocks"], 1),
        "K2 rowsort_compact": phase_rowsort(
            "(c)", captured["tiles.rowsort_compact"], also_no_cut=True),
        "K1 composite": phase_composite(
            "(d)", captured["pipeline.composite_records"],
            captured["pipeline.composite_records_at"]),
    }}
    phase_rowsort_branches(dev)
    phase_composite_branches(dev)
    del captured
    # (e) card against CPU on a small frame.
    phase_small_frame(dev, converged=False)
    torch.cuda.empty_cache()
    # (f) the full frame through the entry point a user calls.
    launches = {"non-converged": phase_full_frame(
        "(f)", params, camera, cfg, kernels,
        dict(never, **{"K1 composite": None, "K2 rowsort_compact": 1,
                       "K3 sample_blocks": 1}), TIMED_FRAMES)[0]}

    # (j) K8 at the inputs of one 10M non-converged grad step: pass 1 and
    # the five deepening passes (`sel`). Its launches are counted here.
    t0 = time.time()
    for k in kernels.values():
        k.launches = 0
    captured = capture_kernel_inputs(
        params, camera, cfg, [(composite_cuda, "composite_records_bwd")],
        t=T_GRAD, grad=True)
    torch.cuda.synchronize()
    step_nc = "non-converged grad step"
    launches[step_nc] = {name: k.launches for name, k in kernels.items()}
    for name in ("K1 composite", "K8 composite_bwd"):
        check(launches[step_nc][name] == cfg.deepening_passes,
              f"(j) {name}: {launches[step_nc][name]} launches per "
              f"non-converged grad step, want {cfg.deepening_passes}")
    print(f"    non-converged grad step capture {time.time() - t0:.1f} s")
    results[step_nc] = phase_backward_kernels(
        "(j) non-converged", captured["composite_cuda.composite_records_bwd"],
        [])
    del captured
    torch.cuda.empty_cache()

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
    phase_prepass_odd_shapes(dev)
    phase_sample_offsets(dev)
    phase_tail_variants("(g)", captured, camera, cfg)
    del captured
    torch.cuda.empty_cache()
    # (h) card against CPU on a small converged frame.
    small_default = phase_small_frame(dev, converged=True)
    torch.cuda.empty_cache()
    # (i) the full converged frame.
    launches["converged"], _, med_default, _ = phase_full_frame(
        "(i)", params, camera, cfg, kernels, converged_frame,
        TIMED_FRAMES_CONVERGED)
    torch.cuda.empty_cache()

    # Training.
    # (j) K8 and K9 at the inputs of one 10M converged grad step.
    t0 = time.time()
    captured = capture_kernel_inputs(
        params, camera, cfg, [(composite_cuda, "composite_records_bwd"),
                              (tail_cuda, "tail_accumulate_bwd")],
        t=T_GRAD, grad=True)
    torch.cuda.synchronize()
    print(f"    converged grad step capture {time.time() - t0:.1f} s")
    step = "converged grad step"
    results[step] = phase_backward_kernels(
        "(j)", captured["composite_cuda.composite_records_bwd"],
        captured["tail_cuda.tail_accumulate_bwd"])
    del captured
    torch.cuda.empty_cache()
    # (k) the 20K frames, card against CPU, and Adam; (j) K8's `sel` form
    # at the 20K non-converged grad step.
    small = f"non-converged grad step ({N_SMALL // 1000}K)"
    captured, launches[small] = phase_small_grads(dev, False, kernels)
    results[small] = phase_backward_kernels("(j)", captured["c"], [])
    del captured
    phase_small_grads(dev, True, kernels)
    torch.cuda.empty_cache()
    # (l) the full converged grad step.
    launches[step], grad_step = phase_grad_step(
        params, camera, cfg, kernels,
        dict(converged_frame, **{"K8 composite_bwd": 1,
                                 "K9 tail_accumulate_bwd": 2}), TIMED_STEPS)
    torch.cuda.empty_cache()
    # (v1), (v2): the within-band weighting at the 10M converged frame, and
    # K2's alternating rows at its keys.
    res, lau, beta = phase_beta_frame(dev, params, camera, kernels,
                                      converged_frame, med_default)
    results.update(res)
    launches.update(lau)
    torch.cuda.empty_cache()

    # The kernel-sorted frame: sort_backend="pallas" with a power-of-two
    # keep. The prune runs as its own pass (K10), the slots are compacted by
    # a row sort into 4,096 alternating rows, and K11-K13 merge the rows.
    cfg_sorted = auto_render_config(N_FULL, W_FULL, H_FULL,
                                    sort_backend="pallas",
                                    sort_compact_keep_cols=MERGE_KEEP)
    t0 = time.time()
    captured = capture_kernel_inputs(
        params, camera, cfg_sorted,
        [(TT, "apply_cutkeys"), (TT, "compact_pairs"),
         (TT, "merge_sorted_rows"), (sort_cuda, "merge_tree"),
         (sort_cuda, "merge_levels")])
    torch.cuda.synchronize()
    print(f"    kernel-sorted capture frame {time.time() - t0:.1f} s")
    # (m) K10-K13 at that frame's inputs.
    sorted_path = "converged, kernel-sorted"
    results[sorted_path], merge = phase_sort_kernels(captured)
    del captured
    torch.cuda.empty_cache()
    phase_merge_adversarial(dev)
    torch.cuda.empty_cache()
    # (n) the 20K frame under the merge kernels: card against CPU, and
    # against the default sort backend.
    phase_sorted_small_frame(dev, small_default)
    torch.cuda.empty_cache()
    # (o) the full kernel-sorted frame.
    steps = sort_cuda.merge_schedule(
        sort_cuda.merged_rows(MERGE_ROWS, MERGE_KEEP) * MERGE_KEEP,
        sort_cuda.MERGE_BLOCK, sort_cuda.CROSS_GROUP)
    n_cross = sum(st[0] == "cross" for st in steps)
    launches[sorted_path], _, med_sorted, _ = phase_full_frame(
        "(o)", params, camera, cfg_sorted, kernels,
        dict(converged_frame, **{
            "K2 rowsort_compact": 0, "K10 apply_cutkeys": 1,
            "K11 merge_tree": 1, "K12 merge_cross_stage": n_cross,
            "K13 merge_finish": len(steps) - n_cross}), TIMED_FRAMES_NEW)
    print(f"(o) kernel-sorted frame median {med_sorted:.2f} ms beside the "
          f"default converged frame's {med_default:.2f} ms of phase (i); of "
          f"it the compacting row sort (plain torch.sort) "
          f"{merge['compact_pairs_ms']:.2f} ms, K11-K13 "
          f"{merge['merge_ms']:.3f} ms")
    torch.cuda.empty_cache()

    # The 4K frame: 135 x 30 = 4,050 tiles of 16x128 in two bands of tile
    # rows, each band through the whole converged path.
    cfg_4k = auto_render_config(N_FULL, W_4K, H_4K)
    camera_4k = Camera.create(**CUBE_CAMERA, width=W_4K, height=H_4K,
                              device=dev)
    ny_4k, nx_4k = TT.tile_grid(W_4K, H_4K, cfg_4k.tile_h, cfg_4k.tile_w)
    rows_per_band = TT.TILE_LIMIT // nx_4k
    check(ny_4k * nx_4k >= TT.TILE_LIMIT and -(-ny_4k // rows_per_band) == 2,
          f"(p) {ny_4k} x {nx_4k} tiles are not two bands")
    t0 = time.time()
    captured = capture_kernel_inputs(
        params, camera_4k, cfg_4k,
        [(TT, "sample_blocks"), (TT, "rowsort_compact"),
         (TP, "composite_records"), (TP, "sample_blocks"),
         (pack_cuda, "pack_record_fields"), (pack_cuda, "pack_meta_rows"),
         (tail_cuda, "tail_prepass"), (tail_cuda, "tail_accumulate")])
    torch.cuda.synchronize()
    print(f"    4K capture frame {time.time() - t0:.1f} s")
    # (p) every kernel of the path at each band's inputs.
    bands = []
    for b in range(2):
        tag = f"(p) band {b}"
        cap = band_slice(captured, b)
        part = {
            "K3 sample_blocks": phase_sample_blocks(
                tag, cap["tiles.sample_blocks"]
                + cap["pipeline.sample_blocks"], 2),
            "K2 rowsort_compact": phase_rowsort(
                tag, cap["tiles.rowsort_compact"], also_no_cut=False),
            "K1 composite": phase_composite(
                tag, cap["pipeline.composite_records"]),
        }
        part.update(phase_converged_kernels(cap, tag))
        bands.append(part)
    path_4k = "converged 4K, two bands"
    results[path_4k] = merge_results(bands)
    del captured, cap, bands
    torch.cuda.empty_cache()
    # (p) the full 4K frame: launch counts twice phase (i)'s, the counters,
    # time and peak memory, and the rows at the band seam.
    launches[path_4k], _, _, img_4k = phase_full_frame(
        "(p)", params, camera_4k, cfg_4k, kernels,
        {k: 2 * v for k, v in converged_frame.items()}, TIMED_FRAMES_NEW)
    seam, other = phase_seam(img_4k, cfg_4k.tile_h, [rows_per_band])
    print(f"(p) band seam at image row {rows_per_band * cfg_4k.tile_h}: rows "
          f"there differ from their neighbours' mean by at most {seam:.3e}, "
          f"rows at the other tile-row boundaries by at most {other:.3e}")
    del img_4k
    torch.cuda.empty_cache()
    # (p) a 20K-splat frame of 4,224 tiles of 8x64 (three bands), both
    # modes, card against CPU.
    for converged in (False, True):
        phase_small_frame(dev, converged, tag="(p)", w=W_BAND, h=H_BAND,
                          comp_tol=EDGE_TOL, tile_h=8, tile_w=64,
                          tail_block=(8, 8))
    torch.cuda.empty_cache()

    # (q) pack_rows and its backward, the public row pack.
    pack_path = "pack_rows and its backward"
    results[pack_path], launches[pack_path] = phase_pack_rows(dev, kernels)
    del params
    torch.cuda.empty_cache()

    # The exact-order paths: (r) the 20K-splat frames of render_splats4d,
    # 3d and 2d, card against CPU; (s) the viewer's full-width frame.
    for phase in (phase_exact_small, phase_exact_full):
        res, lau = phase(dev, kernels)
        results.update(res)
        launches.update(lau)
        torch.cuda.empty_cache()

    # The fitting path: (t1) densify card against CPU, (t2) 3-step fits card
    # against CPU, (t3) the full-width fit, (t4) the example.
    phase_densify_devices(dev)
    phase_fit_devices(dev, kernels)
    torch.cuda.empty_cache()
    res, lau = phase_fit_full(dev, kernels)
    results.update(res)
    launches.update(lau)
    torch.cuda.empty_cache()
    phase_fit_example()
    torch.cuda.empty_cache()
    # The viewer path: (u) viewer.cli.main on the card.
    res, lau = phase_viewer(dev, kernels)
    results.update(res)
    launches.update(lau)
    torch.cuda.empty_cache()
    # The sharded layer: (v3) renders, (v4) train steps, fit_sharded and the
    # dry run, (v5) card against CPU, in a process group of one rank.
    t_v = time.time()
    res, lau, sharded = phase_sharded(dev, kernels)
    results.update(res)
    launches.update(lau)
    print(f"(v3)-(v5) {time.time() - t_v:.1f} s")
    torch.cuda.empty_cache()
    # The certification: (w) validate_kernels' checks under its gate.
    t_w = time.time()
    res, lau, validate = phase_validate(dev, kernels)
    results.update(res)
    launches.update(lau)
    print(f"(w) {time.time() - t_w:.1f} s; the whole script "
          f"{time.time() - t_start:.1f} s")

    print(json.dumps({"kernels": [
        dict(name=f"{name} [{path}]", path=path, route="cuda",
             source=KERNEL_INFO[name][0], replaces=KERNEL_INFO[name][1],
             launches=launches[path][name], **res)
        for path, by_kernel in results.items()
        for name, res in sorted(by_kernel.items())],
        "grad_step": grad_step, "tail_depth_beta_8": beta,
        "sharded_world_size_1": sharded, "validate_kernels": validate,
        "script_s": time.time() - t_start}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
