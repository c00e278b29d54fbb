"""Stage profile of the flagship frame on one card.

    python3 -m fourdgs_torch.tools.profile_frame [--grad]
        [--sort-backend pallas] [--json PATH]

Renders the headline scene, the 10M-splat cube (`scenes/cube.py`;
Morton-ordered and dead-padded for the converged path) at 1920x1088 on
the first CUDA device, with `render_params4d_packed` under
`auto_render_config(n, w, h, converged=...)`, and for each path, converged
then non-converged, reports after 3 warm-up frames:

  * the median wall time of 10 unprofiled frames (host clock, each frame
    ending in `torch.cuda.synchronize()`);
  * a `torch.profiler` trace of 5 frames, each inside a
    `profile_frame::frame` range. Every device operation (kernel, memcpy,
    memset) is mapped through its launch's correlation id to the innermost
    `fourdgs::*` range open when it was launched, so the kernels launched
    through ctypes are attributed like any other; the program's own
    `fourdgs::frame` around each render call is the stage of the entry's
    glue between the other stages. Per stage: device ms per
    frame (exclusive of nested ranges), host ms per frame (the range's
    duration, inclusive of nested ranges) and device operations per frame;
    per frame: operations, busy ms (the union of the device intervals of
    the frame's operations), the traced idle share 1 - busy / frame range
    (the profiler's own host overhead inflates it) and the derived idle
    share 1 - busy / unprofiled median.

With --grad each frame is a grad step instead: mean(img[..., :3]^2) at
t = 0.37 and its backward to the packed params, inside a
`fourdgs::backward` range. The autograd Functions open their own ranges
in their backward (`fourdgs::composite_bwd` for K8, `fourdgs::tail_bwd`
for K9, `fourdgs::pack_bwd`), so `fourdgs::backward` keeps the device time
of every other backward operation (the projection's chain rule above all).

With --sort-backend pallas both paths sort their pairs with the merge
kernels (keep 512, a power of two): the binning then shows
`fourdgs::apply_cutkeys` (K10), `fourdgs::compact_pairs` (the row sort that
compacts the slots) and `fourdgs::merge_sorted_rows` (K11-K13) in place of
`fourdgs::rowsort_compact` and `fourdgs::global_sort`.

`profile_path` also runs on the CPU, where it reports host times only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

import torch
from torch.profiler import ProfilerActivity, profile, record_function

N_SPLATS, WIDTH, HEIGHT = 10_000_000, 1920, 1088
WARMUP, TIMED, PROFILED = 3, 10, 5
MERGE_KEEP = 512       # power-of-two keep of the kernel-sorted frame
GRAD_T = 0.37          # at t = pt the temporal fields get no gradient
PREFIX = "fourdgs::"
FRAME = "profile_frame::frame"     # the tool's unit, outside the program's
BACKWARD = PREFIX + "backward"
OUTSIDE = "(outside the stages)"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _union_ms(intervals) -> float:
    """Total length in ms of the union of (start_us, end_us) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e3


def attribute_trace(events: List[dict]) -> dict:
    """Stage breakdown of a chrome trace's `traceEvents` holding one or more
    `profile_frame::frame` ranges (one host thread launching). Returns
    per-frame means: {"frames", "frame_ms", "ops", "busy_ms", "idle_traced",
    "stages": {name: {"device_ms", "host_ms", "ops"}}}; device operations
    launched outside every frame are ignored."""
    ranges = sorted(
        ((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
         if e.get("ph") == "X" and e.get("cat") == "user_annotation"
         and (e.get("name", "").startswith(PREFIX)
              or e.get("name") == FRAME)),
        key=lambda r: (r[0], -r[1]))
    frames = [r for r in ranges if r[2] == FRAME]
    stages = [r for r in ranges if r[2] != FRAME]
    n_frames = len(frames)
    if not n_frames:
        raise ValueError(f"the trace holds no {FRAME} range")

    def innermost(ts, among):
        best = None
        for s, e, name in among:
            if s > ts:
                break
            if ts <= e and (best is None or s >= best[0]):
                best = (s, e, name)
        return best

    launch = {}
    for e in events:
        if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e["ts"]
    out: Dict[str, dict] = {}

    def stage(name):
        return out.setdefault(name, dict(device_ms=0.0, host_ms=0.0, ops=0))
    for s, e, name in stages:
        if innermost(s, frames) is not None:
            stage(name)["host_ms"] += (e - s) / 1e3
    busy = {f: [] for f in frames}
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        ts = launch.get(e.get("args", {}).get("correlation"))
        frame = None if ts is None else innermost(ts, frames)
        if frame is None:
            continue
        r = innermost(ts, stages)
        st = stage(OUTSIDE if r is None else r[2])
        st["device_ms"] += e["dur"] / 1e3
        st["ops"] += 1
        busy[frame].append((e["ts"], e["ts"] + e["dur"]))
    for st in out.values():
        st["device_ms"] /= n_frames
        st["host_ms"] /= n_frames
        st["ops"] /= n_frames
    frame_ms = sum(e - s for s, e, _ in frames) / 1e3 / n_frames
    busy_ms = sum(_union_ms(v) for v in busy.values()) / n_frames
    return dict(frames=n_frames, frame_ms=frame_ms,
                ops=sum(len(v) for v in busy.values()) / n_frames,
                busy_ms=busy_ms, idle_traced=1.0 - busy_ms / frame_ms,
                stages=dict(sorted(out.items(),
                                   key=lambda kv: -kv[1]["device_ms"])))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile_path(params, camera, cfg, warmup: int, timed: int,
                 profiled: int, grad: bool = False) -> dict:
    """Median of `timed` unprofiled frames, then the stage breakdown of
    `profiled` traced frames (attribute_trace) of one render path; with
    `grad`, of grad steps."""
    from fourdgs_torch.render.pipeline import render_params4d_packed
    dev = params["px"].device
    if grad:
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}

    def frame():
        if not grad:
            render_params4d_packed(params, camera, 0.0, cfg=cfg)
        else:
            for v in params.values():
                v.grad = None
            img = render_params4d_packed(params, camera, GRAD_T, cfg=cfg)
            loss = (img[..., :3] ** 2).mean()
            with record_function(BACKWARD):
                loss.backward()
        _sync(dev)
    for _ in range(warmup):
        frame()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        frame()
        times.append((time.perf_counter() - t0) * 1e3)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        for _ in range(profiled):
            with record_function(FRAME):
                frame()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    res = attribute_trace(events)
    med = statistics.median(times)
    res.update(median_ms=med, frames_ms=times,
               idle_derived=1.0 - res["busy_ms"] / med)
    return res


def _print_path(label: str, res: dict) -> None:
    print(f"{label}: median {res['median_ms']:.3f} ms over "
          f"{len(res['frames_ms'])} unprofiled frames; traced "
          f"{res['frames']} frames: {res['frame_ms']:.3f} ms per frame, "
          f"{res['ops']:.1f} device ops, busy {res['busy_ms']:.3f} ms, idle "
          f"share traced {res['idle_traced']:.4f}, derived "
          f"{res['idle_derived']:.4f}")
    print(f"  {'stage':<28}{'device ms':>11}{'host ms':>11}{'ops':>9}")
    for name, st in res["stages"].items():
        print(f"  {name:<28}{st['device_ms']:>11.3f}{st['host_ms']:>11.3f}"
              f"{st['ops']:>9.1f}")


def main(argv=None) -> int:
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.scenes.cube import (CUBE_CAMERA, build_cube_scene,
                                           converged_cube_scene)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grad", action="store_true",
                    help="profile grad steps instead of frames")
    ap.add_argument("--sort-backend", default="xla",
                    choices=("xla", "pallas"),
                    help="pallas: sort the pairs with the merge kernels")
    ap.add_argument("--json", default=None,
                    help="also write the results to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    overrides = {}
    if args.sort_backend == "pallas":
        overrides = dict(sort_backend="pallas",
                         sort_compact_keep_cols=MERGE_KEEP)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    report = dict(grad=args.grad, sort_backend=args.sort_backend, device=smi)
    print(report["device"])
    base = build_cube_scene(N_SPLATS, seed=0, device=dev)
    camera = Camera.create(**CUBE_CAMERA, width=WIDTH, height=HEIGHT,
                           device=dev)
    for label in ("converged", "non-converged"):
        converged = label == "converged"
        params = converged_cube_scene(base) if converged else base
        cfg = auto_render_config(N_SPLATS, WIDTH, HEIGHT,
                                 converged=converged, **overrides)
        res = profile_path(params, camera, cfg, WARMUP, TIMED, PROFILED,
                           grad=args.grad)
        _print_path(f"{label} {'grad step' if args.grad else 'frame'} "
                    f"{params['px'].shape[0]:,} splats {WIDTH}x{HEIGHT}", res)
        report[label] = res
        del params
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
