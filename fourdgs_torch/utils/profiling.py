"""Timing and tracing on the card (port of fourdgs/utils/profiling.py).

`time_fn` times a call to its end on the device; `profile_pipeline` splits
a frame of `render_params4d_packed` by the pipeline's `fourdgs::*`
`record_function` ranges (tools/profile_frame.py maps each device
operation to the innermost range open at its launch); `trace` writes a
`torch.profiler` Chrome trace of one call. All three need a CUDA device.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def time_fn(fn: Callable, *args, reps: int = 5, warmup: int = 1) -> float:
    """Best-of-reps wall seconds of fn(*args), each call ended by
    torch.cuda.synchronize()."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def profile_pipeline(params, camera, t, cfg, reps: int = 3
                     ) -> List[Tuple[str, float]]:
    """Device milliseconds per frame of each `fourdgs::*` stage of
    `render_params4d_packed(params, camera, t, cfg=cfg)` over `reps` traced
    frames (exclusive of nested stages), largest first, then
    ("full-frame", best wall ms of `reps` untraced frames)."""
    from fourdgs_torch.render.pipeline import render_params4d_packed
    from fourdgs_torch.tools.profile_frame import FRAME, attribute_trace

    def frame():
        render_params4d_packed(params, camera, t, cfg=cfg)
    full_s = time_fn(frame, reps=reps)
    with profile(activities=_ACTIVITIES) as prof:
        for _ in range(reps):
            with record_function(FRAME):
                frame()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            res = attribute_trace(json.load(f)["traceEvents"])
    return ([(name, st["device_ms"]) for name, st in res["stages"].items()]
            + [("full-frame", full_s * 1e3)])


def trace(fn: Callable, *args, log_dir: str = "fourdgs_trace") -> str:
    """Write a torch.profiler Chrome trace of one call of fn(*args) (after
    one untraced call) to `log_dir`/trace.json; returns its path."""
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=_ACTIVITIES) as prof:
        fn(*args)
        torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path
