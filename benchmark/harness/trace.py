"""A torch.profiler trace of a few units of work (frames or steps), reduced
to what the per-layer metric readers take.

Each unit runs inside a `bench::unit` range. Every device operation
(kernel, memcpy, memset) is mapped through its launch's correlation id to
the ranges open on the host when it was launched (the program's
`fourdgs::*` ranges, and any other `record_function` range), so kernels
launched through ctypes are attributed like any other. The mapping follows the port's stage profiler
(`fourdgs_torch/tools/profile_frame.py`), copied here and frozen; it also
keeps every enclosing range, so a reader can take a stage inclusive of the
stages nested in it.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Optional

UNIT = "bench::unit"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CATS = ("user_annotation",)
KERNEL_DECL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*"
                         r"\([^)]*\)\s*)?(\w+)\s*\(", re.S)


def kernel_names(csrc: Path) -> List[str]:
    """The names of the hand-written kernels: every `__global__` function
    of the program's CUDA sources."""
    names = set()
    for src in sorted(csrc.glob("*.cu")):
        names.update(KERNEL_DECL.findall(src.read_text()))
    return sorted(names)


def union_s(intervals) -> float:
    """Total length, in the intervals' unit, of the union of (start, end)
    intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


class Trace:
    """The reduced trace of `units` units of work.

    ops: one dict a device operation launched inside a unit: name, ts and
    dur (us), unit (index), ranges (the names of every range open at its
    launch, outermost first). units: (start, end) host intervals in us.
    host_ranges: (start, end, name) of every range inside a unit.
    """

    def __init__(self, events: List[dict]):
        ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                         for e in events if e.get("ph") == "X"
                         and e.get("cat") in RANGE_CATS),
                        key=lambda r: (r[0], -r[1]))
        self.units = [(s, e) for s, e, name in ranges if name == UNIT]
        if not self.units:
            raise ValueError(f"the trace holds no {UNIT} range")
        self.host_ranges = [r for r in ranges if r[2] != UNIT
                            and self._unit_of(r[0]) is not None]
        starts = [r[0] for r in self.host_ranges]
        launch = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get(
                    "args", {}):
                launch[e["args"]["correlation"]] = e["ts"]
        self.ops = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            ts = launch.get(e.get("args", {}).get("correlation"))
            unit = None if ts is None else self._unit_of(ts)
            if unit is None:
                continue
            hi = bisect.bisect_right(starts, ts)
            open_ = [r[2] for r in self.host_ranges[:hi]
                     if r[0] <= ts <= r[1]]
            self.ops.append(dict(name=e.get("name", ""), ts=e["ts"],
                                 dur=e["dur"], unit=unit, ranges=open_))

    def _unit_of(self, ts) -> Optional[int]:
        for i, (s, e) in enumerate(self.units):
            if s <= ts <= e:
                return i
        return None

    @property
    def n_units(self) -> int:
        return len(self.units)

    def busy_us(self) -> float:
        """The union of the device intervals of the units' operations."""
        return union_s((o["ts"], o["ts"] + o["dur"]) for o in self.ops)

    def window_us(self) -> float:
        """From the first unit's start to the last unit's end, or to its
        last device operation's end where that is later."""
        end = max([self.units[-1][1]]
                  + [o["ts"] + o["dur"] for o in self.ops])
        return end - self.units[0][0]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (by name, seconds over
        the traced units) and the longest idle gaps of the device, each
        named by the innermost range open on the host at the gap's start."""
        by_name: Dict[str, float] = {}
        for o in self.ops:
            by_name[o["name"]] = by_name.get(o["name"], 0.0) + o["dur"] / 1e6
        spans = sorted((o["ts"], o["ts"] + o["dur"]) for o in self.ops)
        gaps: Dict[str, float] = {}
        end = spans[0][1] if spans else 0.0
        for s, e in spans[1:]:
            if s > end:
                name = self._host_at(end) or "(no range)"
                gaps[name] = gaps.get(name, 0.0) + (s - end) / 1e6
            end = max(end, e)
        return dict(
            device_ops=[[k, v] for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:top]],
            idle_gaps=[[k, v] for k, v in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:top]])

    def _host_at(self, ts) -> Optional[str]:
        best = None
        for s, e, name in self.host_ranges:
            if s > ts:
                break
            if ts <= e and (best is None or s >= best[0]):
                best = (s, e, name)
        return None if best is None else best[2]


def profile_units(run_unit: Callable[[int], None], indices, device) -> Trace:
    """Profile `run_unit(i)` for each i of `indices`, each inside a
    `bench::unit` range, and reduce the trace. The chrome trace is written
    to a temporary directory under TMPDIR and removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in indices:
            with record_function(UNIT):
                run_unit(i)
            torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return Trace(events)
