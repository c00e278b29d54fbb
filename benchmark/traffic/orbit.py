"""Traffic kind `orbit`: one viewer in a closed loop, turning about the
scene.

The camera is the configuration's camera turned about the vertical axis
through the scene's centre, keeping its distance, elevation and direction
to the centre. The starting azimuth is drawn from the seed; each frame
turns it by `deg_per_frame` and advances the scene time by `t_per_frame`,
modulo 1. The next frame is rendered once the last one's image is on the
device and synchronized.

Mix parameters: width, height, deg_per_frame, t_per_frame, warmup_frames,
checked_frames (frames of the window compared with the reference, at
places in the window drawn from the seed), traced_frames (poses profiled
in the traced run, spread evenly over one turn).
"""

from __future__ import annotations

import gc
import math
import random
import statistics
import time
from typing import List

SEED_SALT_AZIMUTH = 0x5EED0
SEED_SALT_CHECK = 0xC0FFEE
COUNTERS = ("overflowed", "compact_dropped", "resid_transmittance")


def start_azimuth(seed: int) -> float:
    return random.Random(seed ^ SEED_SALT_AZIMUTH).random() * 360.0


def pose(camera: dict, mix: dict, seed: int, i: int):
    """(position, orientation, t) of frame i, as Python floats."""
    az = math.radians(start_azimuth(seed) + i * mix["deg_per_frame"])
    c, s = math.cos(az), math.sin(az)
    center = camera.get("center", (0.0, 0.0, 0.0))

    def turn(v):
        return (v[0] * c + v[2] * s, v[1], -v[0] * s + v[2] * c)
    rel = turn([p - q for p, q in zip(camera["position"], center)])
    position = tuple(r + q for r, q in zip(rel, center))
    t = math.fmod(i * mix["t_per_frame"], 1.0)
    return position, turn(camera["orientation"]), t


def check_fractions(seed: int, k: int) -> List[float]:
    """Where in the window, as shares of its length, the compared frames
    start: drawn from the seed, sorted."""
    rng = random.Random(seed ^ SEED_SALT_CHECK)
    return sorted(rng.random() for _ in range(k))


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100)."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


class Run:
    """One process's run of an orbit cell: set-up, the measured window, the
    traced frames and the comparison with the reference. On a CPU device
    (the harness's tests) frames are timed by the host's clock alone."""

    trace_unit = "frame"        # what a traced unit of work is
    wall_metric = "frame_ms"    # its wall time in the unprofiled window

    def __init__(self, cell, seed: int, device):
        import torch
        self.torch = torch
        self.seed, self.device = int(seed), device
        self.mix, self.config = cell.mix, cell.config
        self.w, self.h = int(self.mix["width"]), int(self.mix["height"])
        self.camera = self.config["camera"]
        self.kept = []            # (frame index, image) of compared frames
        self.kept_counters = {}   # frame index -> its counters
        self.aux = []
        self.frames_done = 0

    # ---- set-up ---------------------------------------------------------

    def setup(self) -> dict:
        """Scene, program state, kernel libraries and warm-up frames; the
        seconds of each part."""
        t0 = time.perf_counter()
        from fourdgs_torch.core.camera import Camera
        from fourdgs_torch.ops import _build
        from fourdgs_torch.render.autoconfig import auto_render_config
        from fourdgs_torch.render.pipeline import render_params4d_packed
        from fourdgs_torch.scenes.cube import converged_cube_scene
        from harness.scene import cube_params

        self.Camera, self.render = Camera, render_params4d_packed
        parts = {"program_import_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        raw = cube_params(self.config["scene"], self.seed, self.device)
        self.sync()
        parts["scene_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.params = converged_cube_scene(raw)
        del raw
        self.sync()
        parts["morton_pad_s"] = time.perf_counter() - t0
        self.cfg = auto_render_config(int(self.config["scene"]["n_splats"]),
                                      self.w, self.h, converged=True,
                                      **self.overrides())
        lib_s = [0.0]
        load = _build.load_library

        def timed_load(*a, **k):
            t = time.perf_counter()
            try:
                return load(*a, **k)
            finally:
                lib_s[0] += time.perf_counter() - t
        _build.load_library = timed_load
        t0 = time.perf_counter()
        try:
            for i in range(-int(self.mix["warmup_frames"]), 0):
                self.frame(i)
        finally:
            _build.load_library = load
        parts["libraries_s"] = lib_s[0]
        parts["warmup_s"] = time.perf_counter() - t0 - lib_s[0]
        return parts

    def overrides(self) -> dict:
        """The configuration's render knobs set apart from the automatic
        configuration's (by the program's names)."""
        return dict(self.config["render"].get("overrides", {}))

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def frame(self, i: int):
        """Render frame i of the orbit: (image, aux). Returns once the
        image is on the device."""
        position, orientation, t = pose(self.camera, self.mix, self.seed, i)
        cam = self.Camera.create(position=position, orientation=orientation,
                                 far=self.camera["far"], width=self.w,
                                 height=self.h, device=self.device)
        img, aux = self.render(self.params, cam, t, cfg=self.cfg,
                               return_aux=True)
        self.sync()
        return img, aux

    # ---- the measured window ---------------------------------------------

    def window(self, seconds: float) -> dict:
        """Frames in a closed loop for `seconds`: frame_ms is the window's
        wall time over its frames; each frame's own time is read from CUDA
        events recorded before its first and after its last operation."""
        torch = self.torch
        cuda = self.device.type == "cuda"
        marks = [f * seconds for f in check_fractions(
            self.seed, int(self.mix["checked_frames"]))]
        times_ms = []
        t_start = time.perf_counter()
        i = 0
        while True:
            t_frame = time.perf_counter() - t_start
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            img, aux = self.frame(i)
            if cuda:
                end.record()
                end.synchronize()
                times_ms.append(start.elapsed_time(end))
            else:
                times_ms.append((time.perf_counter() - t_start - t_frame)
                                * 1e3)
            self.aux.append(aux)
            done = time.perf_counter() - t_start >= seconds
            # A frame is kept for every place it reaches; the window's last
            # frame takes the places no frame reached.
            due = [m for m in marks if m <= t_frame or done]
            if due:
                marks = marks[len(due):]
                self.kept.append((i, img))
            del img
            i += 1
            if done:
                break
        wall = time.perf_counter() - t_start
        self.frames_done = i
        return dict(frames=i, frame_ms=wall * 1e3 / i,
                    frame_p95_ms=percentile(times_ms, 95.0),
                    frame_median_ms=statistics.median(times_ms),
                    window_s=wall)

    def failed(self) -> int:
        """Frames whose loss counters are not 0: pairs over the budget,
        pairs lost to the compaction, or transmittance left behind the
        converged frame. Also keeps the compared frames' counters."""
        torch = self.torch
        table = torch.stack([torch.stack([a[k].float() for k in COUNTERS])
                             for a in self.aux]).cpu()
        for i, _ in self.kept:
            self.kept_counters[i] = dict(zip(COUNTERS, table[i].tolist()))
        lossy = (table != 0).any(dim=1)
        self.lossy = dict(frames=lossy.nonzero().squeeze(1).tolist(),
                          sums=dict(zip(COUNTERS, table.sum(0).tolist())))
        return int(lossy.sum())

    # ---- the traced frames ----------------------------------------------

    def traced_indices(self) -> List[int]:
        n = int(self.mix["traced_frames"])
        per_turn = 360.0 / self.mix["deg_per_frame"]
        return [self.frames_done + round(j * per_turn / n) for j in range(n)]

    def trace(self):
        """Profile the traced poses, then render them again with the kernel
        wrappers recording their launches' bounds: (Trace, Recorder)."""
        from harness.roofline import Recorder
        from harness.trace import profile_units
        idx = self.traced_indices()
        tr = profile_units(self.frame, idx, self.device)
        with Recorder() as rec:
            for i in idx:
                self.frame(i)
        return tr, rec

    # ---- the comparison with the reference --------------------------------

    def release(self):
        """Free the program's state before the reference runs."""
        self.params = self.cfg = None
        self.aux = []
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def reference_scene(self):
        from harness.scene import cube_params
        from reference import converged_frame as R
        raw = cube_params(self.config["scene"], self.seed, self.device)
        return R.morton_pad(raw, int(self.config["scene"]["pad_to"]))

    def reference_frame(self, ref_params, i: int, records_dtype=None):
        import torch
        from reference import converged_frame as R
        position, orientation, t = pose(self.camera, self.mix, self.seed, i)
        cfg = R.frame_config(int(self.config["scene"]["n_splats"]), self.w,
                             self.h, self.overrides())
        return R.render(ref_params, position, orientation, t, self.w, self.h,
                        far=self.camera["far"], cfg=cfg,
                        records_dtype=records_dtype or torch.float32)

    def compare(self) -> dict:
        """Each kept frame against the reference: the largest mean |d| over
        the rgb channels (image_gap), and the largest difference of the
        loss counters (counter_gap)."""
        ref_params = self.reference_scene()
        gaps, counter_gaps = [], []
        for i, img in self.kept:
            want, wc = self.reference_frame(ref_params, i)
            gaps.append(image_gap(img, want))
            got = self.kept_counters[i]
            counter_gaps.append(abs(got["overflowed"] - wc["overflowed"])
                                + abs(got["compact_dropped"]
                                      - wc["compact_dropped"]))
            del want
        return dict(image_gap=max(gaps) if gaps else None,
                    counter_gap=max(counter_gaps) if counter_gaps else None,
                    frames=[i for i, _ in self.kept], gaps=gaps)

    def control(self, records_dtype) -> dict:
        """The reference computed with its records in `records_dtype`, in
        the program's place, at the kept frames: the same numbers."""
        ref_params = self.reference_scene()
        gaps, counter_gaps = [], []
        for i, _ in self.kept:
            want, wc = self.reference_frame(ref_params, i)
            got, gc_ = self.reference_frame(ref_params, i, records_dtype)
            gaps.append(image_gap(got, want))
            counter_gaps.append(abs(gc_["overflowed"] - wc["overflowed"])
                                + abs(gc_["compact_dropped"]
                                      - wc["compact_dropped"]))
        return dict(image_gap=max(gaps) if gaps else None,
                    counter_gap=max(counter_gaps) if counter_gaps else None,
                    frames=[i for i, _ in self.kept], gaps=gaps)


def image_gap(got, want) -> float:
    """Mean |got - want| over the rgb channels of two (H, W, 4) images."""
    return float((got[..., :3].float() - want[..., :3].float()).abs().mean())
