"""Traffic kind `fit`: one fitting job in a closed loop, one Adam step per
(camera, time) view of a multi-view rig.

The rig is `cameras` cameras at equal azimuths on the ring of the
configuration's camera (its distance and elevation about the centre, turned
about the vertical axis through the centre; the first azimuth drawn from the
seed), each at `times` time stamps t = (k + 0.5) / times: never t = 0, where
the temporal fields of a splat centred at t = 0 get no gradient. The targets
are the program's converged renders (`render_splats4d`) of a second cube
scene drawn from the seed with a salt, one for each view, made at set-up and
held on the device as float32 (H, W, 3). The fitted scene is the
configuration's cube, Morton-ordered, in the trainer's layout and padded
with `densify.pad_params` to `pad_to` slots.

The job is the program's `trainer.Fitter` (ssim_weight, learning_rate, a
densify event after every `densify_every`-th step with no end, opt_reset).
Each step takes the next view of a shuffle of the views, drawn anew every
epoch (3D Gaussian Splatting's viewpoint stack), and starts once the last
step's loss is read back to the host.

Mix parameters: width, height, cameras, times, ssim_weight, learning_rate,
densify_every, opt_reset, warmup_steps (counted as set-up), checked_steps
(steps compared with the reference, at places in the window drawn from the
seed), traced_steps (steps profiled in the traced run, none a densify
event).

At a checked step the run captures, off the clock, the parameters and
Adam's moments before the step, the view, the loss, the gradients, the
loss counters and the parameters after it. The comparison with the plain
reference (reference/fit_step.py), the largest over the checked steps:

  loss_gap        |loss - loss_ref| / |loss_ref|;
  grad_gap        the largest over position4, quat, scale3, velocity and
                  color (GRAD_FIELDS) of |g - g_ref| / |g_ref|, the norms
                  over the field's entries at the splats whose footprint
                  eigenvector the conditioning rule keeps
                  (fit_step.well_conditioned, 99.6% of the cube's). At a
                  nearly round footprint the eigenvector, and every
                  gradient through it, is float32 rounding noise (ROADMAP
                  C-R7) that the two sides round apart. The norm, and not
                  the largest entry: a footprint edge or a pair at a
                  tile's head cut that the two sides' rounding puts apart
                  moves a few splats' gradients whole. Lifetime and fade
                  are left out: their gradient is that of the temporal
                  variance, which the 4D slice adds (tvec tvec^T / st) and
                  takes away again, exactly in exact arithmetic; in
                  float32 the two terms leave noise of the size of
                  |velocity|^2, which the fit grows, while the cube's
                  true temporal gradient (through exp(-dt^2 / 2 st), st
                  near 1,800) is tiny, so by the window's end the two
                  sides' noise is what is compared (both fields' gaps are
                  reported in field_norm_gaps);
  update_gap      the reference's Adam applied to the captured state and
                  the program's own gradients, against the program's
                  parameters after the step: the largest over the fields
                  of max |p - p_ref| / max |p_ref - p_before|;
  counter_gap     |overflowed - ref| + |compact_dropped - ref|.

The precision control (`control`) puts the reference with its records in
bfloat16 in the program's place, and its Adam computed in bfloat16.
"""

from __future__ import annotations

import gc
import math
import random
import statistics
import time
from typing import List

SEED_SALT_RING = 0x5EED1
SEED_SALT_TARGET = 0x7A26E7
SEED_SALT_ORDER = 0x0DE25
SEED_SALT_CHECK = 0xC0FFEE
COUNTERS = ("overflowed", "compact_dropped", "resid_transmittance")
GRAD_FIELDS = ("position4", "quat", "scale3", "velocity", "color")


def ring_poses(camera: dict, n: int, seed: int):
    """(position, orientation) of the n cameras of the ring, as Python
    floats."""
    start = random.Random(seed ^ SEED_SALT_RING).random() * 360.0
    center = camera.get("center", (0.0, 0.0, 0.0))
    rel0 = [p - q for p, q in zip(camera["position"], center)]
    poses = []
    for k in range(n):
        az = math.radians(start + k * 360.0 / n)
        c, s = math.cos(az), math.sin(az)

        def turn(v):
            return (v[0] * c + v[2] * s, v[1], -v[0] * s + v[2] * c)
        rel = turn(rel0)
        poses.append((tuple(r + q for r, q in zip(rel, center)),
                      turn(camera["orientation"])))
    return poses


def view_times(n: int) -> List[float]:
    return [(k + 0.5) / n for k in range(n)]


def view_order(seed: int, n_views: int, epoch: int) -> List[int]:
    """The views of one epoch, in the order they are trained."""
    order = list(range(n_views))
    random.Random((seed ^ SEED_SALT_ORDER) * 1_000_003 + epoch).shuffle(order)
    return order


def check_fractions(seed: int, k: int) -> List[float]:
    """Where in the window, as shares of its length, the checked steps
    are: drawn from the seed, sorted."""
    rng = random.Random(seed ^ SEED_SALT_CHECK)
    return sorted(rng.random() for _ in range(k))


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100)."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def _ratio(diff: float, scale: float) -> float:
    if scale == 0.0:
        return 0.0 if diff == 0.0 else math.inf
    return diff / scale


def field_gap(got, want) -> float:
    """max |got - want| / max |want| (0 where both are 0)."""
    if not want.numel():
        return 0.0
    return _ratio(float((got - want).abs().max()), float(want.abs().max()))


def norm_gap(got, want) -> float:
    """|got - want| / |want|, the norms over every entry (0 where both are
    0)."""
    return _ratio(float((got - want).double().norm()),
                  float(want.double().norm()))


def trainer_scene(scene: dict, seed: int, device):
    """The cube scene of `scene` from `seed` as the trainer's parameter
    dict: Morton-ordered by the program, padded to scene["pad_to"]
    slots."""
    import torch
    from fourdgs_torch.parallel.distributed import splats_to_params
    from fourdgs_torch.splats.packed import morton_order
    from fourdgs_torch.train.densify import pad_params
    from harness.scene import cube_params
    p = morton_order(cube_params(scene, seed, device))

    def cols(*keys):
        return torch.stack([p[k] for k in keys], -1)
    params = splats_to_params(
        cols("px", "py", "pz", "pt"), cols("qw", "qx", "qy", "qz"),
        cols("sx", "sy", "sz"), p["lifetime"], p["fade"],
        cols("vx", "vy", "vz"), cols("cr", "cg", "cb", "ca"))
    return pad_params(params, int(scene["pad_to"]))


class Run:
    """One process's run of a fit cell: set-up, the measured window, the
    traced steps and the comparison with the reference. On a CPU device
    (the harness's tests) steps are timed by the host's clock alone."""

    trace_unit = "step"         # what a traced unit of work is
    wall_metric = "frame_ms"    # its wall time in the unprofiled window

    def __init__(self, cell, seed: int, device):
        import torch
        self.torch = torch
        self.seed, self.device = int(seed), device
        self.mix, self.config, self.root = cell.mix, cell.config, cell.root
        self.w, self.h = int(self.mix["width"]), int(self.mix["height"])
        self.camera = self.config["camera"]
        self.poses = ring_poses(self.camera, int(self.mix["cameras"]),
                                self.seed)
        self.times = view_times(int(self.mix["times"]))
        self.n_views = len(self.poses) * len(self.times)
        if self.n_views != int(self.config.get("views", self.n_views)):
            raise ValueError(f"the mix has {self.n_views} views, the "
                             f"configuration {self.config['views']}")
        self._order = (-1, [])    # (epoch, its view order)
        self.kept = []            # the checked steps' captures
        self.steps_in_window = 0
        self.lossy = None

    # ---- set-up ---------------------------------------------------------

    def setup(self) -> dict:
        """Scene, targets, the fitter, kernel libraries and warm-up steps;
        the seconds of each part."""
        torch = self.torch
        t0 = time.perf_counter()
        from fourdgs_torch.core.camera import Camera
        from fourdgs_torch.ops import _build
        from fourdgs_torch.parallel.distributed import materialize_splats
        from fourdgs_torch.render.autoconfig import auto_render_config
        from fourdgs_torch.render.pipeline import render_splats4d
        from fourdgs_torch.train import densify as D
        from fourdgs_torch.train.trainer import Fitter
        parts = {"program_import_s": time.perf_counter() - t0}
        scene = self.config["scene"]
        lib_s = [0.0]
        load = _build.load_library

        def timed_load(*a, **k):
            t = time.perf_counter()
            try:
                return load(*a, **k)
            finally:
                lib_s[0] += time.perf_counter() - t
        _build.load_library = timed_load
        try:
            t0 = time.perf_counter()
            params = trainer_scene(scene, self.seed, self.device)
            self.sync()
            parts["scene_s"] = time.perf_counter() - t0
            self.cfg = auto_render_config(int(scene["pad_to"]), self.w,
                                          self.h, converged=True,
                                          **self.overrides())
            self.cams = [Camera.create(position=pos, orientation=ori,
                                       far=self.camera["far"], width=self.w,
                                       height=self.h, device=self.device)
                         for pos, ori in self.poses]
            self.t_dev = [torch.tensor(t, device=self.device)
                          for t in self.times]
            t0 = time.perf_counter()
            with torch.no_grad():
                splats = materialize_splats(trainer_scene(
                    scene, self.seed ^ SEED_SALT_TARGET, self.device))
                self.targets = [
                    render_splats4d(splats, self.cams[v // len(self.times)],
                                    self.t_dev[v % len(self.times)],
                                    cfg=self.cfg)[..., :3].contiguous()
                    for v in range(self.n_views)]
                del splats
            self.sync()
            parts["targets_s"] = time.perf_counter() - t0 - lib_s[0]
            self.fitter = Fitter(
                params, None, float(self.mix["learning_rate"]), self.cfg,
                float(self.mix["ssim_weight"]),
                D.DensifyConfig(opt_reset=self.mix["opt_reset"]),
                int(self.mix["densify_every"]), None, self.seed)
            del params
            t1, lib0 = time.perf_counter(), lib_s[0]
            for _ in range(int(self.mix["warmup_steps"])):
                self.step()
            parts["warmup_s"] = time.perf_counter() - t1 - (lib_s[0] - lib0)
        finally:
            _build.load_library = load
        parts["libraries_s"] = lib_s[0]
        return parts

    def overrides(self) -> dict:
        """The configuration's render knobs set apart from the automatic
        configuration's (by the program's names)."""
        return dict(self.config["render"].get("overrides", {}))

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def view_of(self, i: int) -> int:
        """The view step i trains (each epoch's order drawn once)."""
        epoch = i // self.n_views
        if self._order[0] != epoch:
            self._order = (epoch, view_order(self.seed, self.n_views, epoch))
        return self._order[1][i % self.n_views]

    def step(self):
        """The fitter's next step, its loss read back: (view, loss)."""
        v = self.view_of(self.fitter.steps_done)
        loss = self.fitter.step(self.targets[v],
                                self.t_dev[v % len(self.times)],
                                self.cams[v // len(self.times)])
        return v, loss.item()

    # ---- the measured window ---------------------------------------------

    def window(self, seconds: float) -> dict:
        """Steps in a closed loop for `seconds`: frame_ms is the window's
        wall time over its steps, the captures of the checked steps left
        out; each step's own time is read from CUDA events recorded before
        its first and after its last operation."""
        torch = self.torch
        cuda = self.device.type == "cuda"
        marks = [f * seconds for f in check_fractions(
            self.seed, int(self.mix["checked_steps"]))]
        lossy0 = self.fitter.lossy.clone()
        times_ms = []
        off_s = 0.0
        t_start = time.perf_counter()
        n = 0
        while True:
            t_step = time.perf_counter() - t_start - off_s
            check = (bool(marks) and marks[0] <= t_step
                     and not self.fitter.densify_due())
            if check:
                t0 = time.perf_counter()
                before = self.capture_before()
                off_s += time.perf_counter() - t0
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t_host = time.perf_counter()
            v, loss = self.step()
            if cuda:
                end.record()
                end.synchronize()
                times_ms.append(start.elapsed_time(end))
            else:
                times_ms.append((time.perf_counter() - t_host) * 1e3)
            if check:
                t0 = time.perf_counter()
                self.kept.append(self.capture_after(before, v, loss))
                marks.pop(0)
                off_s += time.perf_counter() - t0
            n += 1
            if time.perf_counter() - t_start - off_s >= seconds:
                break
        wall = time.perf_counter() - t_start - off_s
        self.steps_in_window = n
        self.lossy_window = self.fitter.lossy - lossy0
        # Places the window did not reach: steps after it, off the clock.
        while marks:
            if self.fitter.densify_due():
                self.step()
                continue
            before = self.capture_before()
            v, loss = self.step()
            self.kept.append(self.capture_after(before, v, loss))
            marks.pop(0)
        return dict(attempted=n, frame_ms=wall * 1e3 / n,
                    frame_p95_ms=percentile(times_ms, 95.0),
                    frame_median_ms=statistics.median(times_ms),
                    window_s=wall)

    def capture_before(self) -> dict:
        """The parameters and Adam's state before the next step."""
        f = self.fitter
        state = {}
        for k, p in f.params.items():
            st = f.opt.state.get(p, {})
            state[k] = ((st["exp_avg"].clone(), st["exp_avg_sq"].clone(),
                         int(st["step"])) if st else (None, None, 0))
        return dict(step=f.steps_done, state=state,
                    params={k: p.detach().clone()
                            for k, p in f.params.items()})

    def capture_after(self, before: dict, v: int, loss: float) -> dict:
        """The checked step's view, loss, gradients, counters and the
        parameters after it, beside what `capture_before` took."""
        f = self.fitter
        return dict(before, view=v, loss=loss, target=self.targets[v],
                    grads={k: p.grad.clone() for k, p in f.params.items()},
                    after={k: p.detach().clone()
                           for k, p in f.params.items()},
                    counters={k: float(f.aux[k]) for k in COUNTERS
                              if k in f.aux})

    def failed(self) -> int:
        """Steps of the window whose loss counters are not 0: pairs over
        the budget, pairs lost to the compaction, or transmittance left
        behind the converged frame (the fitter's count on the device, read
        once)."""
        n = int(self.lossy_window)
        self.lossy = dict(lossy_steps=n, steps=self.steps_in_window)
        return n

    # ---- the traced steps -------------------------------------------------

    def clear_events(self, n: int):
        """Run steps until none of the next n is a densify event."""
        while any(self.fitter.densify_due(self.fitter.steps_done + j)
                  for j in range(n)):
            self.step()

    def trace(self):
        """Profile traced_steps steps with no densify event among them,
        then run as many again with the kernel wrappers recording their
        launches' bounds: (Trace, Recorder)."""
        from harness.roofline import Recorder
        from harness.trace import profile_units
        n = int(self.mix["traced_steps"])
        self.clear_events(n)
        tr = profile_units(lambda i: self.step(),
                           range(self.fitter.steps_done,
                                 self.fitter.steps_done + n), self.device)
        self.clear_events(n)
        with Recorder(self.root) as rec:
            for _ in range(n):
                self.step()
        return tr, rec

    # ---- the comparison with the reference --------------------------------

    def release(self):
        """Free the program's state before the reference runs (the checked
        steps' captures and targets stay)."""
        self.fitter = self.targets = self.cams = self.cfg = None
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def reference_step(self, kept: dict, records_dtype=None):
        """The reference's (loss, grads, counters) at a captured step."""
        import torch
        from reference import fit_step as RF
        v = kept["view"]
        position, orientation = self.poses[v // len(self.times)]
        cfg = RF.R.frame_config(int(self.config["scene"]["pad_to"]), self.w,
                                self.h, self.overrides())
        return RF.loss_and_grads(
            kept["params"], kept["target"], position, orientation,
            self.times[v % len(self.times)], self.w, self.h,
            self.camera["far"], cfg, float(self.mix["ssim_weight"]),
            records_dtype or torch.float32)

    def well_conditioned(self, kept: dict):
        from reference import fit_step as RF
        v = kept["view"]
        position, orientation = self.poses[v // len(self.times)]
        return RF.well_conditioned(kept["params"], position, orientation,
                                   self.times[v % len(self.times)], self.w,
                                   self.h, self.camera["far"])

    def gaps(self, kept: dict, loss, grads, after, ref_loss, ref_grads,
             ref_after, ref_counters, got_counters) -> dict:
        """The compared numbers of one step: (loss, grads, parameters after,
        counters) against the reference's."""
        from reference import fit_step as RF
        rows = self.well_conditioned(kept)
        before = kept["params"]
        norm_gaps = {k: norm_gap(grads[k][rows], ref_grads[k][rows])
                     for k in RF.FIELDS}
        return dict(
            loss_gap=abs(loss - float(ref_loss)) / abs(float(ref_loss)),
            grad_gap=max(norm_gaps[k] for k in GRAD_FIELDS),
            update_gap=max(field_gap(after[k] - before[k],
                                     ref_after[k] - before[k])
                           for k in RF.FIELDS),
            counter_gap=(abs(got_counters["overflowed"]
                             - ref_counters["overflowed"])
                         + abs(got_counters["compact_dropped"]
                               - ref_counters["compact_dropped"])),
            ill_conditioned=int((~rows).sum()), field_norm_gaps=norm_gaps)

    def adam(self, kept: dict, grads, dtype=None):
        import torch
        from reference import fit_step as RF
        return RF.adam_update(kept["params"], grads, kept["state"],
                              float(self.mix["learning_rate"]),
                              dtype or torch.float32)

    def compare(self) -> dict:
        """Each checked step against the reference (the module docstring
        names the numbers): the largest of each over the steps, and each
        step's."""
        per_step = []
        for kept in self.kept:
            ref_loss, ref_grads, ref_counters = self.reference_step(kept)
            per_step.append(self.gaps(
                kept, kept["loss"], kept["grads"], kept["after"], ref_loss,
                ref_grads, self.adam(kept, kept["grads"]), ref_counters,
                kept["counters"]))
            del ref_grads
        return self._summary(per_step)

    def control(self, records_dtype) -> dict:
        """The reference computed in `records_dtype` (its records, and its
        Adam on its own gradients), in the program's place, at the checked
        steps: the same numbers."""
        per_step = []
        for kept in self.kept:
            ref_loss, ref_grads, ref_counters = self.reference_step(kept)
            loss, grads, counters = self.reference_step(kept, records_dtype)
            per_step.append(self.gaps(
                kept, float(loss), grads,
                self.adam(kept, ref_grads, records_dtype), ref_loss,
                ref_grads, self.adam(kept, ref_grads), ref_counters,
                counters))
        return self._summary(per_step)

    def _summary(self, per_step: List[dict]) -> dict:
        out = {}
        for name in ("loss_gap", "grad_gap", "update_gap", "counter_gap"):
            vals = [s[name] for s in per_step]
            out[name] = max(vals) if vals else None
        out["steps"] = [k["step"] for k in self.kept]
        out["per_step"] = per_step
        return out
