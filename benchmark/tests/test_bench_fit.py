"""The fit cell, `cube-1m.fit-1080p`, on the CPU at a tiny size: the kind
`fit` (benchmark/traffic/fit.py) through run.run_cell with the program's
plain versions in place of its kernels, correct when sound and not correct
under a stale gradient or under the bfloat16 control; the seven `.fit`
readers on a trace fixture of two steps, and the launch partition of a
step; the bounds of K8 and K9, recorded where a fit step's backward calls
their wrappers, and taken after the earlier bound files; every listed
per-layer metric with a tested reader."""

import time

import pytest
import torch

from harness import roofline
from harness.spec import BENCH, ROOT, Cell, load_module
from harness.trace import Trace, kernel_names

RUN = load_module(BENCH / "run.py", "bench_run_for_fit")
CELL = "cube-1m.fit-1080p"
SEED = 2 ** 31 + 4321
FIT_METRICS = ("launches_per_step.fit", "idle_share.fit", "forward_ms.fit",
               "backward_ms.fit", "optimizer_ms.fit", "bwd_kernels_ms.fit",
               "kernel_roofline.fit")
LAYERS = ("fourdgs::forward", "fourdgs::backward", "fourdgs::optimizer",
          "fourdgs::densify")


def tiny(n=2048):
    """The cell at 2,048 splats in 4,096 slots, 2 cameras x 2 times at
    256x128, the cube shrunk so that the splats cover pixels."""
    cell = Cell(CELL)
    cell.config = dict(cell.config, views=4, scene=dict(
        cell.config["scene"], n_splats=n, pad_to=2 * n, half_extent=60.0,
        scale_range=[6.0, 16.0]))
    cell.mix = dict(cell.mix, width=256, height=128, cameras=2, times=2,
                    warmup_steps=1, densify_every=4, traced_steps=2)
    return cell


def run_tiny(seconds=1.0):
    return RUN.run_cell(tiny(), SEED, seconds, False, torch.device("cpu"),
                        time.perf_counter())


def test_the_cell_is_listed_with_its_parts():
    cell = Cell(CELL)
    assert cell.kind == "fit" and cell.chips == 1
    assert cell.config["reference"] == "fit_step"
    assert {m["name"] for m in cell.end_to_end()} == {
        "frame_ms", "frame_p95_ms", "setup_s"}
    assert [m["name"] for m in cell.per_layer()] == list(FIT_METRICS)
    for m in cell.per_layer():
        assert m["workloads"] == [CELL] and m["moves"] == "frame_ms"
        assert hasattr(cell.metric_reader(m["name"]), "read")
    assert set(RUN.limits_for(cell)) == {
        "loss_gap", "grad_gap", "update_gap", "counter_gap"}
    mod = cell.traffic_module()
    assert mod.view_times(16)[0] == pytest.approx(1 / 32)
    assert len(mod.ring_poses(cell.config["camera"], 16, SEED)) == 16


def test_the_rig_keeps_distance_and_elevation_and_shuffles_each_epoch():
    import math
    cell = Cell(CELL)
    mod = cell.traffic_module()
    cam = cell.config["camera"]
    d0 = math.dist(cam["position"], (0, 0, 0))
    poses = mod.ring_poses(cam, 16, SEED)
    assert poses == mod.ring_poses(cam, 16, SEED)
    for pos, ori in poses:
        assert math.dist(pos, (0, 0, 0)) == pytest.approx(d0, rel=1e-12)
        assert pos[1] == cam["position"][1] and ori[1] == cam["orientation"][1]
    az = sorted(math.degrees(math.atan2(p[0], p[2])) % 360 for p, _ in poses)
    assert [b - a for a, b in zip(az, az[1:])] == pytest.approx([22.5] * 15)
    e0, e1 = mod.view_order(SEED, 256, 0), mod.view_order(SEED, 256, 1)
    assert sorted(e0) == list(range(256)) and e0 != e1
    assert e0 == mod.view_order(SEED, 256, 0)


def test_sound_program_is_correct():
    res = run_tiny()
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    assert res["checks"]["counter_gap"]["value"] == 0
    assert len(res["checks"]) == 4


def test_a_stale_gradient_is_not_correct(monkeypatch):
    # Adam steps on gradients that were never cleared: every step's
    # gradient is the sum of all the steps' so far.
    monkeypatch.setattr(torch.optim.Adam, "zero_grad",
                        lambda self, set_to_none=True: None)
    res = run_tiny()
    assert res["correct"] is False
    assert res["checks"]["grad_gap"]["value"] > \
        res["checks"]["grad_gap"]["limit"]


def test_the_bfloat16_control_is_not_correct():
    cell = tiny()
    run = cell.traffic_module().Run(cell, SEED, torch.device("cpu"))
    run.setup()
    run.window(0.5)
    assert run.failed() == 0
    run.release()
    got = run.control(torch.bfloat16)
    limits = RUN.limits_for(cell)
    over = {k for k, limit in limits.items() if got[k] > limit}
    assert over == {"loss_gap", "grad_gap", "update_gap"}, got
    assert got["counter_gap"] == 0


def test_k8_and_k9_bounds_are_recorded_inside_the_backward():
    cell = tiny()
    run = cell.traffic_module().Run(cell, SEED, torch.device("cpu"))
    run.setup()
    with roofline.Recorder(ROOT) as rec:
        run.step()
        run.step()
    # K8 once a step; K9 once for the main stream, once for the big tier.
    assert rec.calls["K8"] == 2 and rec.calls["K9"] == 4
    assert rec.calls["K1"] == 2 and rec.calls["K7"] == 4
    assert rec.bounds["K8"] > 0 and rec.bounds["K9"] > 0


def test_the_recorder_takes_k8_and_k9_after_the_earlier_bounds():
    # The earlier bound files' entries, as test_bench_bounds.py lists them,
    # then K8's and K9's in the files' name order.
    earlier = load_module(BENCH / "tests" / "test_bench_bounds.py",
                          "bench_bounds_tests_for_fit").ENTRIES
    assert [e[:3] for e in roofline.wrappers(ROOT)] == earlier + [
        ("fourdgs_torch.ops.composite_cuda", "composite_records_bwd", "K8"),
        ("fourdgs_torch.ops.tail_cuda", "tail_accumulate_bwd", "K9")]


def bound_fn(kernel):
    mod = load_module(BENCH / "bounds" / f"{kernel}.py",
                      f"bench_bounds_fit_{kernel}")
    (entry,) = mod.WRAPPERS
    return entry


def test_k8_bound_counts_the_records_and_the_pixels_once():
    mod, attr, kernel, fn = bound_fn("K8")
    assert (mod, attr, kernel) == ("fourdgs_torch.ops.composite_cuda",
                                   "composite_records_bwd", "K8")
    records = torch.zeros(4, 16, 9)
    counts = torch.tensor([3, 0, 7, 2], dtype=torch.int32)
    kx = torch.zeros(4, 1, 128)
    args = (records, counts, None, kx, kx, None, None, None)
    # 12 live records of 16 words read and written, 16 B of counts, 26
    # words a pixel of 4 tiles of 128 pixels.
    assert fn(args, {}, records) == (2 * 12 * 64 + 16 + 4 * 128 * 4 * 26,
                                     12 * 128 * roofline.PAIR_TEST_OPS)


def test_k9_bound_counts_the_slots_under_the_budget():
    mod, attr, kernel, fn = bound_fn("K9")
    assert (mod, attr, kernel) == ("fourdgs_torch.ops.tail_cuda",
                                   "tail_accumulate_bwd", "K9")
    meta = torch.zeros((6, 40), dtype=torch.int32)
    meta[5] = torch.arange(40, dtype=torch.int32) % 11
    fields, out = torch.zeros(10, 40), torch.zeros(10, 40)
    args = (fields, meta, torch.zeros(40, dtype=torch.int32),
            torch.zeros(5, dtype=torch.int32), torch.zeros(8),
            torch.zeros(16, 6 * 8), None)
    kw = dict(budget=4, budget_lo=0, s_cy=1, s_cx=8)
    slots = int(meta[5].clamp(max=4).sum())
    moved = (1600 + 960 + 160 + 20 + 32 + 16 * 48 * 4 + 1600)
    assert fn(args, kw, out) == (moved,
                                 slots * 8 * roofline.PAIR_TEST_OPS)


# ---- the readers, on a trace fixture of two steps ------------------------

# (name, start, end) of the host ranges of one step, in us: the four layer
# ranges inside fourdgs::fit_step, the frame and the loss in the forward,
# the Functions' backward ranges opened on autograd's thread inside the
# step thread's fourdgs::backward.
RANGES = [("fourdgs::fit_step", 0, 1000), ("fourdgs::optimizer", 5, 15),
          ("fourdgs::forward", 15, 400), ("fourdgs::frame", 40, 350),
          ("fourdgs::loss", 350, 390), ("fourdgs::backward", 400, 800),
          ("fourdgs::tail_bwd", 450, 520),
          ("fourdgs::composite_bwd", 520, 600),
          ("fourdgs::optimizer", 800, 900), ("fourdgs::densify", 900, 980)]
# (launch time, device start, duration, name, category) of one step.
OPS = [(50, 60, 40, "void composite_kernel<256>(float const*)", "kernel"),
       (60, 100, 10, "void at::elementwise_kernel<128, 4>(int)", "kernel"),
       (360, 360, 20, "void at::avg_pool2d_out_cuda_frame<float>()",
        "kernel"),
       (460, 470, 50, "_Z15tail_bwd_kernel6StreamPKi", "kernel"),
       (470, 530, 30, "_Z15tail_bwd_kernel6StreamPKi", "kernel"),
       (530, 560, 100, "void composite_bwd_kernel<256>(float const*)",
        "kernel"),
       (700, 700, 30, "void at::elementwise_kernel<128, 4>(int)", "kernel"),
       (810, 810, 40, "void at::multi_tensor_apply_kernel<>()", "kernel"),
       (910, 910, 10, "void at::reduce_kernel<512, 1>()", "kernel"),
       (990, 990, 5, "Memset (Device)", "gpu_memset"),
       # The loss read after the step, outside fourdgs::fit_step.
       (1005, 1005, 2, "Memcpy DtoH (Device -> Pageable)", "gpu_memcpy")]
STEP_STARTS = (0, 3000)
UNIT_US = 1010
# Each launch's layer range (None: under fourdgs::fit_step alone; "out":
# outside the step).
LAYER_OF = ["fourdgs::forward"] * 3 + ["fourdgs::backward"] * 4 + [
    "fourdgs::optimizer", "fourdgs::densify", None, "out"]


def fixture_events():
    ev, corr = [], 0
    for base in STEP_STARTS:
        ev.append(dict(ph="X", cat="user_annotation", name="bench::unit",
                       ts=base, dur=UNIT_US, tid=1))
        for name, s, e in RANGES:
            tid = 2 if name.endswith("_bwd") else 1
            ev.append(dict(ph="X", cat="user_annotation", name=name,
                           ts=base + s, dur=e - s, tid=tid))
        for launch, start, dur, name, cat in OPS:
            corr += 1
            tid = 2 if 400 <= launch < 800 else 1
            ev.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                           ts=base + launch, dur=2, tid=tid,
                           args=dict(correlation=corr)))
            ev.append(dict(ph="X", cat=cat, name=name, ts=base + start,
                           dur=dur, args=dict(correlation=corr)))
    return ev


def context(bound_s=1.2e-4, wall_ms=2.0):
    names = kernel_names(BENCH.parent / "fourdgs_torch" / "ops" / "csrc")
    return RUN.Context("step", Trace(fixture_events()), wall_ms, bound_s,
                       names)


EXPECTED = {
    "launches_per_step.fit": 10.0,
    # busy: [60, 110] + [360, 380] + [470, 520] + [530, 660] + [700, 730]
    # + [810, 850] + [910, 920] + [990, 995] + [1005, 1007] = 337 us a
    # step.
    "idle_share.fit": 100.0 * (1.0 - 0.337 / 2.0),
    "forward_ms.fit": 0.070,
    "backward_ms.fit": 0.210,
    "optimizer_ms.fit": 0.040,
    "bwd_kernels_ms.fit": 0.180,
    # 2 x (40 + 50 + 30 + 100) us of hand-written kernels against 120 us
    # of bound.
    "kernel_roofline.fit": 100.0 * 120.0 / 440.0,
}


@pytest.mark.parametrize("name", FIT_METRICS)
def test_fit_reader_reads_the_fixture(name):
    reader = Cell(CELL).metric_reader(name)
    assert reader.read(context()) == pytest.approx(EXPECTED[name])


def test_every_listed_metric_has_a_tested_reader_with_the_fit_cell():
    # The frame's readers are tested in test_bench_metrics.py and
    # test_bench_layer_launches.py, the fit cell's here.
    frame = load_module(BENCH / "tests" / "test_bench_metrics.py",
                        "bench_metrics_tests_for_fit")
    names = {m["name"] for m in Cell(CELL).bench["per_layer"]}
    assert names == (set(frame.EXPECTED) | set(frame.LAYER_TESTS.NEW)
                     | set(FIT_METRICS))


@pytest.mark.parametrize("name", FIT_METRICS)
def test_fit_reader_reads_nothing_in_a_frame_trace(name):
    reader = Cell(CELL).metric_reader(name)
    ctx = context()
    ctx.unit = "frame"
    assert reader.read(ctx) is None


def test_the_layer_ranges_partition_a_steps_launches():
    tr = Trace(fixture_events())
    assert tr.n_units == 2 and len(tr.ops) == 2 * len(OPS)
    counts = dict.fromkeys(LAYERS + ("fit_step alone",), 0)
    for i, o in enumerate(tr.ops):
        r = o["ranges"]
        want = LAYER_OF[i % len(OPS)]
        if want == "out":
            assert "fourdgs::fit_step" not in r
            continue
        layers = [x for x in r if x in LAYERS]
        assert layers == ([want] if want else []), (o["name"], r)
        counts[layers[0] if layers else "fit_step alone"] += 1
    per_step = sum(counts.values()) / tr.n_units
    launches = Cell(CELL).metric_reader("launches_per_step.fit")
    assert per_step == launches.read(context())
    # The backward's launches from autograd's thread fall in the step
    # thread's fourdgs::backward and in the Functions' own ranges.
    bwd = [o for o in tr.ops if "bwd_kernel" in o["name"]]
    assert bwd and all("fourdgs::backward" in o["ranges"] for o in bwd)
