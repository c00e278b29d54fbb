"""Each per-layer metric reader turns a recorded trace into its number.

The fixture is a chrome trace of two traced frames, laid out by hand so
that every reading is known: host ranges of the program (`fourdgs::*`),
launches with correlation ids, and the device operations they launched,
one of them outside every frame."""

import pytest

from harness.spec import BENCH, Cell, load_module
from harness.trace import Trace, kernel_names, union_s

RUN = load_module(BENCH / "run.py", "bench_run_for_tests")

# (name, start, end) of the host ranges of one frame, in us.
RANGES = [("fourdgs::project", 10, 200), ("fourdgs::bin_sort", 200, 500),
          ("fourdgs::emit", 210, 300), ("fourdgs::composite", 500, 900),
          ("fourdgs::tail", 600, 850), ("fourdgs::tail_main", 650, 800)]
# (launch time, device start, duration, name, category) of one frame.
OPS = [(20, 100, 50, "void at::elementwise_kernel<128, 4>(int)", "kernel"),
       (250, 300, 100, "void cub::DeviceRadixSortOnesweepKernel<int>()",
        "kernel"),
       (450, 450, 20, "rowsort_lists_kernel(int const*, int const*)",
        "kernel"),
       (550, 560, 30, "void composite_kernel<256>(float const*)", "kernel"),
       (700, 700, 80, "_Z11tail_kernel6StreamPKiiPKf", "kernel"),
       (620, 620, 10, "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy")]
FRAME_STARTS = (0, 2000)
FRAME_US = 1000


def fixture_events():
    ev, corr = [], 0
    for base in FRAME_STARTS:
        ev.append(dict(ph="X", cat="user_annotation", name="bench::unit",
                       ts=base, dur=FRAME_US))
        for name, s, e in RANGES:
            ev.append(dict(ph="X", cat="user_annotation", name=name,
                           ts=base + s, dur=e - s))
        for launch, start, dur, name, cat in OPS:
            corr += 1
            ev.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                           ts=base + launch, dur=3, args=dict(correlation=corr)))
            ev.append(dict(ph="X", cat=cat, name=name, ts=base + start,
                           dur=dur, args=dict(correlation=corr)))
    # A launch between the frames: not any frame's.
    ev.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                   ts=1500, dur=3, args=dict(correlation=999)))
    ev.append(dict(ph="X", cat="kernel", name="composite_kernel", ts=1500,
                   dur=400, args=dict(correlation=999)))
    return ev


def context(bound_s=1.3e-4, wall_ms=1.0):
    names = kernel_names(BENCH.parent / "fourdgs_torch" / "ops" / "csrc")
    return RUN.Context("frame", Trace(fixture_events()), wall_ms, bound_s,
                       names)


EXPECTED = {
    "launches_per_frame.view": 6.0,
    "idle_share.view": 100.0 * (1.0 - 0.290 / 1.0),
    "project_ms.view": 0.050,
    "bin_ms.view": 0.120,
    "head_ms.view": 0.030,
    "tail_ms.view": 0.090,
    # 2 x (20 + 30 + 80) us of hand-written kernels against 130 us of bound.
    "kernel_roofline.view": 50.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_fixture(name):
    reader = Cell("cube-10m-keep64.orbit-1080p").metric_reader(name)
    assert reader.read(context()) == pytest.approx(EXPECTED[name])


def test_every_listed_metric_has_a_tested_reader():
    names = {m["name"] for m in Cell("cube-10m-keep64.orbit-1080p").bench[
        "per_layer"]}
    assert names == set(EXPECTED)


@pytest.mark.parametrize("name", ["project_ms.view", "tail_ms.view",
                                  "kernel_roofline.view"])
def test_reader_finds_nothing_returns_nothing(name):
    ev = [e for e in fixture_events() if e["cat"] not in ("kernel",
                                                          "gpu_memcpy")]
    reader = Cell("cube-10m-keep64.orbit-1080p").metric_reader(name)
    ctx = RUN.Context("frame", Trace(ev), 1.0, 1.3e-4, ["tail_kernel"])
    assert reader.read(ctx) is None


def test_trace_busy_window_and_breakdown():
    tr = Trace(fixture_events())
    assert tr.n_units == 2 and len(tr.ops) == 12
    assert tr.busy_us() == pytest.approx(580.0)
    assert tr.window_us() == pytest.approx(3000.0)
    bd = tr.breakdown()
    assert bd["device_ops"][0][0].startswith("void cub::DeviceRadixSort")
    assert bd["device_ops"][0][1] == pytest.approx(200e-6)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    # Every idle gap is named by the host range open where it starts.
    assert sum(v for _, v in bd["idle_gaps"]) == pytest.approx(
        (3000 - 100 - 580 - 220) * 1e-6)
    assert union_s([(0, 2), (1, 3), (5, 6)]) == 4


def test_kernel_names_are_the_hand_written_kernels():
    names = kernel_names(BENCH.parent / "fourdgs_torch" / "ops" / "csrc")
    assert {"composite_kernel", "tail_kernel", "tail_prepass_kernel",
            "rowsort_lists_kernel", "sample_blocks_kernel",
            "pack_record_fields_kernel"} <= set(names)
    ctx = context()
    assert ctx.is_kernel("void composite_kernel<2048>(float const*)")
    assert ctx.is_kernel("_Z11tail_kernel6StreamPKi")
    assert not ctx.is_kernel("void at::native::elementwise_kernel<128>()")
    assert not ctx.is_kernel("tail_kernel_helper")
