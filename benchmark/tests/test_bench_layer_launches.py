"""The launch counts by layer and the tail's set-up time, read from
hand-made traces: project_launches, bin_launches, head_launches,
tail_launches and entry_launches partition launches_per_frame, an operation
under `fourdgs::tail` counts to the tail and not to the head, the camera's
copies count to the entry; tail_setup_ms reads the device time under
`fourdgs::tail_setup`."""

import json

import pytest

from harness.spec import BENCH, Cell, load_module
from harness.trace import Trace

RUN = load_module(BENCH / "run.py", "bench_run_for_layer_tests")
CELLS = ("cube-10m-keep64.orbit-1080p", "cube-10m.orbit-4k")
COUNTS = ("project_launches.view", "bin_launches.view", "head_launches.view",
          "tail_launches.view", "entry_launches.view")
NEW = COUNTS + ("tail_setup_ms.view",)

# (name, start, end) of the host ranges of one frame, in us: the camera
# made before the render call, the call's own range around its stages.
RANGES = [("fourdgs::camera", 2, 8), ("fourdgs::frame", 10, 950),
          ("fourdgs::project", 20, 200), ("fourdgs::bin_sort", 200, 500),
          ("fourdgs::emit", 210, 300), ("fourdgs::composite", 500, 900),
          ("fourdgs::pass1_kernel", 540, 580), ("fourdgs::tail", 600, 850),
          ("fourdgs::tail_setup", 600, 640), ("fourdgs::tail_main", 650, 800)]
# (launch time, device start, duration, name, category) of one frame.
OPS = [(4, 5, 2, "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy"),
       (15, 15, 3, "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy"),
       (30, 100, 50, "void at::elementwise_kernel<128, 4>(int)", "kernel"),
       (250, 300, 100, "void cub::DeviceRadixSortOnesweepKernel<int>()",
        "kernel"),
       (450, 450, 20, "rowsort_lists_kernel(int const*, int const*)",
        "kernel"),
       (550, 560, 30, "void composite_kernel<256>(float const*)", "kernel"),
       (620, 620, 10, "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy"),
       (630, 640, 5, "sample_blocks_kernel(int const*)", "kernel"),
       (700, 700, 80, "_Z11tail_kernel6StreamPKiiPKf", "kernel"),
       (920, 925, 4, "void at::elementwise_kernel<128, 4>(int)", "kernel")]
FRAME_STARTS = (0, 2000)
FRAME_US = 1000

EXPECTED = {
    "project_launches.view": 1.0,
    "bin_launches.view": 2.0,
    "head_launches.view": 1.0,
    "tail_launches.view": 3.0,
    # The camera's copy, one before the projection, one after the composite.
    "entry_launches.view": 3.0,
    # The memcpy at 620 us and K3 at 630 us.
    "tail_setup_ms.view": 0.015,
}


def events(ranges=RANGES, ops=OPS):
    ev, corr = [], 0
    for base in FRAME_STARTS:
        ev.append(dict(ph="X", cat="user_annotation", name="bench::unit",
                       ts=base, dur=FRAME_US))
        for name, s, e in ranges:
            ev.append(dict(ph="X", cat="user_annotation", name=name,
                           ts=base + s, dur=e - s))
        for launch, start, dur, name, cat in ops:
            corr += 1
            ev.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                           ts=base + launch, dur=1,
                           args=dict(correlation=corr)))
            ev.append(dict(ph="X", cat=cat, name=name, ts=base + start,
                           dur=dur, args=dict(correlation=corr)))
    # A launch between the frames: not any frame's.
    ev.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                   ts=1500, dur=1, args=dict(correlation=999)))
    ev.append(dict(ph="X", cat="kernel", name="composite_kernel", ts=1500,
                   dur=400, args=dict(correlation=999)))
    return ev


def context(ev, unit="frame"):
    return RUN.Context(unit, Trace(ev), 1.0, 1e-4, ["composite_kernel"])


def read(name, ctx):
    return Cell(CELLS[0]).metric_reader(name).read(ctx)


@pytest.mark.parametrize("name", NEW)
def test_layer_reader_reads_the_fixture(name):
    assert read(name, context(events())) == pytest.approx(EXPECTED[name])


def without(*names):
    return [r for r in RANGES if r[0] not in names]


@pytest.mark.parametrize("ranges", [
    RANGES,
    # A program without the frame's, the camera's and the set-up's ranges.
    without("fourdgs::frame", "fourdgs::camera", "fourdgs::tail_setup"),
    # No tail: the composite's operations are all the head's.
    without("fourdgs::tail", "fourdgs::tail_setup", "fourdgs::tail_main"),
    # No range at all: every operation is the entry's.
    [],
], ids=["program", "no-new-ranges", "no-tail", "no-ranges"])
def test_five_counts_partition_the_launches(ranges):
    ctx = context(events(ranges))
    total = read("launches_per_frame.view", ctx)
    assert total == len(OPS)
    assert sum(read(n, ctx) or 0.0 for n in COUNTS) == total


def test_a_tail_operation_counts_to_the_tail_not_the_head():
    ctx = context(events())
    tail_op = [(710, 710, 5, "_Z11tail_kernel6StreamPKiiPKf", "kernel")]
    more = context(events(ops=OPS + tail_op))
    assert read("tail_launches.view", more) == read(
        "tail_launches.view", ctx) + 1
    assert read("head_launches.view", more) == read("head_launches.view",
                                                    ctx)
    # Without the tail's range every operation under the composite is the
    # head's: K1, the three under the tail and the new one.
    bare = without("fourdgs::tail", "fourdgs::tail_setup",
                   "fourdgs::tail_main")
    assert read("head_launches.view", context(events(bare, OPS + tail_op))
                ) == 5
    assert read("tail_launches.view", context(events(bare))) is None


def test_a_camera_operation_counts_to_the_entry():
    camera_ops = [(5, 9, 1, "Memcpy HtoD (Pageable -> Device)",
                   "gpu_memcpy")] * 5
    ctx = context(events(ops=OPS + camera_ops))
    assert read("entry_launches.view", ctx) == EXPECTED[
        "entry_launches.view"] + 5
    for name in COUNTS[:4]:
        assert read(name, ctx) == EXPECTED[name]
    # Only the camera and the frame's glue: the stages' counts read nothing.
    only = context(events(ops=[OPS[0], OPS[1], OPS[-1]]))
    assert read("entry_launches.view", only) == 3.0
    assert all(read(name, only) is None for name in COUNTS[:4])


def test_readers_find_nothing_return_nothing():
    # The parent program opens no `fourdgs::tail_setup`.
    ctx = context(events(without("fourdgs::tail_setup")))
    assert read("tail_setup_ms.view", ctx) is None
    assert read("tail_launches.view", ctx) == EXPECTED["tail_launches.view"]
    no_ops = [e for e in events() if e["cat"] not in ("kernel",
                                                      "gpu_memcpy")]
    for name in NEW:
        assert read(name, context(no_ops)) is None
        assert read(name, context(events(), unit="step")) is None


def test_new_metrics_are_listed_for_both_cells():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    layers = {m["layer"] for m in entries.values() if m["name"] not in NEW}
    for name in NEW:
        m = entries[name]
        assert m["workloads"] == list(CELLS)
        assert (m["source"], m["moves"], m["better"]) == (
            "device_trace", "frame_ms", "lower")
        assert m["unit"] == ("ms" if name.endswith("_ms.view")
                             else "ops/frame")
        assert m["layer"] in layers
    for cell in CELLS:
        assert set(NEW) <= {m["name"] for m in Cell(cell).per_layer()}
