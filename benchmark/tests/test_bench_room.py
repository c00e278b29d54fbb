"""A cell is added with new files and entries alone. In a copy of
BENCHMARK.json and benchmark/, a configuration with a reference of its own
and that reference's limits file, a traffic kind whose unit is a step and
whose comparison gives another number than `image_gap`, a per-layer metric
and a kernel's bound, all new files, run through run.run_cell from the
copy's root: the new limit decides `correct`, the kernel's bound is
recorded, and no file that was in the copy changes."""

import json
import re
import shutil
import time
from pathlib import Path

import pytest
import torch

from harness import roofline
from harness.spec import BENCH, ROOT, Cell, load_module

RUN = load_module(BENCH / "run.py", "bench_run_for_room")
CELL = "room-cfg.room-steps"
SEED = 2 ** 31 + 77
N_SPLATS = 256
LIMIT = 1e-3

KIND = '''"""Traffic kind `room_step`: a fixed number of steps, each the
projection of a small scene through the program's wrapper, reduced to a
loss; the comparison gives the largest loss gap against the projection's
plain composition."""

import time


class Run:
    trace_unit = "step"
    wall_metric = "step_ms"

    def __init__(self, cell, seed, device):
        self.config, self.mix = cell.config, cell.mix
        self.seed, self.device, self.root = seed, device, cell.root
        self.losses = []

    def setup(self):
        from fourdgs_torch.core.camera import Camera
        from harness.scene import cube_params
        t0 = time.perf_counter()
        cam = self.config["camera"]
        self.params = cube_params(self.config["scene"], self.seed,
                                  self.device)
        self.camera = Camera.create(
            position=cam["position"], orientation=cam["orientation"],
            far=cam["far"], width=self.mix["width"],
            height=self.mix["height"], device=self.device)
        return {"scene_s": time.perf_counter() - t0}

    def step(self, i):
        from fourdgs_torch.ops import project_cuda
        proj = project_cuda.project_params4d(self.params, self.camera,
                                             i / self.mix["steps"])
        return float(proj.mx.sum())

    def window(self, seconds):
        n = int(self.mix["steps"])
        t0 = time.perf_counter()
        self.losses = [self.step(i) for i in range(n)]
        return dict(attempted=n,
                    step_ms=(time.perf_counter() - t0) * 1e3 / n)

    def failed(self):
        return 0

    def trace(self):
        from harness.roofline import Recorder
        from harness.trace import Trace
        events = []
        for unit, base in enumerate((0, 2000)):
            events += [
                dict(ph="X", cat="user_annotation", name="bench::unit",
                     ts=base, dur=1000),
                dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                     ts=base + 10, dur=1, args=dict(correlation=unit)),
                dict(ph="X", cat="kernel", name="project4d_kernel",
                     ts=base + 20, dur=300, args=dict(correlation=unit))]
        with Recorder(self.root) as rec:
            for i in range(2):
                self.step(i)
        return Trace(events), rec

    def release(self):
        pass

    def compare(self):
        from fourdgs_torch.ops.project_cuda import project4d_plain
        n = len(self.losses)
        want = [float(project4d_plain(self.params, self.camera, i / n)
                      .mx.sum()) for i in range(n)]
        return dict(loss_gap=max(abs(a - b)
                                 for a, b in zip(self.losses, want)),
                    steps=list(range(n)))
'''

METRIC = '''"""Device operations a traced step."""


def read(ctx):
    if ctx.unit != "step" or not ctx.trace.ops:
        return None
    return len(ctx.trace.ops) / ctx.trace.n_units
'''

BOUND = '''"""A kernel's bound added by a new file: the projection's x means."""

from harness.roofline import nbytes


def _mx(args, kw, out):
    return nbytes(out.mx), 0


WRAPPERS = [("fourdgs_torch.ops.project_cuda", "project_params4d", "Kroom",
             _mx)]
'''


def files_under(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def add_cell(root):
    """Write the new cell's files and its BENCHMARK.json entries."""
    b = root / "benchmark"
    cube = json.loads((b / "configs" / "cube-10m.json").read_text())
    config = dict(name="room-cfg", reference="room_ref",
                  camera=cube["camera"],
                  scene=dict(cube["scene"], n_splats=N_SPLATS))
    (b / "configs" / "room-cfg.json").write_text(json.dumps(config))
    (b / "reference" / "room_ref.limits.json").write_text(
        json.dumps({"loss_gap": LIMIT}))
    (b / "traffic" / "room-steps.json").write_text(json.dumps(
        dict(kind="room_step", steps=4, width=64, height=32)))
    (b / "traffic" / "room_step.py").write_text(KIND)
    (b / "metrics" / "ops_per_step.room.py").write_text(METRIC)
    (b / "bounds" / "Kroom.py").write_text(BOUND)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(
        name="room-cfg", source="https://example.org/room",
        file="benchmark/configs/room-cfg.json", reduced=[],
        why="a cell added by new files"))
    bench["workloads"].append(dict(
        name=CELL, config="room-cfg", traffic="room-steps", chips=1,
        why="a few projection steps of a small scene"))
    bench["end_to_end"].append(dict(
        name="step_ms", unit="ms", better="lower", bound=0.1,
        source="host_clock", workloads=[CELL]))
    bench["per_layer"].append(dict(
        name="ops_per_step.room", unit="ops/step", better="lower",
        source="device_trace", layer="room", moves="step_ms",
        workloads=[CELL]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


@pytest.fixture
def copy(tmp_path):
    """A copy of BENCHMARK.json and benchmark/ with the new cell, and the
    copy's files as they were before the cell was added."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    before = files_under(tmp_path)
    add_cell(tmp_path)
    return tmp_path, before


def run(root, trace):
    return RUN.run_cell(Cell(CELL, root), SEED, 0.1, trace,
                        torch.device("cpu"), time.perf_counter())


def test_a_cell_of_new_files_runs_under_its_own_limit(copy, capsys):
    root, before = copy
    res = run(root, trace=False)
    assert res["correct"] is True
    assert res["attempted"] == 4 and res["failed"] == 0
    assert res["checks"] == {"loss_gap": dict(value=0.0, limit=LIMIT)}
    assert set(res["metrics"]) == {"step_ms", "setup_s"}
    err = capsys.readouterr().err
    assert f"compared: loss_gap 0.0 (limit {LIMIT!r}); also " \
        '{"steps": [0, 1, 2, 3]}' in err

    res = run(root, trace=True)
    assert res["correct"] is True
    assert res["metrics"] == {"ops_per_step.room": dict(value=1.0,
                                                        unit="ops/step")}
    assert res["roofline_calls"] == {"Kroom": 2}
    assert res["roofline_bounds_s"] == {
        "Kroom": 2 * roofline.bound_s(4 * N_SPLATS, 0)}

    after = files_under(root)
    old = json.loads(before.pop(Path("BENCHMARK.json")))
    new = json.loads(after[Path("BENCHMARK.json")])
    for key, value in old.items():
        assert (new[key][:len(value)] if isinstance(value, list)
                else new[key]) == value
    assert {p: after[p] for p in before} == before


def test_a_number_over_its_own_limit_is_not_correct(copy, monkeypatch):
    from fourdgs_torch.ops import project_cuda
    project = project_cuda.project_params4d

    def off(params, camera, t, *a, **k):
        out = project(params, camera, t, *a, **k)
        out.mx.add_(1.0)
        return out
    monkeypatch.setattr(project_cuda, "project_params4d", off)
    res = run(copy[0], trace=False)
    assert res["correct"] is False
    assert res["checks"]["loss_gap"]["value"] > LIMIT


def test_a_reference_without_its_limits_file_is_an_error(copy):
    root, _ = copy
    path = root / "benchmark" / "reference" / "room_ref.limits.json"
    path.unlink()
    with pytest.raises(FileNotFoundError, match=re.escape(str(path))):
        run(root, trace=False)
