"""The result line and BENCHMARK.json keep to the benchmark's format;
without a card the run prints no result and fails."""

import json
import re
import subprocess
import sys

import pytest

from harness import report
from harness.spec import BENCH, ROOT, Cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_result_has_its_keys_in_order():
    checks = {"image_gap": dict(value=1e-7, limit=1e-4)}
    res = report.result(True, 300, 0,
                        {"frame_ms": dict(value=31.5, unit="ms")},
                        dict(platform="gpu", kind="NVIDIA H100 80GB HBM3",
                             count=1, memory_peak_bytes=123),
                        checks, dict(setup_parts={"scene_s": 0.1}))
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["metrics"]["frame_ms"] == {"value": 31.5, "unit": "ms"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert report.checks_ok(checks)
    assert not report.checks_ok({"image_gap": dict(value=2e-4, limit=1e-4)})
    assert not report.checks_ok({"image_gap": dict(value=None, limit=1e-4)})
    assert not report.checks_ok({})


def test_forbidden_modules_compare_whole_names():
    assert report.forbidden_modules(["fourdgs_torch.render", "torch"]) == []
    assert report.forbidden_modules(["fourdgs.render", "jax.numpy",
                                     "jaxlib", "flaxen"]) == [
        "fourdgs", "jax", "jaxlib"]


def test_without_a_card_no_result_and_a_failing_code():
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "cube-10m-keep64.orbit-1080p", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        env=dict(__import__("os").environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_benchmark_json_keeps_to_its_format():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        names.add(c["name"])
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        cells.add(w["name"])
    e2e = {}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        e2e[m["name"]] = m
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= cells
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in BENCHMARK["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(name):
    cell = Cell(name)
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer()
