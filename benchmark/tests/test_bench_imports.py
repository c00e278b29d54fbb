"""No module that the benchmark's run imports has `jax`, `jaxlib`, `flax`
or `fourdgs` (the JAX package) as its top-level name, compared whole
(`fourdgs_torch` begins with `fourdgs` and is the program); the plain
reference imports nothing of the program."""

import ast
import json
import subprocess
import sys

import pytest

from harness.spec import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "fourdgs"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_source_of_the_benchmark_imports_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")))
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"fourdgs_torch",
                                                       "harness"})


DRIVE = r"""
import json, sys, time
sys.path[:0] = [{bench!r}, {root!r}]
import torch
from harness.spec import Cell, load_module
run = load_module(__import__("pathlib").Path({bench!r}) / "run.py", "r")
cell = Cell("cube-10m-keep64.orbit-1080p")
cell.config = dict(cell.config, scene=dict(cell.config["scene"],
                                           n_splats=4096))
cell.mix = dict(cell.mix, width=256, height=128)
for m in cell.per_layer():
    cell.metric_reader(m["name"])
import harness.trace, harness.roofline
res = run.run_cell(cell, 5, 0.3, False, torch.device("cpu"),
                   time.perf_counter())
names = sorted({{m.split(".", 1)[0] for m in sys.modules}})
print(json.dumps(dict(correct=res["correct"], names=names)))
"""

REFERENCE_ONLY = r"""
import json, sys
sys.path[:0] = [{bench!r}]
from reference import converged_frame
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def test_a_driven_run_loads_no_jax_and_no_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", DRIVE.format(bench=str(BENCH),
                                            root=str(ROOT))],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert "fourdgs_torch" in out["names"]
    assert not set(out["names"]) & FORBIDDEN


def test_the_reference_alone_loads_nothing_of_the_program():
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_ONLY.format(bench=str(BENCH))],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not names & (FORBIDDEN | {"fourdgs_torch", "harness"})
