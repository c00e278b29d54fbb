"""Finding a cell's parts by name.

`BENCHMARK.json` at the checkout's root names the cell's configuration and
traffic mix and lists the metrics. Each part is a file of its own:

  benchmark/configs/<config>.json     the configuration as it is run
  benchmark/traffic/<traffic>.json    the traffic mix: {"kind": ..., params}
  benchmark/traffic/<kind>.py         the general generator of that kind
  benchmark/metrics/<metric>.py       one per-layer metric: read(ctx)

so that a later cell, mix or metric is added with new files and entries
only.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_module(path: Path, name: str) -> ModuleType:
    """Import the Python file `path` as module `name`."""
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _name_token(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


class Cell:
    """One entry of BENCHMARK.json's workloads, with its configuration,
    traffic mix, generator and metrics."""

    def __init__(self, workload: str, root: Path = ROOT):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        entries = [w for w in bench["workloads"] if w["name"] == workload]
        if len(entries) != 1:
            raise KeyError(f"no cell {workload!r} in BENCHMARK.json")
        self.entry = entries[0]
        self.name = workload
        self.chips = int(self.entry["chips"])
        self.bench = bench
        self.config = json.loads(
            (root / "benchmark" / "configs" /
             f"{self.entry['config']}.json").read_text())
        self.mix = json.loads(
            (root / "benchmark" / "traffic" /
             f"{self.entry['traffic']}.json").read_text())
        self.kind = self.mix["kind"]
        self.run_seconds = bench["run_seconds"]
        self.root = root

    def traffic_module(self) -> ModuleType:
        return load_module(self.root / "benchmark" / "traffic" /
                           f"{self.kind}.py",
                           f"bench_traffic_{_name_token(self.kind)}")

    def end_to_end(self) -> List[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        """The per-layer metrics read in this cell's traced run: those that
        list it, and those without a list that move an end-to-end metric it
        reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(self.root / "benchmark" / "metrics" / f"{name}.py",
                           f"bench_metric_{_name_token(name)}")
