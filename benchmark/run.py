#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (`fourdgs_torch`): one run of one
cell on one machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

The cell is an entry of BENCHMARK.json's workloads: a configuration
(benchmark/configs/<config>.json) under a traffic mix
(benchmark/traffic/<traffic>.json, whose `kind` names its generator,
benchmark/traffic/<kind>.py). The run makes its inputs from the seed, sets
up and warms up the program, measures for `--seconds`, compares what the
measured window produced with the plain reference (benchmark/reference/),
each compared number against its limit in
benchmark/reference/<reference>.limits.json, and prints one JSON object as
the last line of standard output: correct, attempted, failed, metrics (the
cell's end-to-end metrics, or with --trace 1 its per-layer metrics, each
read by benchmark/metrics/<name>.py from a profiler trace, and the kernels'
bounds recorded through benchmark/bounds/<kernel>.py), device, and last the
numbers compared, each beside its limit (also the last lines of standard
error).

It exits with a code other than 0, and prints no result, when no CUDA
device is there (or fewer than the cell asks for), or when JAX or the JAX
package is loaded in the process once the window has closed.
"""

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / "_cache"


class Context:
    """What a per-layer metric reader reads: the reduced trace of the
    traced units, the wall ms of a unit in the unprofiled window, the sum
    of the recorded launches' bounds, and a test for hand-written kernel
    names."""

    def __init__(self, unit, trace, wall_ms_per_unit, bound_s, kernel_names):
        self.unit, self.trace = unit, trace
        self.wall_ms_per_unit, self.bound_s = wall_ms_per_unit, bound_s
        self._kernel = re.compile(
            r"(?<![A-Za-z_])(" + "|".join(map(re.escape, kernel_names))
            + r")(?![a-z_])") if kernel_names else None

    def is_kernel(self, name: str) -> bool:
        return bool(self._kernel and self._kernel.search(name))


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def limits_for(cell) -> dict:
    """The limit of each number the cell's comparison gives, from its
    reference's file under the cell's checkout:
    benchmark/reference/<reference>.limits.json."""
    path = (cell.root / "benchmark" / "reference" /
            f"{cell.config['reference']}.limits.json")
    if not path.is_file():
        raise FileNotFoundError(f"no limits file {path} for the reference "
                                f"{cell.config['reference']!r}")
    return json.loads(path.read_text())


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             clock0: float = CLOCK0, marks=None):
    """One run of `cell` on `device`: set-up, the window, with `trace` the
    traced frames, then the comparison. Returns the result object (the
    checks last)."""
    import torch
    from harness import report
    cuda = device.type == "cuda"
    limits = limits_for(cell)
    run = cell.traffic_module().Run(cell, seed, device)
    parts = dict(marks or {})
    parts.update(run.setup())
    setup_s = time.perf_counter() - clock0
    values = run.window(seconds)
    values["setup_s"] = setup_s
    failed = run.failed()
    attempted = values["attempted"]
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    # A traffic kind may keep a report of its failures in `run.lossy`.
    print(f"window: {json.dumps(values)}; set-up parts {json.dumps(parts)}; "
          f"failed {failed} of {attempted}: "
          f"{json.dumps(getattr(run, 'lossy', None))}", file=sys.stderr)

    metrics, extra = {}, {}
    busy_s = window_s = None
    if trace:
        from harness.trace import kernel_names
        tr, rec = run.trace()
        ctx = Context(run.trace_unit, tr, values[run.wall_metric],
                      rec.total_s(),
                      kernel_names(ROOT / "fourdgs_torch" / "ops" / "csrc"))
        for m in cell.per_layer():
            value = cell.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        busy_s = tr.busy_us() / 1e6
        window_s = tr.window_us() / 1e6
        extra["breakdown"] = tr.breakdown()
        extra["roofline_bounds_s"] = rec.bounds
        extra["roofline_calls"] = rec.calls
    else:
        for m in cell.end_to_end():
            metrics[m["name"]] = dict(value=values[m["name"]],
                                      unit=m["unit"])

    run.release()
    t0 = time.perf_counter()
    got = run.compare()
    extra["reference_s"] = time.perf_counter() - t0
    checks = {name: dict(value=got.get(name), limit=limit)
              for name, limit in limits.items()}
    also = {k: v for k, v in got.items() if k not in checks}
    print("compared: " + ", ".join(
        f"{name} {c['value']!r} (limit {c['limit']!r})"
        for name, c in checks.items())
        + f"; also {json.dumps(also, default=repr)}", file=sys.stderr)
    extra.update(card=report.card(0) if cuda else None, setup_parts=parts,
                 window=values)
    device_info = (report.device_block(torch, cell.chips, memory_peak,
                                       busy_s, window_s) if cuda
                   else dict(platform="cpu", kind="cpu", count=0))
    return report.result(report.checks_ok(checks), attempted, failed,
                         metrics, device_info, checks, extra)


def main(argv=None) -> int:
    args = parse_args(argv)
    # Build and kernel caches at fixed places inside the checkout.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    for p in (str(ROOT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness import report
    from harness.spec import Cell

    cell = Cell(args.workload, ROOT)
    import torch
    marks = {"torch_import_s": time.perf_counter() - CLOCK0}
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: the cell needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    torch.cuda.init()
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    marks["cuda_init_s"] = time.perf_counter() - t0
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, CLOCK0, marks)
    card = result.get("card") or {}
    print(f"card: {torch.cuda.get_device_name(0)}, power limit "
          f"{card.get('power_limit')}", file=sys.stderr)
    found = report.forbidden_modules()
    if found:
        print(f"run.py: the process holds {found}", file=sys.stderr)
        return 3
    report.print_checks(result["checks"])
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
