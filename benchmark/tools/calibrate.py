#!/usr/bin/env python3
"""Readings that set the benchmark's limits, on the chip, in one process.

    python3 benchmark/tools/calibrate.py --workload <cell> --seeds 1,2,...
        [--control-seeds 1,2,3] [--seconds 3] [--turn] [--json PATH]

For each seed of --seeds: the cell's set-up from that seed, a short window
at the cell's own load (--seconds), the failed frames, and the numbers the
run compares (the program's frames against the plain reference). For each
seed of --control-seeds, also the control: the reference with its records
in bfloat16 in the program's place, at the same frames. With --turn, one
whole turn of the orbit after the first seed's window, with every frame's
loss counters. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
COUNTERS = ("overflowed", "compact_dropped", "resid_transmittance",
            "prune_underkeep", "live_pairs", "max_tile_pairs")


def turn_counters(run, n_frames: int) -> dict:
    """Every frame of one turn after the window: the largest of each loss
    counter, the frames where any is not 0, and each frame's time."""
    import torch
    rows, times = [], []
    for i in range(run.frames_done, run.frames_done + n_frames):
        t0 = time.perf_counter()
        _, aux = run.frame(i)
        times.append((time.perf_counter() - t0) * 1e3)
        rows.append(torch.stack([aux[k].float() for k in COUNTERS]))
    table = torch.stack(rows).cpu()
    lossy = (table[:, :3] != 0).any(dim=1).nonzero().squeeze(1).tolist()
    return dict(frames=n_frames,
                max={k: float(table[:, j].max())
                     for j, k in enumerate(COUNTERS)},
                min={k: float(table[:, j].min())
                     for j, k in enumerate(COUNTERS)},
                lossy_frames=lossy, frame_ms_min=min(times),
                frame_ms_max=max(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--turn", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import torch
    from harness import report
    from harness.spec import Cell

    cell = Cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    torch.cuda.init()
    torch.zeros(1, device=device)
    out = dict(workload=args.workload, card=report.card(0),
               torch=torch.__version__, cuda=torch.version.cuda,
               python=sys.version.split()[0], seeds=[])
    print(json.dumps({k: out[k] for k in ("card", "torch", "cuda",
                                          "python")}), flush=True)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run = cell.traffic_module().Run(cell, seed, device)
        torch.cuda.reset_peak_memory_stats(device)
        parts = run.setup()
        values = run.window(args.seconds)
        failed = run.failed()
        rec = dict(seed=seed, setup_parts=parts, window=values,
                   failed=failed, attempted=values["frames"],
                   lossy=run.lossy,
                   memory_peak_bytes=torch.cuda.max_memory_allocated(device))
        if args.turn and n == 0:
            per_turn = round(360.0 / cell.mix["deg_per_frame"])
            rec["turn"] = turn_counters(run, per_turn)
        run.release()
        t0 = time.perf_counter()
        rec["program"] = run.compare()
        rec["reference_s"] = time.perf_counter() - t0
        if seed in controls:
            t0 = time.perf_counter()
            rec["control"] = run.control(torch.bfloat16)
            rec["control_s"] = time.perf_counter() - t0
        run.kept = []
        del run
        torch.cuda.empty_cache()
        out["seeds"].append(rec)
        print(json.dumps(rec), flush=True)
    found = report.forbidden_modules()
    out["forbidden_modules"] = found
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    print(json.dumps(dict(
        workload=args.workload,
        program_image_gap=[r["program"]["image_gap"] for r in out["seeds"]],
        program_counter_gap=[r["program"]["counter_gap"]
                             for r in out["seeds"]],
        control_image_gap=[r["control"]["image_gap"] for r in out["seeds"]
                           if "control" in r],
        control_counter_gap=[r["control"]["counter_gap"]
                             for r in out["seeds"] if "control" in r],
        failed=[r["failed"] for r in out["seeds"]],
        forbidden_modules=found)))
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
