#!/usr/bin/env python3
"""The loss counters of whole turns of an orbit cell, on the chip, in one
process.

    python3 benchmark/tools/loss_sweep.py --workload <cell> --seeds 1,2,...
        [--keeps 32,64] [--json PATH]

For each seed of --seeds: the cell's set-up from that seed, then for each
row-sort keep of --keeps (the configuration's own when none is given) one
whole turn of the orbit from the seed's start (the poses every window of
that seed renders, since the orbit repeats each turn), with every frame's
loss counters and the mean frame time. A seed given twice is set up twice,
from nothing. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
COUNTERS = ("overflowed", "compact_dropped", "resid_transmittance")


def turn(run, n_frames: int) -> dict:
    """Frames 0..n_frames-1: the frames where a loss counter is not 0, the
    sums and largest values of the counters, and the mean frame time."""
    import torch
    rows = []
    t0 = time.perf_counter()
    for i in range(n_frames):
        _, aux = run.frame(i)
        rows.append(torch.stack([aux[k].float() for k in COUNTERS]))
    ms = (time.perf_counter() - t0) * 1e3 / n_frames
    table = torch.stack(rows).cpu()
    lossy = (table != 0).any(dim=1).nonzero().squeeze(1).tolist()
    return dict(frames=n_frames, lossy_frames=lossy, n_lossy=len(lossy),
                sums={k: float(table[:, j].sum())
                      for j, k in enumerate(COUNTERS)},
                max={k: float(table[:, j].max())
                     for j, k in enumerate(COUNTERS)},
                frame_ms=ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--keeps", default="")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import torch
    from harness import report
    from harness.spec import Cell

    cell = Cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    torch.cuda.init()
    out = dict(workload=args.workload, card=report.card(0), seeds=[])
    print(json.dumps(out["card"]), flush=True)
    keeps = [int(k) for k in args.keeps.split(",") if k]
    per_turn = round(360.0 / cell.mix["deg_per_frame"])
    for seed in (int(s) for s in args.seeds.split(",")):
        run = cell.traffic_module().Run(cell, seed, device)
        run.setup()
        from fourdgs_torch.render.autoconfig import auto_render_config
        rec = dict(seed=seed, keeps={})
        for keep in keeps or [run.cfg.sort_compact_keep_cols]:
            over = dict(run.overrides(), sort_compact_keep_cols=keep)
            run.cfg = auto_render_config(
                int(cell.config["scene"]["n_splats"]), run.w, run.h,
                converged=True, **over)
            run.frame(0)
            rec["keeps"][keep] = turn(run, per_turn)
        run.release()
        del run
        torch.cuda.empty_cache()
        out["seeds"].append(rec)
        print(json.dumps(rec), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    print(json.dumps({str(r["seed"]): {k: v["n_lossy"]
                                       for k, v in r["keeps"].items()}
                      for r in out["seeds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
