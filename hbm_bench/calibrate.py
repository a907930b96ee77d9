"""Readings that set a cell's correctness limit (not part of a run).

    python3 -m hbm_bench.calibrate --workload <cell> --seeds 1,2,3 \\
        --seconds <s> [--control] [--trace 1]

For each seed, one run of the cell at its own load and the numbers it
compares: the program's readings (the lower end of a limit) or, with
``--control``, the control's -- the reference at the next precision below
the configuration's (float8 weights) put in the program's place, judged
by the run's own comparison, so its ``correct`` must read false (the
upper end; the program's readings on the same sample are printed beside
them).  The cell's metrics of the group (end-to-end, or per-layer with
``--trace 1``) are printed too.  One process serves every seed; each line
of standard output is one seed's JSON.
"""
from __future__ import annotations

import argparse
import json
import sys

from hbm_bench import run as R


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = json.loads((R.ROOT / "BENCHMARK.json").read_text())
    group = "per_layer" if args.trace else "end_to_end"
    cell = next(w for w in spec["workloads"] if w["name"] == args.workload)
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    names = [m["name"] for m in spec[group]
             if "workloads" not in m or args.workload in m["workloads"]]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(R.ROOT / "src"))
    cfg = json.loads((R.ROOT / conf["file"]).read_text())
    mix = R.load_mix(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = R.time.time()
        out = R.run_cell(cfg, mix, seed=seed, seconds=args.seconds,
                         trace=bool(args.trace), device="cuda",
                         metric_names=names, checks=cfg["checks"],
                         t_start=t0, control=args.control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control,
                          "correct": out["correct"],
                          "checks": out["checks"], "sample": out["sample"],
                          "finished": out["finished"],
                          "window": out["window"],
                          "attempted": out["attempted"],
                          "metrics": out["metrics"],
                          "memory_peak_bytes": out["memory_peak_bytes"],
                          "busy_s": out.get("busy_s"),
                          "window_s": out.get("window_s"),
                          "breakdown": out.get("breakdown")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
