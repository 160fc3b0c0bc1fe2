"""The readings that the check's limits are set from: the program's
numbers over many seeds, and the control's (the program at precision
"default", one TF32 pass, in place of float32 with TF32 off), each seed a
full set-up, window and check at the cell's own sizes, all in one process
on the card.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--control]

Prints one JSON line per seed: the seed, `correct`, the check's numbers
and the end-to-end metrics. The benchmark's own runs (run.py) never run
this."""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import spec
    from benchmark.harness.runner import Run

    if not torch.cuda.is_available():
        print("readings need the card", file=sys.stderr)
        return 3
    cell = spec.Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = Run(cell, seed, torch.device("cuda:0"),
                  precision="default" if args.control else None)
        res = run.execute(args.seconds, False, time.time())
        print(json.dumps({
            "workload": cell.name, "seed": seed, "control": args.control,
            "correct": res["correct"], "attempted": res["attempted"],
            "check": {k: v["value"] for k, v in res["check"].items()},
            "metrics": {k: v["value"] for k, v in res["metrics"].items()}}),
            flush=True)
        del run, res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
