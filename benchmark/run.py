"""The benchmark of gaitlab_torch: one cell of BENCHMARK.json, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the weights, SMPL's tensors and the frames on the card from
--seed and hands them to the architecture that the cell's configuration
names (benchmark/arch/<arch>.py): it calibrates the random weights where
they need it (BatchNorm statistics, with the reference's code) and builds
the program's model and runner with them; one track then runs at each
forward size the cell's traffic uses. The window takes the seed's tracks
in turn through the runner's `run_track` for --seconds, then finishes the
deck of track lengths it is on. With --trace 0 the last line of standard
output is the cell's end-to-end metrics; with --trace 1 the window (at
most the traffic's `trace_seconds`) runs under torch.profiler with the
configuration's stage hooks, and the line holds the per-layer metrics,
the card's busy and window seconds and a breakdown. Either way, once the
window has closed and its peak memory is read, the program is freed and
the kept tracks are run through the architecture's plain reference
(benchmark/reference) and compared; `correct` says whether every number
is within its limit, and each number is printed beside its limit on
standard error and under "check", the result's last key.

Exits 3 without a result where CUDA is absent or has fewer cards than the
cell asks for, and 4 where a module of JAX or of the JAX package was
loaded. `--control` runs the program at precision "default" (one TF32
pass), the control of the check; the benchmark's own runs never pass it.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """This process's start on the clock of time.time()."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "gaitlab")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: gaitlab_torch is not gaitlab)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from benchmark.harness import spec

    cell = spec.Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"[bench] {cell.name} needs {cell.chips} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, count: "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    log(f"[bench] process start to imports {time.time() - T_START:.3f} s")
    from benchmark.harness.runner import Run

    run = Run(cell, args.seed, torch.device("cuda:0"),
              precision="default" if args.control else None)
    res = run.execute(args.seconds, bool(args.trace), T_START,
                      card=card_line)
    bad = forbidden_modules()
    if bad:
        log(f"[bench] loaded modules of {bad}: the run may not load JAX or "
            "the JAX package")
        return 4
    for name, row in res["check"].items():
        log(f"check {name} {row['value']!r} limit {row['limit']!r}")
    print(__import__("json").dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
