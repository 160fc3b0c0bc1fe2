"""Small-batch latency of the PyTorch port: ms per model step at serving
batch sizes, on one NVIDIA card.

The port's counterpart of scripts/latency_bench.py (which stays as it
is). bench-style throughput is taken at batch 128; this is the other
serving axis: how long ONE forward takes at live-camera batch sizes (a
camera feeds 1-32 crops at a time), up to 128. The model runs at exactly
b rows (GRNet.forward: the trunk at the mode's precision, then SMPL's
vp_regress), as gaitlab's `module.apply` does, not through GRNetRunner,
whose buckets would pad batch 1 to 32. Random weights from SEED,
synthetic SMPL, noise crops.

Three numbers per batch size:
  * ms_device: CUDA events around one forward, the median of --reps runs
    after two warm-up ones: the card's time for the step;
  * ms_dispatch: host wall time per forward over a chained run of
    CHAIN_ITERS forwards that ends in torch.cuda.synchronize(): what a
    caller that launches forward after forward waits;
  * ms_kernels: the forward's kernels and copies summed, from one
    forward under torch.profiler: the card's own work. Where ms_device
    exceeds it (device_busy_pct below 100), the card waited between
    kernels for the host to launch them: at small batches a forward is
    a few thousand short kernels, and the card's launch queue holds
    about 1,000, so the host's launching, not the card, sets the pace.
gaitlab's device number is the slope between a 32- and a 64-iteration
`lax.fori_loop` program, and its docstring warns of weights embedded as
jit constants: both are XLA methodology with no counterpart here (an
eager forward has no loop program to fold, and its weights are
parameters, never constants), so CUDA events replace the slope.

    python3 scripts/torch_latency_bench.py                  # float32,high
    python3 scripts/torch_latency_bench.py --modes float32 --batches 1,8
    python3 scripts/torch_latency_bench.py --device cpu --batches 1

Modes are scripts/torch_precision_study.py's names: "float32" (TF32
off, the port's default) and "high" (gaitlab's timed mode, resolved as
the runner resolves it: three TF32 passes, the upsampling head at w2x,
the PARE head at "default"). Batches default to $GAITLAB_LATENCY_BATCHES
or 1,8,16,32,64,128. Writes docs/TORCH_LATENCY.json (or --out) with the
card's name and power limit, and prints one JSON line per batch. With
--device cpu the rows hold the host's wall ms per forward (ms_cpu) and
no device metric; without it, a box without CUDA raises.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
import time

import numpy as np

# the study's mode names and views; importing it puts the repo on sys.path
from torch_precision_study import REPO, at_mode
from torch_stage_timing import SEED, card, events_ms

BATCHES = tuple(int(b) for b in os.environ.get(
    "GAITLAB_LATENCY_BATCHES", "1,8,16,32,64,128").split(","))
MODES = ("float32", "high")
CHAIN_ITERS = 16
REPS = 10
OUT = osp.join(REPO, "docs", "TORCH_LATENCY.json")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def step(run, x):
    """One model step at exactly x.shape[0] rows: `run` (a GRNet, or a view
    of one at a mode) on NHWC crops, the trunk then vp_regress ->
    (kp_3d, theta), each (1, N, ...)."""
    out = run.forward(x)[0]
    return out["kp_3d"], out["theta"]


def images(n: int, device):
    """n normalized NHWC crops of unit-scale noise from SEED."""
    import torch

    x = np.random.default_rng(SEED).normal(size=(n, 224, 224, 3))
    return torch.from_numpy(x.astype(np.float32)).to(device)


def kernel_ms(fn) -> float:
    """Device ms of one call of fn as torch.profiler sees it: the sum of
    its kernels' and copies' durations."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def chain_ms(fn, n: int, sync) -> float:
    """Host wall ms per call over n calls of fn back to back, from a
    drained device to the sync() that ends them."""
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync()
    return (time.perf_counter() - t0) / n * 1e3


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)))
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card (raises without CUDA)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    from gaitlab_torch.device import resolve_device
    from gaitlab_torch.nn.grnet import GRNet

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    batches = [int(b) for b in args.batches.split(",")]
    model = GRNet.create(seed=SEED, device=dev)
    res = {"script": "scripts/torch_latency_bench.py",
           "card": card() if on_card else None,
           "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
           "torch": torch.__version__,
           "method": "ms_device: CUDA events around one forward, median "
                     "of reps after two warm-ups; ms_dispatch: host wall "
                     "per forward over a chain of chain_iters forwards "
                     "ending in torch.cuda.synchronize(); ms_kernels: one "
                     "forward's kernels and copies summed (torch.profiler)"
                     if on_card else "ms_cpu: host wall per forward on the "
                     "CPU (no device)",
           "chain_iters": CHAIN_ITERS, "reps": args.reps, "modes": {}}
    log(f"[latency] {res['card'] or 'cpu'}; batches {batches}")
    for mode in args.modes.split(","):
        run = at_mode(model, mode)
        rows = []
        for b in batches:
            x = images(b, dev)

            def fwd():
                return step(run, x)

            t0 = time.perf_counter()
            fwd()
            sync()
            first_s = time.perf_counter() - t0
            if on_card:
                ms_device = events_ms(fwd, args.reps)
                chain_ms(fwd, 2, sync)
                ms_dispatch = chain_ms(fwd, CHAIN_ITERS, sync)
                ms_kernels = kernel_ms(fwd)
                row = {"batch": b, "ms_device": ms_device,
                       "ms_dispatch": ms_dispatch, "ms_kernels": ms_kernels,
                       "device_busy_pct": 100.0 * ms_kernels / ms_device,
                       "dispatch_over_device": ms_dispatch / ms_device,
                       "fps_device": b / ms_device * 1e3,
                       "first_call_s": first_s}
            else:
                row = {"batch": b, "ms_cpu": chain_ms(fwd, 2, sync),
                       "first_call_s": first_s}
            rows.append(row)
            print(json.dumps({"mode": mode, **row}), flush=True)
        res["modes"][mode] = rows
        del run
    os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
        f.write("\n")
    log(f"[latency] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
