"""Host busy time by stage of the PyTorch port's one-pass pipeline, and
the card's busy share, on one NVIDIA card.

The port's counterpart of scripts/onepass_util.py (which stays as it
is). It runs pipeline/stream.run_video_onepass (one decode for
detection, SORT, host crops and ForwardStream's bucketed forwards on a
worker thread) over the standard synthetic corridor-walk clip (2000
frames at 1920x1080, bench_e2e.py's; this script keeps its own copy of
make_clip) with the runner that fetches theta, kp_3d and kp_2d (full-
width GRNet, random weights from SEED, synthetic SMPL): one warm-up run,
then a timed run with a StageTimer, then a run under torch.profiler for
the card's busy time. It reports the wall time, frames/s, the host's
busy seconds by stage (decode, detect, sort, crop, feed, finish), their
sum as a share of the wall (host_busy_fraction) and the unattributed
rest, and on the card the crops' host-to-card MB and the card's kernel
seconds over the timed run's wall (device_busy_fraction). The stages
run on the calling thread, the forwards' launches on ForwardStream's
worker, so they overlap the stages and show only where a stage waits
for them (feed, finish). host_cores is os.cpu_count(); gaitlab's tunnel probes and its
one-core note have no counterpart here.

    python3 scripts/torch_onepass_util.py                 # 2000 frames
    python3 scripts/torch_onepass_util.py --frames 200 --clip_dir /tmp/c

The clip is made once and cached under --clip_dir
(~/.cache/gaitlab_torch/bench). Writes docs/TORCH_ONEPASS_UTILIZATION.json
(or --out) with the card's name and power limit. With --device cpu the
model runs on the CPU and no device metric is reported; without it, a
box without CUDA raises.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
import time

import numpy as np

from torch_precision_study import REPO
from torch_stage_timing import SEED, card

N_FRAMES = 2000
W, H = 1920, 1080          # reference batch_generation operating point
CACHE = osp.expanduser("~/.cache/gaitlab_torch/bench")
CROP_BYTES = 224 * 224 * 3
OUT = osp.join(REPO, "docs", "TORCH_ONEPASS_UTILIZATION.json")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_clip(path: str, n: int = N_FRAMES) -> None:
    """Synthetic corridor-walk clip: static background + moving person."""
    import cv2

    rng = np.random.default_rng(0)
    bg = rng.integers(35, 75, size=(H, W, 3)).astype(np.uint8)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 20.0,
                             (W, H))
    for i in range(n):
        frame = bg.copy()
        x = int(100 + (W - 400) * (0.5 + 0.5 * np.sin(i / 150.0)))
        y = 300 + int(30 * np.sin(i / 7.0))
        cv2.rectangle(frame, (x, y), (x + 130, y + 520), (205, 185, 175), -1)
        cv2.circle(frame, (x + 65, y + 60), 45, (195, 165, 155), -1)
        writer.write(frame)
    writer.release()


def device_seconds(fn) -> tuple[float, float]:
    """(kernel and copy seconds on the card, wall seconds) of fn() under
    torch.profiler, ending in a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / 1e6, wall


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--clip_dir", default=CACHE)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card (raises without CUDA)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    from gaitlab_torch.device import resolve_device
    from gaitlab_torch.nn.grnet import GRNet
    from gaitlab_torch.pipeline import stream
    from gaitlab_torch.pipeline.runner import GRNetRunner
    from gaitlab_torch.utils import StageTimer

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    os.makedirs(args.clip_dir, exist_ok=True)
    clip = osp.join(args.clip_dir, f"e2e_{args.frames}_{W}x{H}.mp4")
    if not osp.isfile(clip):
        t0 = time.perf_counter()
        make_clip(clip, args.frames)
        log(f"[onepass] wrote {clip} in {time.perf_counter() - t0:.1f} s")

    model = GRNet.create(seed=SEED, device=dev)
    runner = GRNetRunner(model, fetch=("theta", "kp_3d", "kp_2d"))
    t0 = time.perf_counter()
    stream.run_video_onepass(runner, clip)  # warm-up: every bucket met
    warm_s = time.perf_counter() - t0

    timer = StageTimer()
    sync()
    t0 = time.perf_counter()
    res = stream.run_video_onepass(runner, clip, timer=timer)
    sync()
    wall = time.perf_counter() - t0
    busy = dict(timer.stages)
    busy_total = sum(busy.values())
    frames = sum(len(r["frames"]) for r in res.values())
    out = {
        "script": "scripts/torch_onepass_util.py",
        "card": card() if on_card else None,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "torch": torch.__version__,
        "clip": f"{args.frames} frames {W}x{H} (bench_e2e synthetic)",
        "host_cores": os.cpu_count(),
        "warmup_s": warm_s,
        "wall_s": wall,
        "fps": args.frames / wall,
        "tracks": {str(k): len(r["frames"]) for k, r in res.items()},
        "host_busy_s": dict(sorted(busy.items(), key=lambda kv: -kv[1])),
        "host_busy_total_s": busy_total,
        "host_busy_fraction": busy_total / wall,
        "unattributed_s": wall - busy_total,
        "note": ("host_busy stages run on the calling thread; forwards "
                 "launch on ForwardStream's worker thread and show in a "
                 "stage only where it waits for them (feed, finish)"),
    }
    if on_card:
        dev_s, prof_wall = device_seconds(
            lambda: stream.run_video_onepass(runner, clip))
        out.update(crop_h2d_mb=frames * CROP_BYTES / 1e6,
                   device_busy_s=dev_s, profiled_wall_s=prof_wall,
                   device_busy_fraction=dev_s / wall)
    log(f"[onepass] {json.dumps(out)}")
    os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
