"""Where the backbone's time goes, region by region, on one NVIDIA card.

The port's counterpart of scripts/stage_timing.py (which stays as it is):
the full-width GRNet (HRNet-W32 + PARE + synthetic SMPL, random weights
from SEED) at batch 128 on 224 crops, the backbone cut after each region
with `stop_after` ("stem", "layer1", "stage2", "stage3", "stage4", then
the whole backbone), then the PARE head on the backbone's features and
SMPL's regression on the head's outputs. Each time is the median of REPS
forwards after two warm-up ones, from CUDA events; a region's own time
is the difference of two cumulative ones.

    python3 scripts/torch_stage_timing.py              # float32 and high
    python3 scripts/torch_stage_timing.py float32,high+l1act16

A mode is one of scripts/torch_precision_study.py's names ("float32":
TF32 off; "high": the runner's, three TF32 passes, the upsampling head at
w2x, the PARE head at default; the variants' suffixes). Prints one JSON
object with the card's name and power limit.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys

import numpy as np

# the study's mode names and views; importing it puts the repo on sys.path
from torch_precision_study import at_mode

BATCH = 128
SEED = 0
REPS = 5
MODES = ("float32", "high")
STOPS = ("stem", "layer1", "stage2", "stage3", "stage4", "")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def events_ms(fn, reps: int = REPS) -> float:
    """Median device time of one call of fn (CUDA events), after two
    warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ops(prof) -> list:
    """The key_averages() entries of a torch.profiler profile that are
    work on the card: kernels, copies and memsets. A record_function range
    (the port's spans among them) is also reported on the card, as a user
    annotation over the work it held; it is left out, as torch's own device
    total leaves it out, so that nothing is counted twice."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def crops(device, n: int = BATCH, seed: int = SEED + 11):
    """n normalized NHWC crops of unit-scale noise."""
    import torch

    x = np.random.default_rng(seed).normal(size=(n, 224, 224, 3))
    return torch.from_numpy(x.astype(np.float32)).to(device)


def region_times(model, x, mode: str) -> dict:
    """{region: cumulative backbone ms} for each stop_after, then "head"
    and "smpl" (each alone), at `mode`; x is NHWC."""
    import torch

    from gaitlab_torch.nn.grnet import vp_regress

    run = at_mode(model, mode)
    core = run.module
    x = x.permute(0, 3, 1, 2).contiguous()
    out = {}
    with torch.inference_mode():
        for stop in STOPS:
            backbone = copy.copy(core.backbone)
            backbone.stop_after = stop
            out[stop or "backbone"] = events_ms(lambda: backbone(x))
        feats = core.backbone(x)
        out["head"] = events_ms(lambda: core.head(feats))
        patt = core.head(feats)
        out["smpl"] = events_ms(lambda: vp_regress(run.smpl, patt))
    return out


def deltas(times: dict) -> dict:
    """Each region's own ms from region_times' cumulative ones."""
    own, prev = {}, 0.0
    for stop in STOPS:
        name = stop or "heads"
        t = times[stop or "backbone"]
        own[name] = t - prev
        prev = t
    return own


def main(argv: list) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_stage_timing: CUDA is not available", file=sys.stderr)
        return 1
    from gaitlab_torch.nn.grnet import GRNet

    modes = argv[0].split(",") if argv else list(MODES)
    model = GRNet.create(seed=SEED)
    x = crops(model.device)
    res = {"script": "scripts/torch_stage_timing.py", "card": card(),
           "torch": torch.__version__, "batch": BATCH, "modes": {}}
    for mode in modes:
        times = region_times(model, x, mode)
        res["modes"][mode] = {"cumulative_ms": times,
                              "region_ms": deltas(times)}
        log(f"[stage_timing] {mode}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in deltas(times).items())
            + f"; head {times['head']:.3f}, smpl {times['smpl']:.3f} ms")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
