"""Space-to-depth packing of HRNet's low-channel branches, timed on one
NVIDIA card.

The port's counterpart of scripts/pack_bench.py (which stays as it is):
the full-width GRNet (HRNet-W32 + PARE + synthetic SMPL, random weights
from SEED) at batch 128 on 224 crops, with `pack_low_channel` 0 (off),
32 (the 32-channel highest-resolution branch) and 64 (the 64-channel
branch too), at "float32" (TF32 off) and at the runner's "high". Packing
computes the same products on a coarser grid with 4x the channels
(layers.packed_basic_block); its kernel and BatchNorm terms are rebuilt
at each call. Reports ms per batch and frames/s (CUDA events, median of
5 after two warm-ups) and each packed run's max |kp_3d - unpacked kp_3d|
in metres at the same mode.

    python3 scripts/torch_pack_bench.py

Prints one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import sys

from torch_precision_study import at_mode
from torch_stage_timing import BATCH, SEED, card, crops, events_ms

PACKS = (0, 32, 64)
MODES = ("float32", "high")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_pack_bench: CUDA is not available", file=sys.stderr)
        return 1
    from gaitlab_torch.nn.grnet import GRNet

    model = GRNet.create(seed=SEED)
    x = crops(model.device)
    rows = []
    for mode in MODES:
        ref = None
        for pack in PACKS:
            run = at_mode(model, mode)
            run = dataclasses.replace(run, module=run.module.with_backbone(
                pack_low_channel=pack))
            kp = run.forward(x)[0]["kp_3d"]
            ref = kp if ref is None else ref
            ms = events_ms(lambda: run.forward(x))
            rows.append(dict(pack_low_channel=pack, mode=mode, ms=ms,
                             frames_per_s=BATCH / ms * 1e3,
                             max_abs_kp3d_m=(kp - ref).abs().max().item()))
            print(f"[pack_bench] {rows[-1]}", file=sys.stderr, flush=True)
    print(json.dumps({"script": "scripts/torch_pack_bench.py",
                      "card": card(), "torch": torch.__version__,
                      "batch": BATCH, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
