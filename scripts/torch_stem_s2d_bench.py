"""The stem's first convolution on the space-to-depth grid, timed on one
NVIDIA card.

The port's counterpart of scripts/stem_s2d_bench.py (which stays as it
is): HRNet-W32's conv1 sees 3 input channels; `stem_s2d` computes the
same products as a 2x2 stride-1 convolution over 12 channels on the
112x112 grid (nn/hrnet.py::stem_conv_s2d, 48 taps of which 21 are zero).
At batch 128 on 224 crops, random weights from SEED, at "float32" (TF32
off) and the runner's "high": the stem alone (stop_after="stem") and the
whole GRNet forward, standard against s2d (CUDA events, median of 5 after
two warm-ups), with the stem's max |s2d - standard| relative to its
largest value, and the forward's max |kp_3d| difference in metres.

    python3 scripts/torch_stem_s2d_bench.py

Prints one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import sys

from torch_precision_study import at_mode
from torch_stage_timing import BATCH, SEED, card, crops, events_ms

MODES = ("float32", "high")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_stem_s2d_bench: CUDA is not available", file=sys.stderr)
        return 1
    from gaitlab_torch.nn.grnet import GRNet

    model = GRNet.create(seed=SEED)
    x = crops(model.device)
    xc = x.permute(0, 3, 1, 2).contiguous()
    res = {"script": "scripts/torch_stem_s2d_bench.py", "card": card(),
           "torch": torch.__version__, "batch": BATCH}
    for mode in MODES:
        outs = {}
        for tag, s2d in (("std", False), ("s2d", True)):
            core = at_mode(model, mode).module.with_backbone(stem_s2d=s2d)
            stem = copy.copy(core.backbone)
            stem.stop_after = "stem"
            run = dataclasses.replace(model, module=core)
            with torch.inference_mode():
                outs[tag] = (stem(xc), run.forward(x)[0]["kp_3d"])
                res[f"stem_{mode}_{tag}_ms"] = events_ms(lambda: stem(xc))
            res[f"grnet_{mode}_{tag}_ms"] = events_ms(lambda: run.forward(x))
        (s0, k0), (s1, k1) = outs["std"], outs["s2d"]
        res[f"stem_{mode}_max_rel"] = ((s1 - s0).abs().max()
                                       / s0.abs().max()).item()
        res[f"grnet_{mode}_max_abs_kp3d_m"] = (k1 - k0).abs().max().item()
        print(f"[stem_s2d] {mode}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in res.items() if mode in k),
            file=sys.stderr, flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
