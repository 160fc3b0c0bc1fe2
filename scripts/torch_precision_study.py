"""Precision-mode study of the PyTorch port on one NVIDIA card.

The port's counterpart of scripts/precision_study.py (which stays as it
is): for each precision mode of gaitlab_torch, frames/s of the full-width
GRNet (HRNet-W32 + PARE + synthetic SMPL) at batch 128, and the error of
its kp_3d against the port's own float32 path (TF32 off) on the card,
which is the oracle here. A mode is qualified when its MPJPE is within
gaitlab's 0.5 mm budget; one that misses is reported all the same.

    python3 scripts/torch_precision_study.py            # every mode
    python3 scripts/torch_precision_study.py high,A:heads

Method, as gaitlab's:
  * random weights from SEED, with BatchNorm statistics calibrated on the
    study's crops first (cumulative train-mode passes), so that the output
    depends on the input; the joints' spread across frames is reported
    beside the errors, and a spread under 10 mm fails the study;
  * MPJPE (mm): the mean over frames and joints of |kp_3d - oracle|; the
    worst frame's mean is reported too, and PVE (mm) for the vertices;
  * frames/s at batch 128 from CUDA events, measured in a process of its
    own that runs before any accuracy probe (calibrating BatchNorm in the
    timing process moved gaitlab's number 2.25x).

Modes (parse_mode; gaitlab's grammar, limited to the port's modes):
  float32, high, default        the runner's modes, resolved as the runner
                                resolves them ("high": the upsample heads
                                at w2x, the head at default)
  bf16trunk, bf16trunk+high     trunk_dtype="bfloat16" at default / high
  backbone_high+rest_f32        every backbone region at high, head f32
  backbone_default+rest_f32     every backbone region at default, head f32
  bb_high+head_default          backbone high, head default, no w2x region
  A:<region>                    backbone high with one region at default,
                                head f32
  B:<r1+r2+...>                 backbone default, the listed regions high,
                                head high
  W:<r1+r2+...>                 backbone high, the listed regions w2x,
                                head default
  ...+heads_w2x, ...+heads_a2x  the upsample-head convs at two passes
  ...+resize_high               gaitlab's resize at high (the port's resize
                                does no matmul: the same numbers)
  bf16trunk+f32stem             the bf16 trunk but the stem (conv1, bn1,
                                conv2, bn2 of the backbone) in float32 at
                                high, its output cast to bf16 (cast_after)
  ...+l1act16                   layer1's residual stream stored as bf16
                                (act_store), layer1 at w2x
  ...+s2d, ...+pack             the stem on the s2d grid (stem_s2d); the
                                32-channel branches packed
                                (pack_low_channel=32): the same products
SMPL runs in float32 with TF32 off in every mode. Writes
docs/TORCH_PRECISION.json (merging rows of modes measured before) with the
card's name and power limit, and prints a markdown table.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)

BATCH = 128
SEED = 0
TIMED, WARM = 8, 2
BUDGET_MM = 0.5
REGIONS = ("stem", "layer1", "stage2", "stage3", "stage4", "heads")
MODES = ("float32", "high", "default", "bf16trunk", "bf16trunk+high",
         "backbone_high+rest_f32", "backbone_default+rest_f32",
         "bb_high+head_default", "high+heads_a2x") \
    + tuple(f"A:{r}" for r in REGIONS) \
    + ("B:stem+layer1", "B:stem+layer1+stage2", "bf16trunk+f32stem",
       "high+l1act16", "float32+s2d", "high+s2d", "float32+pack",
       "high+pack")
PACK = 32  # "+pack": pack_low_channel, W32's highest-resolution branch
STEM = ("conv1", "bn1", "conv2", "bn2")
OUT = osp.join(REPO, "docs", "TORCH_PRECISION.json")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_mode(mode: str) -> dict:
    """A mode name -> the trunk's settings: precision, head_precision,
    region_precision, resize_precision, trunk_dtype, f32_stem, and the
    backbone variants cast_after, act_store, stem_s2d, pack_low_channel."""
    resize = "highest"
    regions = ()
    variants = dict(cast_after=(), act_store=(), stem_s2d=False,
                    pack_low_channel=0)
    l1act16 = False
    while mode.endswith(("+l1act16", "+s2d", "+pack")):
        mode, suffix = mode.rsplit("+", 1)
        if suffix == "l1act16":
            l1act16 = True
            variants["act_store"] = (("layer1", "bfloat16"),)
        elif suffix == "s2d":
            variants["stem_s2d"] = True
        else:
            variants["pack_low_channel"] = PACK
    if mode.endswith("+resize_high"):
        resize, mode = "high", mode[:-len("+resize_high")]
    for suffix in ("+heads_w2x", "+heads_a2x"):
        if mode.endswith(suffix):
            regions += (("heads", suffix[-3:]),)
            mode = mode[:-len(suffix)]
    trunk, f32_stem = None, False
    if mode in ("float32", "default", "high"):
        prec, head = mode, ("default" if mode == "high" else None)
        if mode == "high":
            resize = "high"
            if not any(r == "heads" for r, _ in regions):
                regions += (("heads", "w2x"),)
    elif mode in ("bf16trunk", "bf16trunk+high"):
        trunk = "bfloat16"
        prec = "high" if mode.endswith("high") else "default"
        head = None
    elif mode == "bf16trunk+f32stem":
        trunk, f32_stem = "bfloat16", True
        prec, head = "default", None
        regions += (("stem", "high"),)
        variants["cast_after"] = (("stem", "bfloat16"),)
    elif mode in ("backbone_high+rest_f32", "backbone_default+rest_f32"):
        prec, head = "float32", "float32"
        regions += tuple((r, mode.split("_")[1].split("+")[0])
                         for r in REGIONS)
    elif mode == "bb_high+head_default":
        prec, head = "high", "default"
    elif mode.startswith("A:"):
        prec, head = "high", "float32"
        regions += ((mode[2:], "default"),)
    elif mode.startswith("B:"):
        prec, head = "default", "high"
        regions += tuple((r, "high") for r in mode[2:].split("+") if r)
    elif mode.startswith("W:"):
        prec, head = "high", "default"
        regions += tuple((r, "w2x") for r in mode[2:].split("+") if r)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if l1act16:
        regions += (("layer1", "w2x"),)
    return dict(precision=prec, head_precision=head, region_precision=regions,
                resize_precision=resize, trunk_dtype=trunk, f32_stem=f32_stem,
                **variants)


def crops(device) -> "torch.Tensor":
    """BATCH normalized NHWC crops from SEED + 11: noise of unit scale,
    each crop with its own contrast (0.5-2) and per-channel offset (-1 to
    1), as crops of different people and lighting differ."""
    import torch

    rng = np.random.default_rng(SEED + 11)
    x = rng.normal(size=(BATCH, 224, 224, 3))
    x = x * rng.uniform(0.5, 2.0, (BATCH, 1, 1, 1)) \
        + rng.uniform(-1.0, 1.0, (BATCH, 1, 1, 3))
    return torch.from_numpy(x.astype(np.float32)).to(device)


def build(calibrate: bool):
    """The full-width GRNet on the card; with `calibrate`, BatchNorm
    statistics from train-mode passes over the crops (kp_3d does not
    read the camera, so its MLP stays as initialised)."""
    import torch

    from gaitlab_torch.device import float32_math
    from gaitlab_torch.nn.grnet import GRNet

    model = GRNet.create(seed=SEED)
    if calibrate:
        core = model.module
        for m in core.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.reset_running_stats()
                m.momentum = None
        core.train()
        core.backbone.train()
        x = crops(model.device).permute(0, 3, 1, 2).contiguous()
        with torch.no_grad(), float32_math():
            for s in range(0, BATCH, 32):
                core(x[s:s + 32])
        core.eval()
    return model


def at_mode(model, mode: str):
    """A GRNet whose trunk runs `mode` (a view of the model's trunk, or a
    bf16 copy of it; with f32_stem the stem's four modules stay the
    model's float32 ones)."""
    import copy
    import dataclasses

    import torch

    s = parse_mode(mode)
    core = model.module.with_precision(
        s["precision"], s["head_precision"], s["region_precision"],
        s["resize_precision"]).with_backbone(
        **{k: s[k] for k in ("cast_after", "act_store", "stem_s2d",
                             "pack_low_channel")})
    if s["trunk_dtype"]:
        core = copy.deepcopy(core).to(torch.bfloat16)
        if s["f32_stem"]:  # the stem: conv1/bn1/conv2/bn2 of the backbone
            for name in STEM:
                core.backbone._modules[name] = copy.deepcopy(
                    getattr(model.module.backbone, name))
    return dataclasses.replace(model, module=core)


def timing(modes: list) -> dict:
    """{mode: ms per batch}: CUDA events around each forward, the median of
    TIMED after WARM."""
    import torch

    model = build(calibrate=False)
    x = crops(model.device)
    out = {}
    for mode in modes:
        run = at_mode(model, mode)
        for _ in range(WARM):
            run.forward(x)
        times = []
        for _ in range(TIMED):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run.forward(x)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[mode] = statistics.median(times)
        log(f"[timing] {mode}: {out[mode]:.2f} ms/batch")
        del run
        torch.cuda.empty_cache()
    return out


def accuracy(modes: list) -> tuple[dict, float]:
    """({mode: (MPJPE, worst frame, PVE)} in mm against the float32 path,
    the oracle's joint spread in mm)."""
    model = build(calibrate=True)
    x = crops(model.device)

    def outputs(run):
        out = run.forward(x)[0]
        return (out["kp_3d"][0].cpu().numpy(),
                out["verts"][0].cpu().numpy())

    kp0, v0 = outputs(model)
    spread = float(np.linalg.norm(kp0 - kp0.mean(0), axis=-1).mean() * 1e3)
    log(f"[accuracy] oracle (float32, TF32 off) joint spread across frames "
        f"{spread:.2f} mm")
    if not spread > 10.0:
        raise SystemExit(f"degenerate oracle: spread {spread:.3f} mm")
    res = {}
    for mode in modes:
        kp, v = outputs(at_mode(model, mode))
        per_frame = np.linalg.norm(kp - kp0, axis=-1).mean(-1) * 1e3
        pve = float(np.linalg.norm(v - v0, axis=-1).mean() * 1e3)
        res[mode] = (float(per_frame.mean()), float(per_frame.max()), pve)
        log(f"[accuracy] {mode}: MPJPE {res[mode][0]:.4f} mm (worst frame "
            f"{res[mode][1]:.4f}), PVE {pve:.4f} mm")
    return res, spread


def main(argv: list) -> int:
    import torch

    from torch_stage_timing import card

    if not torch.cuda.is_available():
        print("torch_precision_study: CUDA is not available", file=sys.stderr)
        return 1
    if argv[:1] == ["--timing"]:  # the child process
        print(json.dumps(timing(argv[1].split(","))))
        return 0
    modes = argv[0].split(",") if argv else list(MODES)
    for m in modes:
        parse_mode(m)
    if "float32" not in modes:
        modes = ["float32"] + modes
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, osp.abspath(__file__), "--timing",
                            ",".join(modes)], capture_output=True, text=True)
    sys.stderr.write(child.stderr)
    if child.returncode != 0:
        print(child.stdout)
        return child.returncode
    ms = json.loads(child.stdout.strip().splitlines()[-1])
    err, spread = accuracy(modes)
    rows = [dict(mode=m, **{k: v for k, v in parse_mode(m).items()},
                 mpjpe_mm=err[m][0], worst_frame_mm=err[m][1],
                 pve_mm=err[m][2], ms_per_batch=ms[m],
                 frames_per_s=BATCH / ms[m] * 1e3,
                 qualified=err[m][0] <= BUDGET_MM) for m in modes]
    for r in rows:
        r["region_precision"] = [list(p) for p in r["region_precision"]]
    old = []
    if osp.isfile(OUT):
        with open(OUT) as f:
            old = [r for r in json.load(f).get("results", [])
                   if r["mode"] not in modes]
    doc = {"script": "scripts/torch_precision_study.py", "card": card(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "batch": BATCH, "budget_mm": BUDGET_MM,
           "oracle": "the port's float32 path (TF32 off) on the card, random "
                     "weights from SEED with calibrated BatchNorm",
           "oracle_joint_spread_mm": spread, "results": old + rows}
    os.makedirs(osp.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"card: {doc['card']}; oracle joint spread {spread:.2f} mm; "
          f"{time.perf_counter() - t0:.1f} s")
    print("| mode | MPJPE mm | worst frame mm | PVE mm | ms/batch 128 | "
          "frames/s | within 0.5 mm |")
    print("|---|---|---|---|---|---|---|")
    for r in doc["results"]:
        print(f"| {r['mode']} | {r['mpjpe_mm']:.4f} | "
              f"{r['worst_frame_mm']:.4f} | {r['pve_mm']:.4f} | "
              f"{r['ms_per_batch']:.2f} | {r['frames_per_s']:.1f} | "
              f"{'yes' if r['qualified'] else 'no'} |")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
