#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gaitlab_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repo root, on a machine with CUDA

Phases, each of which exits non-zero on failure:
  1. build   compile the CUDA kernels from gaitlab_torch/csrc (nvcc, sm_90a)
  2. kernels hold each kernel against its plain PyTorch version on the card
             at main-path shapes (B = 128 and a ragged B = 37); time kernel,
             plain version and one library call with CUDA events
  3. path    run `gaitlab_torch.cli.demo --tracking_path` at full width
             (HRNet-W32 + PARE + synthetic SMPL, 224 crops) on a synthetic
             clip with two tracks (150 and 60 frames: two buckets, tail
             padding), with random weights whose BN statistics come from one
             train-mode pass over the clip's crops; both kernels must have
             launched; the pkl must have the demo schema with finite values;
             then the model loop's throughput at batch 128 and a profile of
             one batch (device time by kernel)
  4. cpu     the same weights on 4 frames, card against CPU (plain paths):
             kp_3d and verts must agree, which catches TF32 in the float32
             path
Two lines before the last list every kernel as JSON, the line before the
last holds the card's name and power limit, and the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX or of the gaitlab package.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import pickle
import statistics
import subprocess
import sys
import tempfile
import time

H100_BYTES_PER_S = 3.35e12   # HBM3
H100_FP32_FLOP_PER_S = 67e12  # FP32 outside the tensor cores
SEED = 0
CLIP_W, CLIP_H, CLIP_FRAMES = 320, 240, 160
TRACKS = ((0, 150), (100, 160))  # [start, end) frames of the two tracks
CALIB_FRAMES = 64
LOOP_BATCH = 128
CPU_FRAMES = 4
B1_ATOL = 1e-4  # sums of 3136 fp32 products, taken in another order
B2_ATOL = 1e-5  # sums of 217 fp32 products, taken in another order
CPU_ATOL_M = 1e-3  # kp_3d / verts, metres: ~100 fp32 convs, two libraries


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_ms(fn, flush, reps: int = 20, warm: int = 3) -> float:
    """Median device time of one call, CUDA events, L2 flushed before each."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_blendshapes(gen, flush) -> dict:
    import torch

    from gaitlab_torch.ops.blendshapes import blendshapes, blendshapes_plain

    V, S, P = 6890, 10, 207
    R = V * 3
    err = 0.0
    for b in (LOOP_BATCH, 37):
        vt = torch.randn(V, 3, device="cuda", generator=gen) * 0.3
        sh = torch.randn(V, 3, S, device="cuda", generator=gen) * 0.01
        po = torch.randn(P, R, device="cuda", generator=gen) * 0.001
        be = torch.randn(b, S, device="cuda", generator=gen)
        pf = torch.randn(b, P, device="cuda", generator=gen) * 0.5
        args = (vt, sh, po, be, pf)
        got, ref = blendshapes(*args), blendshapes_plain(*args)
        ref64 = blendshapes_plain(*(a.double() for a in args))
        torch.cuda.synchronize()
        e = (got - ref).abs().max().item()
        log(f"[kernels] blendshapes B={b}: max_abs_err={e:.3e} "
            f"(tolerance {B2_ATOL:g}); against float64: kernel "
            f"{(got - ref64).abs().max().item():.3e}, plain "
            f"{(ref - ref64).abs().max().item():.3e}")
        if not e <= B2_ATOL:
            raise AssertionError(f"blendshapes disagrees with its plain "
                                 f"version: {e} > {B2_ATOL}")
        err = max(err, e)
    # timed at B = 128 (the last b above is 37: redraw at 128)
    be = torch.randn(LOOP_BATCH, S, device="cuda", generator=gen)
    pf = torch.randn(LOOP_BATCH, P, device="cuda", generator=gen) * 0.5
    args = (vt, sh, po, be, pf)
    dirs = torch.cat([sh.reshape(R, S).T, po])     # (S+P, R)
    coef = torch.cat([be, pf], dim=1)              # (B, S+P)
    vt_row = vt.reshape(1, R)
    lib = torch.addmm(vt_row, coef, dirs).reshape(LOOP_BATCH, V, 3)
    if not torch.allclose(lib, blendshapes(*args), atol=1e-4):
        raise AssertionError("the library yardstick computes another function")
    nbytes = 4 * (R + R * S + P * R + LOOP_BATCH * (S + P) + LOOP_BATCH * R)
    flops = 2 * LOOP_BATCH * R * (S + P) + LOOP_BATCH * R
    b_ms, b_by = bound(nbytes, flops)
    return dict(
        name="blendshapes", route="cuda",
        source="gaitlab_torch/csrc/blendshapes.cu",
        replaces="gaitlab/ops/lbs_pallas.py:70",
        max_abs_err=err,
        ms=time_ms(lambda: blendshapes(*args), flush),
        plain_ms=time_ms(lambda: blendshapes_plain(*args), flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.addmm(vt_row, coef, dirs), flush))


def check_keypoint_attention(gen, flush) -> dict:
    import torch
    import torch.nn.functional as F

    from gaitlab_torch.ops.keypoint_attention import (
        keypoint_attention_fused, keypoint_attention_plain)

    H = W = 56
    C1, C2, J = 128, 64, 24
    err = 0.0
    for b in (37, LOOP_BATCH):
        # the head's layout: NCHW tensors passed as NHWC views, background
        # channel of the heatmaps sliced off
        f = torch.randn(b, C1, H, W, device="cuda", generator=gen).relu()
        c = torch.randn(b, C2, H, W, device="cuda", generator=gen)
        hm = torch.randn(b, J + 1, H, W, device="cuda", generator=gen) * 3
        args = (f.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1),
                hm[:, 1:].permute(0, 2, 3, 1))
        got, ref = keypoint_attention_fused(*args), keypoint_attention_plain(*args)
        ref64 = keypoint_attention_plain(*(a.double() for a in args))
        torch.cuda.synchronize()

        def max_err(xs, ys):
            return max((x - y).abs().max().item() for x, y in zip(xs, ys))

        e = max_err(got, ref)
        log(f"[kernels] keypoint_attention B={b}: max_abs_err={e:.3e} "
            f"(tolerance {B1_ATOL:g}); against float64: kernel "
            f"{max_err(got, ref64):.3e}, plain {max_err(ref, ref64):.3e}")
        if not e <= B1_ATOL:
            raise AssertionError(f"keypoint_attention disagrees with its "
                                 f"plain version: {e} > {B1_ATOL}")
        err = max(err, e)
    # library yardstick: softmax(Q K^T) V with Q = I_J, K = the logits and
    # V = both feature tensors, scale 1 -- one scaled_dot_product_attention
    q = torch.eye(J, device="cuda").expand(LOOP_BATCH, 1, J, J).contiguous()
    k = hm[:, 1:].reshape(LOOP_BATCH, 1, J, H * W).transpose(2, 3).contiguous()
    v = torch.cat([f, c], 1).reshape(LOOP_BATCH, 1, C1 + C2, H * W
                                     ).transpose(2, 3).contiguous()

    def library():
        return F.scaled_dot_product_attention(q, k, v, scale=1.0)

    lib = library()[:, 0]
    if not torch.allclose(lib, torch.cat(ref, -1), atol=1e-3):
        raise AssertionError("the library yardstick computes another function")
    hw = H * W
    nbytes = 4 * LOOP_BATCH * (hw * J + hw * (C1 + C2) + J * (C1 + C2))
    flops = LOOP_BATCH * J * hw * (2 * (C1 + C2) + 5)
    b_ms, b_by = bound(nbytes, flops)
    return dict(
        name="keypoint_attention", route="cuda",
        source="gaitlab_torch/csrc/keypoint_attention.cu",
        replaces="gaitlab/ops/attention_pallas.py:60",
        max_abs_err=err,
        ms=time_ms(lambda: keypoint_attention_fused(*args), flush),
        plain_ms=time_ms(lambda: keypoint_attention_plain(*args), flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library, flush))


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def make_clip(workdir: str) -> tuple[str, str]:
    import cv2
    import numpy as np

    vid = osp.join(workdir, "walk.mp4")
    writer = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 20.0,
                             (CLIP_W, CLIP_H))
    rng = np.random.default_rng(SEED)
    bg = rng.integers(40, 70, size=(CLIP_H, CLIP_W, 3)).astype(np.uint8)
    for i in range(CLIP_FRAMES):
        frame = bg.copy()
        x1 = 10 + i
        cv2.rectangle(frame, (x1, 30), (x1 + 40, 190), (210, 190, 180), -1)
        cv2.circle(frame, (x1 + 20, 45), 13, (200, 170, 160), -1)
        if i >= TRACKS[1][0]:
            x2 = 280 - 2 * (i - TRACKS[1][0])
            cv2.rectangle(frame, (x2, 60), (x2 + 35, 210), (150, 200, 160), -1)
        writer.write(frame)
    writer.release()
    tracks = {}
    for pid, (s, e) in enumerate(TRACKS):
        fr = np.arange(s, e)
        if pid == 0:
            cx, cy, side = 10 + fr + 20.0, np.full(len(fr), 110.0), 180.0
        else:
            cx, cy, side = 280 - 2.0 * (fr - s) + 17.5, np.full(len(fr), 135.0), 170.0
        bb = np.stack([cx, cy, np.full(len(fr), side), np.full(len(fr), side)], 1)
        tracks[pid] = {"frames": fr, "bbox": bb.astype(np.float32)}
    trackfile = osp.join(workdir, "tracks.pkl")
    with open(trackfile, "wb") as f:
        pickle.dump(tracks, f)
    return vid, trackfile


def calibrated_model(vid: str, trackfile: str, workdir: str):
    """Full-width GRNet with random weights from SEED, BN statistics from
    one train-mode pass over the first track's crops, and the camera/shape
    MLPs scaled to trained-model magnitudes; saved as a reference-style
    checkpoint for the demo's --ckpt."""
    import torch

    from gaitlab_torch.cli.demo import load_pickle
    from gaitlab_torch.device import float32_math
    from gaitlab_torch.nn.grnet import GRNet
    from gaitlab_torch.pipeline import video
    from gaitlab_torch.pipeline.runner import GRNetRunner

    model = GRNet.create(seed=SEED)
    frames_dir = video.video_to_images(vid, osp.join(workdir, "calib"))
    paths = video.list_image_files(frames_dir)
    track = load_pickle(trackfile)[0]
    runner = GRNetRunner(model)
    crops = runner.crop_track([paths[i] for i in track["frames"][:LOOP_BATCH]],
                              track["bbox"][:LOOP_BATCH])
    core = model.module
    for m in core.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None  # cumulative average: the pass's exact stats
    core.train()
    with torch.no_grad(), float32_math():
        core(crops[:CALIB_FRAMES].permute(0, 3, 1, 2).contiguous())
        for mlp in (core.head.cam_mlp, core.head.shape_mlp):
            for p in mlp.parameters():
                p.mul_(0.02)
        core.head.cam_mlp.bias.add_(torch.tensor([0.9, 0.0, 0.0], device="cuda"))
    core.eval()
    ckpt = osp.join(workdir, "smoke_ckpt.pth")
    torch.save({"gen_state_dict": core.state_dict()}, ckpt)
    return model, crops, ckpt


def run_demo(vid: str, trackfile: str, ckpt: str, workdir: str) -> dict:
    import numpy as np

    from gaitlab_torch.cli import demo
    from gaitlab_torch.ops.blendshapes import blendshapes
    from gaitlab_torch.ops.keypoint_attention import keypoint_attention_fused

    out_dir = osp.join(workdir, "out")
    args = demo.build_parser().parse_args([
        "--vid_file", vid, "--tracking_path", trackfile, "--ckpt", ckpt,
        "--output_folder", out_dir, "--save_vid"])
    kernels = {"blendshapes": blendshapes,
               "keypoint_attention": keypoint_attention_fused}
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = demo.main(args)
    demo_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    log(f"[path] demo --tracking_path: {demo_s:.2f} s, kernel launches "
        f"{launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")

    run_dir = osp.join(out_dir, "walk_mp4")
    pkls = [f for f in os.listdir(run_dir) if f.endswith(".pkl")]
    if pkls != ["smoke_ckpt.pkl"]:
        raise AssertionError(f"unexpected pkl files {pkls}")
    saved = demo.load_pickle(osp.join(run_dir, pkls[0]))
    if set(saved) != {0, 1}:
        raise AssertionError(f"expected persons 0 and 1, got {list(saved)}")
    for pid, (s, e) in enumerate(TRACKS):
        n = e - s
        person = saved[pid]
        shapes = {"pred_cam": (n, 3), "orig_cam": (n, 4),
                  "verts": (n, 6890, 3), "pose": (n, 72), "betas": (n, 10),
                  "joints3d": (n, 29, 3), "joints2d": (n, 29, 2),
                  "bboxes": (n, 4), "frame_ids": (n,)}
        for k, shape in shapes.items():
            v = np.asarray(person[k])
            if v.shape != shape or not np.all(np.isfinite(v)):
                raise AssertionError(f"person {pid} {k}: shape {v.shape} "
                                     f"(want {shape}), finite "
                                     f"{np.all(np.isfinite(v))}")
        spread = np.linalg.norm(person["joints3d"] - person["joints3d"].mean(0),
                                axis=-1).mean() * 1e3
        log(f"[path] person {pid}: {n} frames, schema ok, joints3d spread "
            f"over frames {spread:.3f} mm")
        if not np.array_equal(person["frame_ids"], np.arange(s, e)):
            raise AssertionError(f"person {pid}: wrong frame ids")
    return launches


def model_loop(model, crops) -> None:
    import torch

    x = crops[:LOOP_BATCH]
    for _ in range(2):
        model.forward(x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        model.forward(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    log(f"[path] model loop (crops -> GRNet -> SMPL, float32, TF32 off) at "
        f"batch {LOOP_BATCH}: {ms:.2f} ms/batch = {LOOP_BATCH / ms * 1e3:.1f} "
        f"frames/s; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")


def profile_loop(model, crops) -> None:
    """Where the device time of one batch goes (torch.profiler): the top
    kernels, the two ported kernels' share, and the busy share of the
    window (profiler overhead included, so the idle share is an upper
    bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = crops[:LOOP_BATCH]
    model.forward(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.forward(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    if total <= 0:
        log("[profile] the profiler saw no device time: not measured")
        return
    log(f"[profile] batch {LOOP_BATCH}: device busy {total:.2f} ms of a "
        f"{wall_ms:.2f} ms window ({100 * total / wall_ms:.1f}%); "
        f"{len(kernels)} kernel names")
    groups = {"keypoint_attention (B1)": "attention_",
              "blendshapes (B2)": "blendshapes_kernel"}
    for label, key in groups.items():
        ms = sum(e.self_device_time_total for e in kernels
                 if key in e.key) / 1e3
        log(f"[profile]   {label}: {ms:.3f} ms ({100 * ms / total:.2f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        log(f"[profile]   {ms:8.3f} ms {100 * ms / total:5.1f}% x{e.count:<4d}"
            f" {e.key[:90]}")


# ---------------------------------------------------------------------------
# phase 4: card against CPU
# ---------------------------------------------------------------------------

def card_vs_cpu(model, crops) -> None:
    import torch

    from gaitlab_torch.nn.grnet import GRNet, vp_regress

    x = crops[:CPU_FRAMES]
    cpu = GRNet.create(seed=SEED, device="cpu")
    cpu.module.load_state_dict({k: v.cpu() for k, v in
                                model.module.state_dict().items()})
    card = model.forward(x)[0]
    host = cpu.forward(x.cpu())[0]
    errs = {k: (card[k].cpu() - host[k]).abs().max().item()
            for k in ("kp_3d", "verts")}
    # the same frames with TF32 on, to show what the check would catch
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.inference_mode():
            tf32 = vp_regress(model.smpl, model.module(
                x.permute(0, 3, 1, 2).contiguous()))[0]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    tf32_err = (tf32["kp_3d"].cpu() - host["kp_3d"]).abs().max().item()
    log(f"[cpu] card vs CPU on {CPU_FRAMES} frames: max abs kp_3d "
        f"{errs['kp_3d']:.3e} m, verts {errs['verts']:.3e} m (tolerance "
        f"{CPU_ATOL_M:g} m); with TF32 on, kp_3d {tf32_err:.3e} m")
    for k, e in errs.items():
        if not e <= CPU_ATOL_M:
            raise AssertionError(f"card and CPU disagree on {k}: {e}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from gaitlab_torch.ops import _build

    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build_all(verbose=True)
    log(f"[build] both kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    from gaitlab_torch.device import float32_math

    with float32_math():
        rows = [check_keypoint_attention(gen, flush),
                check_blendshapes(gen, flush)]
    del flush
    for r in rows:
        log(f"[kernels] {r['name']} at B={LOOP_BATCH}: {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    with tempfile.TemporaryDirectory(prefix="gaitlab_smoke_") as workdir:
        vid, trackfile = make_clip(workdir)
        model, crops, ckpt = calibrated_model(vid, trackfile, workdir)
        launches = run_demo(vid, trackfile, ckpt, workdir)
        model_loop(model, crops)
        profile_loop(model, crops)
        card_vs_cpu(model, crops)
    for r in rows:
        r["launches"] = launches[r["name"]]

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
