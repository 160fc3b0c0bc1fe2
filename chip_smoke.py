#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gaitlab_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repo root, on a machine with CUDA

Phases, each of which exits non-zero on failure:
  1. build   compile the CUDA kernels from gaitlab_torch/csrc (nvcc, sm_90a)
  2. kernels hold each kernel against its plain PyTorch version on the card
             at main-path shapes (B = 1, 37, 128 and 450: ragged, one wave,
             the largest bucket); time kernel, plain version and one library
             call with CUDA events at B = 128
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
  5. detect  the full YOLOv3 (Darknet-53) at 416 px, batch 12, random
             weights from SEED with BN statistics from one train-mode pass
             over letterboxed frames, written as a darknet file by the port
             and read back by YoloDetector; card against CPU on 2 frames
             (raw maps and decoded predictions); the detector's frames/s
             with CUDA events against its bound; a profile of one batch
  6. track   `demo --vid_file walk_det.mp4 --detector median_bg --smooth`
             on a second synthetic clip (two walkers in separate bands):
             detection, SORT, gap splitting, GRNet per track and one-euro
             smoothing, whose SMPL pass launches blendshapes once more per
             person; persons 0 and 1 must cover DET_TRACKS within
             TRACK_SLACK frames with the pkl schema and finite values, both
             kernels must launch. A first --smooth run meets the new bucket
             shapes, holds every kernel call against the plain version on
             the call's own inputs (buckets and smoothed tracks) and one
             track's smooth_pose on the card against its CPU run, and
             profiles that smooth_pose call; the main --smooth run may
             launch the kernels only at shapes so checked. One run without
             --smooth is timed beside it, and one with --stream must give
             the same persons, frame ids and boxes
  7. yolo    `demo --detector yolo` with GAITLAB_YOLO_WEIGHTS naming a
             darknet file of the same network whose heads predict one
             frame-sized box per cell (kernels zeroed, biases set), so that
             NMS keeps one box a frame: the detector must be a YoloDetector
             on CUDA whose forwards were counted
Two lines before the last list every kernel as JSON (launches from phase
6, this slice's main path; max_abs_err over phases 2 and 6), the line
before the last holds the card's name and power limit, and the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX or of the gaitlab package.
"""

from __future__ import annotations

import contextlib
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
H100_TF32_FLOP_PER_S = 495e12  # TF32 tensor cores, dense
SEED = 0
CLIP_W, CLIP_H, CLIP_FRAMES = 320, 240, 160
TRACKS = ((0, 150), (100, 160))  # [start, end) frames of the two tracks
CALIB_FRAMES = 64
LOOP_BATCH = 128
CHECK_BATCHES = (1, 37, 450, LOOP_BATCH)  # the last one is timed
CPU_FRAMES = 4
B1_ATOL = 1e-4  # sums of 3136 fp32 products, taken in another order
B2_ATOL = 1e-5  # sums of 217 fp32 products, taken in another order
SLEEP_CYCLES = 2_000_000  # about 1 ms of the card's clock
CPU_ATOL_M = 1e-3  # kp_3d / verts, metres: ~100 fp32 convs, two libraries
DET_SIZE, DET_BATCH, DET_CPU_FRAMES = 416, 12, 2
# card against CPU for YOLOv3: 75 fp32 convs summed in two libraries'
# orders; the bound is max|card - cpu| <= YOLO_RTOL * max|cpu| per map
YOLO_RTOL = 1e-3
DET_TRACKS = ((0, 140), (60, 160))  # [start, end) of the two walkers
TRACK_SLACK = 3  # SORT emits a new track from its third hit
# smooth_pose on the card against its CPU run: the SMPL tolerances of the
# CPU tests (tests/test_torch_filters.py, allclose rtol/atol) for vertices
# and joints, the filters' 1e-6 for the filtered pose
SMOOTH_TOL = {"verts": (2e-4, 2e-5), "pose": (1e-6, 1e-6),
              "joints3d": (2e-4, 2e-5)}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_ms(fn, flush, reps: int = 20, warm: int = 3) -> float:
    """Median device time of one call, CUDA events, L2 flushed before each.
    The card sleeps after the flush, so the host has enqueued the call
    before the start event is reached and its Python time stays out."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float,
          flop_per_s: float = H100_FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
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
    for b in CHECK_BATCHES:
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
    # timed at B = 128, the last of CHECK_BATCHES
    dirs = torch.cat([sh.reshape(R, S).T, po])     # (S+P, R)
    coef = torch.cat([be, pf], dim=1)              # (B, S+P)
    vt_row = vt.reshape(1, R)
    lib = torch.addmm(vt_row, coef, dirs).reshape(LOOP_BATCH, V, 3)
    if not torch.allclose(lib, blendshapes(*args), atol=1e-4):
        raise AssertionError("the library yardstick computes another function")
    nbytes = 4 * (R + R * S + P * R + LOOP_BATCH * (S + P) + LOOP_BATCH * R)
    flops = 2 * LOOP_BATCH * R * (S + P) + LOOP_BATCH * R
    # the kernel's route: 3xTF32, three tensor-core products per product
    b_ms, b_by = bound(nbytes, 3 * flops, H100_TF32_FLOP_PER_S)
    fp32_ms, fp32_by = bound(nbytes, flops)
    log(f"[kernels] blendshapes bound at B={LOOP_BATCH}: 3xTF32 route "
        f"{b_ms:.4f} ms ({b_by}); in FP32 FFMA it would be {fp32_ms:.4f} ms "
        f"({fp32_by})")
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
        keypoint_attention_fused, keypoint_attention_plain, launch_plan)

    H = W = 56
    C1, C2, J = 128, 64, 24
    err = 0.0
    for b in CHECK_BATCHES:
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
        plan = launch_plan(b, H * W, C1 + C2, torch.cuda.get_device_properties(
            0).multi_processor_count)
        log(f"[kernels] keypoint_attention B={b}: max_abs_err={e:.3e} "
            f"(tolerance {B1_ATOL:g}); against float64: kernel "
            f"{max_err(got, ref64):.3e}, plain {max_err(ref, ref64):.3e}; "
            f"{plan.n_split} splits of {plan.split_len} positions, "
            f"{1 + (plan.n_split > 1)} device launches per call")
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


def drive_demo(argv: list, out_dir: str, stem: str):
    """demo.main(argv) with the kernels' counts set to 0 just before it;
    returns (the saved pkl, the counts just after, wall seconds). With the
    smoke's checkpoint the run must write exactly smoke_ckpt.pkl."""
    from gaitlab_torch.cli import demo
    from gaitlab_torch.ops.blendshapes import blendshapes
    from gaitlab_torch.ops.keypoint_attention import keypoint_attention_fused

    fns = {"blendshapes": blendshapes,
           "keypoint_attention": keypoint_attention_fused}
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    demo.main(demo.build_parser().parse_args(
        [*argv, "--output_folder", out_dir, "--save_vid"]))
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in fns.items()}
    run_dir = osp.join(out_dir, stem)
    pkls = os.listdir(run_dir)
    if pkls != ["smoke_ckpt.pkl"]:
        raise AssertionError(f"unexpected files {pkls}")
    return demo.load_pickle(osp.join(run_dir, pkls[0])), launches, wall


def check_person(pid: int, person: dict) -> None:
    import numpy as np

    n = len(person["frame_ids"])
    shapes = {"pred_cam": (n, 3), "orig_cam": (n, 4), "verts": (n, 6890, 3),
              "pose": (n, 72), "betas": (n, 10), "joints3d": (n, 29, 3),
              "joints2d": (n, 29, 2), "bboxes": (n, 4), "frame_ids": (n,)}
    for k, shape in shapes.items():
        v = np.asarray(person[k])
        if v.shape != shape or not np.all(np.isfinite(v)):
            raise AssertionError(f"person {pid} {k}: shape {v.shape} (want "
                                 f"{shape}), finite {np.all(np.isfinite(v))}")


def run_demo(vid: str, trackfile: str, ckpt: str, workdir: str) -> None:
    import numpy as np

    saved, launches, demo_s = drive_demo(
        ["--vid_file", vid, "--tracking_path", trackfile, "--ckpt", ckpt],
        osp.join(workdir, "out"), "walk_mp4")
    log(f"[path] demo --tracking_path: {demo_s:.2f} s, kernel launches "
        f"{launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")
    if set(saved) != {0, 1}:
        raise AssertionError(f"expected persons 0 and 1, got {list(saved)}")
    for pid, (s, e) in enumerate(TRACKS):
        person = saved[pid]
        if not np.array_equal(person["frame_ids"], np.arange(s, e)):
            raise AssertionError(f"person {pid}: wrong frame ids")
        check_person(pid, person)
        spread = np.linalg.norm(person["joints3d"] - person["joints3d"].mean(0),
                                axis=-1).mean() * 1e3
        log(f"[path] person {pid}: {e - s} frames, schema ok, joints3d spread "
            f"over frames {spread:.3f} mm")


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
    # B1 is attention_split_kernel and, with several splits,
    # attention_merge_kernel; B2 is blendshapes_kernel
    groups = {"keypoint_attention (B1)": "attention_",
              "blendshapes (B2)": "blendshapes_kernel"}
    for label, key in groups.items():
        group = [e for e in kernels if key in e.key]
        ms = sum(e.self_device_time_total for e in group) / 1e3
        log(f"[profile]   {label}: {ms:.3f} ms ({100 * ms / total:.2f}%) in "
            f"{sum(e.count for e in group)} device launches")
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


# ---------------------------------------------------------------------------
# phase 5: YOLOv3 on the card
# ---------------------------------------------------------------------------

def make_detect_clip(workdir: str) -> str:
    """Two walkers in bands that never touch, moving 2 px a frame: the
    median background fitted on the clip's first 64 frames (--stream) or
    on 60 frames across it (the folder) shows neither of them."""
    import cv2
    import numpy as np

    vid = osp.join(workdir, "walk_det.mp4")
    writer = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 20.0,
                             (CLIP_W, CLIP_H))
    rng = np.random.default_rng(SEED)
    bg = rng.integers(40, 70, size=(CLIP_H, CLIP_W, 3)).astype(np.uint8)
    (s0, e0), (s1, e1) = DET_TRACKS
    for i in range(CLIP_FRAMES):
        frame = bg.copy()
        if s0 <= i < e0:
            x = 5 + 2 * i
            cv2.rectangle(frame, (x, 10), (x + 30, 110), (210, 190, 180), -1)
        if s1 <= i < e1:
            x = 285 - 2 * (i - s1)
            cv2.rectangle(frame, (x, 130), (x + 30, 230), (150, 200, 160), -1)
        writer.write(frame)
    writer.release()
    return vid


def yolo_flops(layers: tuple, size: int) -> float:
    """Multiply-adds x 2 of every convolution of one frame."""
    from gaitlab_torch.nn.yolo import _channels

    flops, hw, sizes = 0.0, size, []
    for entry, cin in zip(layers, _channels(layers)):
        kind = entry[0]
        if kind in ("conv", "convlin"):
            _, f, k, stride = entry
            hw //= stride
            flops += 2.0 * hw * hw * f * cin * k * k
        elif kind == "maxpool":
            hw //= entry[2]
        elif kind == "upsample":
            hw *= 2
        elif kind == "route":
            hw = sizes[entry[1][0] if entry[1][0] >= 0
                       else len(sizes) + entry[1][0]]
        sizes.append(hw)
    return flops


def yolo_weights(frames, path: str):
    """Full YOLOv3 with random weights from SEED and BN statistics from one
    train-mode pass over `frames` (letterboxed uint8) on the card, written
    as a darknet file."""
    import torch

    from gaitlab_torch.device import float32_math
    from gaitlab_torch.nn import yolo

    torch.manual_seed(SEED)
    net = yolo.YoloV3().cuda()
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None  # cumulative average: the pass's exact stats
    x = torch.from_numpy(frames).cuda().permute(0, 3, 1, 2).float() / 255.0
    net.train()
    with torch.no_grad(), float32_math():
        net(x.contiguous())
    yolo.save_darknet_weights(path, net.eval())
    return net


def max_rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def detect_phase(vid: str, workdir: str) -> str:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gaitlab_torch.device import float32_math
    from gaitlab_torch.nn import yolo
    from gaitlab_torch.pipeline import detect, video

    frames = np.stack(list(video.read_frames(vid))[:DET_BATCH])
    weights = osp.join(workdir, "yolov3.weights")
    boxed = detect.letterbox(frames, DET_SIZE)[0]
    yolo_weights(boxed, weights)
    det = detect.YoloDetector(weights_path=weights, input_size=DET_SIZE,
                              batch=DET_BATCH)
    n_params = sum(p.numel() for p in det.net.parameters())
    log(f"[detect] {det.variant}: {n_params / 1e6:.2f} M parameters on "
        f"{det.device}, {os.path.getsize(weights) / 1e6:.1f} MB darknet file")
    if det.variant != "v3" or det.device.type != "cuda":
        raise AssertionError("the detector is not YOLOv3 on the card")

    # card against CPU on DET_CPU_FRAMES frames: raw maps, then decode
    cpu = detect.YoloDetector(weights_path=weights, input_size=DET_SIZE,
                              device="cpu")
    x = boxed[:DET_CPU_FRAMES]
    with torch.inference_mode():
        xc = torch.from_numpy(x).permute(0, 3, 1, 2).float() / 255.0
        want = cpu.net(xc)
        with float32_math():
            got = [m.cpu() for m in det.net(xc.cuda())]
        errs = [max_rel(g, w) for g, w in zip(got, want)]
        d_got = det.predict(x).cpu()
        d_want = yolo.detect(cpu.net, xc)[..., :6]
        d_errs = [max_rel(d_got[..., c], d_want[..., c])
                  for c in (slice(0, 2), slice(2, 4), slice(4, 6))]
        prev = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = det.net(xc.cuda())
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prev
        tf32_err = max(max_rel(t.cpu(), w) for t, w in zip(tf32, want))
    log(f"[detect] card vs CPU on {DET_CPU_FRAMES} frames: raw maps "
        f"max|diff|/max|cpu| = {', '.join(f'{e:.3e}' for e in errs)}; "
        f"decoded xy, wh, scores {', '.join(f'{e:.3e}' for e in d_errs)} "
        f"(tolerance {YOLO_RTOL:g}); with TF32 on, maps {tf32_err:.3e}")
    if not max(errs + d_errs) <= YOLO_RTOL:
        raise AssertionError(f"YOLOv3 card and CPU disagree: {errs} {d_errs}")

    # frames/s at DET_BATCH: upload of the uint8 batch, /255, the network
    # and the decode, CUDA events
    for _ in range(3):
        det.predict(boxed)
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        det.predict(boxed)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    flops = DET_BATCH * yolo_flops(det.net.layers, DET_SIZE)
    nbytes = (4 * n_params + boxed.nbytes
              + 4 * DET_BATCH * 6 * sum(3 * (DET_SIZE // s) ** 2
                                        for s in (32, 16, 8)))
    b_ms, b_by = bound(nbytes, flops)
    log(f"[detect] batch {DET_BATCH} at {DET_SIZE}: {ms:.3f} ms/batch = "
        f"{DET_BATCH / ms * 1e3:.1f} frames/s (float32, TF32 off); "
        f"{flops / 1e9:.1f} GFLOP, bound {b_ms:.3f} ms ({b_by}), "
        f"{100 * b_ms / ms:.1f}% of it")
    t0 = time.perf_counter()
    dets = det(frames)
    call_s = time.perf_counter() - t0
    log(f"[detect] whole detector call on {len(frames)} clip frames "
        f"(letterbox, network, readback, host NMS): {call_s * 1e3:.1f} ms = "
        f"{len(frames) / call_s:.1f} frames/s; boxes per frame with random "
        f"weights {[len(d) for d in dets]}")

    det.predict(boxed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        det.predict(boxed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    if total <= 0:
        log("[detect] the profiler saw no device time: not measured")
        return weights
    log(f"[detect] profile of one batch: device busy {total:.2f} ms of a "
        f"{wall_ms:.2f} ms window ({100 * total / wall_ms:.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        kms = e.self_device_time_total / 1e3
        log(f"[detect]   {kms:8.3f} ms {100 * kms / total:5.1f}% "
            f"x{e.count:<4d} {e.key[:90]}")
    return weights


# ---------------------------------------------------------------------------
# phase 6: demo from a raw video (detection, SORT, smoothing)
# ---------------------------------------------------------------------------

def spans(saved: dict) -> dict:
    return {p: (int(v["frame_ids"][0]), int(v["frame_ids"][-1]) + 1)
            for p, v in saved.items()}


@contextlib.contextmanager
def stage_timers(targets: dict):
    """Wrap each (owner, attribute) of `targets` so that the seconds spent
    in it add up under its label; every stage named here ends in a host
    copy of its results, so the card is done when it returns."""
    spent = {label: 0.0 for label in targets}
    originals = {label: getattr(owner, attr)
                 for label, (owner, attr) in targets.items()}

    def timed(label, fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[label] += time.perf_counter() - t0
        return wrapper

    for label, (owner, attr) in targets.items():
        setattr(owner, attr, timed(label, originals[label]))
    try:
        yield spent
    finally:
        for label, (owner, attr) in targets.items():
            setattr(owner, attr, originals[label])


@contextlib.contextmanager
def kernel_spies(check: bool):
    """Wrap each kernel's wrapper where the path calls it (pare_head's
    keypoint_attention_fused, smpl's blendshapes) to record the input
    shapes of every call on the card. With `check`, each call's result is
    also held against the plain version on the same inputs, and the first
    smooth_pose call's arguments and result are kept. Yields
    {"calls": {kernel: [(shapes, errors or None)]}, "smooth": ...}, where
    errors holds the largest |kernel - plain|, the largest |plain|, and
    kernel's and plain's largest error against the plain version in
    float64."""
    from gaitlab_torch.body import smpl
    from gaitlab_torch.device import float32_math
    from gaitlab_torch.nn import pare_head
    from gaitlab_torch.ops import blendshapes as b2
    from gaitlab_torch.ops import keypoint_attention as b1
    from gaitlab_torch.pipeline import smoothing

    sites = {"keypoint_attention": (pare_head, "keypoint_attention_fused",
                                    b1.keypoint_attention_plain),
             "blendshapes": (smpl, "blendshapes", b2.blendshapes_plain)}
    seen = {"calls": {name: [] for name in sites}, "smooth": None}
    originals = {name: getattr(owner, attr)
                 for name, (owner, attr, _) in sites.items()}
    smooth_pose = smoothing.smooth_pose

    def spy(name, fn, plain):
        def wrapper(*args):
            out = fn(*args)
            if args[0].device.type != "cuda":
                return out
            err = None
            if check:
                with float32_math():
                    ref = plain(*args)
                    ref64 = plain(*(a.double() for a in args))

                def max_err(xs, ys):
                    xs = xs if isinstance(xs, tuple) else (xs,)
                    ys = ys if isinstance(ys, tuple) else (ys,)
                    return max((x - y).abs().max().item()
                               for x, y in zip(xs, ys))

                refs = ref if isinstance(ref, tuple) else (ref,)
                err = dict(err=max_err(out, ref),
                           scale=max(r.abs().max().item() for r in refs),
                           kernel64=max_err(out, ref64),
                           plain64=max_err(ref, ref64))
            seen["calls"][name].append(
                (tuple(tuple(a.shape) for a in args), err))
            return out
        return wrapper

    def smooth_spy(*args, **kw):
        out = smooth_pose(*args, **kw)
        if seen["smooth"] is None:
            seen["smooth"] = (args, kw, out)
        return out

    for name, (owner, attr, plain) in sites.items():
        setattr(owner, attr, spy(name, originals[name], plain))
    if check:
        smoothing.smooth_pose = smooth_spy
    try:
        yield seen
    finally:
        for name, (owner, attr, _) in sites.items():
            setattr(owner, attr, originals[name])
        smoothing.smooth_pose = smooth_pose


def check_smooth_pose(args, kw, card_out) -> None:
    """One track's smooth_pose on the card against the same call on the
    CPU, then a profile of the card call: device kernels and busy share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gaitlab_torch.pipeline import smoothing

    kw = dict(kw)
    params = kw.pop("smpl_params")
    cpu_out = smoothing.smooth_pose(*args, smpl_params=params.to("cpu"), **kw)
    errs = {}
    for key, got, want in zip(("verts", "pose", "joints3d"), card_out, cpu_out):
        rtol, atol = SMOOTH_TOL[key]
        errs[key] = float(np.abs(got - want).max())
        if not np.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(f"smooth_pose {key}: card and CPU disagree "
                                 f"(max abs {errs[key]:.3e}, rtol {rtol:g}, "
                                 f"atol {atol:g})")
    n = len(args[1])
    log(f"[track] smooth_pose on {n} frames, card vs CPU: max abs verts "
        f"{errs['verts']:.3e} m, pose {errs['pose']:.3e} rad, joints3d "
        f"{errs['joints3d']:.3e} m (allclose at {SMOOTH_TOL})")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        smoothing.smooth_pose(*args, smpl_params=params, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    count = sum(e.count for e in kernels)
    log(f"[track] smooth_pose profile on {n} frames: {count} device "
        f"operations (kernels and copies, {count / n:.1f} a frame), device "
        f"busy {busy:.3f} ms of a {wall_ms:.2f} ms window "
        f"({100 * busy / wall_ms:.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.count)[:5]:
        log(f"[track]   x{e.count:<5d} {e.self_device_time_total / 1e3:7.3f} "
            f"ms {e.key[:80]}")


def track_phase(vid: str, ckpt: str, workdir: str) -> tuple[dict, dict]:
    """The demo from a raw video. A first run with --smooth meets the
    model's new bucket shapes and holds every kernel call of it against
    the plain version on the same inputs, and smooth_pose against its CPU
    run; the timed runs come after it, and the --smooth one is the main
    path whose kernel shapes must all have been checked. Returns the main
    path's launches and each kernel's largest checked error."""
    import numpy as np

    from gaitlab_torch.cli import demo
    from gaitlab_torch.pipeline import runner, smoothing, video

    stages = {"load_model": (demo, "load_model"),
              "decode to PNG": (video, "video_to_images"),
              "detect+track": (demo, "run_tracking"),
              "crop+model": (runner.GRNetRunner, "run_track"),
              "smooth_pose": (smoothing, "smooth_pose")}
    base = ["--vid_file", vid, "--detector", "median_bg", "--ckpt", ckpt]
    runs, seen = {}, {}
    for tag, extra in (("check", ["--smooth"]), ("plain", []),
                       ("smooth", ["--smooth"]),
                       ("stream", ["--stream", "--smooth"])):
        with stage_timers(stages) as spent, \
                kernel_spies(check=tag == "check") as seen[tag]:
            runs[tag] = drive_demo(base + extra,
                                   osp.join(workdir, f"det_{tag}"),
                                   "walk_det_mp4")
        saved, launches, wall = runs[tag]
        log(f"[track] demo --detector median_bg {' '.join(extra)} ({tag} "
            f"run): {wall:.2f} s; stages "
            f"{ {k: round(v, 4) for k, v in spent.items()} }, the rest "
            f"{wall - sum(spent.values()):.4f} s; kernel launches "
            f"{launches}; persons [first, end) frames {spans(saved)}")
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"demo {extra} never launched {name}")
        if set(saved) != {0, 1}:
            raise AssertionError(f"expected persons 0 and 1, got {list(saved)}")
        for pid, person in saved.items():
            check_person(pid, person)
        # B1 runs once per model forward; smoothing adds one B2 launch per
        # person
        want_b2 = launches["keypoint_attention"] + (
            len(saved) if "--smooth" in extra else 0)
        if launches["blendshapes"] != want_b2:
            raise AssertionError(f"blendshapes launched {launches} times, "
                                 f"want {want_b2}")
        if tag == "check":
            check_smooth_pose(*seen["check"]["smooth"])
    # every kernel call of the main path at a shape checked in this phase;
    # the model's activations are not of unit scale, so the phase-2
    # tolerance scales with the largest |output| of each call
    errs = {}
    for name, checked in seen["check"]["calls"].items():
        errs[name] = max(e["err"] for _, e in checked)
        tol = B1_ATOL if name == "keypoint_attention" else B2_ATOL
        main = [shapes for shapes, _ in seen["smooth"]["calls"][name]]
        for shapes, e in checked:
            limit = tol * max(1.0, e["scale"])
            log(f"[track] {name} B={shapes[-1][0]} on the check run's own "
                f"inputs: max_abs_err {e['err']:.3e} (tolerance {tol:g} x "
                f"max(1, max|out| {e['scale']:.3g}) = {limit:.3e}); against "
                f"float64: kernel {e['kernel64']:.3e}, plain "
                f"{e['plain64']:.3e}")
            if not e["err"] <= limit:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version on the demo's inputs: {e}")
        log(f"[track] {name}: main path batches "
            f"{[sh[-1][0] for sh in main]}, all checked")
        unchecked = set(main) - {sh for sh, _ in checked}
        if len(main) != runs["smooth"][1][name] or unchecked:
            raise AssertionError(f"{name}: main-path shapes {unchecked} were "
                                 f"not checked")
    saved = runs["smooth"][0]
    for pid, (s, e) in enumerate(DET_TRACKS):
        fr = saved[pid]["frame_ids"]
        if abs(int(fr[0]) - s) > TRACK_SLACK or abs(int(fr[-1]) + 1 - e) > \
                TRACK_SLACK or len(fr) < e - s - 2 * TRACK_SLACK:
            raise AssertionError(f"person {pid}: frames {fr[0]}..{fr[-1]} "
                                 f"({len(fr)}), want about [{s}, {e})")
        jitter = [np.abs(np.diff(runs[t][0][pid]["joints3d"], axis=0)).mean()
                  * 1e3 for t in ("plain", "smooth")]
        log(f"[track] person {pid}: joints3d mean frame-to-frame change "
            f"{jitter[0]:.3f} mm raw, {jitter[1]:.3f} mm smoothed")
        for k in ("frame_ids", "bboxes"):
            if not np.array_equal(runs["stream"][0][pid][k], saved[pid][k]):
                raise AssertionError(f"--stream person {pid}: other {k}")
    return runs["smooth"][1], errs


# ---------------------------------------------------------------------------
# phase 7: demo --detector yolo
# ---------------------------------------------------------------------------

def frame_sized_heads(weights: str, path: str) -> None:
    """The phase-5 network with every head kernel zeroed and biases that
    make each cell of the stride-32 head predict a 2000 px square box
    (person score sigmoid(3)^2) and the other heads nothing: boxes that
    overlap beyond the NMS threshold wherever their cells lie."""
    import torch

    from gaitlab_torch.nn import yolo

    net = yolo.load_darknet_weights(weights, yolo.YoloV3())
    with torch.no_grad():
        for i, entry in enumerate(net.layers):
            if entry[0] != "convlin":
                continue
            head = getattr(net, f"conv{i}")
            anchors = net.layers[i + 1][1]
            head.weight.zero_()
            bias = torch.full((3, 85), -10.0)
            if anchors == yolo.V3_ANCHORS_32:
                bias[:, 0:2] = 0.0
                bias[:, 2:4] = torch.log(2000.0 / torch.tensor(
                    anchors, dtype=torch.float32))
                bias[:, 4:6] = 3.0
            head.bias.copy_(bias.reshape(-1))
    yolo.save_darknet_weights(path, net)


def yolo_phase(vid: str, ckpt: str, weights: str, workdir: str) -> None:
    from gaitlab_torch.pipeline import detect, tracks

    path = osp.join(workdir, "yolov3_frame_heads.weights")
    frame_sized_heads(weights, path)
    made, seen = [], {}
    get_detector, track_video = detect.get_detector, tracks.track_video

    def spy_detector(*a, **kw):
        made.append(get_detector(*a, **kw))
        return made[-1]

    def spy_tracks(dets, **kw):
        seen["dets"] = list(dets)
        return track_video(seen["dets"], **kw)

    os.environ["GAITLAB_YOLO_WEIGHTS"] = path
    detect.get_detector, tracks.track_video = spy_detector, spy_tracks
    try:
        saved, launches, wall = drive_demo(
            ["--vid_file", vid, "--detector", "yolo", "--ckpt", ckpt],
            osp.join(workdir, "det_yolo"), "walk_det_mp4")
    finally:
        detect.get_detector, tracks.track_video = get_detector, track_video
        del os.environ["GAITLAB_YOLO_WEIGHTS"]
    det = made[0]
    per_frame = [len(d) for d in seen["dets"]]
    hist = {n: per_frame.count(n) for n in sorted(set(per_frame))}
    log(f"[yolo] demo --detector yolo: {wall:.2f} s; {type(det).__name__} "
        f"({getattr(det, 'variant', None)}) on "
        f"{getattr(det, 'device', None)}, {getattr(det, 'forwards', 0)} "
        f"batch forwards; detections per frame {{boxes: frames}} {hist}; "
        f"kernel launches {launches}; persons "
        f"{ {p: len(v['frame_ids']) for p, v in saved.items()} }")
    if not (isinstance(det, detect.YoloDetector) and det.device.type == "cuda"
            and det.forwards > 0):
        raise AssertionError("demo --detector yolo did not run YOLOv3 on "
                             "the card")
    if len(per_frame) != CLIP_FRAMES or set(per_frame) != {1}:
        raise AssertionError(f"expected one box on each of {CLIP_FRAMES} "
                             f"frames, got {per_frame}")
    for pid, person in saved.items():
        check_person(pid, person)


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
        run_demo(vid, trackfile, ckpt, workdir)
        model_loop(model, crops)
        profile_loop(model, crops)
        card_vs_cpu(model, crops)
        del model, crops
        det_vid = make_detect_clip(workdir)
        weights = detect_phase(det_vid, workdir)
        launches, path_errs = track_phase(det_vid, ckpt, workdir)
        yolo_phase(det_vid, ckpt, weights, workdir)
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["max_abs_err"] = max(r["max_abs_err"], path_errs[r["name"]])

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
