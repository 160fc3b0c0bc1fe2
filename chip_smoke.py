#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gaitlab_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repo root, on a machine with CUDA

Phases, each of which exits non-zero on failure:
  1. build   compile the CUDA kernels from gaitlab_torch/csrc (nvcc, sm_90a)
             and the native frame loader (g++; cv2 where the toolchain or
             codec headers are missing, and the build error is printed)
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
  8. gait    MAX-GRNet (GRNet + the gait-feature corrector at gaitlab's
             defaults) from `api.load_pipeline(use_gait_feat=True)` with
             phase 3's checkpoint: card against CPU on a 32-frame track
             (pred_avg, pred_phase, kp_3d, verts; TF32 on printed beside),
             300 frames at bucket 300 against padded to 450, model-loop
             frames/s at buckets 256 and 450 with and without the branch
             and a profile of one gait bucket; a 900-frame track (two
             forwards at 450) cropped on the host and fed to a
             ForwardStream 32 frames at a time, whose feeds must not wait
             for the card (torch's sync debug mode at "error", and less
             host time than one forward takes on the card); then
             `api.analyze_video` on walk_det.mp4 two-pass (a check run
             holding every kernel call against its plain version, then the
             main run) and one-pass (checked too), which must agree on
             persons and frame ids, `gait_report` per person, and a timed
             `demo --onepass`
  9. render  on walk_det.mp4 with phase 3's checkpoint: (a) `demo` with
             gaitlab's default flags, i.e. video output on (skeleton
             overlay, matplotlib): one mp4 frame per clip frame at the
             figure's 1000x500, stage times with "render" and ms per
             rendered frame, every kernel call at a shape phase 6 checked
             (where matplotlib is not installed, the default flags must
             stop before any work, and (a) runs with --mesh_render);
             (b) `demo --mesh_render --sideview --save_obj`: frames twice
             the clip's width, one .obj per person-frame; (c) the z-buffer
             rasterizer (render/raster_torch.py) on scripts/render_bench.py's
             sphere (6,966 vertices, 13,770 faces) at 1920x1080, card
             against CPU (pixels, z-buffers) and card against card
             (bit-identical), ms per person-frame on the card (CUDA events,
             upload and read-back included) beside the host painter's;
             (d) `fbx_output` on (a)'s pkl to .fbx and .glb on the card,
             parsed back; (e) the frame loader: which decoder runs, its
             decode of the clip's PNGs against cv2's, and the runner on
             frame paths (PrefetchLoader) against the same frames as an
             array, with no difference allowed
 10. batchgen the clinical joint database with phase 3's checkpoint, on
             BG_CLIPS at 1280x720 (cropped on the host): OpenPose .mat
             skeletons -> `openpose.load_openpose_anno` on the card, every
             medoid_1 call held against its CPU run, and medoid_1's ms at
             N = 10,000 on card and CPU; then `batch_generation` from the
             PNG folder (the main path), with --stream, and as two shard
             workers (--num_shards 2) whose every kernel call is held
             against the plain version on its own inputs: shard schema,
             finite joints, no failed clip, --stream and the merged
             workers against the one-worker runs, frames/s of each run
             and by stage (PNG extraction, crop+model with the --stream
             decode, flush), and the bytes read back per frame with
             fetch=("kp_3d",) against the default fetch
 11. serve   pinned serving with phase 3's checkpoint: `cli.serve export`
             (torch.export) for cuda and cpu at buckets 128 and 256 (export
             seconds, program and weights.npz sizes; every program's
             state_dict empty, one node of each kernel's op in each graph);
             `cli.serve run` on walk_det.mp4 with the live model's forward
             refused (both kernels launch from the loaded programs, every
             call held against its plain version) against `demo --onepass`
             (persons, frame ids, boxes; joints3d, verts, pose within
             PAD_ATOL); ServingModel.call against the live forward at batch
             128 (outputs, ms with CUDA events, pinned/live); the cpu
             program on CPU_FRAMES frames against the card; MAX-GRNet
             exported at bucket 256 on 200 real frames (a padded tail)
             against the live gait runner, and n_valid read at run time
 12. hmr     the legacy HMR (ResNet-50, 3 regressor steps, SMPL, random
             weights) at batch 128: blendshapes held against its plain
             version, ms/batch, card against CPU on CPU_FRAMES frames, and
             render/vis.py::regressor_output_from_features card against CPU
 13. train   training with phase 3's checkpoint: (a) `cli.train` on two
             .npz shards of 64 real 224 crops of walk.mp4 with synthetic
             labels, at --batch_size 32 for TRAIN_STEPS steps, then
             --resume to TRAIN_RESUME_STEPS: finite logged losses, the
             backbone's parameters and every BN buffer bit-unchanged,
             every head parameter moved, the resumed run starting at the
             saved step, both kernels launched and both ops' backwards
             run once a step, every kernel call held against its plain
             version; (b) one step's loss metrics and head gradients card
             against CPU (and both against the CPU in float64); (c) each
             op's backward at the trainer's shapes (B1 at H*W = 3136 and
             256, B2 at B = 32) against autograd through its plain
             version, forward + backward ms of op and plain version; (d)
             the step's samples/s, peak memory and profile; (e) `cli.train
             --gait --data synthetic` at its defaults, every B1 call
             checked, steps/s; (f) classify.fit and eval.evaluate_batch
             card against CPU
Two lines before the last list every kernel as JSON: launches_by_path
holds the launches of each main path, phase 6's `--smooth` demo
("demo_smooth"), phase 8's two-pass `analyze_video` ("api_gait"), phase
9's default demo ("demo_render"), phase 10's batch_generation from
the folder ("batchgen"), phase 11's `cli.serve run` ("serve_run"),
phase 12's HMR forward ("hmr"), and phase 13's first `cli.train` run
("train") and gait trainer ("train_gait"), each counted from 0 just
before its run; launches is their sum; max_abs_err is the largest over
phases 2, 6, 8, 10, 11, 12 and 13 (13's backwards included); fwd_bwd_ms
holds phase 13's forward + backward timings. Kernel calls are seen at the ops' CUDA implementations, so
calls from inside a loaded torch.export program are counted and checked
too. The line before the last holds the card's name and power limit, and the
last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX or of the gaitlab package.
"""

from __future__ import annotations

import contextlib
import importlib.util
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
GAIT_FRAMES = 450  # the first 450 frames of the walked track, on the card
STREAM_FRAMES, STREAM_FEED = 900, 32  # two forwards at bucket 450
GAIT_CPU_FRAMES = 32  # one track at bucket 32, card against CPU
# gait estimates card against CPU: the same ~100 fp32 convs as phase 4,
# then a GRU and an attention block, summed in two libraries' orders;
# max|card - cpu| <= GAIT_CPU_RTOL * max(1, max|cpu|) (TF32 moves them
# more, and is printed beside)
GAIT_CPU_RTOL = 1e-3
PAD_FRAMES = 300  # at bucket 300 and padded to 450
# padded against exact: the same frames at other batch sizes (cuDNN may
# pick other algorithms) and masked keys; max|a - b| <= PAD_ATOL * max(1,
# max|a|), the CPU tests' 1e-4
PAD_ATOL = 1e-4
GAIT_LOOP_BUCKETS = (256, 450)
GAIT_PROFILE_BUCKET = 256
TRACK_SLACK = 3  # SORT emits a new track from its third hit
# smooth_pose on the card against its CPU run: the SMPL tolerances of the
# CPU tests (tests/test_torch_filters.py, allclose rtol/atol) for vertices
# and joints, the filters' 1e-6 for the filtered pose
SMOOTH_TOL = {"verts": (2e-4, 2e-5), "pose": (1e-6, 1e-6),
              "joints3d": (2e-4, 2e-5)}
RENDER_H, RENDER_W = 1080, 1920
ZBUF_CAM = [0.9, 0.9, 0.05, -0.1]  # scripts/render_bench.py's person scale
ZBUF_REPS = 10
# z-buffer card against CPU: the same float32 arithmetic, fused in other
# orders, may put a fragment on a pixel edge either way
ZBUF_MIN_AGREEMENT = 0.999
ZBUF_ATOL = 1e-5
EXPORT_ATOL = 1e-5  # the CPU tests' tolerance for export floats
BG_W, BG_H = 1280, 720  # a clinic's camera frame: cropped on the host
# (name, fps, frames written, annotation rows or None): 30 fps resampled to
# 20 (120 frames); 20 fps with an annotation 4 frames short (bboxes
# realigned); no annotation (skipped)
BG_CLIPS = (("a001b001c001d001", 30.0, 180, 120),
            ("a001b001c001d002", 20.0, 100, 96),
            ("a001b001c001d003", 20.0, 40, None))
MEDOID_N = 10_000  # one MAX_seqlen clip's joints
# medoid card against CPU: float32 sums in two orders may pick either of
# two near-tied points; their float64 sums must then agree this closely
MEDOID_RTOL = 1e-6
SERVE_BUCKETS = (128, 256)  # walk_det.mp4's tracks of 97 and 140 frames
SERVE_TIMED = 128
SERVE_GAIT_BUCKET, SERVE_GAIT_FRAMES = 256, 200  # a padded tail
SERVE_OPS = ("gaitlab.keypoint_attention_fused.default",
             "gaitlab.blendshapes.default")
TRAIN_SHARDS, TRAIN_SHARD_N = 2, 64
TRAIN_BATCH = 32  # the trainer's default --batch_size
TRAIN_STEPS, TRAIN_RESUME_STEPS = 20, 30
GAIT_TRAIN_STEPS = 20
# one step's loss metrics and head gradients card against CPU: the same
# ~100 fp32 convs as phase 4 and their backward through the head, summed in
# two libraries' orders; max|card - cpu| <= TRAIN_CPU_RTOL * max(1, max|.|)
TRAIN_CPU_RTOL = 1e-3
# ... or, for a gradient, |card - cpu64| <= TRAIN_F64_FACTOR * |cpu - cpu64|
# (float64 on the CPU as the reference; see train_card_vs_cpu)
TRAIN_F64_FACTOR = 3.0
FIT_N = 64  # clips of the seeded cohort
FIT_ATOL = 1e-4  # classify.fit card against CPU: probabilities
EVAL_RTOL = 1e-4  # evaluate_batch card against CPU, relative


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
    core.backbone.train()  # the core keeps it in inference mode otherwise
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


def drive_demo(argv: list, out_dir: str, stem: str, video: bool = False):
    """demo.main(argv) with the kernels' counts set to 0 just before it;
    returns (the saved pkl, the counts just after, wall seconds). Video
    output is off (--save_vid) unless `video`. With the smoke's checkpoint
    the run must write exactly one pkl, smoke_ckpt.pkl."""
    from gaitlab_torch.cli import demo
    from gaitlab_torch.ops.blendshapes import blendshapes
    from gaitlab_torch.ops.keypoint_attention import keypoint_attention_fused

    fns = {"blendshapes": blendshapes,
           "keypoint_attention": keypoint_attention_fused}
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    demo.main(demo.build_parser().parse_args(
        [*argv, "--output_folder", out_dir] + ([] if video else ["--save_vid"])))
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in fns.items()}
    run_dir = osp.join(out_dir, stem)
    pkls = [f for f in os.listdir(run_dir) if f.endswith(".pkl")]
    if pkls != ["smoke_ckpt.pkl"]:
        raise AssertionError(f"unexpected pkl files {pkls}")
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
    """Wrap each kernel's launch, the CUDA implementation of its custom op
    (ops/*.py::_launch), which eager code and loaded torch.export programs
    alike reach through torch.ops.gaitlab.*, to record the input shapes of
    every call on the card. With `check`, each call's result is
    also held against the plain version on the same inputs, and the first
    smooth_pose call's arguments and result are kept. Yields
    {"calls": {kernel: [(shapes, errors or None)]}, "smooth": ...}, where
    errors holds the largest |kernel - plain|, the largest |plain|, and
    kernel's and plain's largest error against the plain version in
    float64."""
    from gaitlab_torch.device import float32_math
    from gaitlab_torch.ops import blendshapes as b2
    from gaitlab_torch.ops import keypoint_attention as b1
    from gaitlab_torch.pipeline import smoothing

    sites = {"keypoint_attention": (b1, "_launch",
                                    b1.keypoint_attention_plain),
             "blendshapes": (b2, "_launch", b2.blendshapes_plain)}
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


def hold_calls(tag: str, checked_calls: dict, main_calls: dict,
               main_counts: dict) -> dict:
    """Every kernel call of a main path at a shape checked on a check run's
    own inputs. The model's activations are not of unit scale, so the
    phase-2 tolerance scales with the largest |output| of each call.
    Returns each kernel's largest checked error."""
    errs = {}
    for name, checked in checked_calls.items():
        errs[name] = max(e["err"] for _, e in checked)
        tol = B1_ATOL if name == "keypoint_attention" else B2_ATOL
        main = [shapes for shapes, _ in main_calls[name]]
        for shapes, e in checked:
            limit = tol * max(1.0, e["scale"])
            log(f"[{tag}] {name} B={shapes[-1][0]} on the check run's own "
                f"inputs: max_abs_err {e['err']:.3e} (tolerance {tol:g} x "
                f"max(1, max|out| {e['scale']:.3g}) = {limit:.3e}); against "
                f"float64: kernel {e['kernel64']:.3e}, plain "
                f"{e['plain64']:.3e}")
            if not e["err"] <= limit:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version on the path's inputs: {e}")
        log(f"[{tag}] {name}: main path batches "
            f"{[sh[-1][0] for sh in main]}, all checked")
        unchecked = set(main) - {sh for sh, _ in checked}
        if len(main) != main_counts[name] or unchecked:
            raise AssertionError(f"{name}: main-path shapes {unchecked} were "
                                 f"not checked")
    return errs


def track_phase(vid: str, ckpt: str, workdir: str
                ) -> tuple[dict, dict, dict]:
    """The demo from a raw video. A first run with --smooth meets the
    model's new bucket shapes and holds every kernel call of it against
    the plain version on the same inputs, and smooth_pose against its CPU
    run; the timed runs come after it, and the --smooth one is the main
    path whose kernel shapes must all have been checked. Returns the main
    path's launches, each kernel's largest checked error and the checked
    calls."""
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
    errs = hold_calls("track", seen["check"]["calls"],
                      seen["smooth"]["calls"], runs["smooth"][1])
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
    return runs["smooth"][1], errs, seen["check"]["calls"]


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


# ---------------------------------------------------------------------------
# phase 8: the gait branch (MAX-GRNet), the API and --onepass
# ---------------------------------------------------------------------------

def gait_track(workdir: str, trackfile: str):
    """walk.mp4's first track (150 frames, from phase 3's PNGs) walked
    forward, back, forward, ... for STREAM_FRAMES frames: the frames, their
    bboxes and the image centre of every frame, on the host."""
    import numpy as np

    from gaitlab_torch.cli.demo import load_pickle
    from gaitlab_torch.pipeline import video

    track = load_pickle(trackfile)[0]
    paths = video.list_image_files(osp.join(workdir, "calib"))
    frames = video.load_frames([paths[i] for i in track["frames"]])
    n = len(frames)
    idx = np.resize(np.concatenate([np.arange(n), np.arange(n - 1, -1, -1)]),
                    STREAM_FRAMES)
    cimg = np.tile(np.float32([CLIP_W / 2, CLIP_H / 2]), (STREAM_FRAMES, 1))
    return frames[idx], np.asarray(track["bbox"], np.float32)[idx], cimg


def gait_card_vs_cpu(model, crops, bbox, cimg) -> None:
    """One GAIT_CPU_FRAMES-frame track at its own bucket on the card and on
    the CPU with the same weights; then on the card with TF32 on."""
    import torch

    from gaitlab_torch.nn.grnet import GRNet, vp_regress

    n = GAIT_CPU_FRAMES
    x, bb, ci = crops[:n], bbox[:n], cimg[:n]
    cpu = GRNet.create(seed=SEED, device="cpu", use_gait_feat=True)
    cpu.module.load_state_dict({k: v.cpu() for k, v in
                                model.module.state_dict().items()})
    card = model.forward(x, bbox=bb, cimg=ci, n_valid=n)[0]
    host = cpu.forward(x.cpu(), bbox=bb, cimg=ci, n_valid=n)[0]
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.inference_mode():
            tf32 = vp_regress(model.smpl, model.module(
                x.permute(0, 3, 1, 2).contiguous(),
                bbox=torch.from_numpy(bb).cuda(),
                cimg=torch.from_numpy(ci).cuda(), n_valid=n))[0]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    for k in ("pred_avg", "pred_phase", "kp_3d", "verts"):
        want = host[k]
        err = (card[k].cpu() - want).abs().max().item()
        tf32_err = (tf32[k].cpu() - want).abs().max().item()
        scale = want.abs().max().item()
        limit = (CPU_ATOL_M if k in ("kp_3d", "verts")
                 else GAIT_CPU_RTOL * max(1.0, scale))
        log(f"[gait] card vs CPU, {n} frames at bucket {n}: {k} max abs "
            f"{err:.3e} (max |cpu| {scale:.3g}; limit {limit:.3e}); with "
            f"TF32 on {tf32_err:.3e}")
        if not (err <= limit and torch.isfinite(card[k]).all()):
            raise AssertionError(f"gait branch: card and CPU disagree on {k}")


def gait_padding(model, crops, bbox, cimg) -> None:
    """PAD_FRAMES frames at bucket PAD_FRAMES and padded to 450: the gait
    estimates and the joints of the real frames must not move."""
    import numpy as np

    from gaitlab_torch.pipeline.runner import GRNetRunner

    n = PAD_FRAMES
    outs = [GRNetRunner(model, buckets=(b,)).forward_crops(
        crops[:n], bbox=bbox[:n], cimg=cimg[:n]) for b in (n, 450)]
    for k in ("pred_avg", "pred_phase", "kp_3d"):
        a, b = outs[0][k], outs[1][k]
        err = float(np.abs(a - b).max())
        limit = PAD_ATOL * max(1.0, float(np.abs(a).max()))
        log(f"[gait] {n} frames at bucket {n} vs padded to 450: {k} "
            f"{a.shape} max abs {err:.3e} (limit {limit:.3e})")
        if not err <= limit:
            raise AssertionError(f"padding moves the gait branch's {k}")


def events_ms(fn, reps: int = 5) -> float:
    """Median device time of one call of a forward (CUDA events), after
    two warm-up calls."""
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


def gait_loop(plain, gait, crops, bbox, cimg) -> dict:
    """Model-loop frames/s (CUDA events, median of 5) at each of
    GAIT_LOOP_BUCKETS with and without the gait branch, and a profile of
    one gait bucket. Returns MAX-GRNet's ms per bucket."""
    gait_ms = {}
    for b in GAIT_LOOP_BUCKETS:
        x, bb, ci = crops[:b], bbox[:b], cimg[:b]
        ms = events_ms(lambda: plain.forward(x))
        gait_ms[b] = events_ms(lambda: gait.forward(x, bbox=bb, cimg=ci,
                                                     n_valid=b))
        log(f"[gait] model loop at bucket {b} (crops -> GRNet -> SMPL, "
            f"float32, TF32 off): without the gait branch {ms:.2f} ms = "
            f"{b / ms * 1e3:.1f} frames/s; MAX-GRNet {gait_ms[b]:.2f} ms = "
            f"{b / gait_ms[b] * 1e3:.1f} frames/s "
            f"({100 * (gait_ms[b] / ms - 1):+.2f}%)")

    b = GAIT_PROFILE_BUCKET
    x, bb, ci = crops[:b], bbox[:b], cimg[:b]
    profiled("gait", f"one MAX-GRNet bucket of {b}",
             lambda: gait.forward(x, bbox=bb, cimg=ci, n_valid=b), 12)
    return gait_ms


def gait_stream(runner, frames, bbox, cimg, forward_ms: float) -> None:
    """The whole STREAM_FRAMES-frame track (two forwards at bucket 450)
    through a ForwardStream session as the one-pass pipeline drives it:
    STREAM_FEED frames at a time are cropped on the host (cv2) and fed with
    their rows; second of two runs. Printed: host ms of the crops, of the
    feeds and of finish(), and the wall time beside the card's time. The
    feeds run with torch's sync debug mode at "error", so any operation of
    theirs that makes the host wait for the card raises; and they must take
    less host time than one forward takes on the card (forward_ms): had a
    feed waited for a forward, the feeds would include it."""
    import numpy as np
    import torch

    def run():
        crop_s = feed_s = 0.0
        t0 = time.perf_counter()
        session = runner.open_stream()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for s in range(0, len(frames), STREAM_FEED):
                e = s + STREAM_FEED
                t = time.perf_counter()
                u8 = runner._host_crop(frames[s:e], bbox[s:e],
                                       runner.bbox_scale)
                crop_s += time.perf_counter() - t
                t = time.perf_counter()
                session.feed(u8, bbox=bbox[s:e], cimg=cimg[s:e])
                feed_s += time.perf_counter() - t
        finally:
            torch.cuda.set_sync_debug_mode("default")
        fed = time.perf_counter()
        out = session.finish()
        end = time.perf_counter()
        return (crop_s * 1e3, feed_s * 1e3, (end - fed) * 1e3,
                (end - t0) * 1e3, out)

    run()
    crop_ms, feed_ms, finish_ms, wall_ms, out = run()
    n_fwd = -(-len(frames) // runner.buckets[-1])
    log(f"[gait] ForwardStream, {len(frames)} frames cropped on the host and "
        f"fed {STREAM_FEED} at a time ({n_fwd} forwards at bucket "
        f"{runner.buckets[-1]}, {forward_ms:.2f} ms each on the card): host "
        f"crops {crop_ms:.2f} ms, feeds {feed_ms:.2f} ms, finish "
        f"{finish_ms:.2f} ms; wall {wall_ms:.2f} ms = "
        f"{len(frames) / wall_ms * 1e3:.1f} frames/s (crops + card "
        f"{crop_ms + n_fwd * forward_ms:.2f} ms)")
    if out["kp_3d"].shape[0] != len(frames) or not all(
            np.isfinite(out[k]).all() for k in ("pred_avg", "pred_phase")):
        raise AssertionError("ForwardStream: wrong or non-finite outputs")
    if not feed_ms < forward_ms:
        raise AssertionError("the feeds waited for the card's forwards")


def profiled(tag: str, label: str, fn, top: int) -> None:
    """One call of `fn` under torch.profiler: device busy share of the
    window, device operations, and the top kernels by device time, logged
    under [tag]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    if total <= 0:
        log(f"[{tag}] profile of {label}: no device time seen, not measured")
        return
    log(f"[{tag}] profile of {label}: device busy {total:.3f} ms of a "
        f"{wall_ms:.2f} ms window ({100 * total / wall_ms:.1f}%), "
        f"{sum(e.count for e in kernels)} device operations")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        kms = e.self_device_time_total / 1e3
        log(f"[{tag}]   {kms:8.3f} ms {100 * kms / total:5.1f}% "
            f"x{e.count:<5d} {e.key[:90]}")


def api_phase(det_vid: str, runner, ckpt: str, workdir: str
              ) -> tuple[dict, dict]:
    """gaitlab_torch.api.analyze_video with the gait pipeline, two-pass and
    one-pass, and gait_report. A first two-pass run holds every kernel call
    against the plain version on its own inputs; the timed two-pass run is
    this phase's main path; the one-pass run is checked call by call too and
    must give the two-pass persons and frame ids. Then a timed
    `demo --onepass`. Returns the main path's launches and each kernel's
    largest checked error."""
    import numpy as np

    from gaitlab_torch import api
    from gaitlab_torch.gait.features import FEATURE_NAMES
    from gaitlab_torch.ops.blendshapes import blendshapes
    from gaitlab_torch.ops.keypoint_attention import keypoint_attention_fused

    fns = {"blendshapes": blendshapes,
           "keypoint_attention": keypoint_attention_fused}
    runs, seen = {}, {}
    for tag, onepass in (("check", False), ("twopass", False),
                         ("onepass", True)):
        with kernel_spies(check=tag != "twopass") as seen[tag]:
            for fn in fns.values():
                fn.launches = 0
            t0 = time.perf_counter()
            res = api.analyze_video(det_vid, runner=runner,
                                    joint_type="kinectv2", onepass=onepass)
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in fns.items()}
        runs[tag] = (res, launches, wall)
        spans_ = {p: (int(r["frame_ids"][0]), int(r["frame_ids"][-1]) + 1,
                      len(r["frame_ids"])) for p, r in res.items()}
        log(f"[gait] api.analyze_video (gait pipeline, smooth, "
            f"{'one-pass' if onepass else 'two-pass'}; {tag} run): "
            f"{wall:.2f} s; kernel launches {launches}; persons "
            f"{{id: (first, end, frames)}} {spans_}")
        if len(res) != 2:
            raise AssertionError(f"expected two persons, got {spans_}")
        for pid, r in res.items():
            n = len(r["frame_ids"])
            for k, shape in (("joints3d", (n, 25, 3)), ("verts", (n, 6890, 3)),
                             ("pose", (n, 72)), ("orig_cam", (n, 4))):
                v = np.asarray(r[k])
                if v.shape != shape or not np.all(np.isfinite(v)):
                    raise AssertionError(f"person {pid} {k}: {v.shape}")
        if launches["blendshapes"] != launches["keypoint_attention"] + len(res) \
                or launches["keypoint_attention"] <= 0:
            raise AssertionError(f"unexpected launches {launches}")
    frames = {tag: sorted(r["frame_ids"].tolist() for r in runs[tag][0].values())
              for tag in runs}
    if frames["onepass"] != frames["twopass"]:
        raise AssertionError("one-pass and two-pass disagree on frames")
    log("[gait] one-pass and two-pass agree: 2 persons, the same frame ids")
    for tag in ("twopass", "onepass"):
        for pid, rep in api.gait_report(runs[tag][0], fps=20.0).items():
            f = rep["features"]
            log(f"[gait] gait_report {tag} person {pid}: "
                f"{ {k: round(float(f[k]), 6) for k in FEATURE_NAMES} }"
                f"; heel strikes left {len(f['events']['left'])}, right "
                f"{len(f['events']['right'])}")
    errs = hold_calls("gait", seen["check"]["calls"],
                      seen["twopass"]["calls"], runs["twopass"][1])
    one = hold_calls("gait one-pass", seen["onepass"]["calls"],
                     seen["onepass"]["calls"], runs["onepass"][1])
    errs = {k: max(v, one[k]) for k, v in errs.items()}

    saved, launches, wall = drive_demo(
        ["--vid_file", det_vid, "--detector", "median_bg", "--ckpt", ckpt,
         "--onepass"], osp.join(workdir, "det_onepass"), "walk_det_mp4")
    log(f"[gait] demo --detector median_bg --onepass: {wall:.2f} s; kernel "
        f"launches {launches}; persons [first, end) frames {spans(saved)}")
    if len(saved) != 2 or min(launches.values()) <= 0:
        raise AssertionError("demo --onepass: expected two persons on the card")
    for pid, person in saved.items():
        check_person(pid, person)
    return runs["twopass"][1], errs


def gait_phase(ckpt: str, workdir: str, trackfile: str, det_vid: str
               ) -> tuple[dict, dict]:
    import torch

    from gaitlab_torch import api
    from gaitlab_torch.cli.demo import build_model
    from gaitlab_torch.device import upload
    from gaitlab_torch.pipeline.crop import normalize_image

    model, runner = api.load_pipeline(ckpt=ckpt, use_gait_feat=True)
    corr = sum(p.numel() for p in model.module.pfeat_corrector.parameters())
    total = sum(p.numel() for p in model.module.parameters())
    log(f"[gait] MAX-GRNet on {model.device}: {total / 1e6:.2f} M parameters, "
        f"{corr / 1e6:.2f} M of them in the gait corrector (h_size 1024, 4 "
        f"heads, 1 block, BiGRU 2x300)")
    frames, bbox, cimg = gait_track(workdir, trackfile)
    crops = normalize_image(upload(runner._host_crop(
        frames[:GAIT_FRAMES], bbox[:GAIT_FRAMES], runner.bbox_scale),
        model.device))
    with kernel_spies(check=True) as seen:
        gait_card_vs_cpu(model, crops, bbox, cimg)
        gait_padding(model, crops, bbox, cimg)
    errs = hold_calls("gait forward", seen["calls"], seen["calls"],
                      {k: len(v) for k, v in seen["calls"].items()})
    gait_ms = gait_loop(build_model(ckpt), model, crops, bbox, cimg)
    del crops
    torch.cuda.empty_cache()
    gait_stream(runner, frames, bbox, cimg, gait_ms[runner.buckets[-1]])
    torch.cuda.empty_cache()
    launches, api_errs = api_phase(det_vid, runner, ckpt, workdir)
    return launches, {k: max(v, api_errs[k]) for k, v in errs.items()}


# ---------------------------------------------------------------------------
# phase 9: render, export and the frame loader
# ---------------------------------------------------------------------------

def sphere_mesh(rings: int = 85, segs: int = 81, r: float = 0.45):
    """scripts/render_bench.py's UV sphere at SMPL scale: 6,966 vertices,
    13,770 faces."""
    import numpy as np

    phi = np.linspace(0, np.pi, rings + 1)
    theta = np.linspace(0, 2 * np.pi, segs, endpoint=False)
    P, T = np.meshgrid(phi, theta, indexing="ij")
    verts = r * np.stack([np.sin(P) * np.cos(T), np.cos(P),
                          np.sin(P) * np.sin(T)], axis=-1).reshape(-1, 3)
    faces = []
    for i in range(rings):
        for j in range(segs):
            a = i * segs + j
            b = i * segs + (j + 1) % segs
            c = (i + 1) * segs + j
            d = (i + 1) * segs + (j + 1) % segs
            faces += [[a, b, c], [b, d, c]]
    return verts, np.asarray(faces, np.int64)


def video_frames(path: str) -> tuple[int, tuple]:
    """(frame count, frame shape) of a video as cv2 decodes it."""
    import cv2

    cap = cv2.VideoCapture(path)
    n, shape = 0, None
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            n, shape = n + 1, frame.shape
    finally:
        cap.release()
    return n, shape


def render_demos(det_vid: str, ckpt: str, workdir: str, checked: dict,
                 card: str) -> tuple[dict, str, dict]:
    """(a) the demo with gaitlab's default flags (video output on, skeleton
    overlay) and (b) --mesh_render --sideview --save_obj, on walk_det.mp4.
    Returns (a)'s launches, its pkl path and its results."""
    from gaitlab_torch.cli import demo
    from gaitlab_torch.pipeline import runner, video
    from gaitlab_torch.render import overlay

    stages = {"load_model": (demo, "load_model"),
              "decode to PNG": (video, "video_to_images"),
              "detect+track": (demo, "run_tracking"),
              "crop+model": (runner.GRNetRunner, "run_track"),
              "render": (overlay, "render_video")}
    base = ["--vid_file", det_vid, "--detector", "median_bg", "--ckpt", ckpt]
    default_extra = []
    if importlib.util.find_spec("matplotlib") is None:
        # the skeleton overlay draws with matplotlib: the demo refuses the
        # default flags before any work, and (a) renders the mesh instead
        try:
            drive_demo(base, osp.join(workdir, "render_nompl"),
                       "walk_det_mp4", video=True)
        except ModuleNotFoundError as e:
            log(f"[render] matplotlib is not installed here: the default "
                f"flags stop before any decode or model work ({e}); (a) "
                f"runs with --mesh_render, the skeleton overlay is not "
                f"measured")
        else:
            raise AssertionError("the demo ran the skeleton overlay "
                                 "without matplotlib")
        default_extra = ["--mesh_render"]
    out = {}
    for tag, extra in (("default", default_extra),
                       ("mesh", ["--mesh_render", "--sideview",
                                 "--save_obj"])):
        out_dir = osp.join(workdir, f"render_{tag}")
        with stage_timers(stages) as spent, \
                kernel_spies(check=False) as seen:
            saved, launches, wall = drive_demo(base + extra, out_dir,
                                               "walk_det_mp4", video=True)
        run_dir = osp.join(out_dir, "walk_det_mp4")
        n, shape = video_frames(osp.join(run_dir, "smoke_ckpt.mp4"))
        log(f"[render] demo {' '.join(extra) or '(default flags)'}: "
            f"{wall:.2f} s; stages "
            f"{ {k: round(v, 4) for k, v in spent.items()} }, the rest "
            f"{wall - sum(spent.values()):.4f} s; render "
            f"{spent['render'] * 1e3 / max(n, 1):.2f} ms per rendered frame "
            f"({n} frames {shape[1]}x{shape[0]}); kernel launches "
            f"{launches}; persons [first, end) frames {spans(saved)} ({card})")
        if set(saved) != {0, 1}:
            raise AssertionError(f"expected persons 0 and 1, got {list(saved)}")
        for pid, person in saved.items():
            check_person(pid, person)
        if "--sideview" in extra:
            want = (CLIP_H, 2 * CLIP_W, 3)
        elif "--mesh_render" in extra:
            want = (CLIP_H, CLIP_W, 3)
        else:
            want = (500, 1000, 3)  # the skeleton overlay's 10x5 in figure
        if n != CLIP_FRAMES or shape != want:
            raise AssertionError(f"{tag} video: {n} frames of {shape}, want "
                                 f"{CLIP_FRAMES} of {want}")
        if min(launches.values()) <= 0 or \
                launches["blendshapes"] != launches["keypoint_attention"]:
            raise AssertionError(f"unexpected launches {launches}")
        for name, calls in seen["calls"].items():
            unchecked = {sh for sh, _ in calls} - {sh for sh, _ in
                                                   checked[name]}
            if len(calls) != launches[name] or unchecked:
                raise AssertionError(f"{name}: shapes {unchecked} of the "
                                     f"render path were not checked")
        log(f"[render] every kernel call of this run at a shape held "
            f"against its plain version in phase 6: "
            f"{ {k: [sh[-1][0] for sh, _ in v] for k, v in seen['calls'].items()} }")
        if tag == "mesh":
            objs = sum(len(fs) for _, _, fs in os.walk(osp.join(run_dir,
                                                                "rendered")))
            want_objs = sum(len(p["frame_ids"]) for p in saved.values())
            log(f"[render] --save_obj: {objs} .obj files for {want_objs} "
                f"person-frames")
            if objs != want_objs:
                raise AssertionError("--save_obj wrote other files")
        out[tag] = (launches, osp.join(run_dir, "smoke_ckpt.pkl"), saved)
    return out["default"]


def zbuffer_phase(card: str) -> None:
    """(c) The sphere at 1920x1080 through render_mesh_zbuffer on the card
    and on the CPU: pixel agreement, z-buffers where both are covered, two
    card runs bit-identical; ms per person-frame on the card (CUDA events,
    host prep, upload and read-back included, median of ZBUF_REPS) beside
    the host painter's on the same frame."""
    import numpy as np
    import torch

    from gaitlab_torch.render import raster, raster_torch

    verts, faces = sphere_mesh()
    img = np.random.default_rng(SEED).integers(0, 255, (RENDER_H, RENDER_W,
                                                        3)).astype(np.uint8)
    color = np.float32([1.0, 1.0, 0.9]) * 255.0
    inputs = raster_torch.mesh_inputs(RENDER_H, RENDER_W, verts, ZBUF_CAM,
                                      faces)
    pix, depth, tri, shade, groups = inputs
    frags = sum(len(i) * k * k for i, k in groups)

    def rasterize(device):
        canvas, zbuf = raster_torch._rasterize(pix, depth, tri, shade, color,
                                               img, groups, device)
        return (canvas.clamp(0, 255).to(torch.uint8).cpu().numpy(),
                zbuf.cpu().numpy())

    torch.cuda.reset_peak_memory_stats()
    card_a = rasterize("cuda")
    peak = torch.cuda.max_memory_allocated() / 2**20
    card_b = rasterize("cuda")
    cpu = rasterize("cpu")
    covered = (card_a[1] < raster_torch.FAR) & (cpu[1] < raster_torch.FAR)
    agree = (card_a[0] == cpu[0]).all(-1).mean()
    zerr = float(np.abs(card_a[1] - cpu[1])[covered].max())
    same = all(np.array_equal(x, y) for x, y in zip(card_a, card_b))
    log(f"[render] z-buffer, sphere {len(verts)} vertices / {len(faces)} "
        f"faces at {RENDER_W}x{RENDER_H}: window classes "
        f"{[(len(i), k) for i, k in groups]} ({frags / 1e6:.2f} M fragments); "
        f"card vs CPU {agree:.6f} of pixels equal (limit "
        f"{ZBUF_MIN_AGREEMENT}), max |zbuf diff| where both covered "
        f"{zerr:.3e} (limit {ZBUF_ATOL:g}) over {int(covered.sum())} pixels; "
        f"two card runs bit-identical: {same}; peak card memory "
        f"{peak:.1f} MiB")
    if not (agree >= ZBUF_MIN_AGREEMENT and zerr <= ZBUF_ATOL and same):
        raise AssertionError("the z-buffer on the card disagrees")
    if not np.array_equal(raster_torch.render_mesh_zbuffer(
            img, verts, ZBUF_CAM, faces), card_a[0]):
        raise AssertionError("render_mesh_zbuffer paints another image")

    def events_ms(fn):
        fn()
        times = []
        for _ in range(ZBUF_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    card_ms = events_ms(lambda: raster_torch.render_mesh_zbuffer(
        img, verts, ZBUF_CAM, faces))
    prep_ms = []
    for _ in range(ZBUF_REPS):
        t0 = time.perf_counter()
        raster_torch.mesh_inputs(RENDER_H, RENDER_W, verts, ZBUF_CAM, faces)
        prep_ms.append((time.perf_counter() - t0) * 1e3)
    device_ms = events_ms(lambda: raster_torch._rasterize(
        pix, depth, tri, shade, color, img, groups, "cuda"))
    painter_ms = []
    for _ in range(ZBUF_REPS):
        t0 = time.perf_counter()
        raster.render_mesh(img, verts, ZBUF_CAM, faces)
        painter_ms.append((time.perf_counter() - t0) * 1e3)
    profiled("render", "one z-buffer frame (host inputs to card canvas)",
             lambda: raster_torch._rasterize(pix, depth, tri, shade, color,
                                             img, groups, "cuda"), 6)
    log(f"[render] z-buffer on the card: {card_ms:.3f} ms per person-frame "
        f"(CUDA events, median of {ZBUF_REPS}: host prep "
        f"{statistics.median(prep_ms):.3f} ms, upload, raster {device_ms:.3f}"
        f" ms with the frame's upload, read-back); host painter on the same "
        f"frame {statistics.median(painter_ms):.3f} ms ({card})")


def export_phase(pkl: str, workdir: str, saved: dict) -> None:
    """(d) fbx_output on (a)'s pkl to .fbx and .glb on the card, parsed
    back: the node tree, 24 LimbNodes and the frame count; the skinning
    data computed on the card against the CPU."""
    import numpy as np

    from gaitlab_torch.cli import fbx_output
    from gaitlab_torch.render import export, fbx

    n = max(len(p["frame_ids"]) for p in saved.values())
    paths = {}
    for ext in (".fbx", ".glb"):
        paths[ext] = osp.join(workdir, "export", f"anim{ext}")
        t0 = time.perf_counter()
        if fbx_output.main(["--input", pkl, "--output", paths[ext]]) != 0:
            raise AssertionError(f"fbx_output {ext} failed")
        log(f"[render] fbx_output {ext} on the card: "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms, "
            f"{os.path.getsize(paths[ext])} bytes")
    tree = fbx.parse_fbx(paths[".fbx"])
    limbs = [m for m in fbx.find_nodes(tree, "Model")
             if m["props"][2] == b"LimbNode"]
    key_counts = {len(k["props"][0]) for k in fbx.find_nodes(tree, "KeyTime")}
    top = [node["name"] for node in tree["nodes"]]
    log(f"[render] .fbx parsed: version {tree['version']}, top nodes {top}, "
        f"{len(limbs)} LimbNodes, key counts {key_counts} for {n} frames")
    if len(limbs) != 24 or key_counts != {n} or "Objects" not in top:
        raise AssertionError("the .fbx has another tree")
    gltf, _ = parse_glb(paths[".glb"])
    times = gltf["accessors"][gltf["animations"][0]["samplers"][0]["input"]]
    log(f"[render] .glb parsed: {len(gltf['nodes'])} nodes, "
        f"{len(gltf['animations'][0]['channels'])} channels, {times['count']} "
        f"keyframes")
    if len(gltf["nodes"]) != 25 or times["count"] != n:
        raise AssertionError("the .glb has another tree")
    # what the card computes for both files, against the CPU
    person = max(saved.values(), key=lambda p: len(p["frame_ids"]))
    card, host = (export.anim_skin_data(person["pose"], person["betas"],
                                        device=d) for d in (None, "cpu"))
    errs = {k: float(np.abs(card[k] - host[k]).max())
            for k in ("v_shaped", "joints_rest", "quats_wxyz")}
    log(f"[render] skinning data card vs CPU: max abs {errs} (tolerance "
        f"{EXPORT_ATOL:g}: float32 sums in other orders)")
    if not max(errs.values()) <= EXPORT_ATOL:
        raise AssertionError("export data: card and CPU disagree")


def parse_glb(path: str):
    """(glTF JSON, binary chunk) of a .glb file."""
    import struct

    with open(path, "rb") as f:
        magic, version, _ = struct.unpack("<III", f.read(12))
        jlen, _ = struct.unpack("<II", f.read(8))
        gltf = json.loads(f.read(jlen))
        blen, _ = struct.unpack("<II", f.read(8))
        blob = f.read(blen)
    if (magic, version) != (0x46546C67, 2):
        raise AssertionError("not a glTF 2 binary")
    return gltf, blob


def loader_phase(det_vid: str, ckpt: str, workdir: str, saved: dict,
                 card: str) -> None:
    """(e) The native loader: which decoder runs; its decode of the clip's
    PNG folder against cv2's; the runner on frame paths (PrefetchLoader,
    pinned chunks) against the same frames as an array."""
    import cv2
    import numpy as np

    from gaitlab_torch.cli.demo import build_model
    from gaitlab_torch.pipeline import loader, video
    from gaitlab_torch.pipeline.runner import GRNetRunner

    decoder, error = loader.native_status()
    log(f"[render] frame loader: {decoder} decoder"
        + (f" (native build failed: {error})" if error else ""))
    folder = video.video_to_images(det_vid, osp.join(workdir, "loader"))
    paths = video.list_image_files(folder)
    t0 = time.perf_counter()
    frames = loader.load_frames(paths)
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = np.stack([cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
                    for p in paths])
    cv2_ms = (time.perf_counter() - t0) * 1e3
    equal = np.array_equal(frames, ref)
    log(f"[render] {len(paths)} PNG frames: loader.load_frames ({decoder}) "
        f"{load_ms:.1f} ms, cv2.imread one by one {cv2_ms:.1f} ms, equal "
        f"{equal} ({card})")
    if not equal:
        raise AssertionError("the loader's decode differs from cv2's")
    person = saved[0]
    ids = np.asarray(person["frame_ids"])
    runner = GRNetRunner(build_model(ckpt), bbox_scale=1.0)
    bboxes = np.asarray(person["bboxes"], np.float32)
    on_paths = runner.run_track([paths[i] for i in ids], bboxes)
    on_array = runner.run_track(ref[ids], bboxes)
    errs = {k: float(np.abs(on_paths[k] - on_array[k]).max())
            for k in ("pred_cam", "pose", "joints3d")}
    log(f"[render] runner on {len(ids)} frame paths (PrefetchLoader, "
        f"{runner.ingest_chunk} a chunk) vs the same frames as an array: "
        f"max abs diff {errs} (tolerance 0: the same uint8 frames reach the "
        f"same crop and forward)")
    if max(errs.values()) != 0.0:
        raise AssertionError("the runner on frame paths gives other outputs")


def render_phase(det_vid: str, ckpt: str, workdir: str, checked: dict,
                 card: str) -> dict:
    """Phase 9; returns the default demo's launches ("demo_render")."""
    launches, pkl, saved = render_demos(det_vid, ckpt, workdir, checked, card)
    zbuffer_phase(card)
    export_phase(pkl, workdir, saved)
    loader_phase(det_vid, ckpt, workdir, saved, card)
    return launches


# ---------------------------------------------------------------------------
# phase 10: batch_generation, the clinical joint database
# ---------------------------------------------------------------------------

def make_batchgen_corpus(workdir: str) -> tuple[str, str]:
    """BG_CLIPS at BG_W x BG_H in a folder, and OpenPose-style .mat
    skeletons for them (x, y normalised to the frame): the walker; in the
    first clip also a smaller person as confident as the walker, so both
    get a bbox and the larger one is kept; no skeleton for the last clip;
    and one empty annotation, which is listed as bad. Returns (the clip
    folder, the annotation folder)."""
    import cv2
    import numpy as np
    import scipy.io as sio

    vids = osp.join(workdir, "bg_vids")
    annos = osp.join(workdir, "bg_openpose")
    os.makedirs(vids)
    os.makedirs(annos)
    rng = np.random.default_rng(SEED)
    bg = rng.integers(40, 70, size=(BG_H, BG_W, 3)).astype(np.uint8)
    # joint offsets inside a 120 x 400 px walker, fixed for the corpus
    offsets = np.stack([rng.uniform(0, 120, 25), rng.uniform(0, 400, 25)], 1)
    for k, (name, fps, n, rows) in enumerate(BG_CLIPS):
        writer = cv2.VideoWriter(osp.join(vids, f"{name}.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                 (BG_W, BG_H))
        for i in range(n):
            frame = bg.copy()
            x = 400 + int(400 * i / n)
            cv2.rectangle(frame, (x, 200), (x + 120, 600),
                          (210 - 30 * k, 190, 180), -1)
            cv2.circle(frame, (x + 60, 180), 40, (200, 170, 160), -1)
            writer.write(frame)
        writer.release()
        if rows is None:
            continue
        t = np.arange(rows) * n / rows  # the frames the annotation saw
        sk = np.zeros((1, rows, 25, 3))
        sk[0, :, :, 0] = (400 + 400 * t / n)[:, None] + offsets[None, :, 0]
        sk[0, :, :, 1] = 200 + offsets[None, :, 1]
        sk[0, :, :, :2] += rng.normal(0, 3, (rows, 25, 2))
        sk[0, :, :, 2] = rng.uniform(0.6, 0.95, (rows, 25))
        if k == 0:  # a second, smaller person
            small = sk[0].copy()
            small[:, :, :2] = 100 + 0.5 * (small[:, :, :2] - 100)
            small[:, :, 2] = rng.uniform(0.6, 0.95, (rows, 25))
            sk = np.concatenate([sk, small[None]])
        sk[..., 0] /= BG_W
        sk[..., 1] /= BG_H
        sio.savemat(osp.join(annos, f"{name}.mat"), {"skeleton": sk})
    sio.savemat(osp.join(annos, "a001b009c001d001.mat"),
                {"skeleton": np.zeros((0, 0, 0, 0))})
    return vids, annos


def medoid_row_sum(points, i: int) -> float:
    import numpy as np

    p = np.asarray(points, np.float64)
    return float(np.linalg.norm(p - p[i], axis=1).sum())


@contextlib.contextmanager
def medoid_check():
    """Every medoid_1 call on the card is held against the same call on
    the CPU: the index equal, or both indices' sums of distances, in
    float64, within MEDOID_RTOL. Yields the list of (N, card index, CPU
    index)."""
    from gaitlab_torch.pipeline import medoids

    original = medoids.medoid_1
    seen = []

    def checked(points, chunk=1024, device=None):
        idx = original(points, chunk, device)
        cpu = original(points, chunk, "cpu")
        if idx != cpu:
            a, b = medoid_row_sum(points, idx), medoid_row_sum(points, cpu)
            if abs(a - b) > MEDOID_RTOL * b:
                raise AssertionError(f"medoid_1 on {len(points)} points: card "
                                     f"{idx} ({a}), CPU {cpu} ({b})")
        seen.append((len(points), idx, cpu))
        return idx

    medoids.medoid_1 = checked
    try:
        yield seen
    finally:
        medoids.medoid_1 = original


def medoid_timing() -> None:
    """medoid_1 at N = MEDOID_N (one clip of MAX_seqlen frames x 25
    joints, (x, y, confidence)) on the card and on the CPU."""
    import numpy as np

    from gaitlab_torch.cli.batch_generation import MAX_seqlen
    from gaitlab_torch.pipeline.medoids import medoid_1

    rng = np.random.default_rng(SEED)
    pts = np.concatenate([rng.normal(960, 150, (MEDOID_N, 2)),
                          rng.uniform(0.1, 1.0, (MEDOID_N, 1))], 1
                         ).astype(np.float32)
    ms = {}
    for dev in ("cuda", "cpu"):
        medoid_1(pts, device=dev)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            idx = medoid_1(pts, device=dev)  # an int: the host waits
            times.append((time.perf_counter() - t0) * 1e3)
        ms[dev] = (statistics.median(times), idx)
    log(f"[batchgen] medoid_1 at N = {MEDOID_N} ({MAX_seqlen} frames x 25 "
        f"joints): card {ms['cuda'][0]:.3f} ms, CPU {ms['cpu'][0]:.3f} ms "
        f"(host clock, median of 5, upload and read-back included); index "
        f"card {ms['cuda'][1]}, CPU {ms['cpu'][1]}")
    if ms["cuda"][1] != ms["cpu"][1]:
        a, b = (medoid_row_sum(pts, ms[d][1]) for d in ("cuda", "cpu"))
        if abs(a - b) > MEDOID_RTOL * b:
            raise AssertionError(f"medoid_1 at N = {MEDOID_N}: {a} vs {b}")


def check_shards(paths: list) -> dict:
    """Read shard files: the schema, finite joints; {vid_name: (frames,
    bbox, joints3D)}."""
    import numpy as np

    from gaitlab_torch.cli.demo import load_pickle

    out = {}
    for p in paths:
        db = load_pickle(p)
        if set(db) != {"vid_name", "bbox", "joints3D"}:
            raise AssertionError(f"{p}: keys {sorted(db)}")
        n = len(db["vid_name"])
        if db["bbox"].shape != (n, 4) or db["joints3D"].shape != (n, 25, 3) \
                or db["joints3D"].dtype != np.float32 \
                or not np.all(np.isfinite(db["joints3D"])):
            j = db["joints3D"]
            raise AssertionError(f"{p}: bbox {db['bbox'].shape}, joints3D "
                                 f"{j.shape} {j.dtype}")
        for name in dict.fromkeys(db["vid_name"].tolist()):
            sel = db["vid_name"] == name
            if name in out:
                raise AssertionError(f"{name} in two shards")
            out[name] = (int(sel.sum()), db["bbox"][sel], db["joints3D"][sel])
    return out


def same_database(tag: str, got: dict, want: dict) -> float:
    """The same clips, frames and bboxes; joints within PAD_ATOL x max(1,
    max|joints|). Returns the largest joint difference."""
    import numpy as np

    if list(got) != list(want):
        raise AssertionError(f"{tag}: clips {list(got)} vs {list(want)}")
    worst = 0.0
    for name, (n, bbox, joints) in want.items():
        gn, gbox, gjoints = got[name]
        if gn != n or not np.array_equal(gbox, bbox):
            raise AssertionError(f"{tag} {name}: frames or bboxes differ")
        err = float(np.abs(gjoints - joints).max())
        limit = PAD_ATOL * max(1.0, float(np.abs(joints).max()))
        if err > limit:
            raise AssertionError(f"{tag} {name}: joints differ by {err:.3e} "
                                 f"> {limit:.3e}")
        worst = max(worst, err)
    return worst


def readback_bytes(runner_kw: dict, model, frames, bboxes
                   ) -> tuple[float, float]:
    """Bytes a run_track reads back per frame (the arrays ForwardStream's
    finish returns), and the run's ms."""
    from gaitlab_torch.pipeline import runner as runner_mod

    finish = runner_mod.ForwardStream.finish
    got = []

    def spy(self):
        out = finish(self)
        got.append(sum(v.nbytes for v in out.values()))
        return out

    runner_mod.ForwardStream.finish = spy
    try:
        t0 = time.perf_counter()
        runner_mod.GRNetRunner(model, **runner_kw).run_track(frames, bboxes,
                                                             scale=1.1)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        runner_mod.ForwardStream.finish = finish
    return sum(got) / len(frames), ms


def batchgen_phase(ckpt: str, workdir: str) -> tuple[dict, dict]:
    """The OpenPose ingestion on the card (every medoid held against the
    CPU), then batch_generation from the PNG folder (the main path: its
    launches are counted from 0 and its kernel shapes must all be checked),
    with --stream, and as two shard workers (with every kernel call held
    against the plain version on its own inputs). Returns the main path's
    launches and each kernel's largest checked error."""
    import numpy as np

    from gaitlab_torch.cli import batch_generation as bg
    from gaitlab_torch.cli import demo
    from gaitlab_torch.ops.blendshapes import blendshapes
    from gaitlab_torch.ops.keypoint_attention import keypoint_attention_fused
    from gaitlab_torch.pipeline import openpose, video

    vids, annos = make_batchgen_corpus(workdir)
    bbox_path = osp.join(workdir, "bg_bbox.json")
    with medoid_check() as seen:
        t0 = time.perf_counter()
        coarse = openpose.load_openpose_anno(
            annos, bbox_path, osp.join(workdir, "bg_bad.json"),
            img_w=BG_W, img_h=BG_H)
        wall = time.perf_counter() - t0
    bad = demo.load_pickle(osp.join(workdir, "bg_bad.json"))
    log(f"[batchgen] load_openpose_anno on the card: {wall * 1e3:.1f} ms; "
        f"clips {sorted(coarse)}, bad {bad}; medoid_1 calls (N, card index, "
        f"CPU index) {seen}")
    want_clips = [c[0] for c in BG_CLIPS if c[3] is not None]
    if sorted(coarse) != want_clips or bad != ["a001b009c001d001.mat"] or \
            len(seen) != 3:  # two skeletons in the first clip
        raise AssertionError("load_openpose_anno: unexpected clips or calls")
    for name in want_clips:
        log(f"[batchgen] {name}: bbox [cx, cy, w, h] "
            f"{np.round(coarse[name][0], 2).tolist()}")
    medoid_timing()

    fns = {"blendshapes": blendshapes,
           "keypoint_attention": keypoint_attention_fused}
    stages = {"load_model": (demo, "load_model"),
              "extract PNG": (bg, "video_to_images_fps20"),
              "crop+model": (bg, "run_grnet_on_frames"),
              "flush": (bg, "_flush_db")}
    base = ["--vid_folder", vids, "--bbox_path", bbox_path,
            "--pretrained_file", ckpt]
    os.makedirs(osp.join(workdir, "bg_out"))
    runs, seen = {}, {}
    for tag, extra in (("folder", []), ("stream", ["--stream"]),
                       ("shard0", ["--stream", "--num_shards", "2",
                                   "--shard_id", "0"]),
                       ("shard1", ["--stream", "--num_shards", "2",
                                   "--shard_id", "1"])):
        out = osp.join(workdir, "bg_out", f"{tag.rstrip('01')}.json")
        with stage_timers(stages) as spent, \
                kernel_spies(check=tag.startswith("shard")) as seen[tag]:
            for fn in fns.values():
                fn.launches = 0
            t0 = time.perf_counter()
            n_files = bg.main(bg.build_parser().parse_args(
                base + ["--outpath", out] + extra))
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in fns.items()}
        # this run's files: <out>_k.json, or <out>.w{id}_k.json for a worker
        prefix = osp.basename(out)[:-5] + (
            f".w{tag[-1]}_" if tag.startswith("shard") else "_")
        files = sorted(f for f in os.listdir(osp.dirname(out))
                       if f.startswith(prefix))
        if any("failed" in f for f in files) or len(files) != n_files:
            raise AssertionError(f"{tag}: files {files}, {n_files} reported")
        db = check_shards([osp.join(osp.dirname(out), f) for f in files])
        frames = sum(v[0] for v in db.values())
        runs[tag] = (db, launches, wall, n_files)
        clips = [(k, v[0]) for k, v in db.items()]
        log(f"[batchgen] batch_generation {' '.join(extra) or '(folder)'}: "
            f"{n_files} shard file(s), clips {clips}, {wall:.2f} s = {frames / wall:.1f} frames/s; stages "
            f"{ {k: round(v, 4) for k, v in spent.items()} } (frames/s "
            f"{ {k: round(frames / v, 1) for k, v in spent.items() if v} }), "
            f"the rest {wall - sum(spent.values()):.4f} s; kernel launches "
            f"{launches}")
        if min(launches.values()) <= 0 or \
                launches["blendshapes"] != launches["keypoint_attention"]:
            raise AssertionError(f"{tag}: kernel launches {launches}")
    one = runs["folder"][0]
    want_frames = [round(n * bg.EXTRACT_FPS / fps)
                   for _, fps, n, rows in BG_CLIPS if rows is not None]
    if list(one) != want_clips or [v[0] for v in one.values()] != want_frames:
        raise AssertionError(f"folder run: clips and frames "
                             f"{[(k, v[0]) for k, v in one.items()]}")
    err = same_database("--stream vs folder", runs["stream"][0], one)
    log(f"[batchgen] --stream against the folder run: the same clips, "
        f"frames and bboxes; joints max abs diff {err:.3e} m")
    shards = {**runs["shard0"][0], **runs["shard1"][0]}
    err = same_database("two workers vs one", dict(sorted(shards.items())),
                        runs["stream"][0])
    log(f"[batchgen] two shard workers merged against the one-worker "
        f"--stream run: the same clips, frames and bboxes; joints max abs "
        f"diff {err:.3e} m")
    calls = {k: seen["shard0"]["calls"][k] + seen["shard1"]["calls"][k]
             for k in fns}
    errs = hold_calls("batchgen", calls, seen["folder"]["calls"],
                      runs["folder"][1])
    hold_calls("batchgen --stream", calls, seen["stream"]["calls"],
               runs["stream"][1])
    # bytes read back per frame: the database's fetch against the default
    model = demo.build_model(ckpt)
    name, fps, n, _ = BG_CLIPS[0]
    frames = np.stack(list(video.read_frames(osp.join(vids, f"{name}.mp4"),
                                             fps=bg.EXTRACT_FPS)))
    bboxes = np.repeat(coarse[name][:1], len(frames), axis=0)
    joints, ms_j = readback_bytes({"fetch": ("kp_3d",)}, model, frames, bboxes)
    full, ms_f = readback_bytes({}, model, frames, bboxes)
    log(f"[batchgen] read back per frame: fetch=('kp_3d',) {joints:.1f} B, "
        f"the default fetch {full:.1f} B ({full / joints:.1f}x); run_track "
        f"of {len(frames)} frames {ms_j:.1f} ms against {ms_f:.1f} ms")
    if joints != 29 * 3 * 4:
        raise AssertionError(f"fetch=('kp_3d',) read back {joints} B a frame")
    return runs["folder"][1], errs


# ---------------------------------------------------------------------------
# phase 11: pinned serving (torch.export programs)
# ---------------------------------------------------------------------------

def host_crops(frames, bbox):
    """The runner's 224-pixel cv2 crops on the host (uint8), one per frame
    of `frames` with its row of `bbox`."""
    import numpy as np

    from gaitlab_torch.pipeline.crop import generate_patch_image

    return np.stack([generate_patch_image(f, *bb[:4], 224, 224, scale=1.0)[0]
                     for f, bb in zip(frames, bbox)])


def close_enough(tag: str, got: dict, want: dict, keys, tol: float,
                 scaled: bool = True) -> None:
    """max|got - want| <= tol (x max(1, max|want|) when `scaled`) for each
    key, logged."""
    import numpy as np

    for k in keys:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        err = float(np.abs(a - b).max())
        limit = tol * max(1.0, float(np.abs(b).max())) if scaled else tol
        log(f"[{tag}] {k} {a.shape}: max abs {err:.3e} (limit {limit:.3e})")
        if not (a.shape == b.shape and err <= limit
                and np.all(np.isfinite(a))):
            raise AssertionError(f"{tag}: {k} disagrees")


@contextlib.contextmanager
def no_model_code():
    """Any call of the live model's forward raises: a serving run's kernel
    launches must come from the loaded programs."""
    from gaitlab_torch.nn import grnet

    saved = grnet.GRNetCore.forward, grnet.BucketForward.forward

    def refuse(*args, **kw):
        raise AssertionError("the live model ran in a serving run")

    grnet.GRNetCore.forward = grnet.BucketForward.forward = refuse
    try:
        yield
    finally:
        grnet.GRNetCore.forward, grnet.BucketForward.forward = saved


def check_programs(art: str, manifest: dict, loaded: list) -> None:
    """Every program file (loaded by the ServingModels of each platform):
    its size, an empty state_dict, one node of each kernel's op."""
    sizes = {}
    for sm in loaded:
        for b, ep in sm.exported.items():
            fname = manifest["files"][str(b)][sm.device.type]
            targets = [str(n.target) for n in ep.graph.nodes
                       if n.op == "call_function"]
            ops = {t: targets.count(t) for t in SERVE_OPS}
            if ep.state_dict or set(ops.values()) != {1}:
                raise AssertionError(f"{fname}: {len(ep.state_dict)} "
                                     f"weights, op nodes {ops}")
            sizes[fname] = os.path.getsize(osp.join(art, fname))
    if len(sizes) != 2 * len(manifest["files"]):
        raise AssertionError(f"programs {sorted(sizes)} of {manifest}")
    weights = os.path.getsize(osp.join(art, manifest["weights"]))
    log(f"[serve] program files (bytes) {sizes}; weights.npz {weights} "
        f"bytes; every state_dict empty, every graph one node of each of "
        f"{sorted(SERVE_OPS)}")


def serve_run(art: str, det_vid: str, ckpt: str, workdir: str
              ) -> tuple[dict, dict]:
    """`cli.serve run` on walk_det.mp4 (the main path: launches counted
    from 0, every kernel call held against the plain version, the live
    model's forward refused), against `demo --onepass` on the same
    checkpoint. Returns the launches and each kernel's largest error."""
    import numpy as np

    from gaitlab_torch.cli import demo
    from gaitlab_torch.cli import serve as serve_cli
    from gaitlab_torch.ops.blendshapes import blendshapes
    from gaitlab_torch.ops.keypoint_attention import keypoint_attention_fused

    fns = {"blendshapes": blendshapes,
           "keypoint_attention": keypoint_attention_fused}
    out_dir = osp.join(workdir, "serve_out")
    with kernel_spies(check=True) as seen, no_model_code():
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        rc = serve_cli.main_cli(["run", "--artifacts", art, "--vid_file",
                                 det_vid, "--detector", "median_bg",
                                 "--output_folder", out_dir])
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in fns.items()}
    served = demo.load_pickle(osp.join(out_dir, "walk_det_serve_output.pkl"))
    log(f"[serve] cli.serve run --detector median_bg: rc {rc}, {wall:.2f} s "
        f"(every kernel call checked); kernel launches {launches}; persons "
        f"[first, end) frames {spans(served)}")
    if rc != 0 or min(launches.values()) <= 0 or \
            launches["blendshapes"] != launches["keypoint_attention"]:
        raise AssertionError(f"serve run: rc {rc}, launches {launches}")
    errs = hold_calls("serve", seen["calls"], seen["calls"], launches)
    for pid, person in served.items():
        check_person(pid, person)

    saved, _, demo_s = drive_demo(
        ["--vid_file", det_vid, "--detector", "median_bg", "--ckpt", ckpt,
         "--onepass"], osp.join(workdir, "serve_demo"), "walk_det_mp4")
    log(f"[serve] demo --onepass on the same checkpoint: {demo_s:.2f} s; "
        f"persons {spans(saved)}")

    def persons(res):  # SORT numbers tracks on across runs
        return sorted(res.values(), key=lambda p: int(p["frame_ids"][0]))

    if len(served) != len(saved):
        raise AssertionError("serve run and demo --onepass: other persons")
    for i, (got, want) in enumerate(zip(persons(served), persons(saved))):
        for k in ("frame_ids", "bboxes"):
            if not np.array_equal(got[k], want[k]):
                raise AssertionError(f"serve run person {i}: other {k}")
        close_enough(f"serve person {i} vs demo --onepass", got, want,
                     ("joints3d", "verts", "pose"), PAD_ATOL)
    return launches, errs


def serve_pinned_vs_live(card, host, ckpt: str, u8) -> dict:
    """ServingModel.call (`card`, the cuda programs) against the live model
    at batch SERVE_TIMED (the same crops, the outputs, ms with CUDA events),
    then the cpu programs (`host`) on CPU_FRAMES frames against the card's.
    Returns each kernel's largest checked error."""
    import torch

    from gaitlab_torch.cli.demo import build_model
    from gaitlab_torch.device import upload
    from gaitlab_torch.pipeline.crop import normalize_image

    model = build_model(ckpt)
    x = upload(u8[:SERVE_TIMED], "cuda")
    with kernel_spies(check=True) as seen:
        got = card.call(None, None, u8[:SERVE_TIMED])
        live = {k: v[0].cpu().numpy() for k, v in
                model.forward(normalize_image(x))[0].items()}
    errs = hold_calls("serve call", seen["calls"], seen["calls"],
                      {k: len(v) for k, v in seen["calls"].items()})
    close_enough(f"serve ServingModel.call vs the live forward at batch "
                 f"{SERVE_TIMED}", got, live, ("theta", "verts", "kp_3d"),
                 PAD_ATOL)
    pinned_ms = events_ms(lambda: card._run(SERVE_TIMED, card.variables,
                                            card.smpl, x), reps=20)
    live_ms = events_ms(lambda: model.forward(normalize_image(x)), reps=20)
    log(f"[serve] batch {SERVE_TIMED} (uint8 crops on the card -> outputs, "
        f"float32, TF32 off; CUDA events, median of 20): pinned program "
        f"{pinned_ms:.2f} ms, live model {live_ms:.2f} ms, pinned/live "
        f"{pinned_ms / live_ms:.4f}")
    profiled("serve", f"the pinned program at batch {SERVE_TIMED}",
             lambda: card._run(SERVE_TIMED, card.variables, card.smpl, x), 10)
    profiled("serve", f"the live model at batch {SERVE_TIMED}",
             lambda: model.forward(normalize_image(x)), 10)
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cpu_out = host.call(None, None, u8[:CPU_FRAMES])
    cpu_s = time.perf_counter() - t0
    card_out = card.call(None, None, u8[:CPU_FRAMES])
    log(f"[serve] the cpu program on {CPU_FRAMES} frames (bucket "
        f"{host.buckets[0]}) on the host: {cpu_s:.2f} s; against the card:")
    close_enough("serve cpu program vs card", card_out, cpu_out,
                 ("kp_3d", "verts"), CPU_ATOL_M, scaled=False)
    return errs


def serve_gait(ckpt: str, workdir: str, u8, bbox, cimg) -> dict:
    """MAX-GRNet exported at SERVE_GAIT_BUCKET (the card's program) and run
    on SERVE_GAIT_FRAMES real frames, a padded tail, against the live gait
    runner; then the same rows all real, whose pred_avg must move. Returns
    each kernel's largest checked error."""
    from gaitlab_torch import api, serve
    from gaitlab_torch.device import upload
    from gaitlab_torch.pipeline.crop import normalize_image
    from gaitlab_torch.pipeline.runner import GRNetRunner

    b, n = SERVE_GAIT_BUCKET, SERVE_GAIT_FRAMES
    model, _ = api.load_pipeline(ckpt=ckpt, use_gait_feat=True)
    runner = GRNetRunner(model, buckets=(b,))
    art = osp.join(workdir, "serve_gait")
    t0 = time.perf_counter()
    serve.save_artifacts(runner, art, platforms=("cuda",))
    export_s = time.perf_counter() - t0
    fname = f"forward_b{b}.cuda.pt2"
    log(f"[serve] MAX-GRNet exported at bucket {b} (cuda): {export_s:.2f} s,"
        f" {os.path.getsize(osp.join(art, fname))} bytes")
    sm = serve.load_artifacts(art)
    with kernel_spies(check=True) as seen:
        got = sm.call(None, None, u8[:n], bbox=bbox[:n], cimg=cimg[:n])
        live = runner.forward_crops(normalize_image(upload(u8[:n], "cuda")),
                                    bbox=bbox[:n], cimg=cimg[:n])
        full = sm.call(None, None, u8[:b], bbox=bbox[:b], cimg=cimg[:b])
    errs = hold_calls("serve gait", seen["calls"], seen["calls"],
                      {k: len(v) for k, v in seen["calls"].items()})
    got["pred_avg"] = got["pred_avg"][0]
    close_enough(f"serve gait, {n} frames at bucket {b}, program vs live",
                 got, live, ("pred_avg", "pred_phase", "kp_3d"), PAD_ATOL)
    moved = float(abs(full["pred_avg"][0] - got["pred_avg"]).max())
    log(f"[serve] gait n_valid {b} against {n} on the first {n} rows: "
        f"pred_avg moves by {moved:.3e}")
    if not moved > PAD_ATOL:
        raise AssertionError("the gait program ignores n_valid")
    return errs


def serve_phase(ckpt: str, workdir: str, trackfile: str, det_vid: str
                ) -> tuple[dict, dict]:
    """Phase 11. Returns the serve run's launches and each kernel's largest
    checked error."""
    import torch

    from gaitlab_torch import serve
    from gaitlab_torch.cli import serve as serve_cli

    art = osp.join(workdir, "serve_art")
    t0 = time.perf_counter()
    rc = serve_cli.main_cli(["export", "--artifacts", art, "--ckpt", ckpt,
                             "--buckets", ",".join(map(str, SERVE_BUCKETS))])
    export_s = time.perf_counter() - t0
    with open(osp.join(art, "manifest.json")) as f:
        manifest = json.load(f)
    log(f"[serve] cli.serve export --platforms cuda,cpu --buckets "
        f"{SERVE_BUCKETS}: rc {rc}, {export_s:.2f} s for "
        f"{len(SERVE_BUCKETS) * 2} programs; manifest "
        f"{ {k: v for k, v in manifest.items() if k != 'files'} }")
    if rc != 0 or manifest["platforms"] != ["cuda", "cpu"]:
        raise AssertionError("cli.serve export failed")
    t0 = time.perf_counter()
    card = serve.load_artifacts(art)
    load_s = time.perf_counter() - t0
    host = serve.load_artifacts(art, device="cpu")
    log(f"[serve] load_artifacts: the card's {len(card.buckets)} programs "
        f"and weights in {load_s:.2f} s")
    check_programs(art, manifest, [card, host])
    launches, errs = serve_run(art, det_vid, ckpt, workdir)
    torch.cuda.empty_cache()

    frames, bbox, cimg = gait_track(workdir, trackfile)
    u8 = host_crops(frames[:SERVE_GAIT_BUCKET], bbox)
    for more in (serve_pinned_vs_live(card, host, ckpt, u8),
                 serve_gait(ckpt, workdir, u8, bbox, cimg)):
        errs = {k: max(v, more[k]) for k, v in errs.items()}
    torch.cuda.empty_cache()
    return launches, errs


# ---------------------------------------------------------------------------
# phase 12: the legacy HMR
# ---------------------------------------------------------------------------

def hmr_phase(workdir: str, trackfile: str) -> tuple[dict, dict]:
    """HMR (ResNet-50 + the 3-step regressor + SMPL, random weights from
    SEED) at batch LOOP_BATCH on the card: the main path (launches counted
    from 0, every call held against the plain version), ms/batch, card
    against CPU, and regressor_output_from_features card against CPU.
    Returns the launches and each kernel's largest checked error."""
    import numpy as np
    import torch

    from gaitlab_torch.device import upload
    from gaitlab_torch.nn.spin import HMR
    from gaitlab_torch.ops.blendshapes import blendshapes
    from gaitlab_torch.ops.keypoint_attention import keypoint_attention_fused
    from gaitlab_torch.pipeline.crop import normalize_image
    from gaitlab_torch.render import vis

    frames, bbox, _ = gait_track(workdir, trackfile)
    x = normalize_image(upload(host_crops(frames[:LOOP_BATCH], bbox),
                               "cuda"))
    hmr = HMR.create(seed=SEED)
    fns = {"blendshapes": blendshapes,
           "keypoint_attention": keypoint_attention_fused}
    with kernel_spies(check=True) as seen:
        for fn in fns.values():
            fn.launches = 0
        out = hmr.forward(x)[0]
        launches = {name: fn.launches for name, fn in fns.items()}
    errs = hold_calls("hmr", {"blendshapes": seen["calls"]["blendshapes"]},
                      seen["calls"], launches)
    errs["keypoint_attention"] = 0.0
    n_params = sum(p.numel() for p in hmr.module.parameters())
    log(f"[hmr] HMR (ResNet-50, 3 regressor steps, SMPL) on {hmr.device}: "
        f"{n_params / 1e6:.2f} M parameters; batch {LOOP_BATCH}: kernel "
        f"launches {launches}; kp_3d {tuple(out['kp_3d'].shape)}")
    if launches != {"blendshapes": 1, "keypoint_attention": 0} or not all(
            torch.isfinite(out[k]).all() for k in ("theta", "verts",
                                                   "kp_3d")):
        raise AssertionError(f"HMR forward: launches {launches} or "
                             f"non-finite outputs")
    ms = events_ms(lambda: hmr.forward(x), reps=10)
    log(f"[hmr] HMR.forward at batch {LOOP_BATCH} (float32, TF32 off; CUDA "
        f"events, median of 10): {ms:.2f} ms/batch = "
        f"{LOOP_BATCH / ms * 1e3:.1f} frames/s")

    cpu = HMR.create(seed=SEED, device="cpu")
    host = cpu.forward(x[:CPU_FRAMES].cpu())[0]
    card = hmr.forward(x[:CPU_FRAMES])[0]
    close_enough(f"hmr card vs CPU, {CPU_FRAMES} frames",
                 {k: v.cpu() for k, v in card.items()}, host,
                 ("kp_3d", "verts"), CPU_ATOL_M, scaled=False)
    with torch.inference_mode():
        feats = hmr.module.backbone(x[:6].permute(0, 3, 1, 2).contiguous())
    feats = feats.cpu().numpy().reshape(2, 3, -1)
    got = dict(zip(("verts", "cam"),
                   vis.regressor_output_from_features(feats, hmr=hmr)))
    want = dict(zip(("verts", "cam"),
                    vis.regressor_output_from_features(feats, hmr=cpu)))
    log(f"[hmr] regressor_output_from_features on the card: verts "
        f"{got['verts'].shape}, cam {got['cam'].shape}; against the CPU:")
    close_enough("hmr regressor_output_from_features", got, want,
                 ("verts", "cam"), CPU_ATOL_M, scaled=False)
    if not np.isfinite(got["verts"]).all():
        raise AssertionError("regressor_output_from_features: non-finite")
    return launches, errs


# ---------------------------------------------------------------------------
# phase 13: training and evaluation
# ---------------------------------------------------------------------------

def make_train_shards(workdir: str, trackfile: str) -> str:
    """TRAIN_SHARDS .npz shards of TRAIN_SHARD_N samples: real 224-pixel
    uint8 crops of walk.mp4's first track, synthetic labels in the schema
    gaitlab's trainer reads. Returns the glob."""
    import numpy as np

    frames, bbox, _ = gait_track(workdir, trackfile)
    n = TRAIN_SHARDS * TRAIN_SHARD_N
    crops = host_crops(frames[:n], bbox)
    rng = np.random.default_rng(SEED)
    d = osp.join(workdir, "train_data")
    os.makedirs(d, exist_ok=True)
    for s in range(TRAIN_SHARDS):
        m = TRAIN_SHARD_N
        np.savez(osp.join(d, f"shard{s}.npz"),
                 images=crops[s * m:(s + 1) * m],
                 kp_2d=np.concatenate([rng.normal(size=(m, 29, 2)),
                                       np.ones((m, 29, 1))], -1
                                      ).astype(np.float32),
                 kp_3d=np.concatenate([rng.normal(size=(m, 29, 3)) * 0.3,
                                       np.ones((m, 29, 1))], -1
                                      ).astype(np.float32),
                 pose=np.tile(np.eye(3, dtype=np.float32), (m, 24, 1, 1)),
                 betas=(rng.normal(size=(m, 10)) * 0.03).astype(np.float32),
                 has_smpl=np.ones((m,), np.float32))
    return osp.join(d, "shard*.npz")


@contextlib.contextmanager
def logged_messages():
    """The messages logged while inside (the trainer logs through the root
    logger)."""
    import logging

    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    handler = Keep(logging.INFO)
    root = logging.getLogger()
    root.addHandler(handler)
    try:
        yield seen
    finally:
        root.removeHandler(handler)


def drive_train(argv: list) -> tuple:
    """cli.train.main(argv) with every kernel call seen and held against
    its plain version, each kernel's launches and backwards counted from 0
    just before it. Returns (model, state, counts, calls, messages,
    wall s)."""
    from gaitlab_torch.cli import train
    from gaitlab_torch.ops.blendshapes import blendshapes
    from gaitlab_torch.ops.keypoint_attention import keypoint_attention_fused

    fns = {"blendshapes": blendshapes,
           "keypoint_attention": keypoint_attention_fused}
    with kernel_spies(check=True) as seen, logged_messages() as msgs:
        for fn in fns.values():
            fn.launches = fn.backwards = 0
        t0 = time.perf_counter()
        out = train.main(train.build_parser().parse_args(argv))
        wall = time.perf_counter() - t0
        counts = {name: (fn.launches, fn.backwards)
                  for name, fn in fns.items()}
    return (*out, counts, seen["calls"], list(msgs), wall)


def checked_errors(tag: str, calls: dict) -> dict:
    """Each kernel's largest error against its plain version over the
    calls a spy checked, each within its tolerance scaled by max(1,
    max|out|)."""
    errs = {}
    for name, checked in calls.items():
        tol = B1_ATOL if name == "keypoint_attention" else B2_ATOL
        errs[name] = 0.0
        for shapes, e in checked:
            if not e["err"] <= tol * max(1.0, e["scale"]):
                raise AssertionError(f"[{tag}] {name} at {shapes} disagrees "
                                     f"with its plain version: {e}")
            errs[name] = max(errs[name], e["err"])
        if checked:
            log(f"[{tag}] {name}: {len(checked)} calls at batch shapes "
                f"{sorted({sh[-1][0] for sh, _ in checked})}, each held "
                f"against the plain version: largest error "
                f"{errs[name]:.3e}")
    return errs


def logged_losses(tag: str, msgs: list) -> list:
    import math

    losses = [float(m.split("loss ")[1].split(" ")[0]) for m in msgs
              if m.startswith("step ")]
    rates = [m.split("(")[1].rstrip(")") for m in msgs
             if m.startswith("step ")]
    log(f"[{tag}] logged losses {losses}; rates {rates}")
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"[{tag}] logged losses {losses}")
    return losses


def train_main_path(ckpt: str, data: str, workdir: str) -> tuple:
    """(a): cli.train on the card, TRAIN_STEPS steps, then --resume to
    TRAIN_RESUME_STEPS. Returns the first run's launches, the trained
    model, the largest checked errors."""
    import torch

    start = torch.load(ckpt, map_location="cpu",
                       weights_only=True)["gen_state_dict"]
    run_dir = osp.join(workdir, "train_run")
    common = ["--data", data, "--workdir", run_dir, "--batch_size",
              str(TRAIN_BATCH), "--init_ckpt", ckpt, "--save_every", "10",
              "--log_every", "5"]
    model, state, counts, calls, msgs, wall = drive_train(
        common + ["--steps", str(TRAIN_STEPS)])
    log(f"[train] cli.train --batch_size {TRAIN_BATCH} --steps "
        f"{TRAIN_STEPS}: {wall:.2f} s; (launches, backwards) {counts}")
    logged_losses("train", msgs)
    errs = checked_errors("train", calls)
    for name, (n_fwd, n_bwd) in counts.items():
        if n_fwd != TRAIN_STEPS or n_bwd != TRAIN_STEPS:
            raise AssertionError(f"{name}: {n_fwd} launches and {n_bwd} "
                                 f"backwards in {TRAIN_STEPS} steps")
    if state.step != TRAIN_STEPS or not any(
            m == f"checkpoint saved at step {TRAIN_STEPS}" for m in msgs):
        raise AssertionError(f"train: step {state.step}, no last checkpoint")
    got = {k: v.cpu() for k, v in model.module.state_dict().items()}
    frozen = [k for k in got if k.startswith("backbone.")
              or k.endswith(("running_mean", "running_var",
                             "num_batches_tracked"))]
    moved = [k for k, _ in model.module.head.named_parameters()]
    unchanged = [k for k in frozen if not torch.equal(got[k], start[k])]
    still = [k for k in moved if k != "keypoint_final_layer.bias"
             and torch.equal(got[f"head.{k}"], start[f"head.{k}"])]
    bias_moved = not torch.equal(got["head.keypoint_final_layer.bias"],
                                 start["head.keypoint_final_layer.bias"])
    log(f"[train] {len(frozen)} backbone parameters and BN buffers "
        f"bit-unchanged: {not unchanged}; {len(moved) - 1} head parameters "
        f"moved: {not still} (keypoint_final_layer.bias, whose exact "
        f"gradient is 0, moved: {bias_moved})")
    if unchanged or still:
        raise AssertionError(f"train: changed {unchanged[:3]}, still "
                             f"{still[:3]}")

    _, state2, counts2, calls2, msgs2, wall2 = drive_train(
        common + ["--steps", str(TRAIN_RESUME_STEPS), "--resume"])
    n = TRAIN_RESUME_STEPS - TRAIN_STEPS
    log(f"[train] --resume to {TRAIN_RESUME_STEPS}: {wall2:.2f} s; "
        f"(launches, backwards) {counts2}")
    logged_losses("train", msgs2)
    errs2 = checked_errors("train", calls2)
    if (f"resumed from step {TRAIN_STEPS}" not in msgs2
            or state2.step != TRAIN_RESUME_STEPS
            or any(c != (n, n) for c in counts2.values())):
        raise AssertionError(f"train --resume: step {state2.step}, "
                             f"counts {counts2}")
    del state, state2
    return ({k: c[0] for k, c in counts.items()}, model,
            {k: max(errs[k], errs2[k]) for k in errs})


def train_card_vs_cpu(ckpt: str, data: str) -> None:
    """(b): one train step's loss metrics and head gradients on CPU_FRAMES
    samples, from phase 3's weights: the card against the CPU in float32,
    and both against the CPU in float64. The metrics must agree within
    TRAIN_CPU_RTOL x max(1, max|.|). So must each gradient, or else the
    card be no further from float64 than TRAIN_F64_FACTOR times the CPU's
    own float32 error: the gradients of the head's first convolutions
    pass through the softmax pooling's backward, attn * (d_attn -
    sum(attn * d_attn)), whose subtraction cancels in float32 on either
    device."""
    import numpy as np
    import torch

    from gaitlab_torch import training
    from gaitlab_torch.body.smpl import SMPLParams
    from gaitlab_torch.cli import train
    from gaitlab_torch.cli.demo import build_model

    batch = next(train._batches(train._load_shards(data), CPU_FRAMES, 1,
                                SEED))
    out = {}
    for where, dev, dtype in (("card", None, torch.float32),
                              ("cpu", "cpu", torch.float32),
                              ("cpu64", "cpu", torch.float64)):
        model = build_model(ckpt, device=dev)
        core = model.module.to(dtype)
        smpl = SMPLParams(*(x.to(dtype) if isinstance(x, torch.Tensor)
                            and x.is_floating_point() else x
                            for x in model.smpl))
        opt, _ = training.make_optimizer(
            training.trainable_parameters(core), lr=5e-5)
        metrics = training.make_train_step(core, smpl, opt)(
            {k: v.to(dtype) for k, v in
             train._to_device(batch, model.device).items()})
        out[where] = {**{k: v.double().cpu().numpy()
                         for k, v in metrics.items()},
                      **{k: p.grad.double().cpu().numpy()
                         for k, p in core.head.named_parameters()}}
        del model, core, opt
    worst = []
    for k, want in out["cpu"].items():
        got, ref = out["card"][k], out["cpu64"][k]
        err = float(np.abs(got - want).max())
        limit = TRAIN_CPU_RTOL * max(1.0, float(np.abs(want).max()))
        card64 = float(np.abs(got - ref).max())
        cpu64 = float(np.abs(want - ref).max())
        ok = np.all(np.isfinite(got)) and (err <= limit or (
            not k.startswith("loss") and card64 <= TRAIN_F64_FACTOR * cpu64))
        if err > limit:
            log(f"[train] card vs CPU {k}: {err:.3e} over {limit:.3e} "
                f"(max|.| {np.abs(want).max():.3e}); against float64: card "
                f"{card64:.3e}, CPU {cpu64:.3e}")
        if not ok:
            raise AssertionError(f"[train] card vs CPU {k}: {err} > {limit}")
        worst.append((err / limit, k))
    log(f"[train] card vs CPU, one step on {CPU_FRAMES} samples: loss "
        f"{float(out['card']['loss']):.6f} vs {float(out['cpu']['loss']):.6f}"
        f" (float64 {float(out['cpu64']['loss']):.6f}); {len(out['cpu'])} "
        f"tensors (metrics and head gradients), {sum(w <= 1 for w, _ in worst)}"
        f" within {TRAIN_CPU_RTOL:g} x max(1, max|.|); largest share of that "
        f"limit {max(worst)[0]:.3f} ({max(worst)[1]})")


def op_backward(flush) -> tuple[dict, dict]:
    """(c): each op's backward on the card at the trainer's shapes against
    autograd through its plain version, and forward + backward timed (CUDA
    events) for the op and the plain version. Returns per kernel its
    largest error and its timings."""
    import torch

    from gaitlab_torch.device import float32_math
    from gaitlab_torch.ops import blendshapes as b2
    from gaitlab_torch.ops import keypoint_attention as b1

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).requires_grad_()

    cases = []
    for hw in (56, 16):  # the head at 224 and at the gait trainer's 64
        f, c = rand(TRAIN_BATCH, 128, hw, hw), rand(TRAIN_BATCH, 64, hw, hw)
        hm = rand(TRAIN_BATCH, 25, hw, hw, scale=3.0)
        views = lambda f, c, hm: (f.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1),
                                  hm[:, 1:].permute(0, 2, 3, 1))
        cases.append(("keypoint_attention", f"B={TRAIN_BATCH} HW={hw * hw}",
                      (f, c, hm),
                      lambda *a: b1.keypoint_attention_fused(*views(*a)),
                      lambda *a: b1.keypoint_attention_plain(*views(*a))))
    vt, sh = rand(6890, 3, scale=0.3), rand(6890, 3, 10, scale=0.01)
    po = rand(207, 6890 * 3, scale=0.001)
    be, pf = rand(TRAIN_BATCH, 10), rand(TRAIN_BATCH, 207, scale=0.5)
    for t in (vt, sh, po):  # SMPL's tensors are constants of the step
        t.requires_grad_(False)
    cases.append(("blendshapes", f"B={TRAIN_BATCH}", (vt, sh, po, be, pf),
                  b2.blendshapes, b2.blendshapes_plain))
    errs = {"keypoint_attention": 0.0, "blendshapes": 0.0}
    times = {}
    for name, label, ins, op, plain in cases:
        need = [t for t in ins if t.requires_grad]

        def fwd_bwd(fn):
            outs = fn(*ins)
            outs = outs if isinstance(outs, tuple) else (outs,)
            return torch.autograd.grad(outs, need, [torch.ones_like(o)
                                                    for o in outs])

        with float32_math():
            got, want = fwd_bwd(op), fwd_bwd(plain)
            ins64 = [t.detach().double().requires_grad_(t.requires_grad)
                     for t in ins]
            need64 = [t for t in ins64 if t.requires_grad]
            outs64 = plain(*ins64)
            outs64 = outs64 if isinstance(outs64, tuple) else (outs64,)
            ref64 = torch.autograd.grad(outs64, need64,
                                        [torch.ones_like(o) for o in outs64])
            ms = time_ms(lambda: fwd_bwd(op), flush)
            plain_ms = time_ms(lambda: fwd_bwd(plain), flush)
        torch.cuda.synchronize()
        tol = B1_ATOL if name == "keypoint_attention" else B2_ATOL
        for i, (g, w, r) in enumerate(zip(got, want, ref64)):
            err = (g - w).abs().max().item()
            limit = tol * max(1.0, w.abs().max().item())
            log(f"[train] {name} backward {label} d_input{i}: max_abs_err "
                f"{err:.3e} (limit {limit:.3e}); against float64: op "
                f"{(g - r).abs().max().item():.3e}, plain "
                f"{(w - r).abs().max().item():.3e}")
            if not err <= limit:
                raise AssertionError(f"{name} backward disagrees at {label}")
            errs[name] = max(errs[name], err)
        log(f"[train] {name} forward + backward {label}: op {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms (CUDA events, median of 20, L2 "
            f"flushed)")
        times.setdefault(name, {})[label] = {"ms": ms, "plain_ms": plain_ms}
    return errs, times


def train_step_cost(model, data: str) -> None:
    """(d): the train step at TRAIN_BATCH: samples/s (CUDA events, median
    of 5), peak memory, a profile of one step."""
    import torch

    from gaitlab_torch import training
    from gaitlab_torch.cli import train

    batch = train._to_device(next(train._batches(
        train._load_shards(data), TRAIN_BATCH, 1, SEED)), model.device)
    opt, sched = training.make_optimizer(
        training.trainable_parameters(model.module), lr=5e-5)
    step = training.make_train_step(model.module, model.smpl, opt,
                                    scheduler=sched)
    step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = events_ms(lambda: step(batch))
    log(f"[train] train step at batch {TRAIN_BATCH} (float32, TF32 off; "
        f"CUDA events, median of 5): {ms:.2f} ms = "
        f"{TRAIN_BATCH / ms * 1e3:.1f} samples/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profiled("train", f"one train step at batch {TRAIN_BATCH}",
             lambda: step(batch), top=10)


def train_gait_path(workdir: str) -> tuple[dict, dict]:
    """(e): cli.train --gait --data synthetic at the CLI's defaults."""
    _, state, counts, calls, msgs, wall = drive_train(
        ["--gait", "--data", "synthetic", "--workdir",
         osp.join(workdir, "train_gait"), "--steps", str(GAIT_TRAIN_STEPS),
         "--log_every", "5"])
    log(f"[train_gait] cli.train --gait --data synthetic --steps "
        f"{GAIT_TRAIN_STEPS}: {wall:.2f} s; (launches, backwards) {counts}")
    logged_losses("train_gait", msgs)
    errs = checked_errors("train_gait", calls)
    n_b1 = counts["keypoint_attention"][0]
    if state.step != GAIT_TRAIN_STEPS or n_b1 != 4 * 6 or len(
            calls["keypoint_attention"]) != n_b1:
        raise AssertionError(f"train_gait: step {state.step}, B1 launches "
                             f"{n_b1}, checked {len(calls['keypoint_attention'])}")
    return {k: c[0] for k, c in counts.items()}, errs


def fit_and_eval(model, data: str) -> None:
    """(f): classify.fit card against CPU on a seeded cohort, and
    eval.evaluate_batch on the trained model's predictions card against
    CPU."""
    import numpy as np
    import torch

    from gaitlab_torch import eval as pt_eval
    from gaitlab_torch.cli import train
    from gaitlab_torch.device import float32_math
    from gaitlab_torch.gait import classify
    from gaitlab_torch.gait.features import FEATURE_NAMES

    rng = np.random.default_rng(SEED)
    feats = rng.normal(size=(FIT_N, len(FEATURE_NAMES))).astype(np.float32)
    labels = (feats[:, 0] + 0.5 * feats[:, 1] > 0).astype(np.int64)
    sev = 1 / (1 + np.exp(-feats[:, 0]))
    fitted = {}
    for where, dev in (("card", None), ("cpu", "cpu")):
        t0 = time.perf_counter()
        fitted[where] = classify.fit(feats, labels, severity=sev,
                                     num_classes=2, device=dev)
        log(f"[train] classify.fit on the {where} ({FIT_N} clips, 500 Adam "
            f"steps): {time.perf_counter() - t0:.2f} s")
    card = classify.predict(fitted["card"], feats)
    host = classify.predict(fitted["cpu"], feats)
    err = float(np.abs(card["probs"] - host["probs"]).max())
    log(f"[train] fit card vs CPU: labels equal "
        f"{np.array_equal(card['label'], host['label'])}, probs max abs "
        f"{err:.3e} (limit {FIT_ATOL:g}); train accuracy "
        f"{(card['label'] == labels).mean():.3f}")
    if not (np.array_equal(card["label"], host["label"]) and err <= FIT_ATOL):
        raise AssertionError("classify.fit: card and CPU disagree")

    batch = next(train._batches(train._load_shards(data), TRAIN_BATCH, 1,
                                SEED + 1))
    x = train._to_device(batch, model.device)["images"]
    with float32_math(), torch.inference_mode():
        pred = model.forward(x)[0]
    pj, pv = pred["kp_3d"][0], pred["verts"][0]
    gj = torch.from_numpy(batch["kp_3d"][..., :3]).to(model.device)
    gv = pv + 0.01 * torch.randn(pv.shape, device=pv.device)
    card = pt_eval.evaluate_batch(pj, gj, pv, gv)
    host = pt_eval.evaluate_batch(pj.cpu(), gj.cpu(), pv.cpu(), gv.cpu())
    log(f"[train] evaluate_batch on the trained model's predictions: card "
        f"{card}, CPU {host}")
    for k in host:
        if not abs(card[k] - host[k]) <= EVAL_RTOL * abs(host[k]):
            raise AssertionError(f"evaluate_batch {k}: card and CPU differ")


def train_phase(ckpt: str, workdir: str, trackfile: str) -> tuple:
    """Phase 13. Returns the launches of the trainer's run and of the gait
    trainer's, each kernel's largest checked error, and the ops'
    forward + backward timings."""
    import torch

    data = make_train_shards(workdir, trackfile)
    launches, model, errs = train_main_path(ckpt, data, workdir)
    train_card_vs_cpu(ckpt, data)
    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    bwd_errs, bwd_times = op_backward(flush)
    del flush
    train_step_cost(model, data)
    fit_and_eval(model, data)
    del model
    torch.cuda.empty_cache()
    gait_launches, gait_errs = train_gait_path(workdir)
    errs = {k: max(errs[k], bwd_errs[k], gait_errs[k]) for k in errs}
    return launches, gait_launches, errs, bwd_times


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
    from gaitlab_torch.pipeline import loader

    t0 = time.perf_counter()
    decoder, error = loader.native_status()
    log(f"[build] frame loader: {decoder} decoder "
        + (f"(native build failed: {error})" if error else
           f"built with g++ into {osp.relpath(loader.BUILD_DIR)} in "
           f"{time.perf_counter() - t0:.2f} s"))

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
        launches, path_errs, checked = track_phase(det_vid, ckpt, workdir)
        yolo_phase(det_vid, ckpt, weights, workdir)
        gait_launches, gait_errs = gait_phase(ckpt, workdir, trackfile,
                                              det_vid)
        render_launches = render_phase(det_vid, ckpt, workdir, checked, card)
        bg_launches, bg_errs = batchgen_phase(ckpt, workdir)
        serve_launches, serve_errs = serve_phase(ckpt, workdir, trackfile,
                                                 det_vid)
        hmr_launches, hmr_errs = hmr_phase(workdir, trackfile)
        train_launches, train_gait_launches, train_errs, bwd_times = \
            train_phase(ckpt, workdir, trackfile)
    paths = {"demo_smooth": launches, "api_gait": gait_launches,
             "demo_render": render_launches, "batchgen": bg_launches,
             "serve_run": serve_launches, "hmr": hmr_launches,
             "train": train_launches, "train_gait": train_gait_launches}
    for r in rows:
        r["launches_by_path"] = {p: n[r["name"]] for p, n in paths.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        r["max_abs_err"] = max(r["max_abs_err"], path_errs[r["name"]],
                               gait_errs[r["name"]], bg_errs[r["name"]],
                               serve_errs[r["name"]], hmr_errs[r["name"]],
                               train_errs[r["name"]])
        r["fwd_bwd_ms"] = bwd_times[r["name"]]

    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "fwd_bwd_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
