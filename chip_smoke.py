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
Two lines before the last list every kernel as JSON: launches_by_path
holds the launches of each main path, phase 6's `--smooth` demo
("demo_smooth"), phase 8's two-pass `analyze_video` ("api_gait") and
phase 9's default demo ("demo_render"), each counted from 0 just before
its run; launches is their sum; max_abs_err is the largest over phases
2, 6 and 8. The line before the last holds the card's name and power limit, and the
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


def gait_loop(plain, gait, crops, bbox, cimg) -> dict:
    """Model-loop frames/s (CUDA events, median of 5) at each of
    GAIT_LOOP_BUCKETS with and without the gait branch, and a profile of
    one gait bucket. Returns MAX-GRNet's ms per bucket."""
    import torch

    def events_ms(fn, reps=5):
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
    paths = {"demo_smooth": launches, "api_gait": gait_launches,
             "demo_render": render_launches}
    for r in rows:
        r["launches_by_path"] = {p: n[r["name"]] for p, n in paths.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        r["max_abs_err"] = max(r["max_abs_err"], path_errs[r["name"]],
                               gait_errs[r["name"]])

    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
