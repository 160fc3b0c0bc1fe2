"""High-level Python API: one call from video to gait analysis.

Counterpart of gaitlab/api.py, for tooling that embeds the pipeline:

    import gaitlab_torch.api as gl
    results = gl.analyze_video("clip.mp4", ckpt="max-grnet.pth.tar",
                               joint_type="kinectv2")
    feats = gl.gait_report(results)        # per-person gait features

Everything runs on the card unless `device="cpu"` is passed (to
load_pipeline, or to analyze_video when it builds the pipeline itself);
without CUDA and without that request it raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def load_pipeline(ckpt: str = "", smpl_model: Optional[str] = None,
                  use_gait_feat: bool = False, precision: str = "float32",
                  device=None, mesh=None, arch: str = "grnet"):
    """(model, runner) ready for repeated video analysis, on `device`
    (None: the card). `mesh` (parallel.make_mesh) splits each bucket over
    replicas on its data axis. `precision` is the runner's: "float32"
    (TF32 off, the default), "high" or "default" (nn/layers.py says what
    each means on the card). With `use_gait_feat`, a reference checkpoint
    fills the trunk and the gait corrector keeps its random init (no
    reference checkpoint carries one). `arch="hmr2"` builds HMR 2.0 with
    random weights (cli/demo.build_model), cropped at its 256 px."""
    from gaitlab_torch.cli.demo import build_model
    from gaitlab_torch.pipeline.runner import PRECISIONS, GRNetRunner

    if precision not in PRECISIONS:  # before building a model
        raise ValueError(f"precision={precision!r}: use one of {PRECISIONS}")
    model = build_model(ckpt, smpl_model, device=device,
                        use_gait_feat=use_gait_feat, arch=arch)
    return model, GRNetRunner(model, precision=precision, mesh=mesh,
                              crop_size=model.module.img_res)


def analyze_video(vid_file: str, ckpt: str = "",
                  smpl_model: Optional[str] = None, joint_type: str = "spin2",
                  smooth: bool = True, tracking: Optional[dict] = None,
                  runner=None, fps: Optional[float] = None,
                  onepass: bool = False, device=None) -> dict:
    """Video -> {person_id: demo pkl-schema dict}. `tracking` supplies
    precomputed tracklets; `runner` reuses a load_pipeline() result
    (otherwise one is built on `device`). onepass=True detects, tracks,
    crops and runs the model over one decode of the video
    (pipeline/stream.py); `tracking` and `fps` need the two-pass path."""
    from gaitlab_torch.body.joints import convert_kps
    from gaitlab_torch.pipeline import coords, detect, smoothing, tracks, video

    if runner is None:
        _, runner = load_pipeline(ckpt=ckpt, smpl_model=smpl_model,
                                  device=device)
    model = runner.model

    if onepass:
        if tracking is not None or fps is not None:
            raise ValueError("onepass detects and tracks itself: precomputed "
                             "tracking or fps resampling need onepass=False")
        from gaitlab_torch.pipeline import stream as stream_mod

        _, _, w, h = video.get_video_info(vid_file)
        raw = stream_mod.run_video_onepass(runner, vid_file)
        per_track = {pid: (r, np.asarray(r["bboxes"], np.float32),
                           np.asarray(r["frames"]))
                     for pid, r in raw.items()}
    else:
        frames = np.stack(list(video.read_frames(vid_file, fps=fps)))
        h, w = frames.shape[1:3]
        if tracking is None:
            detector = detect.MedianBackgroundDetector()
            tracking = tracks.track_video(detector(frames))
        tracking, _ = tracks.smooth_tracking(tracking)
        per_track = {}
        for pid, tr in tracking.items():
            bboxes = np.asarray(tr["bbox"], np.float32)
            fidx = np.asarray(tr["frames"])
            per_track[pid] = (runner.run_track(frames[fidx], bboxes),
                              bboxes, fidx)

    results = {}
    for pid, (out, bboxes, fidx) in per_track.items():
        verts, pose, joints3d = out["verts"], out["pose"], out["joints3d"]
        if smooth:
            verts, pose, joints3d = smoothing.smooth_pose(
                pose, out["betas"], smpl_params=model.smpl)
        results[pid] = {
            "pred_cam": out["pred_cam"],
            "orig_cam": coords.convert_crop_cam_to_orig_img(
                out["pred_cam"], bboxes, w, h),
            "verts": verts,
            "pose": pose,
            "betas": out["betas"],
            "joints3d": (convert_kps(joints3d, "spin2", joint_type)
                         if joint_type not in ("spin", "spin2")
                         else joints3d),
            "joints2d": coords.convert_crop_coords_to_orig_img(
                bboxes, out["joints2d"], 224),
            "bboxes": bboxes,
            "frame_ids": fidx,
        }
    return results


def gait_report(results: dict, fps: float = 30.0, scorer=None) -> dict:
    """Per-person gait features (and a dementia score with a fitted scorer,
    see gait.classify.scorer_from_flax). joints3d that are not kinectv2's
    25 joints are taken as spin2 and converted."""
    from gaitlab_torch.body.joints import convert_kps
    from gaitlab_torch.gait import classify

    report = {}
    for pid, r in results.items():
        j = np.asarray(r["joints3d"])
        if j.shape[1] != 25:
            j = convert_kps(j, "spin2", "kinectv2")
        report[pid] = classify.score_clip(j, fitted=scorer, fps=fps)
    return report
