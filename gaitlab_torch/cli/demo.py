"""Flag-compatible demo CLI: a video -> tracked people -> crops -> GRNet +
SMPL on the card -> optional one-euro smoothing -> pkl.

Counterpart of gaitlab/cli/demo.py with the same parser and the same pkl
schema per person (pred_cam, orig_cam, verts, pose, betas, joints3d,
joints2d, bboxes, frame_ids) and file naming. People come from
precomputed tracklets (--tracking_path) or from a detector (--detector:
YOLOv3 on the card, or the median-background detector on the host) and
SORT; --stream decodes straight from the video instead of a PNG folder,
and --onepass detects, tracks, crops and runs the model in one pass over
it (ignored with --tracking_path or --img_folder, as in gaitlab). Video
output is on unless --save_vid is passed: a skeleton overlay beside a 3D
panel, or with --mesh_render the SMPL mesh (--wireframe, --sideview);
--save_obj writes one .obj per person and frame. With video output on,
--stream and --onepass fall back to the frame folder, as in gaitlab.
Runs on CUDA unless --cpu_only is given. --parallel dp splits each bucket
over every visible card, --parallel pp runs the 2-stage pipeline over them
(it needs two devices); with --cpu_only the device list is the CPU alone.
--precision float32 (the default: TF32 off), high or default passes
through to the runner (nn/layers.py says what each means on the card).

Usage:
  python -m gaitlab_torch.cli.demo --vid_file clip.mp4 \
      --detector median_bg --smooth --output_folder out/
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
import shutil
import sys
import time

import numpy as np

MIN_NUM_FRAMES = 25
ARCHS = ("grnet", "hmr2")  # --arch: GRNet, or HMR 2.0 (nn/hmr2.py)


def build_parser() -> argparse.ArgumentParser:
    """The reference's argparse surface, flag for flag, and --arch."""
    p = argparse.ArgumentParser()
    p.add_argument("--vid_file", type=str, default="",
                   help="input video path")
    p.add_argument("--cfg", type=str, default="configs/config_grnet.yaml",
                   help="configuration file for pretrained ckpt.")
    p.add_argument("--ckpt", type=str, default="",
                   help="path to the pretrained checkpoint.")
    p.add_argument("--output_folder", type=str, default="output/",
                   help="output folder to write results")
    p.add_argument("--detector", type=str, default="yolo",
                   choices=["yolo", "yolo_tiny", "yolo_v3", "median_bg",
                            "dnn"],
                   help="object detector to be used for bbox tracking "
                        "(yolo tells the variant from the weight file; "
                        "yolo_tiny/yolo_v3 force one)")
    p.add_argument("--yolo_img_size", type=int, default=416,
                   help="input image size for yolo detector")
    p.add_argument("--tracker_batch_size", type=int, default=12,
                   help="batch size of object detector used for bbox tracking")
    p.add_argument("--grnet_batch_size", type=int, default=450,
                   help="largest model batch (bucket) size")
    p.add_argument("--display", action="store_true",
                   help="visualize the results of each step during demo")
    p.add_argument("--mesh_render", action="store_true",
                   help="enable final video rendering of human mesh.")
    p.add_argument("--wireframe", action="store_true",
                   help="render all meshes as wireframes.")
    p.add_argument("--sideview", action="store_true",
                   help="render an additional side viewpoint.")
    p.add_argument("--save_obj", action="store_true",
                   help="save results as .obj files.")
    p.add_argument("--smooth", action="store_true",
                   help="smooth the results to prevent jitter")
    p.add_argument("--smooth_min_cutoff", type=float, default=0.004,
                   help="one euro filter min cutoff.")
    p.add_argument("--smooth_beta", type=float, default=0.7,
                   help="one euro filter beta.")
    p.add_argument("--tracking_path", type=str, default=None,
                   help="path to precomputed tracking results.")
    p.add_argument("--img_folder", type=str, default=None)
    p.add_argument("--joint_type", type=str, default="spin",
                   help="output 3D joint format.")
    p.add_argument("--save_vid", action="store_false",
                   help="save output video to output folder (on by "
                        "default; the flag turns it off).")
    p.add_argument("--cpu_only", action="store_true",
                   help="run on the CPU instead of the card.")
    p.add_argument("--smpl_model", type=str, default=None,
                   help="path to SMPL model pkl/npz (defaults to "
                        "data/smpl_data per config).")
    p.add_argument("--stream", action="store_true",
                   help="decode frames straight from the video (no PNG "
                        "frame folder); with video output on (no "
                        "--save_vid) it falls back to the folder.")
    p.add_argument("--onepass", action="store_true",
                   help="single-decode pipeline: detect, track, crop and "
                        "run the model in one pass over the video "
                        "(pipeline/stream.py); with video output on (no "
                        "--save_vid) it falls back to the folder.")
    p.add_argument("--precision", type=str, default=None,
                   choices=["high", "float32", "default"],
                   help="matmul precision: float32 (TF32 off) is the "
                        "default; high and default run TF32 passes "
                        "(nn/layers.py).")
    p.add_argument("--parallel", type=str, default=None,
                   choices=["dp", "pp"],
                   help="multi-card strategy: 'dp' splits frame batches "
                        "over every visible card; 'pp' runs a 2-stage "
                        "pipeline (backbone group | head+SMPL group) over "
                        "them.")
    p.add_argument("--arch", type=str, default="grnet", choices=ARCHS,
                   help="the model: grnet (GRNet, the reference's) or hmr2 "
                        "(HMR 2.0's ViT-H trunk and transformer decoder, "
                        "random weights).")
    return p


def check_render_deps(args) -> None:
    """The skeleton overlay (video output without --mesh_render) draws
    with matplotlib: without it, fail before any decode or model work."""
    if args.save_vid and not args.mesh_render:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise ModuleNotFoundError(
                "the skeleton overlay video needs matplotlib, which is not "
                "installed: pass --mesh_render for the mesh overlay, or "
                "--save_vid to turn video output off") from e


def load_model(args, cfg):
    """GRNet (synthetic SMPL unless a model file is found) with random
    weights, or a reference GRNet checkpoint's weights, on the card (the CPU
    with --cpu_only); HMR 2.0 with --arch hmr2."""
    return build_model(args.ckpt, args.smpl_model,
                       device="cpu" if args.cpu_only else None,
                       arch=args.arch)



def build_model(ckpt: str = "", smpl_model=None, device=None,
                use_gait_feat: bool = False, arch: str = "grnet"):
    """load_model's body, for the API too: `device` None is the card. With
    the gait branch, a reference checkpoint fills the trunk and the
    corrector keeps its random init (no reference checkpoint has one).
    `arch` "hmr2" builds HMR 2.0 (nn/hmr2.py) with random weights: the
    import of 4D-Humans' published checkpoint is not written yet."""
    from gaitlab_torch.body import smpl as body_smpl
    from gaitlab_torch.config import SMPL_DATA_DIR
    from gaitlab_torch.nn.grnet import GRNet
    from gaitlab_torch.weights.torch_import import load_grnet_ckpt

    if arch not in ARCHS:
        raise ValueError(f"arch={arch!r}: use one of {ARCHS}")
    if arch == "hmr2" and use_gait_feat:
        raise ValueError("the gait corrector is GRNet's (MAX-GRNet): "
                         "arch='hmr2' has none")
    if arch == "hmr2" and ckpt:
        raise NotImplementedError(
            f"{ckpt}: the import of 4D-Humans' published HMR 2.0 checkpoint "
            "is not written yet; run arch='hmr2' without a checkpoint "
            "(random weights)")
    smpl_params = None
    smpl_path = smpl_model
    if smpl_path is None:
        cand = osp.join(SMPL_DATA_DIR, "SMPL_NEUTRAL.pkl")
        smpl_path = cand if osp.isfile(cand) else None
    if smpl_path:
        smpl_params = body_smpl.load_smpl_params(smpl_path)
        extra = osp.join(osp.dirname(smpl_path), "J_regressor_extra.npy")
        if osp.isfile(extra):
            smpl_params = body_smpl.with_extra_regressor(smpl_params, extra)
    else:
        print("WARNING: no SMPL model file found; using synthetic SMPL "
              "parameters (outputs are structurally valid, not meaningful).")

    if arch == "hmr2":
        from gaitlab_torch.nn.hmr2 import HMR2Core

        print("WARNING: HMR 2.0 runs with random weights.")
        return GRNet.create(smpl_params=smpl_params, joint_mode="spin2",
                            device=device, trunk=HMR2Core)
    model = GRNet.create(smpl_params=smpl_params, joint_mode="spin2",
                         device=device, use_gait_feat=use_gait_feat)
    if ckpt and osp.isfile(ckpt):
        missing, _, state = load_grnet_ckpt(model.module, ckpt)
        if missing:
            print(f"WARNING: {len(missing)} model params not in checkpoint "
                  f"(e.g. {missing[:3]})")
        if state.get("performance") is not None:
            print(f"Performance of pretrained model on 3DPW: "
                  f"{state['performance']}")
    elif ckpt:
        raise FileNotFoundError(f"checkpoint not found: {ckpt}")
    else:
        print("WARNING: --ckpt not given; running with random weights.")
    return model


def load_pickle(path: str):
    """A pickle as joblib.dump or pickle.dump wrote it. joblib reads both;
    without joblib installed, plain pickles are read."""
    try:
        import joblib
    except ImportError:
        with open(path, "rb") as f:
            return pickle.load(f)
    return joblib.load(path)


def run_tracking(args, image_folder, video_file=None, device=None):
    """Tracklets split at large gaps (smooth_tracking), with the sorted
    list of their frame ids. From --tracking_path when given; else a
    detector on `device` (the model's) and SORT over the clip in chunks of
    64 frames, never the whole clip in memory: from the video itself with
    `video_file` (--stream), the median-background model fitted on the
    first 64 frames; from the frame folder otherwise, that model fitted on
    at most 60 frames sampled across the clip."""
    from gaitlab_torch.pipeline import detect, tracks, video

    if args.tracking_path:
        if not osp.isfile(args.tracking_path):
            raise FileNotFoundError(
                f"tracking file not found: {args.tracking_path}")
        tracking_results = load_pickle(args.tracking_path)
        if 0 not in list(tracking_results.keys()):
            tracking_results = {0: tracking_results}
        print(f'Loaded precomputed tracklets from "{args.tracking_path}"')
        return tracks.smooth_tracking(tracking_results)

    detector = detect.get_detector(
        args.detector, input_size=args.yolo_img_size,
        batch=args.tracker_batch_size, device=device)
    median_bg = isinstance(detector, detect.MedianBackgroundDetector)
    if video_file is not None:
        if median_bg:
            head, got = [], 0
            for chunk in video.VideoChunkReader(video_file, chunk=64):
                head.append(chunk)
                got += len(chunk)
                if got >= 64:
                    break
            detector.fit(np.concatenate(head, axis=0))

        def detections():
            for chunk in video.VideoChunkReader(video_file, chunk=64,
                                                reuse_buffers=True):
                yield from detector(chunk)
    else:
        files = video.list_image_files(image_folder)
        if median_bg:
            # sampled across the clip: a sample from its head would bake a
            # person standing still in the first seconds into the
            # background
            idx = np.unique(np.linspace(0, len(files) - 1,
                                        min(60, len(files))).astype(int))
            detector.fit(video.load_frames([files[i] for i in idx]))

        def detections():
            for s0 in range(0, len(files), 64):
                yield from detector(video.load_frames(files[s0:s0 + 64]))

    return tracks.smooth_tracking(tracks.track_video(detections()))


def _person_output(out, bboxes, frames, person_id, args, model, orig_width,
                   orig_height) -> dict:
    """run_track outputs -> the reference pkl entry: optional one-euro
    smoothing (one SMPL pass on the model's device), crop -> image
    coordinates and the skeleton format conversion."""
    from gaitlab_torch.body.joints import convert_kps
    from gaitlab_torch.pipeline import coords, smoothing

    pred_verts, pred_pose, pred_joints3d = (out["verts"], out["pose"],
                                            out["joints3d"])
    if args.smooth:
        print(f"Running smoothing on person {person_id}, "
              f"min_cutoff: {args.smooth_min_cutoff}, "
              f"beta: {args.smooth_beta}")
        pred_verts, pred_pose, pred_joints3d = smoothing.smooth_pose(
            out["pose"], out["betas"], smpl_params=model.smpl,
            min_cutoff=args.smooth_min_cutoff, beta=args.smooth_beta)

    output_dict = {
        "pred_cam": out["pred_cam"],
        "orig_cam": coords.convert_crop_cam_to_orig_img(
            out["pred_cam"], bboxes, orig_width, orig_height),
        "verts": pred_verts,
        "pose": pred_pose,
        "betas": out["betas"],
        "joints3d": pred_joints3d,
        "joints2d": coords.convert_crop_coords_to_orig_img(
            bboxes, out["joints2d"], crop_size=224),
        "bboxes": bboxes,
        "frame_ids": frames,
    }
    if args.joint_type != "spin":
        # the model emits spin2 (29 joints), converted to the requested
        # skeleton
        try:
            output_dict["joints3d"] = convert_kps(
                pred_joints3d, "spin2", args.joint_type)
        except KeyError:
            print(f"Unknown skeleton type: {args.joint_type}.")
    return output_dict


def _runner_kwargs(args) -> dict:
    """--grnet_batch_size caps the bucket sizes (450, the default, equals
    the largest default bucket); --parallel and --precision go through."""
    from gaitlab_torch.pipeline.runner import DEFAULT_BUCKETS

    kw = {"parallel": args.parallel}
    if args.precision:
        kw["precision"] = args.precision
    gbs = int(args.grnet_batch_size or 0)
    if gbs and gbs != 450:
        kw["buckets"] = tuple(sorted(
            {b for b in DEFAULT_BUCKETS if b < gbs} | {gbs}))
    return kw


def _runner(args, model):
    """The demo's runner, at the trunk's crop (224 for GRNet, 256 for HMR
    2.0) unless `_runner_kwargs` names one."""
    from gaitlab_torch.pipeline.runner import GRNetRunner

    kw = {"crop_size": model.module.img_res, **_runner_kwargs(args)}
    return GRNetRunner(model, bbox_scale=1.0, **kw)


def _save(args, grnet_results: dict, output_path: str) -> str:
    """The pkl, named as the reference names it (a counter on repeats);
    returns its file name."""
    ckpt_base = (osp.basename(args.ckpt).split(".")[0] if args.ckpt
                 else "grnet")
    idx = sum(1 for f in os.listdir(output_path)
              if ckpt_base in f and f.endswith(".pkl"))
    pklname = f"{ckpt_base}{idx}.pkl" if idx else f"{ckpt_base}.pkl"
    pklpath = osp.join(output_path, pklname)
    print(f'Saving complete output results to "{pklpath}".')
    # a plain pickle, which joblib.load (the reference's reader) reads
    with open(pklpath, "wb") as f:
        pickle.dump(grnet_results, f)
    return pklname


def _save_and_render(args, grnet_results: dict, num_frames_list,
                     image_folder, output_path: str, model, timer,
                     orig_width, orig_height) -> None:
    """The demo's tail: the pkl, --save_obj meshes, the overlay video
    (named after the pkl) and the stage report."""
    pklname = _save(args, grnet_results, output_path)
    if args.save_obj and grnet_results:
        # per-person per-frame meshes, the reference's naming
        # rendered/{person:04d}/{frame:06d}.obj, with or without
        # --mesh_render
        from gaitlab_torch.render import export

        faces = model.smpl.faces
        if faces is None:
            print("WARNING: --save_obj needs SMPL faces; skipping.")
        else:
            for person_id, d in grnet_results.items():
                folder = osp.join(output_path, "rendered", f"{person_id:04d}")
                os.makedirs(folder, exist_ok=True)
                for verts, fid in zip(d["verts"], d["frame_ids"]):
                    export.export_obj(
                        osp.join(folder, f"{int(fid):06d}.obj"), verts, faces)
            print(f'Saved per-frame .obj meshes under '
                  f'"{osp.join(output_path, "rendered")}".')
    if args.save_vid and grnet_results:
        from gaitlab_torch.render import overlay

        save_name = osp.join(output_path, pklname.split(".")[0] + ".mp4")
        with timer.stage("render"):
            overlay.render_video(
                grnet_results, num_frames_list, image_folder, save_name,
                orig_size=(orig_width, orig_height),
                mesh_render=args.mesh_render, wireframe=args.wireframe,
                sideview=args.sideview, joint_type=args.joint_type,
                smpl_faces=model.smpl.faces, display=args.display)
    print("Stage timing:\n" + timer.report())


def _report(n_frames: int, grnet_time: float, total_time: float) -> None:
    print(f"VIBE FPS: {n_frames / (time.time() - grnet_time):.2f}")
    t = time.time() - total_time
    print(f"Total time spent: {t:.2f} seconds (including model loading "
          f"time).")
    print(f"Total FPS (including model loading time): {n_frames / t:.2f}.")


def run_onepass(args, model, video_file, orig_width, orig_height,
                total_time) -> tuple[dict, list]:
    """--onepass: one decode of the video for detection, SORT, crops and
    the model (pipeline/stream.py). Returns the results and the sorted
    union of the tracks' frame ids."""
    from gaitlab_torch.pipeline import detect
    from gaitlab_torch.pipeline import stream as stream_mod

    runner = _runner(args, model)
    grnet_time = time.time()
    res = stream_mod.run_video_onepass(
        runner, video_file, detector=detect.get_detector(
            args.detector, input_size=args.yolo_img_size,
            batch=args.tracker_batch_size, device=model.device))
    grnet_results = {
        pid: _person_output(out, out["bboxes"], out["frames"], pid,
                            args, model, orig_width, orig_height)
        for pid, out in res.items()}
    num_frames_list = sorted({int(f) for r in res.values()
                              for f in r["frames"]})
    _report(len(num_frames_list), grnet_time, total_time)
    return grnet_results, num_frames_list


def run_tracks(args, model, tracking_results, image_folder, video_file,
               orig_width, orig_height) -> dict:
    """GRNet on each tracklet: frames from the folder's PNGs, or decoded
    from the video when there is no folder (--stream)."""
    from gaitlab_torch.pipeline import video

    runner = _runner(args, model)
    image_files = (np.array(video.list_image_files(image_folder))
                   if image_folder else None)
    print("Running Model on each tracklet...")
    grnet_results = {}
    for person_id in list(tracking_results.keys()):
        bboxes = np.array(tracking_results[person_id]["bbox"], np.float32)
        frames = np.asarray(tracking_results[person_id]["frames"])
        if image_files is None:  # --stream: decode from the video
            source = video.VideoChunkReader(video_file, frame_ids=frames,
                                            reuse_buffers=True)
        else:
            source = list(image_files[frames])
        out = runner.run_track(source, bboxes)
        grnet_results[person_id] = _person_output(
            out, bboxes, frames, person_id, args, model, orig_width,
            orig_height)
    return grnet_results


def main(args):
    """The demo on parsed arguments, in a trace of the whole run when
    $GAITLAB_PROFILE names a directory (utils.profile_trace)."""
    from gaitlab_torch.utils import profile_trace

    with profile_trace():
        return _run(args)


def _run(args):
    from gaitlab_torch.config import parse_args
    from gaitlab_torch.pipeline import loader, video
    from gaitlab_torch.utils import StageTimer

    check_render_deps(args)
    total_time = time.time()
    timer = StageTimer()
    cfg, _ = parse_args(args)

    video_file = args.vid_file
    if not args.img_folder and "://" in video_file:
        sys.exit(
            f"Input video \"{video_file}\" is a URL. This build runs "
            "offline (no network egress): download the clip first "
            "(e.g. yt-dlp on a connected machine) and pass the local file.")
    if not args.img_folder and not osp.isfile(video_file):
        sys.exit(f"Input video \"{video_file}\" does not exist!")
    output_path = osp.join(
        args.output_folder,
        osp.basename(video_file if video_file else args.img_folder).replace(
            ".", "_"))
    os.makedirs(output_path, exist_ok=True)

    model = load_model(args, cfg)  # before any decode: fail fast on no CUDA
    onepass = (bool(args.onepass) and not args.img_folder
               and not args.tracking_path)
    stream = (bool(args.stream) or onepass) and not args.img_folder
    if stream and (args.save_vid or args.mesh_render or args.display):
        print("WARNING: --stream/--onepass need rendering/display off "
              "(pass --save_vid to disable video output); using the "
              "frame-folder pipeline.")
        stream = onepass = False
    if args.img_folder:
        image_folder = args.img_folder
        files = video.list_image_files(image_folder)
        num_frames = len(files)
        orig_height, orig_width = loader.image_size(files[0])
    elif stream:
        image_folder = None
        num_frames, _, orig_width, orig_height = video.get_video_info(
            video_file)
    else:
        with timer.stage("decode"):
            image_folder, num_frames, img_shape = video.video_to_images(
                video_file, return_info=True)
        orig_height, orig_width = img_shape[:2]
    print(f"Input video number of frames {num_frames}")
    try:
        if onepass:
            with timer.stage("onepass"):
                grnet_results, num_frames_list = run_onepass(
                    args, model, video_file, orig_width, orig_height,
                    total_time)
        else:
            with timer.stage("tracking"):
                tracking_results, num_frames_list = run_tracking(
                    args, image_folder,
                    video_file=video_file if stream else None,
                    device=model.device)
            for person_id in list(tracking_results.keys()):
                if tracking_results[person_id]["frames"].shape[0] < \
                        MIN_NUM_FRAMES:
                    del tracking_results[person_id]
            grnet_time = time.time()
            with timer.stage("model"):
                grnet_results = run_tracks(
                    args, model, tracking_results, image_folder, video_file,
                    orig_width, orig_height)
            _report(len(num_frames_list), grnet_time, total_time)
        _save_and_render(args, grnet_results, num_frames_list, image_folder,
                         output_path, model, timer, orig_width, orig_height)
    finally:
        if not args.img_folder and image_folder:
            shutil.rmtree(image_folder)
    print("================= END =================")
    return grnet_results


def main_cli():
    main(build_parser().parse_args())


if __name__ == "__main__":
    main_cli()
