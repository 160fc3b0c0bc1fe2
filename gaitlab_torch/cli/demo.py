"""Flag-compatible demo CLI, `--tracking_path` path: precomputed tracklets
-> crops -> GRNet + SMPL on the card -> pkl.

Counterpart of gaitlab/cli/demo.py with the same parser and the same pkl
schema per person (pred_cam, orig_cam, verts, pose, betas, joints3d,
joints2d, bboxes, frame_ids) and file naming. Runs on CUDA unless
--cpu_only is given. Paths of gaitlab's demo that are not ported yet raise
NotImplementedError: --smooth, rendering (video output unless --save_vid
is passed, --mesh_render, --display, --save_obj), detection (no
--tracking_path), --stream / --onepass, --precision other than float32, and
--parallel.

Usage:
  python -m gaitlab_torch.cli.demo --vid_file clip.mp4 \
      --tracking_path tracks.pkl --save_vid --output_folder out/
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


def build_parser() -> argparse.ArgumentParser:
    """The reference's argparse surface, flag for flag."""
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
                        "(not ported yet: pass --tracking_path)")
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
                   help="save output video to output folder (the flag "
                        "turns it off; video output is not ported yet).")
    p.add_argument("--cpu_only", action="store_true",
                   help="run on the CPU instead of the card.")
    p.add_argument("--smpl_model", type=str, default=None,
                   help="path to SMPL model pkl/npz (defaults to "
                        "data/smpl_data per config).")
    p.add_argument("--stream", action="store_true",
                   help="decode frames straight from the video (not ported "
                        "yet).")
    p.add_argument("--onepass", action="store_true",
                   help="single-decode pipeline (not ported yet).")
    p.add_argument("--precision", type=str, default=None,
                   choices=["high", "float32", "default"],
                   help="matmul precision; only float32 (TF32 off) is "
                        "ported, and it is the default.")
    p.add_argument("--parallel", type=str, default=None,
                   choices=["dp", "pp"],
                   help="multi-card strategy (not ported yet).")
    return p


def check_ported(args) -> None:
    """Raise NotImplementedError for every flag whose path is not ported."""
    unported = {
        "--smooth": args.smooth,
        "video output (pass --save_vid to turn it off)": args.save_vid,
        "--mesh_render": args.mesh_render,
        "--display": args.display,
        "--save_obj": args.save_obj,
        "detection (pass --tracking_path)": not args.tracking_path,
        "--stream": args.stream,
        "--onepass": args.onepass,
        f"--precision {args.precision}": args.precision not in (None,
                                                                "float32"),
        f"--parallel {args.parallel}": args.parallel is not None,
    }
    missing = [k for k, on in unported.items() if on]
    if missing:
        raise NotImplementedError(
            "not ported to gaitlab_torch yet: " + ", ".join(missing))


def load_model(args, cfg):
    """GRNet (synthetic SMPL unless a model file is found) with random
    weights, or a reference GRNet checkpoint's weights, on the card (the CPU
    with --cpu_only)."""
    from gaitlab_torch.body import smpl as body_smpl
    from gaitlab_torch.config import SMPL_DATA_DIR
    from gaitlab_torch.nn.grnet import GRNet
    from gaitlab_torch.weights.torch_import import load_grnet_ckpt

    smpl_params = None
    smpl_path = args.smpl_model
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

    model = GRNet.create(smpl_params=smpl_params, joint_mode="spin2",
                         device="cpu" if args.cpu_only else None)
    if args.ckpt and osp.isfile(args.ckpt):
        missing, _, state = load_grnet_ckpt(model.module, args.ckpt)
        if missing:
            print(f"WARNING: {len(missing)} model params not in checkpoint "
                  f"(e.g. {missing[:3]})")
        if state.get("performance") is not None:
            print(f"Performance of pretrained model on 3DPW: "
                  f"{state['performance']}")
    elif args.ckpt:
        raise FileNotFoundError(f"checkpoint not found: {args.ckpt}")
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


def load_tracklets(args) -> tuple[dict, list]:
    """Precomputed tracklets -> split at large gaps (smooth_tracking) ->
    tracks of at least MIN_NUM_FRAMES frames."""
    from gaitlab_torch.pipeline import tracks

    if not osp.isfile(args.tracking_path):
        raise FileNotFoundError(
            f"tracking file not found: {args.tracking_path}")
    tracking_results = load_pickle(args.tracking_path)
    if 0 not in list(tracking_results.keys()):
        tracking_results = {0: tracking_results}
    print(f'Loaded precomputed tracklets from "{args.tracking_path}"')
    tracking_results, num_frames_list = tracks.smooth_tracking(
        tracking_results)
    for person_id in list(tracking_results.keys()):
        if tracking_results[person_id]["frames"].shape[0] < MIN_NUM_FRAMES:
            del tracking_results[person_id]
    return tracking_results, num_frames_list


def _person_output(out, bboxes, frames, args, orig_width,
                   orig_height) -> dict:
    """run_track outputs -> the reference pkl entry: crop -> image
    coordinates and the skeleton format conversion."""
    from gaitlab_torch.body.joints import convert_kps
    from gaitlab_torch.pipeline import coords

    output_dict = {
        "pred_cam": out["pred_cam"],
        "orig_cam": coords.convert_crop_cam_to_orig_img(
            out["pred_cam"], bboxes, orig_width, orig_height),
        "verts": out["verts"],
        "pose": out["pose"],
        "betas": out["betas"],
        "joints3d": out["joints3d"],
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
                out["joints3d"], "spin2", args.joint_type)
        except KeyError:
            print(f"Unknown skeleton type: {args.joint_type}.")
    return output_dict


def _runner_kwargs(args) -> dict:
    """--grnet_batch_size caps the bucket sizes (450, the default, equals
    the largest default bucket)."""
    from gaitlab_torch.pipeline.runner import DEFAULT_BUCKETS

    gbs = int(args.grnet_batch_size or 0)
    if gbs and gbs != 450:
        return {"buckets": tuple(sorted(
            {b for b in DEFAULT_BUCKETS if b < gbs} | {gbs}))}
    return {}


def main(args):
    from gaitlab_torch.config import parse_args
    from gaitlab_torch.pipeline import video
    from gaitlab_torch.pipeline.runner import GRNetRunner

    check_ported(args)
    total_time = time.time()
    cfg, _ = parse_args(args)

    video_file = args.vid_file
    if not args.img_folder and not osp.isfile(video_file):
        sys.exit(f"Input video \"{video_file}\" does not exist!")
    output_path = osp.join(
        args.output_folder,
        osp.basename(video_file if video_file else args.img_folder).replace(
            ".", "_"))
    os.makedirs(output_path, exist_ok=True)

    model = load_model(args, cfg)  # before any decode: fail fast on no CUDA
    if args.img_folder:
        image_folder = args.img_folder
        import cv2

        first = cv2.imread(video.list_image_files(image_folder)[0])
        orig_height, orig_width = first.shape[:2]
    else:
        image_folder, _, img_shape = video.video_to_images(
            video_file, return_info=True)
        orig_height, orig_width = img_shape[:2]
    try:
        image_files = np.array(video.list_image_files(image_folder))
        print(f"Input video number of frames {len(image_files)}")
        tracking_results, num_frames_list = load_tracklets(args)
        runner = GRNetRunner(model, bbox_scale=1.0, **_runner_kwargs(args))

        print("Running Model on each tracklet...")
        grnet_time = time.time()
        grnet_results = {}
        for person_id in list(tracking_results.keys()):
            bboxes = np.array(tracking_results[person_id]["bbox"], np.float32)
            frames = np.asarray(tracking_results[person_id]["frames"])
            out = runner.run_track(list(image_files[frames]), bboxes)
            grnet_results[person_id] = _person_output(
                out, bboxes, frames, args, orig_width, orig_height)
        fps = len(num_frames_list) / (time.time() - grnet_time)
        print(f"VIBE FPS: {fps:.2f}")
        t = time.time() - total_time
        print(f"Total time spent: {t:.2f} seconds (including model loading "
              f"time).")
        print(f"Total FPS (including model loading time): "
              f"{len(num_frames_list) / t:.2f}.")

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
    finally:
        if not args.img_folder:
            shutil.rmtree(image_folder)
    print("================= END =================")
    return grnet_results


def main_cli():
    main(build_parser().parse_args())


if __name__ == "__main__":
    main_cli()
