"""Flag-compatible batch_generation CLI: a folder of clips and their bbox
database -> the sharded kinectv2 3D-joint database, with GRNet on the
card.

Counterpart of gaitlab/cli/batch_generation.py with the same flags,
tunables, shard names and schema {vid_name, bbox, joints3D (T, 25, 3)}:
each clip is extracted to PNGs at EXTRACT_FPS (or, with --stream, decoded
straight from the video at the same frames), its bboxes are realigned
when the frame counts differ by less than MIN_FDIFF, GRNet runs on crops
at scale 1.1 and the spin2 joints become kinectv2 joints. Every MAX_VID
clips (or $GAITLAB_BG_MAXVID) a shard is written. --num_shards and
--shard_id split the clips between workers, whose shards never share a
name; --resume skips shards that exist. Shards, and the list of failed
clips, are plain pickles, which joblib.load also reads.

A clip whose input is at fault (it cannot be opened, its frame count is
MIN_FDIFF or more off its bboxes, its bbox array is malformed) is listed
in `<outpath>_failed.json` and the run goes on. A fault of the model,
the kernels or the card stops the run.

Runs on the card unless --cpu_only is given.

Usage:
  python -m gaitlab_torch.cli.batch_generation --vid_folder clips/ \
      --bbox_path coarse_bbox.json --outpath data/db.json --stream
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
import shutil
import time
from collections import defaultdict

import numpy as np

MIN_FDIFF = 10
MAX_seqlen = 400
MAX_VID = 50
EXTRACT_FPS = 20


def build_parser() -> argparse.ArgumentParser:
    """gaitlab's argparse surface, flag for flag."""
    p = argparse.ArgumentParser()
    p.add_argument("--vid_folder", type=str, default="",
                   help="folder containing videos to process.")
    p.add_argument("--bbox_path", type=str, default="",
                   help="json file path, the precomputed bbox (.json).")
    p.add_argument("--outpath", type=str,
                   default=f"data/{time.strftime('%Y%m%d-%H%M%S')}",
                   help="output path to save generated 3D joints.")
    p.add_argument("--pretrained_file", type=str,
                   default="checkpoint/max-grnet.pth.tar",
                   help="path to the pretrained weights.")
    p.add_argument("--smpl_model", type=str, default=None,
                   help="path to SMPL model pkl/npz.")
    p.add_argument("--num_shards", type=int, default=1,
                   help="process-level sharding: total number of workers.")
    p.add_argument("--shard_id", type=int, default=0,
                   help="process-level sharding: this worker's index.")
    p.add_argument("--resume", action="store_true",
                   help="skip output shards that already exist.")
    p.add_argument("--stream", action="store_true",
                   help="decode straight from the video (no PNG folder).")
    p.add_argument("--precision", type=str, default=None,
                   choices=["high", "float32", "default"],
                   help="matmul precision: float32 (TF32 off) is the "
                        "default; high and default run TF32 passes "
                        "(nn/layers.py).")
    p.add_argument("--cpu_only", action="store_true",
                   help="run on the CPU instead of the card.")
    p.add_argument("--crop_size", type=int, default=224,
                   help="crop size of the model's input; 224 is the "
                        "deployed operating point, smaller sizes are for "
                        "tests.")
    return p


def _sort_key(name: str):
    """The reference's clip-name order (aXXXbXXXcXXXdXXX), with the
    lexicographic order for other names after it."""
    try:
        return (0, int(name[1:4] + name[6:9] + name[11:14] + name[16:19]))
    except (ValueError, IndexError):
        return (1, name)


def _shard_path(outpath: str, out_ind: int, num_shards: int = 1,
                shard_id: int = 0) -> str:
    """A flush's file: `<outpath>_{k}.json` for one worker (the
    reference's name), `<outpath>.w{shard_id}_{k}.json` for several, so
    that workers sharing an outpath never collide."""
    if not outpath.endswith(".json"):
        raise ValueError(f"outpath must end in .json: {outpath}")
    base = outpath[:-5]
    if num_shards > 1:
        return f"{base}.w{shard_id}_{out_ind}.json"
    return f"{base}_{out_ind}.json"


def _dump(obj, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _flush_db(db: dict, outfp: str, start_time: float) -> str:
    for k, v in db.items():
        if isinstance(v[0], np.ndarray):
            db[k] = np.concatenate(v, axis=0).astype(np.float32)
        else:
            db[k] = np.array(v)
        print(f"{k} shape: {db[k].shape}")
    rate = db["vid_name"].shape[0] / (time.time() - start_time)
    print(f"=====>>> Generation frame rate: {rate}.")
    _dump(dict(db), outfp)
    print(f"Save database to {outfp}.")
    return outfp


class InputFault(Exception):
    """A clip the run skips and lists as failed: it cannot be opened, its
    frame count is MIN_FDIFF or more off its bboxes, or its bbox array is
    malformed."""


def video_to_images_fps20(vid_path: str) -> str:
    from gaitlab_torch.pipeline import video as video_mod

    return video_mod.video_to_images(vid_path, fps=EXTRACT_FPS)


def _prepare_clip(vid_path: str, anno, stream: bool):
    """The clip's input, before any model work: (its frame source, the
    bboxes realigned to its frame count, the PNG folder or None). Raises
    InputFault for the faults of the clip's input; nothing here runs on
    the card."""
    from gaitlab_torch.pipeline import video as video_mod

    img_dir = None
    try:
        bboxes = np.asarray(anno, np.float32)
        if bboxes.ndim != 2 or bboxes.shape[1] != 4:
            raise ValueError(f"bboxes must be (frames, 4), got {bboxes.shape}")
        frame_num = bboxes.shape[0]
        if stream:
            n_raw, fps_in, _, _ = video_mod.get_video_info(vid_path)
            keep = video_mod._fps_resample_indices(n_raw, fps_in, EXTRACT_FPS)
            n_extracted = len(keep)
        else:
            img_dir = video_to_images_fps20(vid_path)
            img_files = video_mod.list_image_files(img_dir)
            n_extracted = len(img_files)
        if abs(n_extracted - frame_num) >= MIN_FDIFF:
            raise ValueError(f"frame mismatch: {n_extracted} vs {frame_num}")
    except (OSError, ValueError, TypeError) as e:
        if img_dir is not None:
            shutil.rmtree(img_dir)
        raise InputFault(str(e)) from e
    if n_extracted != frame_num:
        # the reference realigns by repeating the first bbox
        bboxes = np.repeat(bboxes[:1], n_extracted, axis=0)
    if stream:
        source = video_mod.VideoChunkReader(vid_path, frame_ids=keep,
                                            reuse_buffers=True)
    else:
        source = img_files
    return source, bboxes, img_dir


def run_grnet_on_frames(runner, source, bboxes: np.ndarray) -> np.ndarray:
    """Crops at scale 1.1 -> GRNet -> kinectv2 joints (T, 25, 3) float32."""
    from gaitlab_torch.body.joints import convert_kps

    out = runner.run_track(source, bboxes, scale=1.1)
    return convert_kps(out["joints3d"], src="spin2",
                       dst="kinectv2").astype(np.float32)


def prepare_data(fv: str, vid_folder: str, outpath: str,
                 pretrained_file: str = None, smpl_model: str = None,
                 num_shards: int = 1, shard_id: int = 0,
                 resume: bool = False, stream: bool = False,
                 precision: str = None, cpu_only: bool = False,
                 crop_size: int = 224) -> int:
    """Write the joint database of the clips of `vid_folder` that have
    bboxes in the database `fv`; returns the number of shard files."""
    from gaitlab_torch.cli import demo
    from gaitlab_torch.device import resolve_device
    from gaitlab_torch.pipeline.runner import (PRECISIONS, FrameCountError,
                                               GRNetRunner)

    if precision is not None and precision not in PRECISIONS:
        raise ValueError(f"--precision {precision}: use one of {PRECISIONS}")
    resolve_device("cpu" if cpu_only else None)  # no card: fail at once
    if not osp.isfile(fv):
        raise FileNotFoundError(f"bbox database not found: {fv}")
    annos = demo.load_pickle(fv)
    vidnames = sorted(os.listdir(vid_folder), key=_sort_key)
    vidnames = [v for i, v in enumerate(vidnames)
                if i % num_shards == shard_id]

    args = argparse.Namespace(ckpt=pretrained_file or "",
                              smpl_model=smpl_model, cfg=None,
                              cpu_only=cpu_only, arch="grnet")
    model = demo.load_model(args, None)
    # the database holds only joints3D: the vertices are not read back
    rkw = {"precision": precision} if precision else {}
    runner = GRNetRunner(model, fetch=("kp_3d",), crop_size=crop_size, **rkw)
    if not outpath.endswith(".json"):
        outpath = outpath + ".json"
    max_vid = int(os.environ.get("GAITLAB_BG_MAXVID", MAX_VID))

    db = defaultdict(list)
    failed = []
    start = time.time()
    out_ind = 0
    for idx, vid_name in enumerate(vidnames):
        # a flush every max_vid clips, unless 10 or fewer clips remain
        if idx % max_vid == 0 and idx > 0 and (len(vidnames) - idx) > 10:
            outfp = _shard_path(outpath, out_ind, num_shards, shard_id)
            if not (resume and osp.isfile(outfp)):
                _flush_db(db, outfp, start)
            out_ind += 1
            db = defaultdict(list)
            start = time.time()
        print("=" * 50 + f" process video {idx + 1}/{len(vidnames)} "
              + "=" * 50)
        if resume and osp.isfile(
                _shard_path(outpath, out_ind, num_shards, shard_id)):
            continue  # a previous run wrote this shard
        name = vid_name.split(".")[0]
        if name not in annos:
            print(f"Skip video {vid_name}, no precomputed 2D joints!")
            continue
        try:
            source, bboxes, img_dir = _prepare_clip(
                osp.join(vid_folder, vid_name), annos[name], stream)
            try:
                kp_3d = run_grnet_on_frames(runner, source, bboxes)
            finally:
                if img_dir is not None:
                    shutil.rmtree(img_dir)
        except (InputFault, FrameCountError) as e:
            print(f"FAILED video {vid_name}: {e}")
            failed.append({"vid_name": vid_name, "error": str(e)})
            continue
        frame_num = len(bboxes)
        db["vid_name"].extend([name] * frame_num)
        db["bbox"].append(bboxes.reshape(frame_num, 4))
        db["joints3D"].append(kp_3d.reshape(frame_num, 25, 3))

    if len(db):
        _flush_db(db, _shard_path(outpath, out_ind, num_shards, shard_id),
                  start)
    if failed:
        failpath = outpath[:-5] + (f".w{shard_id}_failed.json"
                                   if num_shards > 1 else "_failed.json")
        _dump(failed, failpath)
        print(f"{len(failed)} videos failed; manifest at {failpath}.")
    return out_ind + (1 if len(db) else 0)


def main(args) -> int:
    return prepare_data(fv=args.bbox_path, vid_folder=args.vid_folder,
                        outpath=args.outpath,
                        pretrained_file=args.pretrained_file,
                        smpl_model=args.smpl_model,
                        num_shards=args.num_shards, shard_id=args.shard_id,
                        resume=args.resume, stream=args.stream,
                        precision=args.precision, cpu_only=args.cpu_only,
                        crop_size=args.crop_size)


def main_cli():
    main(build_parser().parse_args())


if __name__ == "__main__":
    main_cli()
