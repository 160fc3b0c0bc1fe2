"""OpenPose .mat annotations -> the coarse bbox database of
batch_generation.

Counterpart of gaitlab/pipeline/openpose.py: read each clip's OpenPose
skeletons (`skeleton`, (persons, frames, 25, 3) with x, y normalised to
the frame), drop the interaction actions and unusable annotations, keep
the dominant skeletons, and give each clip one constant square bbox
through the 1-medoid of its joints (pipeline/medoids.py, on `device`).
The bbox database and the list of bad annotations are written as plain
pickles, which joblib.load also reads.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle

import numpy as np

from gaitlab_torch.device import resolve_device
from gaitlab_torch.pipeline.medoids import IMG_H, IMG_W, get_bbox_from_joints2d

M = 3             # a usable frame has more than M confident joints
MIN_SDIFF = 0.01  # skeletons within this mean confidence of the best are kept
MAX_THRESH = 0.3  # 2D joint confidence threshold
INTERACT_ACTIONS = (44, 45, 46, 47, 48)  # actions with interaction


def load_openpose_anno(anno_folder: str = "./data/openpose/",
                       out_json_path: str = "data/coarse_bbox.json",
                       bad_json_path: str = "data/sample_wo_joints2D.json",
                       img_w: int = IMG_W, img_h: int = IMG_H,
                       device=None) -> dict:
    """{clip name: (frames, 4) bbox} for every usable .mat of
    `anno_folder`, also pickled to `out_json_path`; the file names of the
    unusable annotations go to `bad_json_path`. The medoids run on
    `device` (None is the card)."""
    import scipy.io as sio

    device = resolve_device(device)
    if not osp.isdir(anno_folder):
        raise NotADirectoryError(f"no annotation folder: {anno_folder}")
    total, count = 0, 0
    output = {}
    bad_annos = []
    for base in sorted(os.listdir(anno_folder)):
        try:
            act = int(base.split("_")[0][1:])
        except ValueError:
            act = -1
        if act in INTERACT_ACTIONS:
            continue
        joints2d = sio.loadmat(osp.join(anno_folder, base))["skeleton"]
        if joints2d.size == 0:
            bad_annos.append(base)
            continue
        # no skeleton with more than M joints seen on every frame
        if not (np.logical_and.reduce(
                (joints2d[:, :, :, 2] > 0).sum(-1) > M, axis=-1)).sum():
            bad_annos.append(base)
            continue
        seqlen = joints2d.shape[1]
        vid_name = base.split(".")[0]
        # the reference's test, kept as written: it reads joint 2's (x, y,
        # confidence), not the confidence column; a person is valid when
        # one of those three exceeds MAX_THRESH on every frame
        valid = np.logical_and.reduce(
            np.logical_or.reduce(joints2d[:, :, 2] > MAX_THRESH, axis=-1),
            axis=-1)
        if valid.sum() == 0:
            bad_annos.append(base)
            continue
        total += 1
        joints2d = joints2d[valid].reshape(-1, seqlen, 25, 3)
        mask = np.array([True])
        if joints2d.shape[0] > 1:
            scores = joints2d[:, :, :, 2].mean(-1).mean(-1)
            mask = (scores.max() - scores) < MIN_SDIFF
        if mask.sum() > 1:
            count += 1
        j2ds = joints2d[mask].reshape(-1, seqlen, 25, 3).copy()
        j2ds[:, :, :, 0] *= img_w
        j2ds[:, :, :, 1] *= img_h
        area = 0.0
        bboxes = None
        for j2d in j2ds:  # the skeleton with the largest bbox
            bbox = get_bbox_from_joints2d(j2d, smooth=False, device=device)
            if bbox[0, 2] > area:
                area = bbox[0, 2]
                bboxes = bbox
        output[vid_name] = bboxes

    print(f"Current with-interaction files: {count}/{total}.")
    for path, obj in ((out_json_path, output), (bad_json_path, bad_annos)):
        with open(path, "wb") as f:
            pickle.dump(obj, f)
    return output
