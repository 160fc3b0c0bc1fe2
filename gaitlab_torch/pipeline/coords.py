"""Crop-frame -> original-image coordinate converters and the render
order of each frame's people (numpy).

Counterpart of gaitlab/pipeline/coords.py (the reference's
demo_utils.convert_crop_cam_to_orig_img, convert_crop_coords_to_orig_img
and prepare_rendering_results).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np


def convert_crop_cam_to_orig_img(cam: np.ndarray, bbox: np.ndarray,
                                 img_width: float, img_height: float
                                 ) -> np.ndarray:
    """Weak-perspective cam in crop coords -> [sx, sy, tx, ty] in original
    image coords. cam (N,3) [s, tx, ty]; bbox (N,4|3) [cx, cy, h, ...]."""
    cam = np.asarray(cam)
    bbox = np.asarray(bbox)
    cx, cy, h = bbox[:, 0], bbox[:, 1], bbox[:, 2]
    hw, hh = img_width / 2.0, img_height / 2.0
    sx = cam[:, 0] * (1.0 / (img_width / h))
    sy = cam[:, 0] * (1.0 / (img_height / h))
    tx = ((cx - hw) / hw / sx) + cam[:, 1]
    ty = ((cy - hh) / hh / sy) + cam[:, 2]
    return np.stack([sx, sy, tx, ty]).T


def convert_crop_coords_to_orig_img(bbox: np.ndarray, keypoints: np.ndarray,
                                    crop_size: int) -> np.ndarray:
    """[-1,1] crop keypoints -> original-image pixels."""
    bbox = np.asarray(bbox)
    keypoints = np.array(keypoints, np.float32)
    cx, cy, h = bbox[:, 0], bbox[:, 1], bbox[:, 2]
    keypoints = 0.5 * crop_size * (keypoints + 1.0)
    keypoints = keypoints * h[..., None, None] / crop_size
    keypoints[:, :, 0] = (cx - h / 2)[..., None] + keypoints[:, :, 0]
    keypoints[:, :, 1] = (cy - h / 2)[..., None] + keypoints[:, :, 1]
    return keypoints


def prepare_rendering_results(results: dict, nframes: list,
                              concat: bool = False) -> dict:
    """[person][frame] -> [frame][person], each frame's people sorted by
    their image cam's y-scale (far to near). With `concat`, each frame's
    people are concatenated into one array per key instead."""
    if not isinstance(nframes, list):
        raise TypeError("nframes must be a list of frame ids")
    if concat:
        frame_results = {nf: {"verts": [], "cam": [], "j3d": [], "j2d": []}
                         for nf in nframes}
    else:
        frame_results = {nf: {} for nf in nframes}
    for person_id, person_data in results.items():
        for idx, frame_id in enumerate(person_data["frame_ids"]):
            payload = {
                "verts": person_data["verts"][idx],
                "cam": person_data["orig_cam"][idx],
                "j3d": person_data["joints3d"][idx],
                "j2d": person_data["joints2d"][idx],
            }
            if concat:
                for k, v in payload.items():
                    frame_results[frame_id][k].append(v)
            else:
                frame_results[frame_id][person_id] = payload
    for frame_id, frame_data in frame_results.items():
        if concat:
            frame_results[frame_id] = {
                k: np.concatenate(v, axis=0) for k, v in frame_data.items()}
        else:
            keys = list(frame_data.keys())
            sort_idx = np.argsort([frame_data[k]["cam"][1] for k in keys])
            frame_results[frame_id] = OrderedDict(
                (keys[i], frame_data[keys[i]]) for i in sort_idx)
    return frame_results
