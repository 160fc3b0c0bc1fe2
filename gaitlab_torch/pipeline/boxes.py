"""Bounding boxes from 2D keypoints: per-frame params, gap interpolation
and smoothing, on the host (numpy).

Counterpart of gaitlab/pipeline/boxes.py; the median and gaussian
filtering is core/filters.smooth_bbox_params.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from gaitlab_torch.core import filters


def kp_to_bbox_param(kp, vis_thresh: float = 2, squared: bool = True,
                     scale: float = 1.1) -> Optional[np.ndarray]:
    """[cx, cy, s] with s = 150 / person height (squared), or
    [cx, cy, w, h], from (K, 3) keypoints; None when too few are
    visible."""
    if kp is None:
        return None
    kp = np.asarray(kp)
    vis = kp[:, 2] > vis_thresh
    if not np.any(vis):
        return None
    min_pt = np.min(kp[vis, :2], axis=0)
    max_pt = np.max(kp[vis, :2], axis=0)
    person_height = np.linalg.norm(max_pt - min_pt)
    if person_height < 0.5:
        return None
    center = (min_pt + max_pt) / 2.0
    if squared:
        return np.append(center, 150.0 / person_height)
    wh = (max_pt - min_pt) * scale
    if not (wh > 0).all():
        raise ValueError(f"degenerate keypoint box {wh}")
    return np.append(center, wh)


def get_all_bbox_params(kps: Sequence, vis_thresh: float = 2,
                        squared: bool = True, scale: float = 1.1):
    """Per-frame bbox params, linearly interpolated over frames without
    one. Returns (params, first frame, end frame (exclusive))."""
    num_to_interpolate = 0
    start_index = -1
    dim = 3 if squared else 4
    rows: list[np.ndarray] = []
    i = -1
    for i, kp in enumerate(kps):
        bbox_param = kp_to_bbox_param(kp, vis_thresh=vis_thresh,
                                      squared=squared, scale=scale)
        if bbox_param is None:
            num_to_interpolate += 1
            continue
        if start_index == -1:
            start_index = i
            num_to_interpolate = 0
        if num_to_interpolate > 0:
            previous = rows[-1]
            interp = np.array(
                [np.linspace(prev, curr, num_to_interpolate + 2)
                 for prev, curr in zip(previous, bbox_param)])
            rows.extend(interp.T[1:-1])
            num_to_interpolate = 0
        rows.append(bbox_param)
    params = (np.array(rows, dtype=np.float32) if rows
              else np.empty((0, dim), np.float32))
    return params, start_index, i - num_to_interpolate + 1


def track_window_from_joints2d(frames: np.ndarray, joints2d: np.ndarray,
                               vis_thresh: float = 0.3):
    """Square bboxes from a track's 2D keypoints, and the track cut to
    the frames that have one. Returns (frames, bboxes (N, 4)
    [cx, cy, side, side], joints2d)."""
    params, t1, t2 = get_all_bbox_params(joints2d, vis_thresh=vis_thresh)
    side = 150.0 / params[:, 2]  # scale -> pixels
    bboxes = np.stack([params[:, 0], params[:, 1], side, side], axis=1)
    frames = np.asarray(frames)[t1:t2]
    joints2d = np.asarray(joints2d)[t1:t2]
    return frames, bboxes.astype(np.float32), joints2d


def get_smooth_bbox_params(kps: Sequence, vis_thresh: float = 2,
                           kernel_size: int = 11, sigma: float = 3,
                           squared: bool = True, scale: float = 1.1):
    """Bbox params, interpolated, median- then gaussian-filtered, with
    zero rows before the first frame that has one. Returns (params, first
    frame, end frame)."""
    bbox_params, start, end = get_all_bbox_params(
        kps, vis_thresh, squared=squared, scale=scale)
    smoothed = filters.smooth_bbox_params(bbox_params, kernel_size, sigma)
    dim = 3 if squared else 4
    smoothed = np.vstack((np.zeros((start, dim)), smoothed))
    return smoothed, start, end
