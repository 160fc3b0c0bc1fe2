"""Per-item dataset wrappers over a frame folder, for scripts written
against the reference's `Inference` and `ImageFolder` datasets.

Counterpart of gaitlab/pipeline/datasets.py:

    ds = Inference(image_folder, frames, bboxes, scale=1.0)
    norm_img = ds[0]                  # (224, 224, 3) float32 NHWC, host
    batch = ds.batch(range(len(ds)))  # cropped on the card (or `device`)
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from gaitlab_torch.device import resolve_device
from gaitlab_torch.pipeline import boxes as boxes_mod
from gaitlab_torch.pipeline import crop as crop_mod
from gaitlab_torch.pipeline import loader
from gaitlab_torch.pipeline import video as video_mod


class Inference:
    """A track's crops. With `joints2d`, the bboxes come from the
    keypoints and the track is cut to the frames that have one. The
    caller's bboxes are not changed (the reference scales them in
    place)."""

    def __init__(self, image_folder: str, frames, bboxes=None,
                 joints2d=None, scale: float = 1.0, crop_size: int = 224):
        paths = np.array(video_mod.list_image_files(image_folder))
        frames = np.asarray(frames)
        self.scale = scale
        self.crop_size = crop_size
        self.has_keypoints = joints2d is not None
        if self.has_keypoints:
            frames, bboxes, joints2d = boxes_mod.track_window_from_joints2d(
                frames, joints2d)
            self.joints2d = joints2d
            self.bboxes = bboxes
        else:
            self.joints2d = None
            bboxes = np.array(bboxes, np.float32, copy=True)
            bboxes[:, 2:] *= scale
            self.bboxes = bboxes
        self.frames = frames
        self.image_file_names = paths[frames]

    def __len__(self):
        return len(self.image_file_names)

    def __getitem__(self, idx: int):
        """The host crop of one frame (cv2), normalized; with keypoints,
        also the keypoints in crop pixels."""
        norm, _, kp = crop_mod.get_single_image_crop_demo(
            str(self.image_file_names[idx]), self.bboxes[idx],
            kp_2d=self.joints2d[idx] if self.has_keypoints else None,
            scale=1.0 if not self.has_keypoints else self.scale,
            crop_size=self.crop_size)
        if self.has_keypoints:
            return norm, kp
        return norm

    def batch(self, indices: Optional[Sequence[int]] = None,
              device=None) -> torch.Tensor:
        """The crops of `indices` (all by default), (N, crop, crop, 3)
        float32 normalized, cropped on `device` (None is the card)."""
        idx = np.arange(len(self)) if indices is None else np.asarray(indices)
        imgs = loader.load_frames([str(p) for p in self.image_file_names[idx]])
        return crop_mod.crop_and_normalize(
            imgs, self.bboxes[idx], scale=1.0, crop_size=self.crop_size,
            device=resolve_device(device))


class ImageFolder:
    """Whole frames of a folder, RGB float32 in [0, 1]."""

    def __init__(self, image_folder: str):
        self.image_file_names = video_mod.list_image_files(image_folder)

    def __len__(self):
        return len(self.image_file_names)

    def __getitem__(self, idx: int) -> np.ndarray:
        return video_mod.load_frames(
            [self.image_file_names[idx]])[0].astype(np.float32) / 255.0
