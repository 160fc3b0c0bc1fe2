"""Crop-frame -> original-image coordinate converters (numpy).

Counterpart of gaitlab/pipeline/coords.py (the reference's
demo_utils.convert_crop_cam_to_orig_img / convert_crop_coords_to_orig_img).
"""

from __future__ import annotations

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
