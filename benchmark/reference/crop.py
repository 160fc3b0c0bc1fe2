"""The host crop of the original demo: a square box warped to the crop by
the affine through three point pairs and cv2.warpAffine (bilinear, zero
border), then ImageNet normalisation.

The affine is solved in float64 from the points rounded to float32, as
the original's cv2.getAffineTransform takes them. cv2's own solver can
differ from numpy's in the last bit, and warpAffine's fixed-point map then
moves some pixels by one level: enough, through a random-weight network's
ill-conditioned rotations, to move the outputs by more than float32
rounding does. So the reference solves the system itself."""

from __future__ import annotations

import cv2
import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def box_affine(cx: float, cy: float, w: float, h: float, size: int,
               scale: float = 1.0) -> np.ndarray:
    """The 2x3 affine that maps the box (centre, width, height, times
    `scale`) onto a size x size crop: the box's centre, the middle of its
    bottom edge and the middle of its right edge onto the crop's."""
    src = np.array([[cx, cy], [cx, cy + h * scale / 2],
                    [cx + w * scale / 2, cy]], np.float32)
    half = size / 2
    dst = np.array([[half, half], [half, size], [size, half]], np.float32)
    a = np.concatenate([src.astype(np.float64), np.ones((3, 1))], axis=1)
    return np.linalg.solve(a, dst.astype(np.float64)).T


def crops_uint8(frames, boxes: np.ndarray, size: int = 224,
                scale: float = 1.0) -> np.ndarray:
    """frames: a sequence of (H, W, 3) uint8 images; boxes (N, 4) [cx, cy,
    w, h] -> (N, size, size, 3) uint8."""
    out = np.empty((len(boxes), size, size, 3), np.uint8)
    for i, (frame, box) in enumerate(zip(frames, boxes)):
        out[i] = cv2.warpAffine(np.asarray(frame),
                                box_affine(*box, size, scale), (size, size),
                                flags=cv2.INTER_LINEAR,
                                borderMode=cv2.BORDER_CONSTANT)
    return out


def normalize(crops_u8: np.ndarray, device) -> torch.Tensor:
    """uint8 NHWC crops -> float32 NCHW, (x / 255 - mean) / std."""
    x = torch.from_numpy(crops_u8).to(device).float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()
