"""Square-bbox crop + ImageNet normalisation, on the device or the host.

Counterpart of gaitlab/pipeline/crop.py. The inference affine is always
axis-aligned (rot=0, no flip), so the device crop is a separable bilinear
warp: float64 sampling tables built on the host (as cv2.warpAffine builds
its maps in double), then a gather-lerp over rows and one over columns,
rounding to uint8 intensities and the ImageNet normalisation, as plain
torch ops on the frames' device. The host crop is cv2.warpAffine, exactly
the reference's preprocessing.
"""

from __future__ import annotations

import numpy as np
import torch

from gaitlab_torch.device import constant, upload

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def gen_trans_from_patch(c_x, c_y, src_width, src_height, dst_width,
                         dst_height, scale, rot, inv=False) -> np.ndarray:
    """2x3 affine of the reference's triangle construction; rot in degrees."""
    src_w = src_width * scale
    src_h = src_height * scale
    rot_rad = np.pi * rot / 180.0

    def rot2d(pt):
        sn, cs = np.sin(rot_rad), np.cos(rot_rad)
        return np.array([pt[0] * cs - pt[1] * sn, pt[0] * sn + pt[1] * cs],
                        np.float64)

    src = np.zeros((3, 2), np.float64)
    src[0] = [c_x, c_y]
    src[1] = src[0] + rot2d([0, src_h * 0.5])
    src[2] = src[0] + rot2d([src_w * 0.5, 0])
    dst = np.zeros((3, 2), np.float64)
    dst[0] = [dst_width * 0.5, dst_height * 0.5]
    dst[1] = dst[0] + [0, dst_height * 0.5]
    dst[2] = dst[0] + [dst_width * 0.5, 0]
    if inv:
        src, dst = dst, src
    # cv2.getAffineTransform takes float32 points and solves in double
    src = src.astype(np.float32).astype(np.float64)
    dst = dst.astype(np.float32).astype(np.float64)
    A = np.concatenate([src, np.ones((3, 1))], axis=1)
    return np.linalg.solve(A, dst).T  # (2,3)


def _axis_samples(dst_size: int, inv_scale: np.ndarray, offset: np.ndarray,
                  src_size: int, quantize: bool):
    """Source coordinates + lerp weights for one axis of the inverse map,
    in float64 on the host. Returns (lo (B,D) int64, frac (B,D) f32,
    valid_lo, valid_hi)."""
    d = np.arange(dst_size, dtype=np.float64)
    inv_scale = np.asarray(inv_scale, np.float64)
    offset = np.asarray(offset, np.float64)
    if quantize:
        # cv2.warpAffine fixed point: per-axis terms rounded to 10
        # fractional bits, a rounding delta, then shifted to 1/32 px
        v = (np.rint(offset[:, None] * 1024.0) + 16.0
             + np.rint(d[None, :] * inv_scale[:, None] * 1024.0))
        src = np.floor(v / 32.0) / 32.0
    else:
        src = d[None, :] * inv_scale[:, None] + offset[:, None]
    lo = np.floor(src)
    frac = (src - lo).astype(np.float32)
    lo_i = lo.astype(np.int64)
    valid_lo = ((lo_i >= 0) & (lo_i <= src_size - 1)).astype(np.float32)
    valid_hi = ((lo_i + 1 >= 0) & (lo_i + 1 <= src_size - 1)).astype(np.float32)
    return np.clip(lo_i, 0, src_size - 1), frac, valid_lo, valid_hi


def _gather_lerp(x: torch.Tensor, tables, dim: int) -> torch.Tensor:
    """Bilinear tap along `dim` (1 = rows, 2 = columns) of x (B,H,W,C) with
    a zero border."""
    lo, frac, vlo, vhi = (upload(t, x.device) for t in tables)
    hi = (lo + 1).clamp_max(x.shape[dim] - 1)
    shape = [x.shape[0], 1, 1, 1]
    shape[dim] = lo.shape[1]
    full = list(x.shape)
    full[dim] = lo.shape[1]

    def take(idx):
        return torch.gather(x, dim, idx.reshape(shape).expand(full))

    f = frac.reshape(shape)
    return (take(lo) * vlo.reshape(shape) * (1.0 - f)
            + take(hi) * vhi.reshape(shape) * f)


def crop_and_normalize(frames, bboxes: np.ndarray, scale: float = 1.0,
                       crop_size: int = 224, quantize: bool = False,
                       normalize: bool = True, round_uint8: bool = True,
                       device=None) -> torch.Tensor:
    """Batched square-bbox crop -> crop_size^2 -> ImageNet normalize.

    frames: (B, H, W, 3) uint8/float RGB, numpy or a tensor; bboxes: host
    (B, 4) [cx, cy, w, h]. Runs on `device` (default: the frames' device
    for a tensor, the CPU for numpy). Returns (B, crop, crop, 3) float32
    NHWC."""
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.ascontiguousarray(frames))
    if device is not None:
        frames = upload(frames, device)
    h, w = frames.shape[1:3]
    bboxes = np.asarray(bboxes, np.float64)
    # the exact forward affine per box, inverted in double as cv2 does
    minv = np.array([
        np.linalg.inv(np.vstack([gen_trans_from_patch(
            bb[0], bb[1], bb[2], bb[3], crop_size, crop_size, scale, 0),
            [0, 0, 1]])) for bb in bboxes]).reshape(-1, 3, 3)
    x_tab = _axis_samples(crop_size, minv[:, 0, 0], minv[:, 0, 2], w, quantize)
    y_tab = _axis_samples(crop_size, minv[:, 1, 1], minv[:, 1, 2], h, quantize)
    out = _gather_lerp(frames.float(), y_tab, dim=1)  # (B,c,W,3)
    out = _gather_lerp(out, x_tab, dim=2)             # (B,c,c,3)
    if round_uint8:
        # cv2.warpAffine emits uint8
        out = torch.round(out.clamp(0.0, 255.0))
    if normalize:
        mean = constant(IMAGENET_MEAN, "float32", out.device) * 255.0
        std = constant(IMAGENET_STD, "float32", out.device) * 255.0
        out = (out - mean) / std
    return out


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (...,3) -> float ImageNet-normalized (ToTensor + Normalize)."""
    mean = constant(IMAGENET_MEAN, "float32", img.device)
    std = constant(IMAGENET_STD, "float32", img.device)
    return (img.float() / 255.0 - mean) / std


def generate_patch_image(cvimg: np.ndarray, c_x, c_y, bb_width, bb_height,
                         patch_width: int, patch_height: int,
                         do_flip: bool = False, scale: float = 1.0,
                         rot: float = 0.0):
    """The reference's host crop (both branches) via cv2; returns (patch
    RGB uint8, 2x3 forward trans)."""
    import cv2

    img = np.asarray(cvimg)
    img_height, img_width = img.shape[:2]
    if do_flip:
        img = img[:, ::-1, :]
        c_x = img_width - c_x - 1
    if bb_width != bb_height:
        # letterbox via two successive warps
        s = patch_height / max(bb_height, bb_width)
        ptrans = gen_trans_from_patch(c_x, c_y, bb_width, bb_height,
                                      int(s * bb_width), int(s * bb_height),
                                      scale, rot)
        img = cv2.warpAffine(img, ptrans,
                             (int(s * bb_width), int(s * bb_height)),
                             flags=cv2.INTER_LINEAR,
                             borderMode=cv2.BORDER_CONSTANT)
        dx = patch_width / 2 - img.shape[1] / 2
        dy = patch_width / 2 - img.shape[0] / 2
        trans = np.array([[1, 0, dx], [0, 1, dy]], np.float64)
    else:
        trans = gen_trans_from_patch(c_x, c_y, bb_width, bb_height,
                                     patch_width, patch_height, scale, rot)
    patch = cv2.warpAffine(img, trans, (int(patch_width), int(patch_height)),
                           flags=cv2.INTER_LINEAR,
                           borderMode=cv2.BORDER_CONSTANT)
    return patch, trans


def get_single_image_crop_demo(image, bbox, kp_2d=None, scale: float = 1.2,
                               crop_size: int = 224):
    """One host crop + normalized array: (norm (crop,crop,3) f32 NHWC,
    raw uint8 patch, kp_2d mapped into the crop)."""
    import os

    import cv2

    if isinstance(image, str):
        if not os.path.isfile(image):
            raise FileNotFoundError(image)
        image = cv2.cvtColor(cv2.imread(image), cv2.COLOR_BGR2RGB)
    patch, trans = generate_patch_image(
        np.asarray(image), bbox[0], bbox[1], bbox[2], bbox[3], crop_size,
        crop_size, do_flip=False, scale=scale, rot=0)
    if kp_2d is not None:
        kp_2d = np.asarray(kp_2d, np.float32).copy()
        for j in range(kp_2d.shape[0]):
            kp_2d[j, :2] = trans @ np.array([kp_2d[j, 0], kp_2d[j, 1], 1.0])
    norm = normalize_image(torch.from_numpy(patch)).numpy()
    return norm, patch, kp_2d
