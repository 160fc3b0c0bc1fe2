"""A clip's square bbox from its OpenPose joints, through the exact
1-medoid of the joints.

Counterpart of gaitlab/pipeline/medoids.py. For one cluster the medoid is
argmin_i sum_j ||p_i - p_j||: an O(N^2) reduction, run here as torch code
on the card (or on `device`), in chunks of columns so that the distance
matrix of a long clip (10,000 joints at MAX_seqlen = 400 frames) never
exists whole.

The reference's quirks, kept:
  * the distance runs over (x, y, confidence) triples: the confidence
    column takes part;
  * low-confidence joints are replaced by each frame's most confident
    joint before the medoid;
  * the side is 1.1 x the median height, upscaled by BS below MIN_PIXEL.
"""

from __future__ import annotations

import numpy as np
import torch

from gaitlab_torch.device import resolve_device, upload

IMG_W = 1920  # the clinic's camera frame
IMG_H = 1080
MIN_PIXEL = 500
BS = 1.8
N_JOINTS = 25


def medoid_1(points, chunk: int = 1024, device=None) -> int:
    """Index of the exact 1-medoid of (N, D) points: the least sum of
    euclidean distances to all points, in float32, the first index on a
    tie. Runs on `device` (None is the card).

    Each distance is sqrt(max(sum_d (p_i - p_j)^2, 0)), the difference
    form: the matmul form |p|^2 + |q|^2 - 2 p.q (torch.cdist's default for
    large inputs) cancels for nearby points and can reorder near-tied
    sums. Columns are taken `chunk` at a time; the last chunk is a shorter
    slice, so no padded point exists to mask."""
    device = resolve_device(device)
    pts = upload(np.asarray(points, np.float32), device)
    n, dims = pts.shape
    sums = torch.zeros(n, dtype=torch.float32, device=device)
    for s in range(0, n, chunk):
        blk = pts[s:s + chunk]
        sq = torch.zeros((n, len(blk)), dtype=torch.float32, device=device)
        for d in range(dims):
            sq += (pts[:, d, None] - blk[None, :, d]).square()
        sums += sq.clamp_min_(0.0).sqrt_().sum(dim=1)
    return int(torch.argmin(sums))


def get_bbox_from_joints2d(kp_2d: np.ndarray, smooth: bool = False,
                           threshold: float = 0.1, device=None) -> np.ndarray:
    """(seqlen, 25, 3) OpenPose joints in pixels -> (seqlen, 4) constant
    square bbox [cx, cy, side, side]; the medoid runs on `device` (None is
    the card)."""
    kp_2d = np.array(kp_2d, np.float32)
    if kp_2d.ndim != 3 or kp_2d.shape[1:] != (N_JOINTS, 3):
        raise ValueError(f"joints must be (seqlen, {N_JOINTS}, 3), got "
                         f"{kp_2d.shape}")
    seqlen = kp_2d.shape[0]

    # low-confidence joints take each frame's most confident joint
    invalid = kp_2d[:, :, 2] < threshold
    best = np.argmax(kp_2d[:, :, 2], axis=-1)
    ref = kp_2d[np.arange(seqlen)[:, None],
                np.broadcast_to(best[:, None], (seqlen, N_JOINTS))]
    kp_2d[invalid] = ref[invalid]

    ul = np.array([kp_2d[:, :, 0].min(axis=1), kp_2d[:, :, 1].min(axis=1)])
    lr = np.array([kp_2d[:, :, 0].max(axis=1), kp_2d[:, :, 1].max(axis=1)])
    ul[1] -= (lr[1] - ul[1]) * 0.10  # keep the head inside
    h = lr[1] - ul[1]

    kp = kp_2d.reshape(-1, 3)
    c_xy = kp[medoid_1(kp, device=device), :2]

    nh = np.median(h, keepdims=True)
    nw = nh = nh * 1.1  # square
    if nw < MIN_PIXEL:
        nw = nh = nh * BS
    bbox = np.repeat(np.hstack([c_xy, nw, nh])[None, :], seqlen, axis=0)
    if smooth:
        from gaitlab_torch.core.filters import smooth_bbox_params

        bbox = smooth_bbox_params(bbox)
    return bbox
