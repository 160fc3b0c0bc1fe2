"""Training-data helpers on the host: windows over the frames of
batch_generation's shards, and augmentation.

Counterpart of gaitlab/pipeline/data.py: sliding-window chunking of each
video's frames in a flat frame index, random crop-scale and colour-scale
parameters, colour scaling and occlusion masking. Randomness comes from
the generator the caller passes (the module's global one otherwise).
"""

from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np


def split_into_chunks(vid_names: np.ndarray, seqlen: int, stride: int):
    """Windows of `seqlen` consecutive frames of one video each, every
    `stride` frames, over a flat per-frame `vid_names`. Returns
    [(first index, last index (inclusive)), ...]."""
    vid_names = np.asarray(vid_names)
    video_start_end_indices = []
    video_names, group = np.unique(vid_names, return_index=True)
    perm = np.argsort(group)
    video_names, group = video_names[perm], group[perm]
    indices = np.split(np.arange(0, vid_names.shape[0]), group[1:])
    for idx in range(len(video_names)):
        indexes = indices[idx]
        if indexes.shape[0] < seqlen:
            continue
        n_windows = indexes.shape[0] - seqlen + 1
        starts = np.arange(0, n_windows, stride)
        chunks = np.stack([indexes[s:s + seqlen] for s in starts])
        video_start_end_indices += chunks[:, (0, -1)].tolist()
    return video_start_end_indices


def do_augmentation(scale_factor: float = 0.3, color_factor: float = 0.2,
                    rng: Optional[random.Random] = None):
    """(crop scale in [1.2, 1.2 + scale_factor], rotation 0, no flip,
    three per-channel colour scales in 1 -/+ color_factor)."""
    r = rng or random
    scale = r.uniform(1.2, 1.2 + scale_factor)
    rot = 0
    do_flip = False
    c_up = 1.0 + color_factor
    c_low = 1.0 - color_factor
    color_scale = [r.uniform(c_low, c_up) for _ in range(3)]
    return scale, rot, do_flip, color_scale


def color_jitter(image: np.ndarray,
                 color_scale: Sequence[float]) -> np.ndarray:
    """Per-channel multiplicative colour scaling, clipped to [0, 255]."""
    img = image.astype(np.float32) * np.asarray(color_scale, np.float32)
    return np.clip(img, 0, 255).astype(image.dtype)


def get_image_masked(image: np.ndarray, bbox, ratio=(0.6, 0.3),
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Occlusion: a copy of `image` with a random ratio-sized rectangle of
    the person's bbox [cx, cy, w, h] set to 0."""
    g = rng or np.random.default_rng()
    img = image.copy()
    cx, cy, w, h = [float(v) for v in bbox]
    mw, mh = w * ratio[0], h * ratio[1]
    x0 = int(np.clip(cx - w / 2 + g.uniform(0, w - mw), 0, img.shape[1] - 1))
    y0 = int(np.clip(cy - h / 2 + g.uniform(0, h - mh), 0, img.shape[0] - 1))
    x1 = int(np.clip(x0 + mw, 0, img.shape[1]))
    y1 = int(np.clip(y0 + mh, 0, img.shape[0]))
    img[y0:y1, x0:x1] = 0
    return img
