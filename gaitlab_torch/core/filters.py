"""Temporal filters on torch tensors.

Counterpart of gaitlab/core/filters.py:
  * the one-euro filter, a per-frame recurrence: a plain loop over the
    frame axis on the tensor's device, every channel at once;
  * a 1-D median filter with scipy.signal.medfilt semantics (zero padding)
    and a gaussian filter with scipy.ndimage.gaussian_filter1d semantics
    (mode "reflect", which repeats the edge sample), used by bbox
    smoothing.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor


def _smoothing_factor(t_e, cutoff):
    r = 2.0 * math.pi * cutoff * t_e
    return r / (r + 1.0)


def one_euro(x: Tensor, t: Optional[Tensor] = None, min_cutoff: float = 1.0,
             beta: float = 0.0, d_cutoff: float = 1.0) -> Tensor:
    """One-euro filter over the leading (time) axis of `x`.

    Initialised with x_prev = x[0], dx_prev = 0, t_prev = 0, so out[0] ==
    x[0]; `t` defaults to the frame index (dt = 1 between frames).
    x: (T, ...) signal. Returns the filtered (T, ...) signal."""
    if t is None:
        t = torch.arange(x.shape[0], dtype=x.dtype, device=x.device)
    t = t.reshape((x.shape[0],) + (1,) * (x.dim() - 1)).expand(x.shape)
    x_prev = x[0]
    dx_prev = torch.zeros_like(x[0])
    t_prev = torch.zeros_like(x[0])
    out = [x[0]]
    for xi, ti in zip(x[1:], t[1:]):
        t_e = ti - t_prev
        a_d = _smoothing_factor(t_e, d_cutoff)
        dx = (xi - x_prev) / t_e
        dx_hat = a_d * dx + (1.0 - a_d) * dx_prev
        cutoff = min_cutoff + beta * torch.abs(dx_hat)
        a = _smoothing_factor(t_e, cutoff)
        x_hat = a * xi + (1.0 - a) * x_prev
        out.append(x_hat)
        x_prev, dx_prev, t_prev = x_hat, dx_hat, ti
    return torch.stack(out)


def median_filter1d(x: Tensor, kernel_size: int = 11) -> Tensor:
    """scipy.signal.medfilt semantics along axis 0 (zero padding; the
    kernel may be longer than the sequence). x: (T,) or (T, C); the kernel
    size must be odd."""
    if kernel_size % 2 == 0:
        raise ValueError("kernel_size must be odd")
    half = kernel_size // 2
    pad = x.new_zeros((half,) + tuple(x.shape[1:]))
    xp = torch.cat([pad, x, pad])
    windows = torch.stack([xp[i:i + x.shape[0]] for i in range(kernel_size)])
    return windows.median(dim=0).values


def _gaussian_kernel(sigma: float, truncate: float = 4.0) -> Tensor:
    radius = int(truncate * float(sigma) + 0.5)
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return torch.from_numpy((k / k.sum()).astype(np.float32))


def _reflect_index(n: int, radius: int) -> Tensor:
    """Indices of x padded by `radius` on both sides with numpy's
    "symmetric" rule (scipy.ndimage's "reflect": d c b a | a b c d |
    d c b a), repeated for a radius longer than the sequence.
    torch's F.pad(mode="reflect") is numpy's "reflect", which leaves the
    edge sample out, so it cannot serve here."""
    j = torch.arange(-radius, n + radius) % (2 * n)
    return torch.where(j >= n, 2 * n - 1 - j, j)


def gaussian_filter1d(x: Tensor, sigma: float = 8.0,
                      truncate: float = 4.0) -> Tensor:
    """scipy.ndimage.gaussian_filter1d semantics along axis 0 (reflect
    boundary). x: (T,) or (T, C)."""
    k = _gaussian_kernel(sigma, truncate).to(x.device)
    radius = (k.shape[0] - 1) // 2
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    n = x.shape[0]
    xp = x.float()[_reflect_index(n, radius).to(x.device)]
    out = torch.stack([xp[i:i + n] * k[i] for i in range(k.shape[0])]).sum(0)
    return out[:, 0] if squeeze else out


def smooth_bbox_params(bbox_params, kernel_size: int = 11,
                       sigma: float = 8) -> np.ndarray:
    """Median then gaussian filtering of (N, 3|4) bbox params, on the host
    (numpy in, numpy out)."""
    x = torch.from_numpy(np.asarray(bbox_params, np.float32))
    return gaussian_filter1d(median_filter1d(x, kernel_size), sigma).numpy()
