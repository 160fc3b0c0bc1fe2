"""Fused keypoint-attention pooling of the PARE head.

The CUDA kernel (csrc/keypoint_attention.cu) replaces the Pallas TPU
kernel gaitlab/ops/attention_pallas.py::keypoint_attention_fused. On the
card it is bound by the bytes of logits and features it must read (about
0.1 ms at B = 128 on an H100); the source note says how the design meets
that: the wrapper splits each frame's positions over several blocks and
hands the kernel its scratch (softmax statistics and partial sums). CPU
tensors take the plain version.

The public signature is gaitlab's NHWC one. The kernel reads through
strides, so the head passes its NCHW tensors as permuted views and no copy
is made.
"""

from __future__ import annotations

import torch

from gaitlab_torch.nn.layers import keypoint_attention
from gaitlab_torch.ops import _build

KERNEL_PARTS = 24  # kJ in csrc/keypoint_attention.cu
KERNEL_TILE = 32   # kTile: the positions of a split are a multiple of it
BLOCKS_PER_SM = 8  # pooling blocks in flight per SM that the split aims at


def keypoint_attention_plain(features: torch.Tensor, cam_feats: torch.Tensor,
                             heatmaps: torch.Tensor):
    """Plain PyTorch version of `keypoint_attention_fused`."""
    return (keypoint_attention(features, heatmaps),
            keypoint_attention(cam_feats, heatmaps))


def _position_strides(x: torch.Tensor, name: str) -> tuple:
    """(batch, position, channel) strides of a (B,H,W,C) tensor whose
    positions h*W + w lie on one stride (true of NHWC and of NCHW views)."""
    sb, sh, sw, sc = x.stride()
    h, w = x.shape[1:3]
    sp = sw if w > 1 else sh
    if h > 1 and sh != w * sp:
        raise ValueError(f"keypoint_attention_fused: {name} positions are not "
                         f"evenly strided (strides {x.stride()})")
    return sb, sp, sc


def keypoint_attention_fused(features: torch.Tensor, cam_feats: torch.Tensor,
                             heatmaps: torch.Tensor):
    """features (B,H,W,C1), cam_feats (B,H,W,C2), heatmaps (B,H,W,J) raw
    part logits -> (pooled features (B,J,C1), pooled cam (B,J,C2)), float32.

    On CUDA tensors this launches the kernel (or raises); on CPU tensors
    it runs `keypoint_attention_plain`."""
    args = (features, cam_feats, heatmaps)
    if all(a.device.type == "cpu" for a in args):
        return keypoint_attention_plain(*args)
    dev = features.device
    if dev.type != "cuda" or any(a.device != dev for a in args):
        raise ValueError("keypoint_attention_fused: all inputs must be on one "
                         f"CUDA device (got {[str(a.device) for a in args]})")
    if any(a.dtype != torch.float32 or a.dim() != 4 for a in args):
        raise ValueError("keypoint_attention_fused: inputs must be 4-d float32")
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        raise NotImplementedError(
            "keypoint_attention_fused: the kernel has no backward")
    b, h, w, c1 = features.shape
    c2 = cam_feats.shape[-1]
    j = heatmaps.shape[-1]
    if cam_feats.shape[:3] != (b, h, w) or heatmaps.shape[:3] != (b, h, w):
        raise ValueError("keypoint_attention_fused: shapes "
                         f"{[tuple(a.shape) for a in args]} disagree")
    if j != KERNEL_PARTS:
        raise ValueError(f"keypoint_attention_fused: the kernel is built for "
                         f"{KERNEL_PARTS} parts, got {j}")
    strides = [_position_strides(a, n) for a, n in
               zip(args, ("features", "cam_feats", "heatmaps"))]
    out1 = torch.empty((b, j, c1), device=dev, dtype=torch.float32)
    out2 = torch.empty((b, j, c2), device=dev, dtype=torch.float32)
    if b == 0:
        return out1, out2
    # split each frame's positions over enough blocks to fill the card
    hw = h * w
    tiles = -(-hw // KERNEL_TILE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split = max(1, min(tiles, -(-BLOCKS_PER_SM * sms // b)))
    split_len = -(-tiles // n_split) * KERNEL_TILE
    n_split = -(-hw // split_len)
    stats = torch.empty((b, j, 2), device=dev, dtype=torch.float32)
    partial = torch.empty((n_split, b, j, c1 + c2), device=dev,
                          dtype=torch.float32)
    lib = _build.library("keypoint_attention")
    with torch.cuda.device(dev):
        code = lib.gaitlab_keypoint_attention(
            features.data_ptr(), *strides[0], c1,
            cam_feats.data_ptr(), *strides[1], c2,
            heatmaps.data_ptr(), *strides[2],
            out1.data_ptr(), out2.data_ptr(), stats.data_ptr(),
            partial.data_ptr(), b, hw, n_split, split_len,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "keypoint_attention")
    keypoint_attention_fused.launches += 1
    return out1, out2


keypoint_attention_fused.launches = 0
