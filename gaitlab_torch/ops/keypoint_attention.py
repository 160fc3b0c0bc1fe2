"""Fused keypoint-attention pooling of the PARE head.

The CUDA kernel (csrc/keypoint_attention.cu) replaces the Pallas TPU
kernel gaitlab/ops/attention_pallas.py::keypoint_attention_fused. On the
card it is bound by the bytes of logits and features it must read (about
0.1 ms at B = 128 on an H100); the source note says how the design meets
that: each frame's positions are split over blocks that keep a running
softmax and write partials, which a second launch merges. `launch_plan`
sizes the split; the launch hands the kernel its scratch.

The wrapper calls the custom op `gaitlab::keypoint_attention_fused`, whose
CUDA implementation is the kernel and whose CPU implementation is the plain
version, so the device of the inputs picks one when the op runs: in eager
code and inside a `torch.export` program alike (`serve.py`), where the op
is one node of the graph. Its backward is plain torch code on either
device (gaitlab's Pallas kernel has no backward either: gaitlab trains
through XLA's autodiff of the plain pooling), so a training step runs the
kernel forward and differentiates through the softmax by hand.

The public signature is gaitlab's NHWC one. The kernel reads through
strides, so the head passes its NCHW tensors as permuted views and no copy
is made. The inputs are all float32 or all bf16 (the head of a bf16 trunk,
the runner's trunk_dtype): the kernel then reads bf16 and converts in
registers, and either way the outputs are float32, as gaitlab's wrapper
upcasts before its pallas_call. The plain version upcasts and pools.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaitlab_torch.ops import _build

# the tiles of csrc/keypoint_attention.cu
KERNEL_PARTS = 24      # kJ
KERNEL_TILE = 32       # kTile: positions per stage; splits are multiples
KERNEL_STAGES = 2      # kStages of the cp.async ring
KERNEL_CHANNELS = 192  # kChanTile: channels per block
KERNEL_BLOCKS = 4      # kMinBlocks: blocks per SM its registers allow
MAX_SPLITS = 16
# shared memory of an H100 SM, and what the card keeps back per block
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED = 1024
MAX_SMEM = 227 * 1024  # dynamic shared memory a block may have


class AttentionPlan(NamedTuple):
    n_split: int     # position splits per frame
    split_len: int   # positions per split, a multiple of KERNEL_TILE
    n_chunk: int     # channel chunks of KERNEL_CHANNELS
    smem: int        # dynamic shared memory per block, bytes
    blocks_per_sm: int


def launch_plan(n_batch: int, hw: int, c_all: int, sms: int) -> AttentionPlan:
    """How the kernel splits `hw` positions of each of `n_batch` frames
    over blocks on a card with `sms` SMs.

    Registers and shared memory allow `blocks_per_sm` blocks on each SM.
    Among up to MAX_SPLITS splits the plan takes the one whose blocks
    finish soonest in whole waves: waves times the tiles of one split,
    plus one tile's worth for writing partials when there are several
    splits (ties go to fewer splits, which write fewer partials)."""
    smem = KERNEL_STAGES * (KERNEL_CHANNELS + KERNEL_PARTS) * KERNEL_TILE * 4
    blocks_per_sm = min(KERNEL_BLOCKS,
                        SMEM_PER_SM // (smem + SMEM_RESERVED))
    slots = blocks_per_sm * sms
    tiles = -(-hw // KERNEL_TILE)
    n_chunk = -(-c_all // KERNEL_CHANNELS)
    best = None
    for n in range(1, min(tiles, MAX_SPLITS) + 1):
        per_split = -(-tiles // n)
        n_real = -(-tiles // per_split)  # no empty split
        waves = -(-n_batch * n_real * n_chunk // slots)
        cost = waves * (per_split + (n_real > 1))
        if best is None or cost < best[0]:
            best = (cost, n_real, per_split)
    _, n_split, per_split = best
    return AttentionPlan(n_split, per_split * KERNEL_TILE, n_chunk, smem,
                         blocks_per_sm)


def keypoint_attention(features: torch.Tensor,
                       heatmaps: torch.Tensor) -> torch.Tensor:
    """Softmax attention pooling (reference keypoint_attention.py:34-56).

    features (B,H,W,C); heatmaps (B,H,W,J) raw part logits, both NHWC as in
    gaitlab. Returns (B,J,C)."""
    b, h, w, c = features.shape
    attn = torch.softmax(heatmaps.reshape(b, h * w, -1), dim=1)
    return torch.einsum("bpj,bpc->bjc", attn, features.reshape(b, h * w, c))


def keypoint_attention_plain(features: torch.Tensor, cam_feats: torch.Tensor,
                             heatmaps: torch.Tensor):
    """Plain PyTorch version of `keypoint_attention_fused`; bf16 inputs
    are upcast to float32 first (float64 ones stay float64)."""
    features, cam_feats, heatmaps = (
        a if a.dtype in (torch.float32, torch.float64) else a.float()
        for a in (features, cam_feats, heatmaps))
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
    part logits, all float32 or all bf16 -> (pooled features (B,J,C1),
    pooled cam (B,J,C2)), float32.

    On CUDA tensors this launches the kernel (or raises); on CPU tensors
    it runs `keypoint_attention_plain`. Either way through the custom op
    `torch.ops.gaitlab.keypoint_attention_fused`."""
    args = (features, cam_feats, heatmaps)
    if not all(a.device.type == "cpu" for a in args):
        dev = features.device
        if dev.type != "cuda" or any(a.device != dev for a in args):
            raise ValueError("keypoint_attention_fused: all inputs must be on "
                             "one CUDA device (got "
                             f"{[str(a.device) for a in args]})")
    return torch.ops.gaitlab.keypoint_attention_fused(*args)


keypoint_attention_fused.launches = 0
keypoint_attention_fused.launches_bf16 = 0  # those of them on bf16 inputs
keypoint_attention_fused.backwards = 0


def _launch(features: torch.Tensor, cam_feats: torch.Tensor,
            heatmaps: torch.Tensor):
    """The op's CUDA implementation: checks, scratch, the kernel's two
    launches (split, and merge where there are several splits); counts one
    launch of the wrapper (and one in `launches_bf16` on bf16 inputs)."""
    args = (features, cam_feats, heatmaps)
    dev = features.device
    if dev.type != "cuda" or any(a.device != dev for a in args):
        raise ValueError("keypoint_attention_fused: all inputs must be on one "
                         f"CUDA device (got {[str(a.device) for a in args]})")
    dtype = features.dtype
    if (dtype not in (torch.float32, torch.bfloat16)
            or any(a.dtype != dtype or a.dim() != 4 for a in args)):
        raise ValueError("keypoint_attention_fused: inputs must be 4-d, all "
                         "float32 or all bfloat16 (got "
                         f"{[a.dtype for a in args]})")
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
    hw = h * w
    plan = launch_plan(b, hw, c1 + c2, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    # 16-byte copies where every position stride is 1 and every other
    # stride and pointer is 16-byte aligned (the head's NCHW views)
    bf16 = dtype == torch.bfloat16
    vec = 8 if bf16 else 4  # elements in 16 bytes
    width = vec if all(
        st[1] == 1 and st[0] % vec == 0 and st[2] % vec == 0
        and a.data_ptr() % 16 == 0 for a, st in zip(args, strides)) else 1
    ms = acc = None
    if plan.n_split > 1:
        ms = torch.empty((plan.n_split, b, j, 2), device=dev,
                         dtype=torch.float32)
        acc = torch.empty((plan.n_split, b, j, c1 + c2), device=dev,
                          dtype=torch.float32)
    lib = _build.library("keypoint_attention")
    with torch.cuda.device(dev):
        code = lib.gaitlab_keypoint_attention(
            features.data_ptr(), *strides[0], c1,
            cam_feats.data_ptr(), *strides[1], c2,
            heatmaps.data_ptr(), *strides[2],
            out1.data_ptr(), out2.data_ptr(),
            None if ms is None else ms.data_ptr(),
            None if acc is None else acc.data_ptr(), b, hw, plan.n_split,
            plan.split_len, plan.n_chunk, width, int(bf16), plan.smem,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "keypoint_attention")
    _build.count(keypoint_attention_fused)
    if bf16:
        _build.count(keypoint_attention_fused, "launches_bf16")
    return out1, out2


@torch.library.custom_op("gaitlab::keypoint_attention_fused", mutates_args=(),
                         device_types="cuda")
def _op(features: torch.Tensor, cam_feats: torch.Tensor,
        heatmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _launch(features, cam_feats, heatmaps)


@_op.register_kernel("cpu")
def _op_cpu(features, cam_feats, heatmaps):
    return keypoint_attention_plain(features, cam_feats, heatmaps)


@_op.register_fake
def _op_fake(features, cam_feats, heatmaps):
    b, j = features.shape[0], heatmaps.shape[-1]
    return (features.new_empty((b, j, features.shape[-1]),
                               dtype=torch.float32),
            features.new_empty((b, j, cam_feats.shape[-1]),
                               dtype=torch.float32))


def _setup_backward(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, d_out1, d_out2):
    """Gradients of both poolings: with attn = softmax over H*W of the
    logits, d_features = attn^T d_out1, d_cam = attn^T d_out2, and the
    logits get attn * (d_attn - sum_hw attn * d_attn) with d_attn =
    d_out1 features^T + d_out2 cam^T. Each comes back in its input's
    (B,H,W,C) shape and dtype (bf16 inputs' in float32); counts one
    backward."""
    saved = ctx.saved_tensors
    features, cam_feats, heatmaps = (
        a if a.dtype in (torch.float32, torch.float64) else a.float()
        for a in saved)
    b, h, w, _ = features.shape
    hw = h * w
    attn = torch.softmax(heatmaps.reshape(b, hw, -1), dim=1)  # (B,HW,J)
    grads = [None, None, None]
    d_attn = 0
    for i, (x, d) in enumerate(((features, d_out1), (cam_feats, d_out2))):
        if ctx.needs_input_grad[i]:
            grads[i] = torch.bmm(attn, d).reshape(x.shape)
        if ctx.needs_input_grad[2]:
            d_attn = d_attn + torch.bmm(x.reshape(b, hw, -1), d.transpose(1, 2))
    if ctx.needs_input_grad[2]:
        grads[2] = (attn * (d_attn - (attn * d_attn).sum(1, keepdim=True))
                    ).reshape(heatmaps.shape)
    _build.count(keypoint_attention_fused, "backwards")
    return tuple(None if g is None else g.to(a.dtype)
                 for g, a in zip(grads, saved))


_op.register_autograd(_backward, setup_context=_setup_backward)
