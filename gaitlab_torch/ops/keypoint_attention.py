"""Fused keypoint-attention pooling of the PARE head.

Two CUDA kernels replace the Pallas TPU kernel gaitlab/ops/attention_pallas.py::
keypoint_attention_fused, one for each input type; on the card both are
bound by the bytes of logits and features they must read. On float32
inputs, csrc/keypoint_attention.cu (FP32 FFMA, about 0.1 ms of bytes at
B = 128 on an H100): each frame's positions are split over blocks that
keep a running softmax and write partials, which a second launch merges;
`launch_plan` sizes the split. On bf16 inputs (the head of a bf16 trunk,
the runner's trunk_dtype), csrc/keypoint_attention_bf16.cu (about 0.05
ms of bytes): TMA brings the tiles, the tensor cores take the products
(each FP32 softmax weight split exactly into three bf16 parts), and
`launch_plan_bf16` splits whole tiles over one block per SM, with the
same merge. Either way the outputs are float32, as gaitlab's wrapper
upcasts before its pallas_call; the launch hands the kernel its scratch.

The wrapper calls the custom op `gaitlab::keypoint_attention_fused`, whose
CUDA implementation is the kernel and whose CPU implementation is the plain
version, so the device of the inputs picks one when the op runs: in eager
code and inside a `torch.export` program alike (`serve.py`), where the op
is one node of the graph. Its backward is plain torch code on either
device (gaitlab's Pallas kernel has no backward either: gaitlab trains
through XLA's autodiff of the plain pooling), so a training step runs the
kernel forward and differentiates through the softmax by hand.

The public signature is gaitlab's NHWC one. The head passes its NCHW
tensors as permuted views, which both kernels read as they lie: the FP32
kernel through any even position stride, the bf16 kernel's TMA maps where
`tma_strides` allows (positions contiguous, 16-byte aligned strides). A
bf16 tensor in another layout is first copied into the head's
(`nchw_copy`), which `keypoint_attention_fused.copies_bf16` counts. The
plain version upcasts and pools.
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

# the tiles of csrc/keypoint_attention_bf16.cu
BF16_TILE = 64       # kTile: positions per tile; splits are multiples
BF16_ROWS = 64       # kRows: channels per m-block
BF16_MBLOCKS = 3     # kMB: m-blocks per block
BF16_STAGES = 4      # kStages of the TMA ring
# a stage: the m-blocks' tiles, the logits and the weights' three parts
BF16_STAGE_BYTES = 2 * BF16_TILE * (BF16_MBLOCKS * BF16_ROWS
                                    + 4 * KERNEL_PARTS)
# kSmemBytes: the ring, two barriers a stage, (m, s) per part, alignment
BF16_SMEM = BF16_STAGES * (BF16_STAGE_BYTES + 16) + 8 * KERNEL_PARTS + 1024
BF16_ALIGN = 8       # bf16 elements in 16 bytes: TMA's stride alignment


class AttentionPlan(NamedTuple):
    n_split: int     # position splits per frame
    split_len: int   # positions per split, a multiple of KERNEL_TILE
    n_chunk: int     # channel chunks of KERNEL_CHANNELS
    smem: int        # dynamic shared memory per block, bytes
    blocks_per_sm: int


def _splits(n_batch: int, tiles: int, n_chunk: int, slots: int) -> tuple:
    """(n_split, tiles per split) of `tiles` tiles a frame over `slots`
    blocks at a time: among up to MAX_SPLITS splits, the one whose blocks
    finish soonest in whole waves: waves times the tiles of one split,
    plus one tile's worth for writing partials when there are several
    splits (ties go to fewer splits, which write fewer partials)."""
    best = None
    for n in range(1, min(tiles, MAX_SPLITS) + 1):
        per_split = -(-tiles // n)
        n_real = -(-tiles // per_split)  # no empty split
        waves = -(-n_batch * n_real * n_chunk // slots)
        cost = waves * (per_split + (n_real > 1))
        if best is None or cost < best[0]:
            best = (cost, n_real, per_split)
    return best[1:]


def launch_plan(n_batch: int, hw: int, c_all: int, sms: int) -> AttentionPlan:
    """How the FP32 kernel splits `hw` positions of each of `n_batch`
    frames over blocks on a card with `sms` SMs. Registers and shared
    memory allow `blocks_per_sm` blocks on each SM; `_splits` picks the
    split."""
    smem = KERNEL_STAGES * (KERNEL_CHANNELS + KERNEL_PARTS) * KERNEL_TILE * 4
    blocks_per_sm = min(KERNEL_BLOCKS,
                        SMEM_PER_SM // (smem + SMEM_RESERVED))
    n_chunk = -(-c_all // KERNEL_CHANNELS)
    n_split, per_split = _splits(n_batch, -(-hw // KERNEL_TILE), n_chunk,
                                 blocks_per_sm * sms)
    return AttentionPlan(n_split, per_split * KERNEL_TILE, n_chunk, smem,
                         blocks_per_sm)


def launch_plan_bf16(n_batch: int, hw: int, sms: int, c1: int = 128,
                     c2: int = 64) -> AttentionPlan:
    """How the bf16 kernel splits `hw` positions of each of `n_batch`
    frames, in whole tiles of BF16_TILE, over blocks on a card with `sms`
    SMs: its ring takes most of an SM's shared memory, so one block runs
    on each, and `_splits` picks the split. A chunk holds BF16_MBLOCKS
    m-blocks of BF16_ROWS channels, the features' and then the cam's (the
    head's 128 + 64 channels are one chunk)."""
    blocks_per_sm = SMEM_PER_SM // (BF16_SMEM + SMEM_RESERVED)
    m_blocks = -(-c1 // BF16_ROWS) + -(-c2 // BF16_ROWS)
    n_chunk = -(-m_blocks // BF16_MBLOCKS)
    n_split, per_split = _splits(n_batch, -(-hw // BF16_TILE), n_chunk,
                                 blocks_per_sm * sms)
    return AttentionPlan(n_split, per_split * BF16_TILE, n_chunk, BF16_SMEM,
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
keypoint_attention_fused.copies_bf16 = 0  # bf16 calls that copied a tensor
keypoint_attention_fused.backwards = 0


def tma_strides(x: torch.Tensor):
    """(batch, channel) strides, in elements, under which the bf16 kernel's
    TMA maps read a (B,H,W,C) bf16 tensor as it lies: positions h*W + w
    contiguous, the channels' and frames' strides nested outside them, and
    those strides and the pointer 16-byte aligned, as in the head's NCHW
    views. None where the tensor must be copied first. A stride along a
    dimension of size 1 is never followed, so it gets one that TMA takes."""
    b, h, w, c = x.shape
    sb, sh, sw, sc = x.stride()
    if (w > 1 and sw != 1) or (h > 1 and sh != w):
        return None
    hw = h * w
    sc = sc if c > 1 else -(-hw // BF16_ALIGN) * BF16_ALIGN
    sb = sb if b > 1 else c * sc
    if (sc % BF16_ALIGN or sb % BF16_ALIGN or sc < hw or sb < c * sc
            or x.data_ptr() % 16):
        return None
    return sb, sc


def nchw_copy(x: torch.Tensor) -> torch.Tensor:
    """x (B,H,W,C) copied into the head's layout, NCHW with each channel's
    positions padded to a multiple of BF16_ALIGN (so that TMA's strides
    are 16-byte aligned), returned as an NHWC view. The padding is never
    read: the kernel's maps end at H*W."""
    b, h, w, c = x.shape
    hwp = -(-h * w // BF16_ALIGN) * BF16_ALIGN
    nchw = torch.empty((b, c, hwp), dtype=x.dtype, device=x.device)
    nchw = nchw[:, :, :h * w].view(b, c, h, w)
    nchw.copy_(x.permute(0, 3, 1, 2))
    return nchw.permute(0, 2, 3, 1)


def _launch(features: torch.Tensor, cam_feats: torch.Tensor,
            heatmaps: torch.Tensor):
    """The op's CUDA implementation: checks, then the kernel of the inputs'
    type; counts one launch of the wrapper (and one in `launches_bf16` on
    bf16 inputs)."""
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
    bf16 = dtype == torch.bfloat16
    out1 = torch.empty((b, j, c1), device=dev, dtype=torch.float32)
    out2 = torch.empty((b, j, c2), device=dev, dtype=torch.float32)
    if b == 0:
        return out1, out2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    (_launch_bf16 if bf16 else _launch_fp32)(args, out1, out2, sms)
    _build.count(keypoint_attention_fused)
    if bf16:
        _build.count(keypoint_attention_fused, "launches_bf16")
    return out1, out2


def _scratch(plan: AttentionPlan, out1: torch.Tensor, c_all: int):
    """The splits' (m, s) and partial sums for the merge, or None, None
    with one split."""
    if plan.n_split == 1:
        return None, None
    b, j = out1.shape[:2]
    return (torch.empty((plan.n_split, b, j, 2), device=out1.device,
                        dtype=torch.float32),
            torch.empty((plan.n_split, b, j, c_all), device=out1.device,
                        dtype=torch.float32))


def _launch_fp32(args: tuple, out1: torch.Tensor, out2: torch.Tensor,
                 sms: int) -> None:
    """csrc/keypoint_attention.cu: split, and merge where there are
    several splits."""
    features, cam_feats, heatmaps = args
    strides = [_position_strides(a, n) for a, n in
               zip(args, ("features", "cam_feats", "heatmaps"))]
    b, h, w, c1 = features.shape
    c2 = cam_feats.shape[-1]
    hw = h * w
    plan = launch_plan(b, hw, c1 + c2, sms)
    # 16-byte copies where every position stride is 1 and every other
    # stride and pointer is 16-byte aligned (the head's NCHW views)
    width = 4 if all(
        st[1] == 1 and st[0] % 4 == 0 and st[2] % 4 == 0
        and a.data_ptr() % 16 == 0 for a, st in zip(args, strides)) else 1
    ms, acc = _scratch(plan, out1, c1 + c2)
    lib = _build.library("keypoint_attention")
    dev = features.device
    with torch.cuda.device(dev):
        code = lib.gaitlab_keypoint_attention(
            features.data_ptr(), *strides[0], c1,
            cam_feats.data_ptr(), *strides[1], c2,
            heatmaps.data_ptr(), *strides[2],
            out1.data_ptr(), out2.data_ptr(),
            None if ms is None else ms.data_ptr(),
            None if acc is None else acc.data_ptr(), b, hw, plan.n_split,
            plan.split_len, plan.n_chunk, width, plan.smem,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "keypoint_attention")


def _launch_bf16(args: tuple, out1: torch.Tensor, out2: torch.Tensor,
                 sms: int) -> None:
    """csrc/keypoint_attention_bf16.cu, and the merge where there are
    several splits. A tensor TMA cannot read as it lies is copied first
    into the head's layout (one count in `copies_bf16` per call)."""
    strides = [tma_strides(a) for a in args]
    if None in strides:
        args = tuple(nchw_copy(a) if st is None else a
                     for a, st in zip(args, strides))
        strides = [tma_strides(a) for a in args]
        _build.count(keypoint_attention_fused, "copies_bf16")
    features, cam_feats, heatmaps = args
    b, h, w, c1 = features.shape
    c2 = cam_feats.shape[-1]
    hw = h * w
    plan = launch_plan_bf16(b, hw, sms, c1, c2)
    ms, acc = _scratch(plan, out1, c1 + c2)
    lib = _build.library("keypoint_attention_bf16")
    dev = features.device
    with torch.cuda.device(dev):
        code = lib.gaitlab_keypoint_attention_bf16(
            features.data_ptr(), *strides[0], c1,
            cam_feats.data_ptr(), *strides[1], c2,
            heatmaps.data_ptr(), *strides[2],
            out1.data_ptr(), out2.data_ptr(),
            None if ms is None else ms.data_ptr(),
            None if acc is None else acc.data_ptr(), b, hw, plan.n_split,
            plan.split_len, plan.n_chunk, plan.smem,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "keypoint_attention_bf16")


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
