"""The ViT trunk's linear layers, y = x W^T + b, in float32 accuracy on the
tensor cores.

The CUDA kernel (csrc/vit_linear.cu) takes the place of cuBLAS's FFMA
SGEMM behind `F.linear` for the four products of each HMR 2.0 ViT block
(`Attention.qkv`, `Attention.proj`, `Mlp.fc1`, `Mlp.fc2`) in a segment that
computes in full float32; it replaces no TPU kernel (gaitlab leaves these
products to XLA). It computes each product as three TF32 passes over
TF32-exact parts, x_lo.W_hi + x_hi.W_lo + x_hi.W_hi, with FP32 sums, and
is bound by its operations: 3 x 2MNK at TF32's 495 TFLOP/s, a nominal 165
TFLOP/s. `launch_plan` gives the persistent grid's geometry; `weight_lo`
keeps each weight's low part (2.52 GB beside ViT-H's 2.52 GB of weights).

The wrapper calls the custom op `gaitlab::vit_linear_f32`, whose CUDA
implementation is the kernel and whose CPU implementation is
`vit_linear_plain`, which repeats the kernel's split arithmetic; the
device of the input picks one when the op runs, in eager code and inside
a `torch.export` program alike. Its backward is plain PyTorch.
"""

from __future__ import annotations

import math
import threading
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
import torch.utils.weak

from gaitlab_torch.ops import _build

BM = 128          # kBM, kBN of csrc/vit_linear.cu: an output tile
BK = 32           # kBK: K of a stage
STAGES = 4        # kStages: stages of the TMA ring
STAGE_BYTES = 3 * BM * BK * 4  # x, W's hi and W's lo tiles
SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024
GROUP = 8         # m-tiles walked together over all n-tiles
ALIGN = 128       # N and K must be multiples of it


class VitLinearPlan(NamedTuple):
    tiles: int   # 128 x 128 output tiles
    grid: int    # persistent blocks, at most one per SM
    group: int   # m-tiles of a group of the walk
    smem: int    # dynamic shared memory per block, bytes


def launch_plan(m: int, n: int, k: int, sms: int) -> VitLinearPlan:
    """The kernel's geometry for y (m, n) = x (m, k) W^T on a card of `sms`
    SMs: one block per SM (its ring takes most of the shared memory), or
    one per tile where there are fewer tiles."""
    if m <= 0 or n % ALIGN or k % ALIGN or n <= 0 or k <= 0:
        raise ValueError(f"vit_linear: (m, n, k) = {(m, n, k)}; m must be "
                         f"positive and n and k positive multiples of "
                         f"{ALIGN}")
    tiles = math.ceil(m / BM) * (n // BM)
    return VitLinearPlan(tiles, min(tiles, sms), GROUP, SMEM_BYTES)


def tile_coords(t: int, n_m: int, n_n: int, group: int) -> tuple:
    """The kernel's walk: (m-tile, n-tile) of output tile t, in groups of
    `group` m-tiles, each walked m-fastest over all n-tiles."""
    per_group = group * n_n
    g, r = divmod(t, per_group)
    rows = min(group, n_m - g * group)
    return g * group + r % rows, r // rows


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero, bit for bit as cvt.rna.tf32.f32."""
    return ((a.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def tf32_trunc(a: torch.Tensor) -> torch.Tensor:
    """float32 values with their low 13 mantissa bits cleared: TF32 as the
    tensor cores read a float32 operand."""
    return (a.view(torch.int32) & -8192).view(torch.float32)


def split_x(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The activations' parts as the kernel splits them in registers:
    hi = tf32_rna(x), lo = tf32_rna(x - hi)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def split_w(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The weight's parts as the kernel reads them: hi = tf32_trunc(W),
    which is W as the tensor cores take it, and lo = tf32_rna(W - hi)."""
    hi = tf32_trunc(weight)
    return hi, tf32_rna(weight - hi)


_LO = torch.utils.weak.WeakTensorKeyDictionary()
_lo_lock = threading.Lock()


def weight_lo(weight: torch.Tensor) -> torch.Tensor:
    """W's low part for the kernel, split_w(W)[1], prepared once per weight
    tensor and kept while the tensor lives (a dictionary with weak keys).
    It is split again when the weight changes: an edit in place moves its
    `_version`, new data its pointer. An inference tensor keeps no version
    counter, so its part is not kept."""
    with torch.no_grad():
        if weight.is_inference():
            return split_w(weight)[1]
        key = (weight._version, weight.data_ptr(), tuple(weight.shape))
        with _lo_lock:
            kept = _LO.get(weight)
        if kept is not None and kept[0] == key:
            return kept[1]
        lo = split_w(weight)[1]
    with _lo_lock:
        _LO[weight] = (key, lo)
    return lo


def vit_linear_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version: the kernel's three passes over the split
    parts, the two small ones first, with FP32 sums."""
    x_hi, x_lo = split_x(x)
    w_hi, w_lo = split_w(weight)
    y = F.linear(x_lo, w_hi) + F.linear(x_hi, w_lo) + F.linear(x_hi, w_hi)
    return y if bias is None else y + bias


def vit_linear_f32(x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor]) -> torch.Tensor:
    """x (..., K) -> (..., N) = x W^T + b in float32.

    On a CUDA tensor this launches the kernel (or raises); on a CPU tensor
    it runs `vit_linear_plain`. Either way through the custom op
    `torch.ops.gaitlab.vit_linear_f32`."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError("vit_linear: the input must be on the CPU or on a "
                         f"CUDA device (got {x.device})")
    return torch.ops.gaitlab.vit_linear_f32(x, weight, bias)


vit_linear_f32.launches = 0
vit_linear_f32.backwards = 0


def _launch(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The op's CUDA implementation: checks, plan, one launch; counts it."""
    tensors = (x, weight) if bias is None else (x, weight, bias)
    if any(t.device != x.device or t.device.type != "cuda" for t in tensors):
        raise ValueError("vit_linear: every tensor must be on one CUDA "
                         "device (got "
                         f"{[str(t.device) for t in tensors]})")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("vit_linear: the kernel takes float32 tensors (got "
                         f"{[t.dtype for t in tensors]})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("vit_linear: the tensors must be contiguous")
    n, k = weight.shape
    if x.shape[-1] != k or (bias is not None and bias.shape != (n,)):
        raise ValueError(f"vit_linear: x {tuple(x.shape)}, weight "
                         f"{(n, k)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    m = x.numel() // k
    out = torch.empty((*x.shape[:-1], n), device=x.device,
                      dtype=torch.float32)
    if m == 0:
        return out
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("vit_linear: the tensors must be 16-byte aligned")
    dev = x.device
    plan = launch_plan(m, n, k,
                       torch.cuda.get_device_properties(dev)
                       .multi_processor_count)
    lib = _build.library("vit_linear")
    lo = weight_lo(weight)
    with torch.cuda.device(dev):
        code = lib.gaitlab_vit_linear(
            x.data_ptr(), weight.data_ptr(), lo.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), m, n,
            k, plan.tiles, plan.grid, plan.group, plan.smem,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "vit_linear")
    _build.count(vit_linear_f32)
    return out


@torch.library.custom_op("gaitlab::vit_linear_f32", mutates_args=(),
                         device_types="cuda")
def _op(x: torch.Tensor, weight: torch.Tensor,
        bias: Optional[torch.Tensor]) -> torch.Tensor:
    return _launch(x, weight, bias)


@_op.register_kernel("cpu")
def _op_cpu(x, weight, bias):
    return vit_linear_plain(x, weight, bias)


@_op.register_fake
def _op_fake(x, weight, bias):
    return x.new_empty((*x.shape[:-1], weight.shape[0]))


def _setup_backward(ctx, inputs, output):
    x, weight, bias = inputs
    ctx.save_for_backward(x, weight)
    ctx.has_bias = bias is not None


def _backward(ctx, d_y):
    """Plain PyTorch: d_x = d_y W, d_W = d_y^T x, d_b = the sum of d_y over
    rows. Counts one backward."""
    x, weight = ctx.saved_tensors
    d_x = d_y @ weight
    d_w = d_y.reshape(-1, d_y.shape[-1]).T @ x.reshape(-1, x.shape[-1])
    d_b = d_y.reshape(-1, d_y.shape[-1]).sum(0) if ctx.has_bias else None
    _build.count(vit_linear_f32, "backwards")
    return d_x, d_w, d_b


_op.register_autograd(_backward, setup_context=_setup_backward)
