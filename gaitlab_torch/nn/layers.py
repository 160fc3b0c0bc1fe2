"""Shared NN building blocks (NCHW, inference-ready BatchNorm), and the
pass-split products behind gaitlab's precision modes.

Module names follow the reference torch modules, so the reference
checkpoints' state_dict keys load as they are.

gaitlab's modes are counts of bf16 passes on the TPU's matrix unit. On an
H100 a pass is a TF32 tensor-core pass: TF32 keeps 10 mantissa bits, so a
value masked to bf16's 8 significant bits (`bf16_hi`) is exact in it, and
gaitlab's split products carry over one TF32 pass for each bf16 pass, with
FP32 sums:

  mode       a product x.k as                           TF32 switches
  "float32"  one FP32 product                           off
  "high"     x_hi.k_hi + x_hi.k_lo + x_lo.k_hi          on
  "default"  one TF32 pass (x and k rounded to TF32)    on
  "w2x"      x.k_hi + x.k_lo (x rounded once)           on
  "a2x"      x_hi.k + x_lo.k (k rounded once)           on

with a_hi = bf16_hi(a), a_lo = bf16_hi(a - a_hi). A region's mode is set
by `precision_scope(mode)`: the TF32 gate (device.math_mode) for the
switches, and `conv_mode` for the splits, which `Conv2d` and `Linear`
read when they are called (their parameters keep nn.Conv2d's and
nn.Linear's names, so weight conversion and checkpoint loading do not
change). As in gaitlab, w2x and a2x apply to convolutions without a bias
only. Each pass is its own FP32-output convolution or matmul: a bf16
cuDNN convolution would round each pass to bf16 and lose the low pass.
On tensors in bf16 (gaitlab's trunk_dtype) every mode is one product:
both operands are exact in bf16 already, so the splits' low parts are
zero. On the CPU there is no TF32: every mode computes in FP32, and the
masks and sums run as on the card.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F
from torch import nn

from gaitlab_torch.device import constant, held_math_mode, math_mode
from gaitlab_torch.ops.keypoint_attention import keypoint_attention  # noqa: F401

BN_EPS = 1e-5  # torch BatchNorm2d default
MODES = ("float32", "high", "default", "w2x", "a2x")

_CONV_MODE: contextvars.ContextVar = contextvars.ContextVar(
    "gaitlab_torch_conv_mode", default=None)


def check_mode(mode: str) -> str:
    """`mode` if it is one of MODES, else ValueError."""
    if mode not in MODES:
        raise ValueError(f"precision mode {mode!r}: use one of {MODES}")
    return mode


def conv_mode(mode):
    """A context in which the `Conv2d` and `Linear` layers called by this
    thread compute their products as `mode` says (module docstring); None
    or "float32" is one product. The TF32 switches are precision_scope's."""
    if mode is not None:
        check_mode(mode)

    @contextlib.contextmanager
    def _ctx():
        tok = _CONV_MODE.set(mode)
        try:
            yield
        finally:
            _CONV_MODE.reset(tok)

    return _ctx()


@contextlib.contextmanager
def precision_scope(mode: str):
    """One segment at `mode`: the TF32 gate on for every mode but
    "float32", and the convolutions' and linears' splits."""
    with conv_mode(check_mode(mode)), math_mode(mode != "float32"):
        yield


def bf16_hi(a: torch.Tensor) -> torch.Tensor:
    """The bf16-representable high part of float32 values: the low 16
    mantissa bits masked off (truncation toward zero), bit for bit as
    gaitlab's layers._bf16_hi."""
    return (a.view(torch.int32) & -65536).view(torch.float32)


def _split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = bf16_hi(a)
    return hi, bf16_hi(a - hi)


def _passes(op, x: torch.Tensor, k: torch.Tensor, mode) -> torch.Tensor:
    """op(x, k) as `mode`'s passes, in float32 (module docstring)."""
    if mode == "high":
        x_hi, x_lo = _split(x)
        k_hi, k_lo = _split(k)
        return op(x_hi, k_hi) + op(x_hi, k_lo) + op(x_lo, k_hi)
    if mode == "w2x":
        k_hi, k_lo = _split(k)
        return op(x, k_hi) + op(x, k_lo)
    if mode == "a2x":
        x_hi, x_lo = _split(x)
        return op(x_hi, k) + op(x_lo, k)
    return op(x, k)


def _f32_product(op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """op(a, b), a bilinear product, at full float32 whatever the thread's
    TF32 switches: on the card inside a TF32 segment three TF32 passes
    over TF32-exact parts (a_hi a 10-bit-mantissa mask, a_lo = a - a_hi;
    the a_lo.b_lo pass is dropped), which keeps about 21 bits; elsewhere
    one product."""
    if not (held_math_mode() and a.is_cuda and a.dtype == torch.float32):
        return op(a, b)

    def hi(t):
        return (t.view(torch.int32) & -8192).view(torch.float32)

    a_hi, b_hi = hi(a), hi(b)
    return op(a_hi, b_hi) + op(a_hi, b - b_hi) + op(a - a_hi, b_hi)


def conv_at(x: torch.Tensor, weight: torch.Tensor, padding, mode: str
            ) -> torch.Tensor:
    """A stride-1 convolution at one of gaitlab's matmul precisions
    ("float32", "high" or "default"), whatever split the thread's
    `conv_mode` asks for: gaitlab's packed convolutions (`packed_basic_
    block`, hrnet.stem_conv_s2d) call conv_general_dilated themselves, so
    a region's precision reaches them and its w2x/a2x split does not."""
    def op(a, k):
        return F.conv2d(a, k, None, 1, padding)

    dt = torch.promote_types(x.dtype, weight.dtype)
    x, weight = x.to(dt), weight.to(dt)
    if dt != torch.float32:
        return op(x, weight)
    if mode == "high":
        return _passes(op, x, weight, "high")
    if mode == "float32":
        return _f32_product(op, x, weight)
    return op(x, weight)


def conv_w2x(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
             padding: int | None = None) -> torch.Tensor:
    """Two-pass kernel-split convolution (gaitlab's layers.conv_w2x, NCHW
    and an OIHW weight): conv(x, k_hi) + conv(x, k_lo)."""
    return _conv_passes(x, weight, stride, padding, "w2x")


def conv_a2x(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
             padding: int | None = None) -> torch.Tensor:
    """conv_w2x's mirror, the activation split: conv(x_hi, k) +
    conv(x_lo, k)."""
    return _conv_passes(x, weight, stride, padding, "a2x")


def _conv_passes(x, weight, stride, padding, mode):
    if padding is None:
        padding = (weight.shape[-1] - 1) // 2
    return _passes(lambda a, k: F.conv2d(a, k, None, stride, padding),
                   x.float(), weight.float(), mode)


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose product follows the thread's `conv_mode`. An input
    whose dtype is not the weight's (a bf16-stored activation under
    `act_store`) meets it in the wider of the two, as Flax promotes mixed
    operands: a bf16 value is exact in float32, so a bf16 activation
    against float32 weights at w2x gives gaitlab's conv_w2x bf16 path,
    x.k_hi + x.k_lo with exact products and FP32 sums, in float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        if x.dtype != w.dtype:
            dt = torch.promote_types(x.dtype, w.dtype)
            x, w = x.to(dt), w.to(dt)
            b = None if b is None else b.to(dt)
        mode = _CONV_MODE.get()
        if (mode in ("high", "w2x", "a2x") and x.dtype == torch.float32
                and not (mode != "high" and b is not None)):
            y = _passes(lambda a, k: self._conv_forward(a, k, None), x, w,
                        mode)
            return y if b is None else y + b[:, None, None]
        return self._conv_forward(x, w, b)


class Linear(nn.Linear):
    """nn.Linear whose product follows the thread's `conv_mode` ("high"
    splits; gaitlab's w2x and a2x are for convolutions)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _CONV_MODE.get() == "high" and x.dtype == torch.float32:
            y = _passes(F.linear, x, self.weight, "high")
            return y if self.bias is None else y + self.bias
        return super().forward(x)


def einsum_passes(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An einsum whose product follows the thread's `conv_mode`, as
    `Linear` does."""
    if _CONV_MODE.get() == "high" and a.dtype == torch.float32:
        return _passes(lambda x, k: torch.einsum(eq, x, k), a, b, "high")
    return torch.einsum(eq, a, b)


def einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An einsum gaitlab pins at HIGHEST (full float32) whatever the
    segment's mode. On the card inside a TF32 segment it runs as three
    TF32 passes over TF32-exact parts (a_hi a 10-bit-mantissa mask, a_lo =
    a - a_hi; the a_lo.b_lo pass is dropped), which keeps about 21 bits;
    elsewhere it is one product."""
    return _f32_product(lambda x, k: torch.einsum(eq, x, k), a, b)


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
         padding: int | None = None, bias: bool = False) -> Conv2d:
    if padding is None:
        padding = (kernel - 1) // 2
    return Conv2d(in_ch, out_ch, kernel, stride, padding, bias=bias)


def batch_norm(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS)


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """NCHW nearest-neighbour upsampling by an integer `scale`."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def upsample_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int
                                    ) -> torch.Tensor:
    """NCHW bilinear resize to (out_h, out_w) with align_corners=True, up or
    down. gaitlab computes it as two interpolation matmuls; ATen's kernel
    takes the same two-tap lerps in FP32, with no matmul to set a
    precision for."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def bf16_store(x: torch.Tensor) -> torch.Tensor:
    """Activations stored as bfloat16, rounded to nearest even (gaitlab's
    bf16_store on finite values; torch keeps a NaN a NaN, where gaitlab's
    integer rounding can carry a NaN's mantissa into the sign bit)."""
    return x.to(torch.bfloat16)


# Space-to-depth packing: a stride-1 3x3 convolution on an (N, C, H, W)
# grid is the same set of products as a 3x3 convolution on the (N, 4C,
# H/2, W/2) grid of 2x2 pixel phases, with a zero-structured (4K, 4C, 3,
# 3) kernel; every nonzero multiply-add is one of the original ones, and
# one pixel of zero padding on the packed grid reproduces the original
# padding exactly. gaitlab packs HRNet's 32-channel branches so for the
# TPU's 128-lane matrix unit; on the card it is one more layout to time.

def space_to_depth(x: torch.Tensor, f: int = 2) -> torch.Tensor:
    """(N, C, H, W) -> (N, f*f*C, H/f, W/f), gaitlab's phase-major channel
    order: pixel (f*i + qy, f*j + qx) channel c lands on channel
    (qy*f + qx)*C + c."""
    n, c, h, w = x.shape
    if h % f or w % f:
        raise ValueError(f"space_to_depth: H={h}, W={w} not multiples of {f}")
    x = x.reshape(n, c, h // f, f, w // f, f).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, f * f * c, h // f, w // f)


def depth_to_space(x: torch.Tensor, f: int = 2) -> torch.Tensor:
    """The inverse of space_to_depth."""
    n, cc, h, w = x.shape
    c = cc // (f * f)
    x = x.reshape(n, f, f, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c, h * f, w * f)


def _packed_taps() -> tuple:
    """For (output phase p = py*2+px, input phase q = qy*2+qx, packed tap
    di+1, dj+1), flattened in that order: the original tap (dy+1)*3 + dx+1
    it carries, with dy = 2*di + qy - py (and likewise dx), or 9 (a zero)
    where |dy| or |dx| exceeds 1."""
    taps = []
    for py in (0, 1):
        for px in (0, 1):
            for qy in (0, 1):
                for qx in (0, 1):
                    for di in (-1, 0, 1):
                        for dj in (-1, 0, 1):
                            dy, dx = 2 * di + qy - py, 2 * dj + qx - px
                            taps.append((dy + 1) * 3 + dx + 1
                                        if abs(dy) <= 1 and abs(dx) <= 1
                                        else 9)
    return tuple(taps)


_PACKED_TAPS = _packed_taps()


def packed_conv3x3_kernel(w: torch.Tensor) -> torch.Tensor:
    """A stride-1, pad-1 3x3 kernel (K, C, 3, 3) -> its space-to-depth
    form (4K, 4C, 3, 3), pad 1 on the packed grid too (gaitlab's
    packed_conv3x3_kernel in OIHW): one gather from the kernel's taps and a
    zero."""
    k, c = w.shape[:2]
    taps = torch.cat([w.reshape(k, c, 9), w.new_zeros(k, c, 1)], dim=2)
    g = taps[:, :, constant(_PACKED_TAPS, "int64", w.device)]
    return (g.reshape(k, c, 4, 4, 3, 3).permute(2, 0, 3, 1, 4, 5)
            .reshape(4 * k, 4 * c, 3, 3))


def packed_basic_block(block: nn.Module, x: torch.Tensor,
                       mode: str = "float32") -> torch.Tensor:
    """gaitlab's PackedBasicBlock: an HRNet BasicBlock (stride 1, no
    projection) on space_to_depth's grid, through the block's own
    conv1/bn1/conv2/bn2, inference only. It has no parameters of its own:
    the packed kernels and the BatchNorms' running statistics and affine
    terms tiled 4x are built from the block's at each call. Its
    convolutions run at `mode` (conv_at)."""
    if block.downsample is not None:
        raise ValueError("packed_basic_block: a block with a projection")

    def bn(z, m):
        return F.batch_norm(z, m.running_mean.repeat(4),
                            m.running_var.repeat(4), m.weight.repeat(4),
                            m.bias.repeat(4), False, 0.0, m.eps)

    out = conv_at(x, packed_conv3x3_kernel(block.conv1.weight), 1, mode)
    out = F.relu(bn(out, block.bn1))
    out = bn(conv_at(out, packed_conv3x3_kernel(block.conv2.weight), 1,
                     mode), block.bn2)
    return F.relu(out + x)


_STANDARD_ONLY: contextvars.ContextVar = contextvars.ContextVar(
    "gaitlab_torch_standard_only", default=False)


@contextlib.contextmanager
def standard_blocks():
    """A context in which the backbone runs its standard blocks, never the
    packed or space-to-depth ones, as gaitlab's train-mode passes do. BN
    calibration (training._calibrate) reads each BatchNorm2d's input in a
    hook, which a packed block, applying its BatchNorms' terms itself,
    would never fire."""
    tok = _STANDARD_ONLY.set(True)
    try:
        yield
    finally:
        _STANDARD_ONLY.reset(tok)


def packing_allowed(module: nn.Module) -> bool:
    """Whether `module` may take its packed or space-to-depth form:
    gaitlab's inference-only rule (not in train mode), and not inside
    standard_blocks()."""
    return not (module.training or _STANDARD_ONLY.get())


class LocallyConnected2d(nn.Module):
    """Per-token unshared 1x1 'conv' (reference LocallyConnected2d with
    output_size (J, 1) and kernel 1): (N, J, C_in) -> (N, J, C_out).

    The weight keeps the reference layout (1, C_out, C_in, J, 1, 1)."""

    def __init__(self, in_channels: int, out_channels: int, num_tokens: int):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn(1, out_channels, in_channels, num_tokens, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return einsum_f32("nji,oij->njo", x, self.weight[0, :, :, :, 0, 0])


class LocallyConnected(nn.Module):
    """Per-token unshared linear map on token-major features (gaitlab's
    LocallyConnected): (..., J, C_in) -> (..., J, C_out).

    The weight keeps gaitlab's layout (J, C_in, C_out), the bias (J, C_out):
    no reference checkpoint carries these layers (they belong to the gait
    branch), so the layout is the one the converter reads."""

    def __init__(self, num_tokens: int, in_features: int, out_features: int,
                 bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn(num_tokens, in_features, out_features))
        self.bias = (nn.Parameter(torch.randn(num_tokens, out_features))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = einsum_f32("...jc,jco->...jo", x, self.weight)
        return out if self.bias is None else out + self.bias
