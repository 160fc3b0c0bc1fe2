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

from gaitlab_torch.device import held_math_mode, math_mode
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
    """nn.Conv2d whose product follows the thread's `conv_mode`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mode = _CONV_MODE.get()
        if (mode in ("high", "w2x", "a2x") and x.dtype == torch.float32
                and not (mode != "high" and self.bias is not None)):
            y = _passes(lambda a, k: self._conv_forward(a, k, None), x,
                        self.weight, mode)
            return y if self.bias is None else y + self.bias[:, None, None]
        return super().forward(x)


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
    if not (held_math_mode() and a.is_cuda and a.dtype == torch.float32):
        return torch.einsum(eq, a, b)

    def hi(t):
        return (t.view(torch.int32) & -8192).view(torch.float32)

    a_hi, b_hi = hi(a), hi(b)
    return (torch.einsum(eq, a_hi, b_hi) + torch.einsum(eq, a_hi, b - b_hi)
            + torch.einsum(eq, a - a_hi, b_hi))


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
         padding: int | None = None, bias: bool = False) -> Conv2d:
    if padding is None:
        padding = (kernel - 1) // 2
    return Conv2d(in_ch, out_ch, kernel, stride, padding, bias=bias)


def batch_norm(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS)


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
