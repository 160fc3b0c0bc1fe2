"""Shared NN building blocks (NCHW, inference-ready BatchNorm).

Module names follow the reference torch modules, so the reference
checkpoints' state_dict keys load as they are.
"""

from __future__ import annotations

import torch
from torch import nn

from gaitlab_torch.ops.keypoint_attention import keypoint_attention  # noqa: F401

BN_EPS = 1e-5  # torch BatchNorm2d default


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
         padding: int | None = None, bias: bool = False) -> nn.Conv2d:
    if padding is None:
        padding = (kernel - 1) // 2
    return nn.Conv2d(in_ch, out_ch, kernel, stride, padding, bias=bias)


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
        return torch.einsum("nji,oij->njo", x, self.weight[0, :, :, :, 0, 0])


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
        out = torch.einsum("...jc,jco->...jo", x, self.weight)
        return out if self.bias is None else out + self.bias
