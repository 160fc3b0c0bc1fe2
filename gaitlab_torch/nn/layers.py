"""Shared NN building blocks (NCHW, inference-ready BatchNorm).

Module names follow the reference torch modules, so the reference
checkpoints' state_dict keys load as they are.
"""

from __future__ import annotations

import torch
from torch import nn

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


def keypoint_attention(features: torch.Tensor,
                       heatmaps: torch.Tensor) -> torch.Tensor:
    """Softmax attention pooling (reference keypoint_attention.py:34-56).

    features (B,H,W,C); heatmaps (B,H,W,J) raw part logits, both NHWC as in
    gaitlab. Returns (B,J,C)."""
    b, h, w, c = features.shape
    attn = torch.softmax(heatmaps.reshape(b, h * w, -1), dim=1)
    return torch.einsum("bpj,bpc->bjc", attn, features.reshape(b, h * w, c))
