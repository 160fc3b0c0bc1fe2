"""Headless ResNet feature extractors (NCHW).

Counterpart of gaitlab/nn/resnet.py: the standard stem and four stages,
then a global average pool to the feature vector (the classifier head is
removed). The blocks are HRNet's (nn/hrnet.py), with the stride on the
first 3x3 conv of a stage; attribute names give torchvision's state_dict
keys (conv1, bn1, layer1.0.conv1, layer2.0.downsample.0, ...), which
gaitlab's Flax names map to through weights.convert.
"""

from __future__ import annotations

from typing import Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from gaitlab_torch.nn.hrnet import BasicBlock, Bottleneck
from gaitlab_torch.nn.layers import batch_norm, conv


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(kernel_size=3, stride=2, padding=1), NCHW."""
    return F.max_pool2d(x, 3, 2, 1)


class ResNet(nn.Module):
    """ResNet trunk: (N,3,H,W) -> (N, 512*expansion) pooled features."""

    def __init__(self, block: Type[nn.Module] = Bottleneck,
                 layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2, padding=3)
        self.bn1 = batch_norm(64)
        self.relu = nn.ReLU(inplace=True)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(
                zip((64, 128, 256, 512), layers), start=1):
            stride = 1 if stage == 1 else 2
            mods = []
            for b in range(blocks):
                mods.append(block(inplanes, planes, stride if b == 0 else 1))
                inplanes = planes * block.expansion
            self.add_module(f"layer{stage}", nn.Sequential(*mods))
        self.out_features = inplanes

    def forward(self, x: torch.Tensor, return_spatial: bool = False):
        x = max_pool_3x3_s2(self.relu(self.bn1(self.conv1(x))))
        spatial = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        pooled = spatial.mean(dim=(2, 3))  # global average pool (headless)
        return (pooled, spatial) if return_spatial else pooled


def resnet18() -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2))


def resnet34() -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3))


def resnet50() -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3))


def resnet101() -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3))


def resnet152() -> ResNet:
    return ResNet(Bottleneck, (3, 8, 36, 3))
