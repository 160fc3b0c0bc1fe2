"""HRNet-W32 pose backbone (NCHW) for the deployed PARE configuration.

Counterpart of gaitlab/nn/hrnet.py with the reference's module layout
(stem, Bottleneck layer1, three multi-resolution stages with fuse layers)
and its deployed head (downsample=False, use_conv=True): branches 2-4 go
through `upsample_stage_{2,3,4}` (bilinear align-corners upsampling, conv,
BN, ReLU) and are concatenated onto branch 1, giving (N, 480, 56, 56) for
a 224 crop. Attribute names and Sequential indices give the reference's
state_dict keys.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from gaitlab_torch.nn.layers import batch_norm, conv


@dataclass(frozen=True)
class StageCfg:
    num_modules: int
    num_branches: int
    num_blocks: tuple
    num_channels: tuple


@dataclass(frozen=True)
class HRNetCfg:
    width: int = 32
    stage2: StageCfg = None
    stage3: StageCfg = None
    stage4: StageCfg = None

    @staticmethod
    def w(width: int = 32, modules: tuple = (1, 4, 3),
          blocks: int = 4) -> "HRNetCfg":
        """The deployed topology is modules=(1,4,3), blocks=4; smaller
        values keep every branch, transition and fuse path (and so every
        parameter shape family) for cheap test models."""
        return HRNetCfg(
            width=width,
            stage2=StageCfg(modules[0], 2, (blocks,) * 2, (width, width * 2)),
            stage3=StageCfg(modules[1], 3, (blocks,) * 3,
                            (width, width * 2, width * 4)),
            stage4=StageCfg(modules[2], 4, (blocks,) * 4,
                            (width, width * 2, width * 4, width * 8)),
        )


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv(planes, planes, 3)
        self.bn2 = batch_norm(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (nn.Sequential(conv(inplanes, planes, 1),
                                         batch_norm(planes))
                           if inplanes != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = conv(inplanes, planes, 1)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv(planes, planes, 3)
        self.bn2 = batch_norm(planes)
        self.conv3 = conv(planes, out_ch, 1)
        self.bn3 = batch_norm(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (nn.Sequential(conv(inplanes, out_ch, 1),
                                         batch_norm(out_ch))
                           if inplanes != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + residual)


class HighResolutionModule(nn.Module):
    """Parallel branches of BasicBlocks + full cross-resolution fusion."""

    def __init__(self, num_inchannels: tuple, num_channels: tuple,
                 num_blocks: tuple):
        super().__init__()
        n = len(num_channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(num_inchannels[i] if b == 0
                                       else num_channels[i], num_channels[i])
                            for b in range(num_blocks[i])))
            for i in range(n))
        self.fuse_layers = None
        if n > 1:
            self.fuse_layers = nn.ModuleList(
                nn.ModuleList(self._fuse(num_channels, i, j) for j in range(n))
                for i in range(n))
        self.relu = nn.ReLU(inplace=True)

    @staticmethod
    def _fuse(ch: tuple, i: int, j: int):
        if j == i:
            return None
        if j > i:  # 1x1 conv, BN, nearest upsampling
            return nn.Sequential(conv(ch[j], ch[i], 1), batch_norm(ch[i]),
                                 nn.Upsample(scale_factor=2 ** (j - i),
                                             mode="nearest"))
        steps = []  # chain of stride-2 3x3 convs
        for k in range(i - j):
            last = k == i - j - 1
            out = ch[i] if last else ch[j]
            layers = [conv(ch[j], out, 3, 2), batch_norm(out)]
            if not last:
                layers.append(nn.ReLU(inplace=True))
            steps.append(nn.Sequential(*layers))
        return nn.Sequential(*steps)

    def forward(self, xs: list) -> list:
        outs = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return outs
        fused = []
        for row in self.fuse_layers:
            y = None
            for j, layer in enumerate(row):
                z = outs[j] if layer is None else layer(outs[j])
                y = z if y is None else y + z
            fused.append(self.relu(y))
        return fused


def _transition(prev_ch: tuple, cur_ch: tuple) -> nn.ModuleList:
    layers = []
    n_pre = len(prev_ch)
    for i in range(len(cur_ch)):
        if i < n_pre:
            layers.append(
                nn.Sequential(conv(prev_ch[i], cur_ch[i], 3),
                              batch_norm(cur_ch[i]), nn.ReLU(inplace=True))
                if cur_ch[i] != prev_ch[i] else None)
        else:  # new branch: chain of stride-2 convs from the lowest branch
            steps = []
            for j in range(i + 1 - n_pre):
                out = cur_ch[i] if j == i - n_pre else prev_ch[-1]
                steps.append(nn.Sequential(conv(prev_ch[-1], out, 3, 2),
                                           batch_norm(out),
                                           nn.ReLU(inplace=True)))
            layers.append(nn.Sequential(*steps))
    return nn.ModuleList(layers)


def _stage(in_ch: tuple, scfg: StageCfg) -> nn.Sequential:
    mods = []
    for _ in range(scfg.num_modules):
        mods.append(HighResolutionModule(in_ch, scfg.num_channels,
                                         scfg.num_blocks))
        in_ch = scfg.num_channels
    return nn.Sequential(*mods)


def _up_head(ch: int, reps: int) -> nn.Sequential:
    """reps x [Upsample x2 (bilinear, align corners), conv3x3, BN, ReLU]."""
    layers = []
    for _ in range(reps):
        layers += [nn.Upsample(scale_factor=2, mode="bilinear",
                               align_corners=True),
                   conv(ch, ch, 3), batch_norm(ch), nn.ReLU(inplace=True)]
    return nn.Sequential(*layers)


class PoseHighResolutionNet(nn.Module):
    """Input (N,3,224,224); output (N, 15*width, 56, 56)."""

    def __init__(self, cfg: HRNetCfg):
        super().__init__()
        self.conv1 = conv(3, 64, 3, 2)
        self.bn1 = batch_norm(64)
        self.conv2 = conv(64, 64, 3, 2)
        self.bn2 = batch_norm(64)
        self.relu = nn.ReLU(inplace=True)
        self.layer1 = nn.Sequential(Bottleneck(64, 64),
                                    *(Bottleneck(256, 64) for _ in range(3)))
        c2, c3, c4 = (cfg.stage2.num_channels, cfg.stage3.num_channels,
                      cfg.stage4.num_channels)
        self.transition1 = _transition((256,), c2)
        self.stage2 = _stage(c2, cfg.stage2)
        self.transition2 = _transition(c2, c3)
        self.stage3 = _stage(c3, cfg.stage3)
        self.transition3 = _transition(c3, c4)
        self.stage4 = _stage(c4, cfg.stage4)
        self.upsample_stage_2 = _up_head(c4[1], 1)
        self.upsample_stage_3 = _up_head(c4[2], 2)
        self.upsample_stage_4 = _up_head(c4[3], 3)

    @staticmethod
    def _apply_transition(transition: nn.ModuleList, xs: list) -> list:
        return [(xs[i] if layer is None else layer(xs[i])) if i < len(xs)
                else layer(xs[-1]) for i, layer in enumerate(transition)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        xs = self.stage2(self._apply_transition(self.transition1, xs))
        xs = self.stage3(self._apply_transition(self.transition2, xs))
        xs = self.stage4(self._apply_transition(self.transition3, xs))
        return torch.cat([xs[0], self.upsample_stage_2(xs[1]),
                          self.upsample_stage_3(xs[2]),
                          self.upsample_stage_4(xs[3])], dim=1)
