"""HRNet-W32 pose backbone (NCHW) for the deployed PARE configuration.

Counterpart of gaitlab/nn/hrnet.py with the reference's module layout
(stem, Bottleneck layer1, three multi-resolution stages with fuse layers)
and its deployed head (downsample=False, use_conv=True): branches 2-4 go
through `upsample_stage_{2,3,4}` (bilinear align-corners upsampling, conv,
BN, ReLU) and are concatenated onto branch 1, giving (N, 480, 56, 56) for
a 224 crop. Attribute names and Sequential indices give the reference's
state_dict keys.

The forward runs as six regions (REGIONS, gaitlab's `_prec` regions),
each in its own precision segment (layers.precision_scope): the region's
entry of `cfg.region_precision` or, without one, the backbone's
`precision`. The backbone computes in its weights' dtype (bf16 under the
runner's trunk_dtype). `cfg.resize_precision` is gaitlab's precision of
its two-matmul bilinear resize; the port's resize is ATen's bilinear
kernel, which does no matmul and computes the same FP32 result at every
value, so the knob is carried and resolved but changes nothing here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
from torch import nn

from gaitlab_torch.nn.layers import (batch_norm, check_mode, conv,
                                     precision_scope)

REGIONS = ("stem", "layer1", "stage2", "stage3", "stage4", "heads")
RESIZE_PRECISIONS = ("highest", "high", "default")


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
    # (region, mode) pairs: a region in REGIONS runs at `mode` (one of
    # layers.MODES) instead of the backbone's precision
    region_precision: tuple = ()
    # gaitlab's resize-matmul precision (module docstring)
    resize_precision: str = "highest"

    @staticmethod
    def w(width: int = 32, modules: tuple = (1, 4, 3), blocks: int = 4,
          region_precision: tuple = (),
          resize_precision: str = "highest") -> "HRNetCfg":
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
        ).at_precision(region_precision, resize_precision)

    def at_precision(self, region_precision: tuple = (),
                     resize_precision: str = "highest") -> "HRNetCfg":
        """This topology with other precision fields (checked)."""
        region_precision = tuple(tuple(rp) for rp in region_precision)
        for region, mode in region_precision:
            check_mode(mode)
            if region not in REGIONS:
                raise ValueError(f"region_precision region {region!r}: use "
                                 f"one of {REGIONS}")
        if resize_precision not in RESIZE_PRECISIONS:
            raise ValueError(f"resize_precision={resize_precision!r}: use "
                             f"one of {RESIZE_PRECISIONS}")
        return dataclasses.replace(self, region_precision=region_precision,
                                   resize_precision=resize_precision)


class BasicBlock(nn.Module):
    """3x3, 3x3 residual block; `stride` on the first conv and on the
    projection shortcut (ResNet's stages, nn/resnet.py)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv(planes, planes, 3)
        self.bn2 = batch_norm(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (nn.Sequential(conv(inplanes, planes, 1, stride),
                                         batch_norm(planes))
                           if stride != 1 or inplanes != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1, 3x3, 1x1 residual block; `stride` on the 3x3 conv (torchvision's
    ResNet v1.5, as gaitlab's) and on the projection shortcut."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = conv(inplanes, planes, 1)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv(planes, planes, 3, stride)
        self.bn2 = batch_norm(planes)
        self.conv3 = conv(planes, out_ch, 1)
        self.bn3 = batch_norm(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (nn.Sequential(conv(inplanes, out_ch, 1, stride),
                                         batch_norm(out_ch))
                           if stride != 1 or inplanes != out_ch else None)

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
        self.cfg = cfg
        # the mode of the regions without an entry in cfg.region_precision
        # (gaitlab's enclosing precision context)
        self.precision = "float32"
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

    def region_mode(self, name: str) -> str:
        """The precision mode region `name` runs at."""
        return dict(self.cfg.region_precision).get(name, self.precision)

    def region(self, name: str, x):
        """Region `name` of the forward, on the previous region's output
        (the images for "stem"; a list of branches between the stages)."""
        if name == "stem":
            x = self.relu(self.bn1(self.conv1(x.to(self.conv1.weight.dtype))))
            return self.relu(self.bn2(self.conv2(x)))
        if name == "layer1":
            return [self.layer1(x)]
        if name == "stage2":
            return self.stage2(self._apply_transition(self.transition1, x))
        if name == "stage3":
            return self.stage3(self._apply_transition(self.transition2, x))
        if name == "stage4":
            return self.stage4(self._apply_transition(self.transition3, x))
        if name == "heads":
            return torch.cat([x[0], self.upsample_stage_2(x[1]),
                              self.upsample_stage_3(x[2]),
                              self.upsample_stage_4(x[3])], dim=1)
        raise ValueError(f"region {name!r}: use one of {REGIONS}")

    def run_region(self, name: str, x):
        """`region` in its own precision segment, at the region's mode."""
        with precision_scope(self.region_mode(name)):
            return self.region(name, x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in REGIONS:
            x = self.run_region(name, x)
        return x
