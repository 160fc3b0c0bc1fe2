"""HRNet-W32/W48 pose backbone (NCHW).

Counterpart of gaitlab/nn/hrnet.py with the reference's module layout
(stem, Bottleneck layer1, three multi-resolution stages with fuse layers)
and its four heads, chosen by `downsample` and `use_conv`: the deployed
one (False, True) sends branches 2-4 through `upsample_stage_{2,3,4}`
(bilinear align-corners upsampling, conv, BN, ReLU) and concatenates them
onto branch 1, giving (N, 15*width, 56, 56) for a 224 crop; (True, True)
sends branches 1-3 through `downsample_stage_{1,2,3}` (stride-2 conv, BN,
ReLU) onto branch 4's grid; without `use_conv` the branches are only
resized, onto branch 1's grid or, with `downsample`, branch 4's.
Attribute names and Sequential indices give the reference's state_dict
keys.

The forward runs as six regions (REGIONS, gaitlab's `_prec` regions),
each in its own precision segment (layers.precision_scope): the region's
entry of `cfg.region_precision` or, without one, the backbone's
`precision`. The backbone computes in its weights' dtype (bf16 under the
runner's trunk_dtype). `cfg.resize_precision` is gaitlab's precision of
its two-matmul bilinear resize; the port's resize is ATen's bilinear
kernel, which does no matmul and computes the same FP32 result at every
value, so the knob is carried and resolved but changes nothing here. As
in gaitlab, a region's precision reaches only the upsampling head: the
other three heads run at the backbone's.

gaitlab's exact-math and storage variants, all off by default and none
with parameters of its own, so that every variant loads the same
state_dict (`cfg`):
  pack_low_channel  a stage branch of at most this many channels (whose
                    input width is its output width, on an even grid)
                    runs on the space-to-depth grid, one s2d/d2s pair a
                    module (layers.packed_basic_block)
  stem_s2d          conv1 as a 2x2 convolution on the s2d grid
                    (stem_conv_s2d)
  act_store         (("layer1", "bfloat16"),): layer1's residual stream
                    stored as bf16 at its five block boundaries; pair it
                    with the region at w2x
  cast_after        (region, dtype) pairs: a region's output cast to dtype
The packed and s2d forms are inference only: they step aside in train
mode and under layers.standard_blocks() (BN calibration), and on an odd
grid. Their convolutions take a region's "float32", "high" or "default"
but not its w2x/a2x split, which leaves them at the backbone's precision
(layers.conv_at). `stop_after` ends the forward after a region, returning
branch 1 (gaitlab's profiling knob).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from gaitlab_torch.device import constant
from gaitlab_torch.nn.layers import (batch_norm, bf16_store, check_mode,
                                     conv, conv_at, depth_to_space,
                                     packed_basic_block, packing_allowed,
                                     precision_scope, space_to_depth,
                                     upsample_bilinear_align_corners)

REGIONS = ("stem", "layer1", "stage2", "stage3", "stage4", "heads")
RESIZE_PRECISIONS = ("highest", "high", "default")
ACT_DTYPES = ("bfloat16", "float16", "float32")


@dataclass(frozen=True)
class StageCfg:
    num_modules: int
    num_branches: int
    num_blocks: tuple
    num_channels: tuple


@dataclass(frozen=True)
class HRNetCfg:
    width: int = 32
    downsample: bool = False
    use_conv: bool = True
    stage2: StageCfg = None
    stage3: StageCfg = None
    stage4: StageCfg = None
    # the variants (module docstring); 0, (), () and False are off
    pack_low_channel: int = 0
    # (region, mode) pairs: a region in REGIONS runs at `mode` (one of
    # layers.MODES) instead of the backbone's precision
    region_precision: tuple = ()
    cast_after: tuple = ()
    act_store: tuple = ()
    stem_s2d: bool = False
    # gaitlab's resize-matmul precision (module docstring)
    resize_precision: str = "highest"

    def __post_init__(self):
        object.__setattr__(self, "region_precision", tuple(
            tuple(rp) for rp in self.region_precision))
        for region, mode in self.region_precision:
            check_mode(mode)
            if region not in REGIONS:
                raise ValueError(f"region_precision region {region!r}: use "
                                 f"one of {REGIONS}")
        if self.resize_precision not in RESIZE_PRECISIONS:
            raise ValueError(f"resize_precision={self.resize_precision!r}: "
                             f"use one of {RESIZE_PRECISIONS}")
        for field in ("cast_after", "act_store"):
            pairs = tuple(tuple(p) for p in getattr(self, field))
            object.__setattr__(self, field, pairs)
            for region, dtype in pairs:
                if region not in REGIONS or dtype not in ACT_DTYPES:
                    raise ValueError(f"{field} ({region!r}, {dtype!r}): use "
                                     f"a region of {REGIONS} and a dtype of "
                                     f"{ACT_DTYPES}")
        if any(r != "layer1" or d != "bfloat16" for r, d in self.act_store):
            raise ValueError(f"act_store={self.act_store}: only "
                             "(('layer1', 'bfloat16'),) is supported")

    @staticmethod
    def w(width: int = 32, downsample: bool = False, use_conv: bool = True,
          pack_low_channel: int = 0, region_precision: tuple = (),
          cast_after: tuple = (), act_store: tuple = (),
          stem_s2d: bool = False, modules: tuple = (1, 4, 3),
          blocks: int = 4, resize_precision: str = "highest") -> "HRNetCfg":
        """gaitlab's fields in gaitlab's order. The deployed topology is
        modules=(1,4,3), blocks=4; smaller values keep every branch,
        transition and fuse path (and so every parameter shape family)
        for cheap test models."""
        return HRNetCfg(
            width=width, downsample=downsample, use_conv=use_conv,
            stage2=StageCfg(modules[0], 2, (blocks,) * 2, (width, width * 2)),
            stage3=StageCfg(modules[1], 3, (blocks,) * 3,
                            (width, width * 2, width * 4)),
            stage4=StageCfg(modules[2], 4, (blocks,) * 4,
                            (width, width * 2, width * 4, width * 8)),
            pack_low_channel=pack_low_channel,
            region_precision=region_precision, cast_after=cast_after,
            act_store=act_store, stem_s2d=stem_s2d,
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
        self.num_channels = tuple(num_channels)
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

    def forward(self, xs: list, pack: int = 0, mode: str = "float32"
                ) -> list:
        """`pack`: the pack_low_channel threshold in force (0: none); a
        packed branch's convolutions run at `mode` (layers.conv_at)."""
        outs = []
        for branch, x, ch in zip(self.branches, xs, self.num_channels):
            if (ch <= pack and branch[0].downsample is None
                    and x.shape[-2] % 2 == 0 and x.shape[-1] % 2 == 0):
                x = space_to_depth(x)
                for block in branch:
                    x = packed_basic_block(block, x, mode)
                outs.append(depth_to_space(x))
            else:
                outs.append(branch(x))
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


def _down_head(ch: int, reps: int) -> nn.Sequential:
    """reps x [conv3x3 stride 2, BN, ReLU]."""
    layers = []
    for _ in range(reps):
        layers += [conv(ch, ch, 3, 2), batch_norm(ch), nn.ReLU(inplace=True)]
    return nn.Sequential(*layers)


def _stem_taps() -> tuple:
    """For (py, px, dy, dx), flattened in that order: the tap ky*3 + kx of
    a 3x3 stride-2 kernel that the 2x2 stride-1 kernel on the s2d grid
    carries at packed tap (py, px) for input phase (dy, dx), with
    ky = 2*py + dy - 1 (and likewise kx), or 9 (a zero) outside it."""
    taps = []
    for py in (0, 1):
        for px in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    ky, kx = 2 * py + dy - 1, 2 * px + dx - 1
                    taps.append(ky * 3 + kx if 0 <= ky <= 2 and 0 <= kx <= 2
                                else 9)
    return tuple(taps)


_STEM_TAPS = _stem_taps()


def stem_conv_s2d(x: torch.Tensor, weight: torch.Tensor,
                  mode: str = "float32") -> torch.Tensor:
    """gaitlab's StemConvS2D: the stem's 3x3 stride-2 pad-1 convolution
    with `weight` (F, C, 3, 3) as the same products on space_to_depth's
    (N, 4C, H/2, W/2) grid, a 2x2 stride-1 convolution whose kernel
    (F, 4C, 2, 2) holds the 27 taps and 21 zeros, padded by one row and
    column at the top and left only. It runs at `mode` (layers.conv_at)."""
    f, c = weight.shape[:2]
    taps = torch.cat([weight.reshape(f, c, 9), weight.new_zeros(f, c, 1)],
                     dim=2)
    g = taps[:, :, constant(_STEM_TAPS, "int64", weight.device)]
    wp = (g.reshape(f, c, 2, 2, 2, 2).permute(0, 4, 5, 1, 2, 3)
          .reshape(f, 4 * c, 2, 2))
    return conv_at(F.pad(space_to_depth(x), (1, 0, 1, 0)), wp, 0, mode)


class PoseHighResolutionNet(nn.Module):
    """Input (N,3,H,W); output (N, 15*width, H/4, W/4) from the deployed
    head, (N, 15*width, H/32, W/32) from a downsampling one."""

    def __init__(self, cfg: HRNetCfg, stop_after: str = ""):
        super().__init__()
        if stop_after not in ("",) + REGIONS[:-1]:
            raise ValueError(f"stop_after={stop_after!r}: use one of "
                             f"{REGIONS[:-1]}")
        self.cfg = cfg
        self.stop_after = stop_after
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
        if cfg.use_conv and not cfg.downsample:
            self.upsample_stage_2 = _up_head(c4[1], 1)
            self.upsample_stage_3 = _up_head(c4[2], 2)
            self.upsample_stage_4 = _up_head(c4[3], 3)
        elif cfg.use_conv:
            self.downsample_stage_1 = _down_head(c4[0], 3)
            self.downsample_stage_2 = _down_head(c4[1], 2)
            self.downsample_stage_3 = _down_head(c4[2], 1)

    @staticmethod
    def _apply_transition(transition: nn.ModuleList, xs: list) -> list:
        return [(xs[i] if layer is None else layer(xs[i])) if i < len(xs)
                else layer(xs[-1]) for i, layer in enumerate(transition)]

    def region_mode(self, name: str) -> str:
        """The precision mode region `name` runs at."""
        if name == "heads" and not (self.cfg.use_conv
                                    and not self.cfg.downsample):
            return self.precision
        return dict(self.cfg.region_precision).get(name, self.precision)

    def _packed_mode(self, name: str) -> str:
        """The mode of region `name`'s packed convolutions: the region's,
        or the backbone's where the region's is a w2x/a2x split."""
        mode = self.region_mode(name)
        return mode if mode in ("float32", "high", "default") \
            else self.precision

    def _run_stage(self, name: str, transition, stage, xs: list) -> list:
        pack = self.cfg.pack_low_channel if packing_allowed(self) else 0
        xs = self._apply_transition(transition, xs)
        for module in stage:
            xs = module(xs, pack, self._packed_mode(name))
        return xs

    def region(self, name: str, x):
        """Region `name` of the forward, on the previous region's output
        (the images for "stem"; a list of branches between the stages)."""
        cfg = self.cfg
        if name == "stem":
            x = x.to(self.conv1.weight.dtype)
            if (cfg.stem_s2d and packing_allowed(self)
                    and x.shape[-2] % 2 == 0 and x.shape[-1] % 2 == 0):
                x = stem_conv_s2d(x, self.conv1.weight,
                                  self._packed_mode(name))
            else:
                x = self.conv1(x)
            x = self.relu(self.bn1(x))
            return self.relu(self.bn2(self.conv2(x)))
        if name == "layer1":
            if not cfg.act_store:
                return [self.layer1(x)]
            for block in self.layer1:
                x = block(bf16_store(x))
            return [bf16_store(x)]
        if name == "stage2":
            return self._run_stage(name, self.transition1, self.stage2, x)
        if name == "stage3":
            return self._run_stage(name, self.transition2, self.stage3, x)
        if name == "stage4":
            return self._run_stage(name, self.transition3, self.stage4, x)
        if name != "heads":
            raise ValueError(f"region {name!r}: use one of {REGIONS}")
        if cfg.use_conv and not cfg.downsample:
            return torch.cat([x[0], self.upsample_stage_2(x[1]),
                              self.upsample_stage_3(x[2]),
                              self.upsample_stage_4(x[3])], dim=1)
        if cfg.use_conv:
            return torch.cat([self.downsample_stage_1(x[0]),
                              self.downsample_stage_2(x[1]),
                              self.downsample_stage_3(x[2]), x[3]], dim=1)
        ref = x[3] if cfg.downsample else x[0]
        h, w = ref.shape[-2:]
        return torch.cat([z if z is ref
                          else upsample_bilinear_align_corners(z, h, w)
                          for z in x], dim=1)

    def _cast_after(self, name: str, x):
        dtype = dict(self.cfg.cast_after).get(name)
        if dtype is None:
            return x
        dtype = getattr(torch, dtype)
        return [a.to(dtype) for a in x] if isinstance(x, list) \
            else x.to(dtype)

    def run_region(self, name: str, x, cast: bool = True):
        """`region` in its own precision segment, at the region's mode,
        then, with `cast`, cfg.cast_after's cast of its output."""
        with precision_scope(self.region_mode(name)):
            x = self.region(name, x)
        return self._cast_after(name, x) if cast else x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in REGIONS:
            if name == self.stop_after:  # branch 1, before any cast
                x = self.run_region(name, x, cast=False)
                return x[0] if isinstance(x, list) else x
            x = self.run_region(name, x)
        return x


def hrnet_w32(downsample: bool = False, use_conv: bool = True
              ) -> PoseHighResolutionNet:
    """HRNet-W32, 480 channels out."""
    return PoseHighResolutionNet(HRNetCfg.w(32, downsample, use_conv))


def hrnet_w48(downsample: bool = False, use_conv: bool = True
              ) -> PoseHighResolutionNet:
    """HRNet-W48, 720 channels out."""
    return PoseHighResolutionNet(HRNetCfg.w(48, downsample, use_conv))
