"""YOLOv3 person detectors (full and tiny) and the darknet `.weights` format.

Counterpart of gaitlab/nn/yolo.py. The network is table-driven:
`tiny_layers()` / `v3_layers()` list the layers in the public cfg's block
order (conv / maxpool / shortcut (residual add) / route (concat) /
upsample / yolo), and one `YoloNet` module executes any such table in
NCHW float32. Submodules are named by their darknet layer index as
gaitlab's Flax modules are: `conv{i}.conv` and `conv{i}.bn` for a
conv + batchnorm + leaky block, `conv{i}` for a linear head conv with bias.

The darknet file stores kernels as (out, in, kh, kw), which is torch's
OIHW layout already, so the importer copies them as they are.

Decode follows the darknet yolo layer: box center = (sigmoid(t_xy) +
grid) * stride, box size = anchor * exp(t_wh), objectness and class scores
sigmoid'd.
"""

from __future__ import annotations

import io
import os
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NUM_CLASSES = 80
PERSON_CLASS = 0

# yolov3-tiny.cfg anchors
ANCHORS_COARSE = ((81, 82), (135, 169), (344, 319))   # stride-32 head
ANCHORS_FINE = ((10, 14), (23, 27), (37, 58))         # stride-16 head
# yolov3.cfg anchors (masks 6-8 / 3-5 / 0-2)
V3_ANCHORS_32 = ((116, 90), (156, 198), (373, 326))
V3_ANCHORS_16 = ((30, 61), (62, 45), (59, 119))
V3_ANCHORS_8 = ((10, 13), (16, 30), (33, 23))


# ---------------------------------------------------------------------------
# layer tables (one entry per darknet layer index, so route/shortcut offsets
# read exactly like the cfg)
# ---------------------------------------------------------------------------
#   ("conv", filters, size, stride)     convolutional + BN + leaky(0.1)
#   ("convlin", filters, size, stride)  linear conv with bias (det heads)
#   ("maxpool", size, stride)
#   ("shortcut", offset)                x = x + out[i + offset]
#   ("route", (ref, ...))               concat referenced outputs (<0 =
#                                       relative to this layer, else abs)
#   ("upsample",)                       2x nearest
#   ("yolo", anchors)                   emit raw prediction map


def tiny_layers(num_classes: int = NUM_CLASSES) -> tuple:
    """yolov3-tiny.cfg: 13 convs, 6 maxpools, 2 scales."""
    c = 3 * (5 + num_classes)
    return (
        ("conv", 16, 3, 1), ("maxpool", 2, 2),
        ("conv", 32, 3, 1), ("maxpool", 2, 2),
        ("conv", 64, 3, 1), ("maxpool", 2, 2),
        ("conv", 128, 3, 1), ("maxpool", 2, 2),
        ("conv", 256, 3, 1), ("maxpool", 2, 2),          # idx 8: route src
        ("conv", 512, 3, 1), ("maxpool", 2, 1),          # size2/stride1
        ("conv", 1024, 3, 1),
        ("conv", 256, 1, 1),                              # idx 13
        ("conv", 512, 3, 1),
        ("convlin", c, 1, 1),
        ("yolo", ANCHORS_COARSE),                         # idx 16
        ("route", (-4,)),                                 # -> 13
        ("conv", 128, 1, 1),
        ("upsample",),
        ("route", (-1, 8)),
        ("conv", 256, 3, 1),
        ("convlin", c, 1, 1),
        ("yolo", ANCHORS_FINE),
    )


def v3_layers(num_classes: int = NUM_CLASSES) -> tuple:
    """yolov3.cfg: Darknet-53 backbone (23 residual blocks) + 3 scales."""
    c = 3 * (5 + num_classes)
    t = [("conv", 32, 3, 1)]

    def res_stage(filters: int, blocks: int):
        t.append(("conv", filters, 3, 2))  # downsample
        for _ in range(blocks):
            t.append(("conv", filters // 2, 1, 1))
            t.append(("conv", filters, 3, 1))
            t.append(("shortcut", -3))

    res_stage(64, 1)
    res_stage(128, 2)
    res_stage(256, 8)       # ends at idx 36: stride-8 route source
    res_stage(512, 8)       # ends at idx 61: stride-16 route source
    res_stage(1024, 4)      # ends at idx 74
    t += [
        ("conv", 512, 1, 1), ("conv", 1024, 3, 1),
        ("conv", 512, 1, 1), ("conv", 1024, 3, 1),
        ("conv", 512, 1, 1),                              # idx 79
        ("conv", 1024, 3, 1),
        ("convlin", c, 1, 1),
        ("yolo", V3_ANCHORS_32),                          # idx 82
        ("route", (-4,)),                                 # -> 79
        ("conv", 256, 1, 1),
        ("upsample",),
        ("route", (-1, 61)),
        ("conv", 256, 1, 1), ("conv", 512, 3, 1),
        ("conv", 256, 1, 1), ("conv", 512, 3, 1),
        ("conv", 256, 1, 1),                              # idx 91
        ("conv", 512, 3, 1),
        ("convlin", c, 1, 1),
        ("yolo", V3_ANCHORS_16),                          # idx 94
        ("route", (-4,)),                                 # -> 91
        ("conv", 128, 1, 1),
        ("upsample",),
        ("route", (-1, 36)),
        ("conv", 128, 1, 1), ("conv", 256, 3, 1),
        ("conv", 128, 1, 1), ("conv", 256, 3, 1),
        ("conv", 128, 1, 1), ("conv", 256, 3, 1),
        ("convlin", c, 1, 1),
        ("yolo", V3_ANCHORS_8),                           # idx 106
    ]
    assert len(t) == 107
    return tuple(t)


def _channels(layers: tuple, in_channels: int = 3) -> list:
    """Input channels of each layer of the table."""
    outs: list = []
    cur = in_channels
    ins = []
    for i, entry in enumerate(layers):
        ins.append(cur)
        kind = entry[0]
        if kind in ("conv", "convlin"):
            cur = entry[1]
        elif kind == "route":
            cur = sum(outs[r if r >= 0 else i + r] for r in entry[1])
        outs.append(cur)
    return ins


class ConvBN(nn.Module):
    """conv + batchnorm + leaky(0.1): darknet's `convolutional` block with
    batch_normalize=1. Darknet pads (k-1)//2 on each side at every stride
    (not SAME: with stride 2 that differs)."""

    def __init__(self, in_ch: int, features: int, kernel: int, stride: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel, stride,
                              padding=(kernel - 1) // 2, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.bn(self.conv(x)), negative_slope=0.1)


class YoloNet(nn.Module):
    """Darknet graph executor over a layer table.

    forward((N,3,S,S) images in [0,1]) returns the raw prediction maps,
    (N, 3*(5+C), G, G) each, one per ("yolo", ...) entry, in table order
    (coarse -> fine)."""

    def __init__(self, layers: tuple, num_classes: int = NUM_CLASSES):
        super().__init__()
        self.layers = layers
        self.num_classes = num_classes
        for i, (entry, cin) in enumerate(zip(layers, _channels(layers))):
            if entry[0] == "conv":
                _, f, k, s = entry
                self.add_module(f"conv{i}", ConvBN(cin, f, k, s))
            elif entry[0] == "convlin":
                _, f, k, s = entry
                self.add_module(f"conv{i}", nn.Conv2d(
                    cin, f, k, s, padding=(k - 1) // 2, bias=True))

    def forward(self, x: torch.Tensor) -> tuple:
        outs: list = []       # per-layer outputs for route/shortcut refs
        maps: list = []
        for i, entry in enumerate(self.layers):
            kind = entry[0]
            if kind in ("conv", "convlin"):
                x = getattr(self, f"conv{i}")(x)
            elif kind == "maxpool":
                _, size, stride = entry
                if stride == 1:
                    # darknet maxpool size=2 stride=1: pad right/bottom by
                    # repeating the edge
                    x = F.max_pool2d(F.pad(x, (0, 1, 0, 1), mode="replicate"),
                                     size, 1)
                else:
                    x = F.max_pool2d(x, size, stride)
            elif kind == "shortcut":
                x = x + outs[i + entry[1]]
            elif kind == "route":
                refs = [outs[r if r >= 0 else i + r] for r in entry[1]]
                x = refs[0] if len(refs) == 1 else torch.cat(refs, dim=1)
            elif kind == "upsample":
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            elif kind == "yolo":
                # the layer after a yolo block restarts from the yolo
                # layer's input, so outs[i] = x keeps the refs consistent
                maps.append(x)
            else:
                raise ValueError(kind)
            outs.append(x)
        return tuple(maps)


def YoloV3Tiny(num_classes: int = NUM_CLASSES) -> YoloNet:
    """yolov3-tiny (the cheap variant)."""
    return YoloNet(tiny_layers(num_classes), num_classes)


def YoloV3(num_classes: int = NUM_CLASSES) -> YoloNet:
    """Full yolov3 (Darknet-53), the reference's detector."""
    return YoloNet(v3_layers(num_classes), num_classes)


def decode_predictions(raw: torch.Tensor, anchors: Sequence[tuple],
                       stride: int,
                       num_classes: int = NUM_CLASSES) -> torch.Tensor:
    """Raw map (N, 3*(5+C), G, G) -> (N, G*G*3, 5+C) [cx,cy,w,h,obj,cls...]
    in input-pixel units, rows ordered (y, x, anchor) as gaitlab's NHWC
    maps are."""
    n, _, g, _ = raw.shape
    a = len(anchors)
    raw = raw.permute(0, 2, 3, 1).reshape(n, g, g, a, 5 + num_classes)
    ar = torch.arange(g, device=raw.device)
    grid = torch.stack(torch.meshgrid(ar, ar, indexing="xy"), dim=-1)  # x, y
    xy = (torch.sigmoid(raw[..., :2]) + grid[None, :, :, None, :]) * stride
    wh = torch.tensor(anchors, dtype=raw.dtype,
                      device=raw.device) * torch.exp(raw[..., 2:4])
    obj = torch.sigmoid(raw[..., 4:5])
    cls = torch.sigmoid(raw[..., 5:])
    return torch.cat([xy, wh, obj, cls], -1).reshape(n, g * g * a, -1)


def detect(net: YoloNet, images: torch.Tensor) -> torch.Tensor:
    """images (N,3,S,S) in [0,1] -> (N, K, 5+C) decoded predictions, all
    scales concatenated in table (coarse -> fine) order."""
    maps = net(images)
    s = images.shape[-1]
    anchor_sets = [e[1] for e in net.layers if e[0] == "yolo"]
    return torch.cat([decode_predictions(m, a, s // m.shape[-1],
                                         net.num_classes)
                      for m, a in zip(maps, anchor_sets)], dim=1)


# ---------------------------------------------------------------------------
# darknet .weights files
# ---------------------------------------------------------------------------

def _conv_entries(layers: tuple):
    """(name, has_bn) of each conv in file order (= table order: darknet
    saves convs as it walks the cfg)."""
    for i, entry in enumerate(layers):
        if entry[0] in ("conv", "convlin"):
            yield f"conv{i}", entry[0] == "conv"


def expected_float_count(layers: tuple, in_channels: int = 3) -> int:
    """Number of float32 payload values a darknet file for this table
    holds (to tell the variant from the file size)."""
    n = 0
    for entry, cin in zip(layers, _channels(layers, in_channels)):
        if entry[0] in ("conv", "convlin"):
            f, k = entry[1], entry[2]
            n += f * (4 if entry[0] == "conv" else 1)  # BN stats or bias
            n += f * cin * k * k
    return n


def infer_variant(path_or_bytes) -> str:
    """'tiny' | 'v3' from the weight file's payload size. The header is
    three int32 and a `seen` counter of int64 (darknet >= 0.2) or int32."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        size = len(path_or_bytes)
    else:
        size = os.path.getsize(path_or_bytes)
    counts = {(size - hdr) // 4 for hdr in (20, 16) if (size - hdr) % 4 == 0}
    if expected_float_count(tiny_layers()) in counts:
        return "tiny"
    if expected_float_count(v3_layers()) in counts:
        return "v3"
    raise ValueError(
        f"unrecognized darknet file: {sorted(counts)} payload floats "
        f"(expected {expected_float_count(tiny_layers())} for yolov3-tiny "
        f"or {expected_float_count(v3_layers())} for yolov3)")


def load_darknet_weights(path_or_bytes, net: YoloNet) -> YoloNet:
    """Read a standard darknet `.weights` file into `net` (in place).

    Layout (darknet save_weights): a header of 3 int32 (major, minor,
    revision) and an int64 `seen` (int32 when major*10+minor < 2), then for
    each conv in cfg order [bn_beta, bn_gamma, bn_mean, bn_var] with batch
    normalization, else [conv_bias], then the kernel as (out, in, kh, kw)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        f = io.BytesIO(path_or_bytes)
    else:
        f = open(path_or_bytes, "rb")
    with f:
        major, minor, _rev = np.frombuffer(f.read(12), np.int32)
        f.read(8 if major * 10 + minor >= 2 else 4)  # `seen` counter
        buf = np.frombuffer(bytearray(f.read()), np.float32)
    pos = 0

    def fill(t: torch.Tensor):
        nonlocal pos
        n = t.numel()
        if pos + n > buf.size:
            raise ValueError(
                f"darknet file too short: wanted {n} floats at {pos}, "
                f"file has {buf.size}")
        t.copy_(torch.from_numpy(buf[pos:pos + n].reshape(t.shape)))
        pos += n

    with torch.no_grad():
        for name, has_bn in _conv_entries(net.layers):
            m = getattr(net, name)
            if has_bn:
                for t in (m.bn.bias, m.bn.weight, m.bn.running_mean,
                          m.bn.running_var):
                    fill(t)
                fill(m.conv.weight)
            else:
                fill(m.bias)
                fill(m.weight)
    if pos != buf.size:
        raise ValueError(f"{buf.size - pos} unread floats: wrong variant?")
    return net


def save_darknet_weights(path: str, net: YoloNet) -> None:
    """Write `net` out in the darknet layout (version 0.2.0, int64 seen)."""
    parts = [np.array([0, 2, 0], np.int32).tobytes(),
             np.array([0], np.int64).tobytes()]
    for name, has_bn in _conv_entries(net.layers):
        m = getattr(net, name)
        ts = ((m.bn.bias, m.bn.weight, m.bn.running_mean, m.bn.running_var,
               m.conv.weight) if has_bn else (m.bias, m.weight))
        parts += [t.detach().cpu().float().contiguous().numpy().tobytes()
                  for t in ts]
    with open(path, "wb") as f:
        f.write(b"".join(parts))
