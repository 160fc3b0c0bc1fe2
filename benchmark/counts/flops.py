"""Nominal FLOPs and least bytes of the GRNet step (arch/grnet.py's
`counts`), frozen here so that the program cannot change its own
yardstick.

The layer counting is that of scripts/torch_mfu_trace.py (which agreed
with FlopCounterMode within 1%), with two corrections:
  * FLOPs are 2 per multiply-add of the published layers in direct form,
    whatever algorithm runs (FFT, Winograd, split products), plus B1's
    and B2's analytic counts, SMPL's products around B2 (counts/smpl.py,
    shared by every architecture) and the gait corrector's products,
    counted from the sizes;
  * bytes are a stage's or a kernel's own inputs read once, its outputs
    written once and its convolutions' weights once, at the
    configuration's precision; no intermediate between layers counts,
    since a fused kernel would not move it, and BatchNorm's terms do not
    count, since they fold into the convolutions. The mfu script counted
    every layer's input and output, which is no lower bound.
The trunk's counts come from the plain reference's own layer walk
(benchmark/reference) on the meta device (`count_trunk`), and from the
shapes of the benchmark's state dict; nothing of the program is read.
"""

from __future__ import annotations

import collections
import math

import torch

from benchmark.counts.smpl import SMPL_JOINTS, b2_work, smpl_products
from benchmark.reference.model import Reference

PREDICT_LAYERS = ("head.pose_mlp", "head.shape_mlp", "head.cam_mlp")
HR_HEAD = "backbone.upsample_stage_"
BYTES_PER_VALUE = {"float32": 4, "tf32": 4, "bfloat16": 2}


class _Walk(Reference):
    """The reference's forward with each convolution's direct-form FLOPs
    summed by its key."""

    def __init__(self, sd: dict, cfg: dict):
        super().__init__(sd, cfg)
        self.sums: collections.Counter = collections.Counter()

    def conv(self, x, p: str, stride: int = 1):
        y = super().conv(x, p, stride)
        self.sums[p] += 2 * y.numel() * math.prod(
            self.sd[p + ".weight"].shape[1:])
        return y


def count_trunk(sd: dict, cfg: dict) -> dict:
    """Per-frame FLOPs of the trunk's layers without the gait corrector:
    {"backbone", "hr_head" (part of backbone), "head" (the PARE head's
    convolutions), "predict" (its regressors)}, from the reference's
    forward of one crop on the meta device (shapes only) and the
    regressors' weight sizes."""
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in sd.items()}
    walk = _Walk(meta, cfg)
    size = cfg["crop_size"]
    walk.head_features(walk.backbone(
        torch.empty((1, 3, size, size), device="meta")))
    sums = {"backbone": 0.0, "hr_head": 0.0, "head": 0.0}
    for key, f in walk.sums.items():
        part = "backbone" if key.startswith("backbone.") else "head"
        sums[part] += f
        if key.startswith(HR_HEAD):
            sums["hr_head"] += f
    sums["predict"] = float(sum(2 * sd[k + ".weight"].numel()
                                for k in PREDICT_LAYERS))
    return sums


def conv_weight_bytes(sd: dict, prefix: str, precision: str) -> int:
    """Bytes of the convolution weights under `prefix`, read once at the
    configuration's precision."""
    n = sum(v.numel() for k, v in sd.items()
            if k.startswith(prefix) and k.endswith(".weight") and v.dim() == 4)
    return n * BYTES_PER_VALUE[precision]


def b1_work(rows: int, hw: int, c1: int, c2: int, j: int) -> tuple:
    """(FLOPs, bytes) of B1 on `rows` frames: the softmax over hw
    positions of j part logits and the pooling of both feature maps
    (c1 and c2 channels); float32 inputs read once, the (rows,j,c1) and
    (rows,j,c2) outputs written once."""
    flops = rows * j * hw * (2 * (c1 + c2) + 5)
    return flops, 4 * rows * (hw * (c1 + c2 + j) + j * (c1 + c2))


def corrector_flops(t: int, sd: dict, cfg: dict) -> float:
    """The gait corrector's products over one forward of t real frames,
    from the sizes of its weights (`sd`, keys under "pfeat_corrector.")
    and the configuration: the camera embedding, the two-layer
    bidirectional GRU, the gait MLPs, the gait token, then per block the
    temporal attention over t frames, the spatial attention over each
    frame's J+1 tokens, the mixing linear and the feed-forward."""
    m = cfg["model"]
    j, c = m["num_joints"], m["num_features_pare"]
    p = "pfeat_corrector."

    def shape(k):
        return tuple(sd[p + k].shape)

    f = 2 * t * j * 3 * c                                  # cparam_mlp
    layer = 0
    while p + f"featnet.rnn.weight_ih_l{layer}" in sd:
        g3, i = shape(f"featnet.rnn.weight_ih_l{layer}")
        h = shape(f"featnet.rnn.weight_hh_l{layer}")[1]
        f += 2 * (2 * t * g3 * (i + h))                   # both directions
        layer += 1
    for k in ("speed_fc", "speed_out", "step_fc", "step_out"):
        o, i = shape(f"featnet.{k}.weight")
        f += 2 * o * i
    for k in ("phase_fc", "phase_out", "gfeat_fc", "gfeat_token"):
        o, i = shape(("featnet." if k.startswith("phase") else "") + k
                     + ".weight")
        f += 2 * t * o * i
    nt = j + 1
    for b in range(m["featcorr_num_layers"]):
        q = f"block{b}."
        d, flat = shape(q + "mulattn.temporal.query.weight")
        f += 2 * t * (3 * d * flat + d * flat)             # q, k, v, out
        f += 2 * 2 * t * t * d                             # logits, sum
        d, cs = shape(q + "mulattn.spatial.query.weight")
        f += 2 * t * nt * (3 * d * cs + d * cs)
        f += 2 * 2 * t * nt * nt * d
        o, i = shape(q + "mulattn.ts_attn.weight")
        f += 2 * o * i                                     # on the mean
        if p + q + "jwff1.weight" in sd:
            _, ci, co = shape(q + "jwff1.weight")
            f += 2 * 2 * t * nt * ci * co
        else:
            o, i = shape(q + "pwff1.weight")
            f += 2 * 2 * t * nt * o * i
    return float(f)


class StepCounts:
    """What one configuration's step needs, per frame and per forward,
    from the configuration and the shapes of the benchmark's state dict."""

    def __init__(self, cfg: dict, sd: dict):
        m = cfg["model"]
        self.cfg, self.sd = cfg, sd
        self.trunk = count_trunk(sd, cfg)
        self.gait = bool(m.get("use_gait_feat"))
        size = cfg["crop_size"]
        grid = size // 4
        w = m["backbone_width"]
        self.hw = grid * grid
        self.c1, self.c2 = m["num_features_pare"], m["num_features_smpl"]
        self.j = m["num_joints"]
        s = cfg["smpl"]
        self.verts, self.betas = s["num_verts"], s["num_betas"]
        self.pose = 9 * (SMPL_JOINTS - 1)
        out = 4 * m["num_input_features"] * grid * grid
        self.hrnet_io = 4 * 3 * size * size + out
        self.hr_head_io = out + sum(4 * (w << i) * (grid >> i) ** 2
                                    for i in range(4))
        prec = cfg["precision"]
        self.hrnet_weights = conv_weight_bytes(sd, "backbone.", prec)
        self.hr_head_weights = conv_weight_bytes(sd, HR_HEAD, prec)

    def frame_flops(self) -> float:
        """The step's FLOPs per frame, without the corrector."""
        t = self.trunk
        f = t["backbone"] + t["head"] + t["predict"] * (2 if self.gait else 1)
        f += b1_work(1, self.hw, self.c1, self.c2, self.j)[0]
        f += b2_work(1, self.verts, self.betas, self.pose)[0]
        return f + smpl_products(1, self.verts, self.betas)

    def forward_flops(self, real: int) -> float:
        """The step's FLOPs for one forward's `real` frames."""
        f = real * self.frame_flops()
        return f + (corrector_flops(real, self.sd, self.cfg)
                    if self.gait else 0.0)

    def hrnet(self, rows: int) -> tuple:
        """(FLOPs, bytes) of the backbone, stem to upsampling head."""
        return (rows * self.trunk["backbone"],
                rows * self.hrnet_io + self.hrnet_weights)

    def hr_head(self, rows: int) -> tuple:
        """(FLOPs, bytes) of the upsampling head alone."""
        return (rows * self.trunk["hr_head"],
                rows * self.hr_head_io + self.hr_head_weights)

    def b1(self, rows: int) -> tuple:
        return b1_work(rows, self.hw, self.c1, self.c2, self.j)

    def b2(self, rows: int) -> tuple:
        return b2_work(rows, self.verts, self.betas, self.pose)
