"""Nominal FLOPs and least bytes of the HMR 2.0 step (arch/hmr2.py's
`counts`), from the configuration's sizes alone, frozen here so that the
program cannot change its own yardstick.

FLOPs are 2 per multiply-add of the published layers in direct form: per
frame the patch embedding (a 16x16 convolution over the 16x12 output
positions), each block's qkv, projection and two MLP products, the
attention's two batched products (n^2 x width each), the decoder's
products on its one token (self-attention, cross-attention with `to_kv`
over the trunk's n tokens, feed-forward; the token embedding of the zero
input, which FlopCounterMode counts too) and the three regressors; SMPL's
come from counts/smpl.py. LayerNorm, softmax and GELU count none.

The ViT's least bytes (`vit`): each forward reads its crops' middle
columns and writes its tokens once, and reads the ViT's weights once at
the configuration's precision; no activation between layers counts, as a
fused kernel would not move it."""

from __future__ import annotations

from benchmark.counts.flops import BYTES_PER_VALUE
from benchmark.counts.smpl import SMPL_JOINTS, b2_work, smpl_products


def grid(cfg: dict) -> tuple:
    """The ViT's (Hp, Wp) token grid: the patch embedding's output over
    the crop's middle 3/4 of the columns."""
    m = cfg["model"]
    size = cfg["crop_size"]
    p, pad = m["patch"], m["patch_padding"]
    return tuple((s + 2 * pad - p) // p + 1 for s in (size, size * 3 // 4))


class StepCounts:
    def __init__(self, cfg: dict, sd: dict):
        m, s = cfg["model"], cfg["smpl"]
        self.cfg = cfg
        hp, wp = grid(cfg)
        n = self.tokens = hp * wp
        w, p = m["width"], m["patch"]
        self.embed = 2.0 * n * w * 3 * p * p
        block = 2.0 * n * w * (3 * w + w + 2 * m["mlp"])
        self.vit_linear = self.embed + m["depth"] * block
        self.vit_attention = m["depth"] * 2 * 2.0 * n * n * w
        d, inner = m["dec_width"], m["dec_heads"] * m["dec_head_dim"]
        layer = (2.0 * d * 3 * inner + 2 * 2.0 * inner + 2.0 * inner * d
                 + 2.0 * d * inner + 2.0 * n * w * 2 * inner
                 + 2 * 2.0 * n * inner + 2.0 * inner * d
                 + 2 * 2.0 * d * m["dec_mlp"])
        regressors = 2.0 * d * (6 * m["num_joints"] + m["num_betas"] + 3)
        self.decoder = 2.0 * d + m["dec_depth"] * layer + regressors
        size = cfg["crop_size"]
        bpv = BYTES_PER_VALUE[cfg["precision"]]
        self.vit_io = bpv * (3 * size * (size * 3 // 4) + n * w)
        self.vit_weights = bpv * sum(v.numel() for k, v in sd.items()
                                     if k.startswith("backbone."))
        self.verts, self.betas = s["num_verts"], s["num_betas"]
        self.pose = 9 * (SMPL_JOINTS - 1)

    def trunk_flops(self) -> float:
        """The ViT's and the decoder's FLOPs per frame."""
        return self.vit_linear + self.vit_attention + self.decoder

    def frame_flops(self) -> float:
        return (self.trunk_flops() + b2_work(1, self.verts, self.betas,
                                             self.pose)[0]
                + smpl_products(1, self.verts, self.betas))

    def forward_flops(self, real: int) -> float:
        """The step's FLOPs for one forward's `real` frames."""
        return real * self.frame_flops()

    def vit(self, rows: int) -> tuple:
        """(FLOPs, bytes) of the ViT, patch embedding to last norm."""
        return (rows * (self.vit_linear + self.vit_attention),
                rows * self.vit_io + self.vit_weights)

    def b2(self, rows: int) -> tuple:
        return b2_work(rows, self.verts, self.betas, self.pose)
