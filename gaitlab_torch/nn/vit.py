"""ViT in ViTPose's layout: HMR 2.0's trunk (4D-Humans,
hmr2/models/backbones/vit.py, ViT-H/16: width 1280, 32 blocks, 16 heads
of 80, MLP 5120, input 256x192).

  tokens = PatchEmbed(x) + pos_embed[:, 1:] + pos_embed[:, :1]
  for each block:  x += attn(norm1(x));  x += mlp(norm2(x))
  tokens = last_norm(x)

with a 16x16 patch embedding of stride 16 and padding 2 (16x12 = 192
tokens at 256x192), pre-LayerNorms of eps 1e-6, attention with a qkv bias
and scale head_dim^-0.5, an exact-GELU MLP; drop-path is the identity at
inference. Module and parameter names are 4D-Humans', so its checkpoint's
`backbone.*` keys name the same tensors. The published forward returns
the tokens reshaped to (B, C, Hp, Wp), which its head flattens back; the
port hands the (B, Hp*Wp, C) tokens on as they are.

Every product follows the thread's precision mode (nn/layers.py):
`Conv2d` for the patch embedding, `BlockLinear` for the blocks' four
linears, `attention` for the two batched products of each head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gaitlab_torch.nn.layers import (Conv2d, Linear, full_float32,
                                     matmul_passes)
from gaitlab_torch.ops.vit_linear import vit_linear_f32

LN_EPS = 1e-6


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """softmax((q * scale) k^T) v over (B, heads, tokens, head_dim)
    tensors, as two batched products and ATen's softmax: cuBLAS's
    strided-batched SGEMM under "float32" (TF32 off), one TF32 pass under
    "default", the split passes under "high". This is the arithmetic of
    scaled_dot_product_attention's math backend; its flash backend has no
    float32 path and its memory-efficient one multiplies float32 on the
    tensor cores (3xTF32), so neither is plain float32."""
    logits = matmul_passes(q * scale, k.transpose(-2, -1))
    return matmul_passes(logits.softmax(dim=-1), v)


class BlockLinear(Linear):
    """`Linear` of a block (qkv, proj, fc1, fc2): a float32 product on the
    card in a segment at full float32 runs on the op gaitlab::vit_linear_f32
    (ops/vit_linear.py: three TF32 passes on the tensor cores, in place of
    cuBLAS's FFMA SGEMM); every other mode, dtype and device is
    `Linear`'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (x.is_cuda and x.dtype == self.weight.dtype == torch.float32
                and full_float32()):
            return vit_linear_f32(x, self.weight, self.bias)
        return super().forward(x)


class PatchEmbed(nn.Module):
    def __init__(self, img_size: tuple, patch: int, padding: int,
                 width: int, in_chans: int = 3):
        super().__init__()
        self.proj = Conv2d(in_chans, width, patch, stride=patch,
                           padding=padding)
        self.grid = tuple((s + 2 * padding - patch) // patch + 1
                          for s in img_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, Hp*Wp, width)."""
        return self.proj(x).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.scale = (width // heads) ** -0.5
        self.qkv = BlockLinear(width, 3 * width, bias=True)
        self.proj = BlockLinear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads
                                  ).permute(2, 0, 3, 1, 4)
        out = attention(qkv[0], qkv[1], qkv[2], self.scale)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = BlockLinear(width, hidden)
        self.fc2 = BlockLinear(hidden, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, width: int, heads: int, mlp: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = Attention(width, heads)
        self.norm2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = Mlp(width, mlp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """The trunk at any size: the CPU tests build it tiny. `img_size` is
    (H, W) of its input."""

    def __init__(self, img_size: tuple = (256, 192), patch: int = 16,
                 padding: int = 2, width: int = 1280, depth: int = 32,
                 heads: int = 16, mlp: int = 5120):
        super().__init__()
        self.patch_embed = PatchEmbed(img_size, patch, padding, width)
        hp, wp = self.patch_embed.grid
        self.pos_embed = nn.Parameter(torch.zeros(1, hp * wp + 1, width))
        self.blocks = nn.ModuleList(Block(width, heads, mlp)
                                    for _ in range(depth))
        self.last_norm = nn.LayerNorm(width, eps=LN_EPS)

    @property
    def num_tokens(self) -> int:
        return self.pos_embed.shape[1] - 1

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) images -> (B, tokens, width), position added."""
        t = self.patch_embed(x)
        return t + self.pos_embed[:, 1:] + self.pos_embed[:, :1]

    def run_blocks(self, t: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            t = blk(t)
        return self.last_norm(t)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.run_blocks(self.embed(x))
