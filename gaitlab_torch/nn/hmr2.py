"""HMR 2.0 (Goel et al., "Humans in 4D", ICCV 2023; 4D-Humans,
hmr2/models/heads/smpl_head.py and components/pose_transformer.py): the
ViT-H trunk (nn/vit.py) on the middle three quarters of the crop's
columns, then `SMPLTransformerDecoderHead` with IEF_ITERS 1:

  token = to_token_embedding(zeros (B, 1, 1)) + pos_embedding
  6 x: token += SelfAttn(LN(token)); token += CrossAttn(LN(token), tokens);
       token += FF(LN(token))
  pose  = decpose(token) + init_body_pose      (6D, 24 joints)
  betas = decshape(token) + init_betas
  cam   = deccam(token) + init_cam              ([s, tx, ty])

with LayerNorms of eps 1e-5, 8 heads of 64 (self-attention `to_qkv`
1024->1536 and cross-attention `to_q` 1024->512, `to_kv` 1280->1024, all
without bias; `to_out` 512->1024), a GELU feed-forward 1024->1024->1024,
and HMR 2.0's 6D layout: two rows of 3, `reshape(-1, 2, 3).permute(0, 2,
1)`, whose identity is [1, 0, 0, 0, 1, 0] (the port's
geometry.rot6d_to_rotmat reads SPIN's three rows of 2). Its camera is
[tx, ty, 2 f / (img_res s + 1e-9)] at f = 5000 and img_res = the crop,
which is vp_regress's at `img_res` 256. Module names are 4D-Humans', with
`backbone` the ViT and `smpl_head` the decoder head; the mean parameters
are the head's buffers `init_body_pose`, `init_betas`, `init_cam`.

`HMR2Core` is the trunk the runner takes (pipeline/runner.py's trunk
protocol): `use_gait_feat` False, `img_res`, `at_modes`, `segments` and
`run_segments` over the segments embed, blocks and decoder, each a span
`model/<segment>` with its rows and tokens. `GRNet.create(trunk=HMR2Core)`
makes a model of it: the same bundle, runner, SMPL regression and outputs
as GRNet's.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gaitlab_torch.nn.layers import Linear, check_mode, precision_scope
from gaitlab_torch.nn.vit import ViT, attention
from gaitlab_torch.utils import span

DEC_LN_EPS = 1e-5
IDENTITY_6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)
# the mean parameters where 4D-Humans loads smpl_mean_params.npz: the
# identity pose, zero betas and PARE's and SPIN's initial camera
MEAN_CAM = (0.9, 0.0, 0.0)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """(..., 6) in HMR 2.0's layout (two rows of 3: the first two columns
    of the rotation) -> (N, 3, 3) by Gram-Schmidt, F.normalize's eps."""
    x = x.reshape(-1, 2, 3).transpose(1, 2)
    a1, a2 = x[..., 0], x[..., 1]
    b1 = F.normalize(a1, dim=-1)
    b2 = F.normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1, dim=-1)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2)], dim=-1)


def mean_params(num_joints: int = 24, num_betas: int = 10) -> dict:
    """The head's mean-parameter buffers as the port assumes them
    (4D-Humans loads smpl_mean_params.npz, which is not in the
    repository): the identity pose, zero betas and camera MEAN_CAM."""
    return {"init_body_pose": torch.tensor(IDENTITY_6D * num_joints)[None],
            "init_betas": torch.zeros(1, num_betas),
            "init_cam": torch.tensor(MEAN_CAM)[None]}


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=DEC_LN_EPS)
        self.fn = fn

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        return self.fn(self.norm(x), **kw)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, H*D) -> (B, H, N, D)."""
    b, n, _ = t.shape
    return t.reshape(b, n, heads, -1).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) -> (B, N, H*D)."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        self.heads, self.scale = heads, head_dim ** -0.5
        self.to_qkv = Linear(dim, 3 * heads * head_dim, bias=False)
        self.to_out = nn.Sequential(Linear(heads * head_dim, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_heads(t, self.heads)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        return self.to_out(_merge(attention(q, k, v, self.scale)))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int,
                 head_dim: int):
        super().__init__()
        self.heads, self.scale = heads, head_dim ** -0.5
        self.to_kv = Linear(context_dim, 2 * heads * head_dim, bias=False)
        self.to_q = Linear(dim, heads * head_dim, bias=False)
        self.to_out = nn.Sequential(Linear(heads * head_dim, dim))

    def forward(self, x: torch.Tensor, context: torch.Tensor
                ) -> torch.Tensor:
        k, v = (_heads(t, self.heads)
                for t in self.to_kv(context).chunk(2, dim=-1))
        q = _heads(self.to_q(x), self.heads)
        return self.to_out(_merge(attention(q, k, v, self.scale)))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        # 4D-Humans' indices (its dropouts at 2 and 4), so that its
        # checkpoint's net.0 and net.3 keys load
        self.net = nn.Sequential(Linear(dim, hidden), nn.GELU(),
                                 nn.Identity(), Linear(hidden, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class TransformerDecoder(nn.Module):
    """4D-Humans' TransformerDecoder with one token and its
    TransformerCrossAttn layers (no final norm)."""

    def __init__(self, dim: int, depth: int, heads: int, head_dim: int,
                 mlp: int, context_dim: int, token_dim: int = 1):
        super().__init__()
        self.to_token_embedding = Linear(token_dim, dim)
        self.pos_embedding = nn.Parameter(torch.randn(1, 1, dim))
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(nn.ModuleList([
            PreNorm(dim, SelfAttention(dim, heads, head_dim)),
            PreNorm(dim, CrossAttention(dim, context_dim, heads, head_dim)),
            PreNorm(dim, FeedForward(dim, mlp))]) for _ in range(depth))

    def forward(self, inp: torch.Tensor, context: torch.Tensor
                ) -> torch.Tensor:
        x = self.to_token_embedding(inp) + self.pos_embedding
        for self_attn, cross_attn, ff in self.transformer.layers:
            x = self_attn(x) + x
            x = cross_attn(x, context=context) + x
            x = ff(x) + x
        return x


class DecoderHead(nn.Module):
    """SMPLTransformerDecoderHead: the zero token through the decoder over
    the trunk's tokens, then one correction of the mean parameters."""

    def __init__(self, context_dim: int = 1280, dim: int = 1024,
                 depth: int = 6, heads: int = 8, head_dim: int = 64,
                 mlp: int = 1024, num_joints: int = 24, num_betas: int = 10):
        super().__init__()
        self.transformer = TransformerDecoder(dim, depth, heads, head_dim,
                                              mlp, context_dim)
        self.decpose = Linear(dim, 6 * num_joints)
        self.decshape = Linear(dim, num_betas)
        self.deccam = Linear(dim, 3)
        for name, value in mean_params(num_joints, num_betas).items():
            self.register_buffer(name, value)

    def forward(self, tokens: torch.Tensor) -> dict:
        """(B, N, context_dim) -> {"pred_pose" (B,24,3,3), "pred_shape",
        "pred_cam"}."""
        n = tokens.shape[0]
        token = self.transformer(tokens.new_zeros(n, 1, 1), tokens)[:, 0]
        pose = self.decpose(token) + self.init_body_pose
        betas = self.decshape(token) + self.init_betas
        cam = self.deccam(token) + self.init_cam
        return {"pred_pose": rot6d_to_rotmat(pose).reshape(n, -1, 3, 3),
                "pred_shape": betas, "pred_cam": cam}


SEGMENTS = ("embed", "blocks", "decoder")


class HMR2Core(nn.Module):
    """The ViT trunk and the decoder head: normalized (N, 3, img_res,
    img_res) crops -> vp_regress's keys. The sizes default to the
    published ones and exist so that tests can build small models; the
    ViT sees the crop's middle 3/4 of the columns (192 of 256).

    Precision (nn/layers.py's modes): `precision` runs the embedding and
    the blocks, `head_precision` (None: inherit) the decoder, each segment
    in its own precision_scope; `at_modes` makes a view at other modes.
    The trunk computes in its weights' dtype (bf16 under the runner's
    trunk_dtype)."""

    use_gait_feat = False

    def __init__(self, img_res: int = 256, width: int = 1280,
                 depth: int = 32, heads: int = 16, mlp: int = 5120,
                 patch: int = 16, patch_padding: int = 2,
                 dec_width: int = 1024, dec_depth: int = 6,
                 dec_heads: int = 8, dec_head_dim: int = 64,
                 dec_mlp: int = 1024, num_joints: int = 24,
                 num_betas: int = 10):
        super().__init__()
        if img_res % 8:
            raise ValueError(f"img_res={img_res}: the ViT takes the middle "
                             "3/4 of the columns, so it must divide by 8")
        self.img_res = img_res
        self.precision = "float32"
        self.head_precision: Optional[str] = None
        self.backbone = ViT((img_res, img_res * 3 // 4), patch,
                            patch_padding, width, depth, heads, mlp)
        self.smpl_head = DecoderHead(width, dec_width, dec_depth, dec_heads,
                                     dec_head_dim, dec_mlp, num_joints,
                                     num_betas)

    def at_modes(self, precision: str, head_precision: Optional[str]
                 ) -> "HMR2Core":
        """This trunk at the runner's modes: itself when it runs at them
        already, else a shallow copy sharing every parameter and buffer."""
        check_mode(precision)
        if head_precision is not None:
            check_mode(head_precision)
        if (precision, head_precision) == (self.precision,
                                           self.head_precision):
            return self
        core = copy.copy(self)
        core.precision, core.head_precision = precision, head_precision
        return core

    def segments(self) -> list:
        """The forward's precision segments in order, as (name, mode)."""
        return [("embed", self.precision), ("blocks", self.precision),
                ("decoder", self.head_precision or self.precision)]

    def run_segments(self, carry: dict, names) -> dict:
        """Run the named segments on a carry dict: {"x": images} before the
        first, {"x": tokens} between them, vp_regress's keys after the
        decoder. Each segment is a span `model/<name>` with its rows and
        the tokens it computes."""
        modes = dict(self.segments())
        for name in names:
            rows = carry["x"].shape[0]
            tokens = rows * (1 if name == "decoder"
                             else self.backbone.num_tokens)
            with span("model/" + name, rows=rows, tokens=tokens), \
                    precision_scope(modes[name]):
                carry = self._segment(name, carry["x"])
        return carry

    def _segment(self, name: str, x: torch.Tensor) -> dict:
        if name == "embed":
            if tuple(x.shape[-2:]) != (self.img_res, self.img_res):
                raise ValueError(f"HMR 2.0 takes {self.img_res}-px crops, "
                                 f"got {tuple(x.shape[-2:])}: give the "
                                 f"runner crop_size={self.img_res}")
            cut = self.img_res // 8
            x = x[..., cut:-cut].to(self.backbone.pos_embed.dtype)
            return {"x": self.backbone.embed(x)}
        if name == "blocks":
            return {"x": self.backbone.run_blocks(x)}
        if name == "decoder":
            return self.smpl_head(x)
        raise ValueError(f"segment {name!r}")

    def forward(self, images: torch.Tensor) -> dict:
        """images: (N, 3, img_res, img_res) normalized crops."""
        return self.run_segments({"x": images}, SEGMENTS)

