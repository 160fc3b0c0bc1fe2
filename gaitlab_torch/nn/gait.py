"""Gait branch: GaitFeat encoder (bidirectional GRU) + temporal-spatial
attention pose-feature corrector.

Counterpart of gaitlab/nn/gait.py. Submodules carry gaitlab's Flax names
(`featnet.rnn`, `block0.mulattn.temporal.query`, ...), so that
`weights.convert.state_dict_from_flax` maps each leaf by name. What Flax
does by default and torch does not is written out here:
  * LayerNorm eps is 1e-6, GELU is the tanh approximation, the leaky ReLU
    slope is 0.05;
  * attention scales the query by 1/sqrt(head_dim), the qkv width is
    rounded down to a multiple of the head count, and masked logits are
    filled with the dtype's minimum (not -inf);
  * Flax's GRUCell has no b_hr / b_hz: the GRU's `bias_hh` holds
    [0, 0, b_hn] (the converter writes it so), and a gradient hook keeps
    training from moving the two zeros (they would double the step of
    b_ir and b_iz, which they duplicate).
The GRU is torch.nn.GRU's (cuDNN on the card); gaitlab runs it as a scan
outside any Pallas kernel. With `seq_lengths` (a tensor of real-frame
counts, read on the device: the runner pads a track to a bucket, and a
serving program takes the count at run time) every layer and direction
runs as one single-layer GRU over all T frames, the reverse direction on
each sequence's valid prefix reversed in place; so the backward direction
starts at the last real frame and the final states are the carries there,
as in Flax. Outputs at padded frames are zeros here (Flax leaves them
non-zero), and nothing downstream reads them: the runner slices them off
and temporal attention masks them as keys. The same code runs eagerly and
under `torch.export`, and it copies nothing from the host to the card.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gaitlab_torch.nn.layers import LocallyConnected

LN_EPS = 1e-6  # flax.linen.LayerNorm


def _leaky(x):
    return F.leaky_relu(x, negative_slope=0.05)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class BiGRU(nn.GRU):
    """Multi-layer bidirectional GRU, batch first.

    forward(x (B,T,C), seq_lengths (B,) int tensor or ints, or None) ->
    (outputs (B,T,2H), final states (B, num_layers*2*H) ordered [l0_fwd,
    l0_bwd, l1_fwd, ...]).
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 2):
        super().__init__(input_size, hidden_size, num_layers,
                         batch_first=True, bidirectional=True)
        h = hidden_size
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.startswith("bias_hh"):
                    p[:2 * h] = 0.0  # Flax has no b_hr, b_hz
                    p.register_hook(functools.partial(_without_rz, h))

    def forward(self, x: torch.Tensor,
                seq_lengths: Optional[torch.Tensor] = None):
        b, t, _ = x.shape
        if seq_lengths is None:
            out, h = super().forward(x)
            return out, h.permute(1, 0, 2).reshape(b, -1)
        n = torch.as_tensor(seq_lengths).to(x.device).reshape(b, 1)
        steps = torch.arange(t, device=x.device)[None]
        valid = (steps < n)[..., None]                      # (B,T,1)
        # frame t of the reversed valid prefix, padded frames in place
        rev = torch.where(steps < n, n - 1 - steps, steps)[..., None]
        h0 = x.new_zeros(1, b, self.hidden_size)
        out, finals = x, []
        for layer in range(self.num_layers):
            dirs = []
            for sfx in ("", "_reverse"):
                w = [getattr(self, f"{k}_l{layer}{sfx}") for k in
                     ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
                if x.device.type == "cuda":
                    w = _packed(w)
                xi = out.gather(1, rev.expand(b, t, out.shape[-1])) \
                    if sfx else out
                o, _ = torch._VF.gru(xi, h0, w, True, 1, 0.0, False, False,
                                     True)
                if sfx:  # back in frame order; the carry ends at frame 0
                    o = o.gather(1, rev.expand(b, t, o.shape[-1]))
                    finals.append(o[:, 0])
                else:    # the carry at the last real frame
                    finals.append(o.gather(1, (n - 1)[..., None].expand(
                        b, 1, o.shape[-1]))[:, 0])
                dirs.append(o)
            out = torch.cat(dirs, dim=-1) * valid
        return out, torch.cat(finals, dim=-1)


def _without_rz(h: int, grad: torch.Tensor) -> torch.Tensor:
    """bias_hh's gradient with its r and z parts (the first 2h) zeroed."""
    return torch.cat([torch.zeros_like(grad[:2 * h]), grad[2 * h:]])


def _packed(tensors: list) -> list:
    """Views of one new buffer holding `tensors` back to back: cuDNN's
    layout of a one-layer GRU's weights, which it then reads in place
    (from the module's own parameters it would pack them itself, and warn
    at every call)."""
    flat = torch.cat([w.reshape(-1) for w in tensors])
    return [v.view(w.shape) for v, w in zip(
        flat.split([w.numel() for w in tensors]), tensors)]


class GaitFeatEncoder(nn.Module):
    """Pose features (B,T,J,C) + camera params (B,T,3) -> pred_avg (B,3)
    walk speed and step params, pred_phase (B,T,4) tanh phase, and the
    camera-parameter embedding xc (B,T,J,C)."""

    def __init__(self, num_joints: int = 24, feat_dim: int = 128,
                 num_outputs: int = 3, estim_phase: bool = True,
                 h_size: int = 300, fc_size: int = 100, num_layers: int = 2):
        super().__init__()
        self.num_outputs = num_outputs
        self.estim_phase = estim_phase
        self.cparam_mlp = LocallyConnected(num_joints, 3, feat_dim)
        self.rnn = BiGRU(num_joints * feat_dim, h_size, num_layers)
        if num_outputs > 0:
            self.speed_fc = nn.Linear(2 * num_layers * h_size, fc_size)
            self.speed_out = nn.Linear(fc_size, 1)
            self.step_fc = nn.Linear(2 * num_layers * h_size, fc_size)
            self.step_out = nn.Linear(fc_size, 2)
        if estim_phase:
            self.phase_fc = nn.Linear(2 * h_size, fc_size)
            self.phase_out = nn.Linear(fc_size, 4)

    def forward(self, x: torch.Tensor, cparams: torch.Tensor,
                seq_lengths: Optional[torch.Tensor] = None):
        b, t, j, c = x.shape
        xc = self.cparam_mlp(cparams[:, :, None, :].expand(b, t, j, 3))
        x = x + xc
        seq, h = self.rnn(x.reshape(b, t, j * c), seq_lengths)
        pred_avg = pred_phase = None
        if self.num_outputs > 0:
            pred_avg = torch.cat(
                [self.speed_out(_leaky(self.speed_fc(h))),
                 self.step_out(_leaky(self.step_fc(h)))], dim=-1)
        if self.estim_phase:
            pred_phase = torch.tanh(self.phase_out(_leaky(self.phase_fc(seq))))
        return pred_avg, pred_phase, xc


def positional_encoding(t: int, d_model: int, dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """Sin/cos positional-encoding table (T, d_model)."""
    position = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=device)
                    * -(math.log(10000.0) / d_model))
    pe = torch.zeros(t, d_model, dtype=dtype, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div[: d_model // 2])
    return pe


def add_positional_encoding(x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, D) -> x + PE[:T]."""
    return x + positional_encoding(x.shape[1], x.shape[2], x.dtype,
                                   x.device)[None]


class MultiHeadAttention(nn.Module):
    """Self-attention as flax.linen.MultiHeadDotProductAttention computes
    it: per-head query/key/value projections with bias, query scaled by
    1/sqrt(head_dim), softmax over keys, output projection with bias.
    `mask` (broadcastable to (B, heads, Lq, Lk), True = attend)."""

    def __init__(self, in_features: int, qkv_features: int,
                 out_features: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(in_features, qkv_features)
        self.key = nn.Linear(in_features, qkv_features)
        self.value = nn.Linear(in_features, qkv_features)
        self.out = nn.Linear(qkv_features, out_features)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = (proj(x).reshape(b, n, self.num_heads, -1)
                   for proj in (self.query, self.key, self.value))
        q = q / math.sqrt(q.shape[-1])
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, v)
                        .reshape(b, n, -1))


class TSAttention(nn.Module):
    """Parallel temporal + spatial attention with learned per-channel
    mixing. x: (B, T, J+1, C) tokens; temporal attention runs over frames
    on the flattened tokens, spatial attention over the tokens of a frame.
    frame_mask (B,T) bool, True = real frame: padded frames are then no
    temporal keys and stay out of the mixing mean."""

    def __init__(self, encode_dim: int, num_heads: int, num_tokens: int = 25,
                 feat_dim: int = 128):
        super().__init__()
        d = encode_dim - encode_dim % num_heads
        flat = num_tokens * feat_dim
        self.temporal = MultiHeadAttention(flat, d, flat, num_heads)
        self.spatial = MultiHeadAttention(feat_dim, d, feat_dim, num_heads)
        self.ts_attn = nn.Linear(2 * flat, 2 * flat)

    def forward(self, x: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, nt, c = x.shape
        tmask = None if frame_mask is None else frame_mask[:, None, None, :]
        x_t = self.temporal(x.reshape(b, t, nt * c), tmask)
        x_s = self.spatial(x.reshape(b * t, nt, c)).reshape(b, t, nt * c)
        cat = torch.cat([x_t, x_s], dim=-1)
        if frame_mask is None:
            alpha = cat.mean(dim=1, keepdim=True)
        else:
            w = frame_mask[..., None].to(cat.dtype)
            alpha = ((cat * w).sum(dim=1, keepdim=True)
                     / w.sum(dim=1, keepdim=True).clamp_min(1.0))
        alpha = torch.softmax(self.ts_attn(alpha).reshape(b, 1, nt * c, 2),
                              dim=-1)
        return (x_t * alpha[..., 0] + x_s * alpha[..., 1]).reshape(b, t, nt, c)


class TSAttnBlock(nn.Module):
    """Attention + feed-forward block with post-norm residuals; the
    feed-forward is per token (jwff: unshared weights) or shared (pwff)."""

    def __init__(self, encode_dim: int, num_heads: int, use_jwff: bool = False,
                 num_tokens: int = 25, feat_dim: int = 128):
        super().__init__()
        c = feat_dim
        self.use_jwff = use_jwff
        self.mulattn = TSAttention(encode_dim, num_heads, num_tokens, c)
        self.norm1 = nn.LayerNorm(c, eps=LN_EPS)
        if use_jwff:
            self.jwff1 = LocallyConnected(num_tokens, c, c // 2, bias=True)
            self.jwff2 = LocallyConnected(num_tokens, c // 2, c, bias=True)
        else:
            self.pwff1 = nn.Linear(c, c // 2)
            self.pwff2 = nn.Linear(c // 2, c)
        self.norm2 = nn.LayerNorm(c, eps=LN_EPS)

    def forward(self, x: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.norm1(x + self.mulattn(x, frame_mask))
        if self.use_jwff:
            out = self.jwff2(_gelu(self.jwff1(x)))
        else:
            out = self.pwff2(_gelu(self.pwff1(x)))
        return self.norm2(x + out)


class FeatCorrector(nn.Module):
    """Pose-feature correction from estimated gait features.

    forward(x (B,T,J,C) pose features, cparams (B,T,3), seq_lengths) ->
    (corrected (B,T,J,C), pred_avg (B,3), pred_phase (B,T,4)).
    With `stop_gaitfeat_grad` (the default, as in gaitlab) the corrector
    does not back-drive the gait estimates; the gait trainer turns it off."""

    def __init__(self, num_joints: int = 24, feat_dim: int = 128,
                 num_avg_gfeat: int = 3, estim_phase: bool = True,
                 num_layers: int = 1, h_size: int = 1024, num_heads: int = 4,
                 use_jwff: bool = False, stop_gaitfeat_grad: bool = True):
        super().__init__()
        c = feat_dim
        self.estim_phase = estim_phase
        self.stop_gaitfeat_grad = stop_gaitfeat_grad
        self.num_layers = num_layers
        self.featnet = GaitFeatEncoder(num_joints, c, num_avg_gfeat,
                                       estim_phase)
        self.gfeat_fc = nn.Linear(num_avg_gfeat + 4 * estim_phase, c // 2)
        self.gfeat_token = nn.Linear(c // 2, c)
        for i in range(num_layers):
            self.add_module(f"block{i}", TSAttnBlock(
                h_size, num_heads, use_jwff, num_joints + 1, c))

    def forward(self, x: torch.Tensor, cparams: torch.Tensor,
                seq_lengths: Optional[torch.Tensor] = None):
        b, t, j, c = x.shape
        frame_mask = None
        if seq_lengths is not None:
            n = torch.as_tensor(seq_lengths).to(x.device).reshape(b, 1)
            frame_mask = torch.arange(t, device=x.device)[None] < n
        pred_avg, pred_phase, _ = self.featnet(x, cparams, seq_lengths)

        # the two phase 2-vectors on the unit circle
        raw = pred_avg[:, None, :].expand(b, t, pred_avg.shape[-1])
        if self.estim_phase:
            def unit(v):
                return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True)
                            + 1e-12)

            raw = torch.cat([raw, unit(pred_phase[..., :2]),
                             unit(pred_phase[..., 2:])], dim=-1)
        if self.stop_gaitfeat_grad:
            raw = raw.detach()

        gtok = self.gfeat_token(_leaky(self.gfeat_fc(raw)))
        y = torch.cat([x, gtok[:, :, None, :]], dim=2)  # (B,T,J+1,C)
        for i in range(self.num_layers):
            y = getattr(self, f"block{i}")(y, frame_mask)
        return x + y[:, :, :j, :], pred_avg, pred_phase


def camera_reparam(pred_cam: torch.Tensor, bbox: torch.Tensor,
                   cimg: torch.Tensor) -> torch.Tensor:
    """Crop-frame weak-perspective cam -> image-frame cparams.

    pred_cam (N,3); bbox (N,4) [cx,cy,w,h]; cimg (N,2) image center."""
    bs = bbox[..., 2] / 224.0
    t_bb = bbox[..., :2] - cimg
    scale = bs.reshape(-1, 1) * pred_cam[:, 0:1]
    return torch.cat([scale, t_bb.reshape(-1, 2) / scale / 112.0
                      + pred_cam[:, 1:]], dim=-1)
