"""HMR 2.0 in plain PyTorch, float32 (the caller sets TF32 off), from the
benchmark's state dict in 4D-Humans' key layout (Goel et al., ICCV 2023;
4D-Humans hmr2/models/backbones/vit.py, heads/smpl_head.py,
components/pose_transformer.py): ViT-H/16 in ViTPose's layout on
x[..., c/8:-c/8] of the c x c crop, the transformer decoder head with
IEF_ITERS 1 on one zero token, HMR 2.0's 6D layout and camera, then SMPL
(reference/smpl.py) with the projection at the crop's size. A track runs
through reference/crop.py's host crops in blocks of frames.

Departures from 4D-Humans, each the program's as well:
  * the runner's square crop of the track's box, not 4D-Humans' fit of the
    box to 192:256;
  * 2D joints in [-1, 1] crop units (projected / (c / 2)); HMR 2.0 divides
    by c, to [-0.5, 0.5]: a factor 2 on joints2d only;
  * the `spin2` joint set (reference/smpl.py), not HMR 2.0's 44 joints;
  * the mean parameters (smpl_mean_params.npz is not in the repository):
    the identity pose, zero betas and camera [0.9, 0, 0].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import crop, smpl as smpl_ref

VIT_EPS, DEC_EPS = 1e-6, 1e-5
MEAN_POSE_6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)
MEAN_CAM = (0.9, 0.0, 0.0)


def _ln(sd, p, x, eps):
    return F.layer_norm(x, x.shape[-1:], sd[p + ".weight"], sd[p + ".bias"],
                        eps)


def _lin(sd, p, x):
    return F.linear(x, sd[p + ".weight"], sd.get(p + ".bias"))


def vit(sd: dict, m: dict, x: torch.Tensor) -> torch.Tensor:
    """ViTPose's forward_features: (B, 3, H, W) -> (B, C, Hp, Wp)."""
    p = "backbone."
    b = x.shape[0]
    x = F.conv2d(x, sd[p + "patch_embed.proj.weight"],
                 sd[p + "patch_embed.proj.bias"], stride=m["patch"],
                 padding=m["patch_padding"])
    hp, wp = x.shape[2:]
    x = x.flatten(2).transpose(1, 2)
    pos = sd[p + "pos_embed"]
    x = x + pos[:, 1:] + pos[:, :1]
    heads = m["heads"]
    for i in range(m["depth"]):
        q = f"{p}blocks.{i}."
        y = _ln(sd, q + "norm1", x, VIT_EPS)
        n, c = y.shape[1:]
        qkv = _lin(sd, q + "attn.qkv", y).reshape(b, n, 3, heads, -1
                                                  ).permute(2, 0, 3, 1, 4)
        qq = qkv[0] * (c // heads) ** -0.5
        attn = (qq @ qkv[1].transpose(-2, -1)).softmax(dim=-1)
        y = (attn @ qkv[2]).transpose(1, 2).reshape(b, n, c)
        x = x + _lin(sd, q + "attn.proj", y)
        y = _ln(sd, q + "norm2", x, VIT_EPS)
        x = x + _lin(sd, q + "mlp.fc2", F.gelu(_lin(sd, q + "mlp.fc1", y)))
    x = _ln(sd, p + "last_norm", x, VIT_EPS)
    return x.permute(0, 2, 1).reshape(b, -1, hp, wp)


def _split_heads(t, heads):
    b, n, _ = t.shape
    return t.reshape(b, n, heads, -1).permute(0, 2, 1, 3)


def _attend(q, k, v, scale):
    dots = (q @ k.transpose(-1, -2)) * scale
    out = dots.softmax(dim=-1) @ v
    b, h, n, d = out.shape
    return out.permute(0, 2, 1, 3).reshape(b, n, h * d)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """HMR 2.0's 6D layout (two rows of 3) -> (N, 3, 3)."""
    x = x.reshape(-1, 2, 3).permute(0, 2, 1).contiguous()
    a1, a2 = x[:, :, 0], x[:, :, 1]
    b1 = F.normalize(a1)
    b2 = F.normalize(a2 - torch.einsum("bi,bi->b", b1, a2).unsqueeze(-1)
                     * b1)
    return torch.stack((b1, b2, torch.linalg.cross(b1, b2, dim=-1)), dim=-1)


def decoder_head(sd: dict, m: dict, feats: torch.Tensor) -> tuple:
    """SMPLTransformerDecoderHead, IEF_ITERS 1: (B, C, Hp, Wp) ->
    (rotations (B,24,3,3), betas (B,10), camera (B,3))."""
    p = "smpl_head."
    b = feats.shape[0]
    context = feats.flatten(2).transpose(1, 2)  # b c h w -> b (h w) c
    heads = m["dec_heads"]
    scale = m["dec_head_dim"] ** -0.5
    token = feats.new_zeros(b, 1, 1)
    x = _lin(sd, p + "transformer.to_token_embedding", token)
    x = x + sd[p + "transformer.pos_embedding"][:, :1]
    for i in range(m["dec_depth"]):
        q = f"{p}transformer.transformer.layers.{i}."
        y = _ln(sd, q + "0.norm", x, DEC_EPS)
        qq, kk, vv = (_split_heads(t, heads) for t in
                      _lin(sd, q + "0.fn.to_qkv", y).chunk(3, dim=-1))
        x = _lin(sd, q + "0.fn.to_out.0", _attend(qq, kk, vv, scale)) + x
        y = _ln(sd, q + "1.norm", x, DEC_EPS)
        kk, vv = (_split_heads(t, heads) for t in
                  _lin(sd, q + "1.fn.to_kv", context).chunk(2, dim=-1))
        qq = _split_heads(_lin(sd, q + "1.fn.to_q", y), heads)
        x = _lin(sd, q + "1.fn.to_out.0", _attend(qq, kk, vv, scale)) + x
        y = _ln(sd, q + "2.norm", x, DEC_EPS)
        x = _lin(sd, q + "2.fn.net.3",
                 F.gelu(_lin(sd, q + "2.fn.net.0", y))) + x
    token = x.squeeze(1)
    dev = feats.device
    pose = _lin(sd, p + "decpose", token) + torch.tensor(
        MEAN_POSE_6D * 24, device=dev)
    betas = _lin(sd, p + "decshape", token)
    cam = _lin(sd, p + "deccam", token) + torch.tensor(MEAN_CAM, device=dev)
    return rot6d_to_rotmat(pose).view(b, 24, 3, 3), betas, cam


def trunk(sd: dict, cfg: dict, x: torch.Tensor) -> tuple:
    """(N, 3, c, c) normalized crops -> (rotations, betas, camera)."""
    cut = cfg["crop_size"] // 8
    return decoder_head(sd, cfg["model"], vit(sd, cfg["model"],
                                              x[..., cut:-cut]))


def regress(smpl: dict, rot, betas, cam, img_res: int) -> dict:
    """SMPL, the spin2 joints and their projection at HMR 2.0's camera
    [tx, ty, 2 f / (img_res s + 1e-9)], in [-1, 1] crop units."""
    verts, joints24 = smpl_ref.lbs(smpl, betas, rot)
    hands = verts[:, list(smpl_ref.HAND_TIP_VERTS)]
    thorax = torch.einsum("v,nvk->nk",
                          smpl["J_regressor_extra"][smpl_ref.THORAX_ROW],
                          verts)[:, None]
    joints = torch.cat([joints24, hands, thorax], dim=1)
    tz = 2 * smpl_ref.FOCAL / (img_res * cam[:, 0] + 1e-9)
    p = joints + torch.stack([cam[:, 1], cam[:, 2], tz], dim=-1)[:, None]
    joints2d = p[..., :2] / p[..., 2:3] * smpl_ref.FOCAL / (img_res / 2)
    return {"verts": verts, "joints3d": joints, "joints2d": joints2d}


@torch.no_grad()
def run_track(sd: dict, smpl: dict, cfg: dict, track, block: int,
              device) -> dict:
    """One track (inputs.Track) in blocks of `block` frames -> numpy
    {"pose_rotmat" (N,24,3,3), "betas", "pred_cam", "verts", "joints3d",
    "joints2d"}."""
    size = cfg["crop_size"]
    frames, boxes = track.frames(), track.boxes
    outs = []
    for s in range(0, len(boxes), block):
        x = crop.normalize(crop.crops_uint8(frames[s:s + block],
                                            boxes[s:s + block], size), device)
        rot, betas, cam = trunk(sd, cfg, x)
        out = {"pose_rotmat": rot, "betas": betas, "pred_cam": cam,
               **regress(smpl, rot, betas, cam, size)}
        outs.append({k: v.cpu() for k, v in out.items()})
    return {k: torch.cat([o[k] for o in outs]).numpy() for k in outs[0]}
