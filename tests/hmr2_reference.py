"""HMR 2.0 in plain PyTorch, float32 with TF32 off: the plain reference that
tests/test_torch_hmr2.py holds gaitlab_torch/nn/hmr2.py against. It
imports nothing of gaitlab, gaitlab_torch or JAX, runs every frame the
same way (no batching tricks) from a state dict in 4D-Humans' key layout,
and follows the published equations (Goel et al., ICCV 2023;
4D-Humans hmr2/models/backbones/vit.py, heads/smpl_head.py,
components/pose_transformer.py): the ViT-H trunk in ViTPose's layout on
x[..., c/8:-c/8] of a c x c crop, the transformer decoder head with
IEF_ITERS 1 on one zero token, HMR 2.0's 6D layout and camera, then SMPL.

Departures from 4D-Humans, each the port's as well:
  * the runner's square crop of the track's box, not 4D-Humans' fit of the
    box to 192:256;
  * 2D joints in the port's [-1, 1] crop units (projected / (c / 2));
    HMR 2.0 divides by c, to [-0.5, 0.5]: a factor 2 on kp_2d only;
  * the port's `spin2` joint set (SMPL's 24, both thumbs and middle
    fingertips, the MPII thorax), not HMR 2.0's 44 joints, so that the
    downstream convert_kps calls stay as they are;
  * the mean parameters (smpl_mean_params.npz is not in the repository):
    the identity pose, zero betas and camera [0.9, 0, 0].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

VIT_EPS, DEC_EPS = 1e-6, 1e-5
FOCAL = 5000.0
PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16,
           17, 18, 19, 20, 21)
HAND_TIP_VERTS = (2746, 2445, 6191, 5905)  # thumbs and middle fingertips
THORAX_ROW = 5  # of J_regressor_extra: the MPII thorax
MEAN_POSE_6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)
MEAN_CAM = (0.9, 0.0, 0.0)


class tf32_off:
    """TF32 off for cuDNN and cuBLAS inside the block."""

    def __enter__(self):
        self.old = (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.old


def _ln(sd, p, x, eps):
    return F.layer_norm(x, x.shape[-1:], sd[p + ".weight"], sd[p + ".bias"],
                        eps)


def _lin(sd, p, x):
    return F.linear(x, sd[p + ".weight"], sd.get(p + ".bias"))


def vit(sd: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """ViTPose's forward_features: (B, 3, H, W) -> (B, C, Hp, Wp)."""
    p = "backbone."
    b = x.shape[0]
    x = F.conv2d(x, sd[p + "patch_embed.proj.weight"],
                 sd[p + "patch_embed.proj.bias"], stride=cfg["patch"],
                 padding=cfg["patch_padding"])
    hp, wp = x.shape[2:]
    x = x.flatten(2).transpose(1, 2)
    pos = sd[p + "pos_embed"]
    x = x + pos[:, 1:] + pos[:, :1]
    heads = cfg["heads"]
    for i in range(cfg["depth"]):
        q = f"{p}blocks.{i}."
        y = _ln(sd, q + "norm1", x, VIT_EPS)
        n, c = y.shape[1:]
        qkv = _lin(sd, q + "attn.qkv", y).reshape(b, n, 3, heads, -1
                                                  ).permute(2, 0, 3, 1, 4)
        qq, kk, vv = qkv[0], qkv[1], qkv[2]
        qq = qq * (c // heads) ** -0.5
        attn = (qq @ kk.transpose(-2, -1)).softmax(dim=-1)
        y = (attn @ vv).transpose(1, 2).reshape(b, n, c)
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
    """HMR 2.0's: (.., 6) -> (N, 3, 3)."""
    x = x.reshape(-1, 2, 3).permute(0, 2, 1).contiguous()
    a1, a2 = x[:, :, 0], x[:, :, 1]
    b1 = F.normalize(a1)
    b2 = F.normalize(a2 - torch.einsum("bi,bi->b", b1, a2).unsqueeze(-1)
                     * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack((b1, b2, b3), dim=-1)


def decoder_head(sd: dict, cfg: dict, feats: torch.Tensor) -> tuple:
    """SMPLTransformerDecoderHead, IEF_ITERS 1: (B, C, Hp, Wp) ->
    (rotations (B,24,3,3), betas (B,10), camera (B,3))."""
    p = "smpl_head."
    b = feats.shape[0]
    context = feats.flatten(2).transpose(1, 2)  # b c h w -> b (h w) c
    heads = cfg["dec_heads"]
    scale = cfg["dec_head_dim"] ** -0.5
    token = feats.new_zeros(b, 1, 1)
    x = _lin(sd, p + "transformer.to_token_embedding", token)
    x = x + sd[p + "transformer.pos_embedding"][:, :1]
    for i in range(cfg["dec_depth"]):
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


def lbs(smpl: dict, betas, rot):
    """SMPL's linear blend skinning: (vertices (N,V,3), joints (N,24,3))."""
    n = betas.shape[0]
    v_shaped = smpl["v_template"] + torch.einsum("vks,ns->nvk",
                                                 smpl["shapedirs"], betas)
    rest = torch.einsum("jv,nvk->njk", smpl["J_regressor"], v_shaped)
    eye = torch.eye(3, device=rot.device, dtype=rot.dtype)
    pose_feature = (rot[:, 1:] - eye).reshape(n, -1)
    v_posed = v_shaped + (pose_feature @ smpl["posedirs"]).reshape(n, -1, 3)
    rel = rest.clone()
    rel[:, 1:] -= rest[:, list(PARENTS[1:])]
    mats = torch.zeros((n, 24, 4, 4), device=rot.device, dtype=rot.dtype)
    mats[:, :, :3, :3] = rot
    mats[:, :, :3, 3] = rel
    mats[:, :, 3, 3] = 1.0
    world = [mats[:, 0]]
    for j in range(1, 24):
        world.append(world[PARENTS[j]] @ mats[:, j])
    world = torch.stack(world, dim=1)
    joints = world[:, :, :3, 3]
    a = world.clone()
    a[:, :, :3, 3] -= torch.einsum("njik,njk->nji", world[:, :, :3, :3],
                                   rest)
    t = torch.einsum("vj,njab->nvab", smpl["lbs_weights"], a)
    verts = torch.einsum("nvik,nvk->nvi", t[:, :, :3, :3], v_posed) \
        + t[:, :, :3, 3]
    return verts, joints


def regress(smpl: dict, rot, betas, cam, img_res: int) -> dict:
    """SMPL, the spin2 joints and their projection at HMR 2.0's camera
    [tx, ty, 2 f / (img_res s + 1e-9)], in [-1, 1] crop units."""
    verts, joints24 = lbs(smpl, betas, rot)
    hands = verts[:, list(HAND_TIP_VERTS)]
    thorax = torch.einsum("v,nvk->nk", smpl["J_regressor_extra"][THORAX_ROW],
                          verts)[:, None]
    joints = torch.cat([joints24, hands, thorax], dim=1)
    tz = 2 * FOCAL / (img_res * cam[:, 0] + 1e-9)
    p = joints + torch.stack([cam[:, 1], cam[:, 2], tz], dim=-1)[:, None]
    joints2d = p[..., :2] / p[..., 2:3] * FOCAL / (img_res / 2)
    return {"verts": verts, "joints3d": joints, "joints2d": joints2d}


@torch.no_grad()
def forward(sd: dict, smpl: dict, cfg: dict, crops: torch.Tensor) -> dict:
    """(N, 3, c, c) normalized crops, frame by frame -> {"rotmat",
    "betas", "pred_cam", "verts", "joints3d", "joints2d"}; cfg holds
    HMR2Core's sizes (img_res, patch, patch_padding, heads, depth,
    dec_heads, dec_head_dim, dec_depth)."""
    cut = cfg["img_res"] // 8
    outs = []
    with tf32_off():
        for x in crops.split(1):
            rot, betas, cam = decoder_head(sd, cfg,
                                           vit(sd, cfg, x[..., cut:-cut]))
            outs.append({"rotmat": rot, "betas": betas, "pred_cam": cam,
                         **regress(smpl, rot, betas, cam, cfg["img_res"])})
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
