"""The toy's plain reference: its trunk as functions of the state dict,
then the benchmark's SMPL (reference/smpl.py) on the benchmark's crops
(reference/crop.py); nothing of the program."""

from __future__ import annotations

import torch
from torch.nn import functional as F

from benchmark.reference import crop, smpl as smpl_ref

LN_EPS = 1e-6


def _rot6d(x):
    """(..., 6) as 3x2 columns -> Gram-Schmidt rotation (..., 3, 3)."""
    x = x.reshape(x.shape[:-1] + (3, 2))
    a1, a2 = x[..., 0], x[..., 1]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(1e-6)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp_min(1e-6)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2)], dim=-1)


def trunk(sd: dict, cfg: dict, x):
    """NCHW normalised crops -> (rotations (N,24,3,3), betas, camera)."""
    def ln(v, p):
        return F.layer_norm(v, v.shape[-1:], sd[p + ".weight"],
                            sd[p + ".bias"], LN_EPS)

    def lin(v, p):
        return F.linear(v, sd[p + ".weight"], sd[p + ".bias"])

    p = cfg["model"]["patch"]
    t = F.conv2d(x, sd["patch_embed.weight"], sd["patch_embed.bias"],
                 stride=p).flatten(2).transpose(1, 2) + sd["pos_embed"]
    t = t + lin(F.gelu(lin(ln(t, "norm1"), "fc1")), "fc2")
    d = lin(ln(t, "norm").mean(1), "head")
    n = d.shape[0]
    pose = d[:, :144].reshape(n, 24, 6) + d.new_tensor([1, 0, 0, 1, 0, 0])
    cam = d[:, -3:] + d.new_tensor([0.9, 0.0, 0.0])
    return _rot6d(pose), d[:, 144:-3], cam


@torch.no_grad()
def run_track(sd: dict, smpl: dict, cfg: dict, track, device) -> dict:
    x = crop.normalize(crop.crops_uint8(track.frames(), track.boxes,
                                        cfg["crop_size"]), device)
    rot, betas, cam = trunk(sd, cfg, x)
    r = smpl_ref.regress(smpl, rot, betas, cam)
    out = {"pose_rotmat": rot, "betas": betas, "pred_cam": cam, **r}
    return {k: v.cpu().numpy() for k, v in out.items()}
