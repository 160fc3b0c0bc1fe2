"""SMPL (Loper et al., SIGGRAPH Asia 2015) in plain PyTorch, float32, and
the regression's outputs: vertices, the 29 joints of the clinical set
("spin2": the 24 kinematic joints, both thumbs and middle fingertips, the
MPII thorax) and their weak-perspective projection.

SMPL's tensors come as a dict: v_template (V,3), shapedirs (V,3,10),
posedirs (207, V*3), J_regressor (24,V), lbs_weights (V,24),
J_regressor_extra (9,V). `axis_angle_to_rotmat` reads SMPL's axis-angle
pose as rotation matrices (the check compares a program's pose so)."""

from __future__ import annotations

import torch

PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16,
           17, 18, 19, 20, 21)
# smplx's vertex joint selector: left thumb and middle fingertips, right
# thumb and middle fingertips
HAND_TIP_VERTS = (2746, 2445, 6191, 5905)
THORAX_ROW = 5  # of J_regressor_extra (SPIN's extra regressor), MPII thorax
FOCAL = 5000.0
IMG_RES = 224


def lbs(smpl: dict, betas, rot):
    """betas (N,10), rot (N,24,3,3) -> (vertices (N,V,3), joints
    (N,24,3)) by linear blend skinning."""
    n = betas.shape[0]
    v_shaped = smpl["v_template"] + torch.einsum("vks,ns->nvk",
                                                 smpl["shapedirs"], betas)
    rest = torch.einsum("jv,nvk->njk", smpl["J_regressor"], v_shaped)
    eye = torch.eye(3, device=rot.device, dtype=rot.dtype)
    pose_feature = (rot[:, 1:] - eye).reshape(n, -1)
    v_posed = v_shaped + (pose_feature @ smpl["posedirs"]).reshape(n, -1, 3)
    # forward kinematics: each joint's world transform
    rel = rest.clone()
    rel[:, 1:] -= rest[:, list(PARENTS[1:])]
    mats = torch.zeros((n, 24, 4, 4), device=rot.device, dtype=rot.dtype)
    mats[:, :, :3, :3] = rot
    mats[:, :, :3, 3] = rel
    mats[:, :, 3, 3] = 1.0
    world = [mats[:, 0]]
    for j in range(1, 24):
        world.append(world[PARENTS[j]] @ mats[:, j])
    world = torch.stack(world, dim=1)  # (N,24,4,4)
    joints = world[:, :, :3, 3]
    # transforms relative to the rest pose
    a = world.clone()
    a[:, :, :3, 3] -= torch.einsum("njik,njk->nji", world[:, :, :3, :3],
                                   rest)
    t = torch.einsum("vj,njab->nvab", smpl["lbs_weights"], a)
    verts = torch.einsum("nvik,nvk->nvi", t[:, :, :3, :3], v_posed) \
        + t[:, :, :3, 3]
    return verts, joints


def regress(smpl: dict, rot, betas, cam) -> dict:
    """The head's rotations (N,24,3,3), betas (N,10) and camera (N,3) ->
    {"verts" (N,V,3), "joints3d" (N,29,3), "joints2d" (N,29,2) in crop
    coordinates over 112}."""
    verts, joints24 = lbs(smpl, betas, rot)
    hands = verts[:, list(HAND_TIP_VERTS)]
    thorax = torch.einsum("v,nvk->nk", smpl["J_regressor_extra"][THORAX_ROW],
                          verts)[:, None]
    joints = torch.cat([joints24, hands, thorax], dim=1)
    tz = 2 * FOCAL / (IMG_RES * cam[:, 0] + 1e-9)
    trans = torch.stack([cam[:, 1], cam[:, 2], tz], dim=-1)
    p = joints + trans[:, None]
    joints2d = p[..., :2] / p[..., 2:3] * FOCAL / (IMG_RES / 2)
    return {"verts": verts, "joints3d": joints, "joints2d": joints2d}


def axis_angle_to_rotmat(aa):
    """Rodrigues: (..., 3) -> (..., 3, 3), in float64."""
    aa = aa.double()
    theta = torch.linalg.norm(aa, dim=-1, keepdim=True)
    k = aa / theta.clamp_min(1e-12)
    kx, ky, kz = k.unbind(-1)
    zero = torch.zeros_like(kx)
    kmat = torch.stack([zero, -kz, ky, kz, zero, -kx, -ky, kx, zero],
                       -1).reshape(aa.shape[:-1] + (3, 3))
    s, c = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + s * kmat + (1 - c) * (kmat @ kmat)
