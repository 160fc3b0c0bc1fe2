"""GRNet: HRNet backbone + PARE head + SMPL regression.

Counterpart of gaitlab/nn/grnet.py without the gait branch. `GRNetCore`
is the neural trunk (an nn.Module whose state_dict keys are the reference
GRNet's 'backbone.*' / 'head.*' keys); `vp_regress` is the SMPL regression
and output assembly; `GRNet` bundles the trunk, the SMPL tensors and the
device.

Output contract:
  [{'theta': (B,T,85), 'verts': (B,T,6890,3), 'kp_2d': (B,T,J,2),
    'kp_3d': (B,T,J,3), 'rotmat': (B,T,24,3,3)}]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from gaitlab_torch.body import smpl as body_smpl
from gaitlab_torch.core import geometry
from gaitlab_torch.device import float32_math, resolve_device
from gaitlab_torch.nn.hrnet import HRNetCfg, PoseHighResolutionNet
from gaitlab_torch.nn.pare_head import PareHead


class GRNetCore(nn.Module):
    """HRNet-W32 backbone + PARE head. The width, depth and head-feature
    knobs exist so that tests can build small models."""

    def __init__(self, num_joints: int = 24, num_input_features: int = 480,
                 num_features_pare: int = 128, num_features_smpl: int = 64,
                 backbone_width: int = 32, backbone_modules: tuple = (1, 4, 3),
                 backbone_blocks: int = 4, use_gait_feat: bool = False):
        super().__init__()
        if use_gait_feat:
            raise NotImplementedError(
                "the gait branch (use_gait_feat=True) is not ported yet")
        self.backbone = PoseHighResolutionNet(
            HRNetCfg.w(backbone_width, backbone_modules, backbone_blocks))
        self.head = PareHead(num_joints, num_input_features,
                             num_features_pare, num_features_smpl)

    def forward(self, images: torch.Tensor) -> dict:
        """images: (N, 3, 224, 224) normalized crops."""
        return self.head(self.backbone(images))


def vp_regress(smpl_params: body_smpl.SMPLParams, patt_output: dict,
               batch_size: int = 1,
               J_regressor: Optional[torch.Tensor] = None,
               joint_mode: str = "spin2", focal_length: float = 5000.0,
               img_res: int = 224) -> list[dict]:
    """SMPL regression + output assembly (reference VPRegressor.forward)."""
    pred_rotmat = patt_output["pred_pose"]  # (N,24,3,3)
    n = pred_rotmat.shape[0]
    smpl_out = body_smpl.smpl_head(
        smpl_params, pred_rotmat, patt_output["pred_shape"],
        cam=patt_output["pred_cam"], focal_length=focal_length,
        img_res=img_res, normalize_joints2d=True, joint_mode=joint_mode)
    pose = geometry.rotmat_to_axis_angle(
        pred_rotmat.reshape(-1, 3, 3)).reshape(n, 72)
    seqlen = n // batch_size

    joints3d = smpl_out["smpl_joints3d"]
    if J_regressor is not None:
        joints3d = torch.einsum("jv,nvk->njk", J_regressor,
                                smpl_out["smpl_vertices"])
        if J_regressor.shape[0] < 24:
            joints3d = joints3d[:, list(body_smpl.H36M_TO_J14)]

    theta = torch.cat([patt_output["pred_cam"], pose,
                       patt_output["pred_shape"]], dim=1)
    return [{
        "theta": theta.reshape(batch_size, seqlen, -1),
        "verts": smpl_out["smpl_vertices"].reshape(batch_size, seqlen, -1, 3),
        "kp_2d": smpl_out["smpl_joints2d"].reshape(batch_size, seqlen, -1, 2),
        "kp_3d": joints3d.reshape(batch_size, seqlen, -1, 3),
        "rotmat": pred_rotmat.reshape(batch_size, seqlen, -1, 3, 3),
    }]


@dataclass
class GRNet:
    """The trunk module, the SMPL tensors and the device they live on."""

    module: GRNetCore
    smpl: body_smpl.SMPLParams
    device: torch.device
    joint_mode: str = "spin2"

    @staticmethod
    def create(smpl_params: Optional[body_smpl.SMPLParams] = None,
               seed: int = 0, joint_mode: str = "spin2", device=None,
               **module_kwargs) -> "GRNet":
        """Random weights from `seed`, in eval mode, on `device` (default:
        the card; raises when CUDA is absent and the CPU was not asked
        for). Without `smpl_params`, synthetic SMPL tensors are used."""
        device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            module = GRNetCore(**module_kwargs)
        if smpl_params is None:
            smpl_params = body_smpl.synthetic_smpl_params()
        return GRNet(module=module.to(device).eval(),
                     smpl=smpl_params.to(device), device=device,
                     joint_mode=joint_mode)

    def forward(self, images: torch.Tensor,
                J_regressor: Optional[torch.Tensor] = None) -> list[dict]:
        """images: (B,T,3,H,W) or (T,3,H,W) crops, or NHWC (N,H,W,3), on the
        model's device. Runs in float32 with TF32 off."""
        if images.dim() == 5:  # (B,T,3,H,W)
            b = images.shape[0]
            x = images.reshape((-1,) + tuple(images.shape[2:]))
        elif images.dim() == 4 and images.shape[1] == 3:  # (T,3,H,W)
            b, x = 1, images
        elif images.dim() == 4:  # (N,H,W,3)
            b, x = 1, images.permute(0, 3, 1, 2)
        else:
            raise ValueError(f"Wrong input rank: {tuple(images.shape)}")
        with float32_math(), torch.inference_mode():
            patt = self.module(x.contiguous())
            return vp_regress(self.smpl, patt, batch_size=b,
                              J_regressor=J_regressor,
                              joint_mode=self.joint_mode)
