"""Legacy SPIN/HMR: ResNet-50 backbone + 3-iteration SMPL regressor.

Counterpart of gaitlab/nn/spin.py (the reference's lib/models/spin.py,
kept for weight provenance; its `Regressor` also serves the vis debug
utilities, render/vis.py::regressor_output_from_features). The iterative
refinement is a fixed loop, unrolled as the forward runs. Dropout is the
identity at inference and is left out, as in gaitlab. SMPL goes through
body/smpl.py, so the blendshapes kernel runs on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from gaitlab_torch.body import smpl as body_smpl
from gaitlab_torch.core import geometry
from gaitlab_torch.device import float32_math, resolve_device
from gaitlab_torch.nn.hrnet import Bottleneck
from gaitlab_torch.nn.resnet import ResNet

NPOSE = 24 * 6


class RegressorHead(nn.Module):
    """Iterative residual regressor (reference spin.py:210-248): (N, F)
    features + running (pose6d, shape, cam) estimates -> refined ones."""

    def __init__(self, feat_dim: int = 2048):
        super().__init__()
        self.fc1 = nn.Linear(feat_dim + NPOSE + 13, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        self.decpose = nn.Linear(1024, NPOSE)
        self.decshape = nn.Linear(1024, 10)
        self.deccam = nn.Linear(1024, 3)

    def forward(self, xf: torch.Tensor, init_pose: torch.Tensor,
                init_shape: torch.Tensor, init_cam: torch.Tensor,
                n_iter: int = 3):
        pred_pose, pred_shape, pred_cam = init_pose, init_shape, init_cam
        for _ in range(n_iter):
            xc = torch.cat([xf, pred_pose, pred_shape, pred_cam], dim=1)
            xc = self.fc2(self.fc1(xc))
            pred_pose = self.decpose(xc) + pred_pose
            pred_shape = self.decshape(xc) + pred_shape
            pred_cam = self.deccam(xc) + pred_cam
        return pred_pose, pred_shape, pred_cam


class HMRCore(nn.Module):
    """ResNet-50 trunk + regressor head (reference spin.py:60-210)."""

    def __init__(self, layers: tuple = (3, 4, 6, 3)):
        super().__init__()
        self.backbone = ResNet(Bottleneck, layers)
        self.head = RegressorHead(self.backbone.out_features)

    def forward(self, x: torch.Tensor, init_pose: torch.Tensor,
                init_shape: torch.Tensor, init_cam: torch.Tensor,
                n_iter: int = 3):
        """x: (N,3,H,W) normalized crops."""
        return self.head(self.backbone(x), init_pose, init_shape, init_cam,
                         n_iter)


def regress_output(smpl_params: body_smpl.SMPLParams,
                   pred_pose6d: torch.Tensor, pred_shape: torch.Tensor,
                   pred_cam: torch.Tensor,
                   J_regressor: Optional[torch.Tensor] = None,
                   joint_mode: str = "spin2") -> list[dict]:
    """rot6d/shape/cam -> the reference output list (spin.py:269-296)."""
    n = pred_pose6d.shape[0]
    pred_rotmat = geometry.rot6d_to_rotmat(
        pred_pose6d.reshape(-1, 6)).reshape(n, 24, 3, 3)
    out = body_smpl.smpl_forward(smpl_params, pred_shape, pred_rotmat,
                                 joint_mode=joint_mode)
    pred_vertices, pred_joints = out["vertices"], out["joints"]
    if J_regressor is not None:
        pred_joints = torch.einsum("jv,nvk->njk", J_regressor, pred_vertices)
        pred_joints = pred_joints[:, list(body_smpl.H36M_TO_J14)]
    pose = geometry.rotmat_to_axis_angle(
        pred_rotmat.reshape(-1, 3, 3)).reshape(-1, 72)
    return [{
        "theta": torch.cat([pred_cam, pose, pred_shape], dim=1),
        "verts": pred_vertices,
        "kp_2d": geometry.projection(pred_joints, pred_cam),
        "kp_3d": pred_joints,
        "rotmat": pred_rotmat,
    }]


def default_init_params(n: int, mean_params: Optional[dict] = None,
                        device=None):
    """Mean-parameter initial estimates (reference spin.py:225-235
    buffers): (pose6d (n,144), shape (n,10), cam (n,3)); without
    `mean_params` the identity pose, zero shape and cam [0.9, 0, 0]."""
    if mean_params is None:
        pose = geometry.rotmat_to_rot6d(torch.eye(3).expand(24, 3, 3))
        shape = torch.zeros(10)
        cam = torch.tensor([0.9, 0.0, 0.0])
    else:
        pose, shape, cam = (torch.as_tensor(mean_params[k],
                                            dtype=torch.float32)
                            for k in ("pose", "shape", "cam"))
    return tuple(v.reshape(1, -1).expand(n, -1).to(device)
                 for v in (pose, shape, cam))


@dataclass
class HMR:
    """The legacy model bundled (reference hmr()/get_pretrained_hmr,
    spin.py:298-315): trunk, SMPL tensors and their device."""

    module: HMRCore
    smpl: body_smpl.SMPLParams
    device: torch.device
    mean_params: Optional[dict] = None
    joint_mode: str = "spin2"

    @staticmethod
    def create(smpl_params: Optional[body_smpl.SMPLParams] = None,
               seed: int = 0, mean_params: Optional[dict] = None,
               joint_mode: str = "spin2", device=None) -> "HMR":
        """Random weights from `seed`, in eval mode, on `device` (None:
        the card). Without `smpl_params`, synthetic SMPL tensors."""
        device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            module = HMRCore()
        if smpl_params is None:
            smpl_params = body_smpl.synthetic_smpl_params()
        return HMR(module.to(device).eval(), smpl_params.to(device), device,
                   mean_params, joint_mode)

    def regress(self, features: torch.Tensor, n_iter: int = 3,
                J_regressor: Optional[torch.Tensor] = None) -> list[dict]:
        """The regressor head and SMPL on (N, 2048) backbone features, in
        float32 with TF32 off."""
        p, s, c = default_init_params(features.shape[0], self.mean_params,
                                      self.device)
        with float32_math(), torch.inference_mode():
            pose6d, shape, cam = self.module.head(features, p, s, c, n_iter)
            return regress_output(self.smpl, pose6d, shape, cam,
                                  J_regressor=J_regressor,
                                  joint_mode=self.joint_mode)

    def forward(self, images_nhwc: torch.Tensor, n_iter: int = 3,
                J_regressor: Optional[torch.Tensor] = None) -> list[dict]:
        """images: (N,H,W,3) normalized crops on the model's device."""
        with float32_math(), torch.inference_mode():
            features = self.module.backbone(
                images_nhwc.permute(0, 3, 1, 2).contiguous())
        return self.regress(features, n_iter, J_regressor)
