"""GRNet: HRNet backbone + PARE head [+ gait-feature corrector] + SMPL
regression.

Counterpart of gaitlab/nn/grnet.py. `GRNetCore` is the neural trunk (an
nn.Module whose state_dict keys are the reference GRNet's 'backbone.*' /
'head.*' keys, and 'pfeat_corrector.*' for the gait branch, named as
gaitlab names it); `vp_regress` is the SMPL regression and output
assembly; `GRNet` bundles the trunk, the SMPL tensors and the device.

Output contract:
  [{'theta': (B,T,85), 'verts': (B,T,6890,3), 'kp_2d': (B,T,J,2),
    'kp_3d': (B,T,J,3), 'rotmat': (B,T,24,3,3)}]
with the gait branch also 'pred_avg' (1,3), 'pred_phase' (1,N,4) and
'pred_cparam' (N,3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from gaitlab_torch.body import smpl as body_smpl
from gaitlab_torch.core import geometry
from gaitlab_torch.device import float32_math, resolve_device, upload
from gaitlab_torch.nn.gait import FeatCorrector, camera_reparam
from gaitlab_torch.nn.hrnet import HRNetCfg, PoseHighResolutionNet
from gaitlab_torch.nn.pare_head import PareHead
from gaitlab_torch.pipeline.crop import normalize_image


class GRNetCore(nn.Module):
    """HRNet-W32 backbone + PARE head, and with `use_gait_feat` the
    gait-feature corrector between the head's pooling and its regressors.
    The width, depth and head-feature knobs exist so that tests can build
    small models; the featcorr_* knobs are gaitlab's MODEL.FEAT_CORR.*.

    As in gaitlab, the backbone's BatchNorms always run on their running
    statistics, whatever `.train()` says, and with `freeze_backbone` the
    backbone runs without autograd: gradients reach the head (and the
    corrector) only, and the backbone's activations are not kept."""

    def __init__(self, num_joints: int = 24, num_input_features: int = 480,
                 num_features_pare: int = 128, num_features_smpl: int = 64,
                 backbone_width: int = 32, backbone_modules: tuple = (1, 4, 3),
                 backbone_blocks: int = 4, use_gait_feat: bool = False,
                 featcorr_avg_dim: int = 3, featcorr_estim_phase: bool = True,
                 featcorr_num_layers: int = 1, featcorr_h_size: int = 1024,
                 featcorr_num_heads: int = 4, featcorr_use_jwff: bool = False,
                 freeze_backbone: bool = True):
        super().__init__()
        self.use_gait_feat = use_gait_feat
        self.freeze_backbone = freeze_backbone
        self.backbone = PoseHighResolutionNet(
            HRNetCfg.w(backbone_width, backbone_modules, backbone_blocks))
        self.head = PareHead(num_joints, num_input_features,
                             num_features_pare, num_features_smpl)
        if use_gait_feat:
            self.pfeat_corrector = FeatCorrector(
                num_joints, num_features_pare, featcorr_avg_dim,
                featcorr_estim_phase, featcorr_num_layers, featcorr_h_size,
                featcorr_num_heads, featcorr_use_jwff)

    def train(self, mode: bool = True) -> "GRNetCore":
        super().train(mode)
        self.backbone.train(False)  # gaitlab: backbone(images, train=False)
        return self

    def forward(self, images: torch.Tensor,
                bbox: Optional[torch.Tensor] = None,
                cimg: Optional[torch.Tensor] = None,
                n_valid: Optional[torch.Tensor] = None) -> dict:
        """images: (N, 3, 224, 224) normalized crops of one track. bbox (N,4)
        and cimg (N,2) feed the gait branch; n_valid (a 0-d int tensor, read
        on the device) says how many leading frames are real when the
        runner pads the track to a bucket: padded frames then stay out of
        the gait GRU and attention."""
        if not self.use_gait_feat:
            return self.head(self._features(images))
        return self.track_part(self.frame_part(images, bbox, cimg), n_valid)

    def _features(self, images: torch.Tensor) -> torch.Tensor:
        if self.freeze_backbone and torch.is_grad_enabled():
            with torch.no_grad():
                return self.backbone(images)
        return self.backbone(images)

    def frame_part(self, images: torch.Tensor, bbox: torch.Tensor,
                   cimg: torch.Tensor) -> dict:
        """The gait branch's per-frame part, which a data-parallel runner
        splits over replicas: the backbone, the PARE feature extractor, the
        first prediction and the camera reparametrisation ->
        {"point_local_feat", "cam_shape_feats", "pred_segm_mask",
        "cparams"}, one row per frame."""
        if bbox is None or cimg is None:
            raise ValueError("the gait branch needs bbox and cimg")
        feats = self.head.feature_extractor(self._features(images))
        patt = self.head.predict(feats["point_local_feat"],
                                 feats["cam_shape_feats"])
        feats["cparams"] = camera_reparam(patt["pred_cam"], bbox, cimg)
        return feats

    def track_part(self, frames: dict, n_valid=None) -> dict:
        """The gait branch's part over the whole track: the corrector on
        frame_part's rows, then the second prediction."""
        cparams = frames["cparams"]
        corrected, pred_avg, pred_phase = self.pfeat_corrector(
            frames["point_local_feat"][None], cparams[None],
            None if n_valid is None else torch.as_tensor(n_valid).reshape(1))
        out = self.head.predict(corrected[0], frames["cam_shape_feats"])
        if "pred_segm_mask" in frames:
            out["pred_segm_mask"] = frames["pred_segm_mask"]
        out["pred_avg"] = pred_avg
        out["pred_phase"] = pred_phase
        out["pred_cparam"] = cparams
        return out


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
    out = {
        "theta": theta.reshape(batch_size, seqlen, -1),
        "verts": smpl_out["smpl_vertices"].reshape(batch_size, seqlen, -1, 3),
        "kp_2d": smpl_out["smpl_joints2d"].reshape(batch_size, seqlen, -1, 2),
        "kp_3d": joints3d.reshape(batch_size, seqlen, -1, 3),
        "rotmat": pred_rotmat.reshape(batch_size, seqlen, -1, 3, 3),
    }
    for k in ("pred_avg", "pred_phase", "pred_cparam"):  # gait branch
        if k in patt_output:
            out[k] = patt_output[k]
    return [out]


BUCKET_KEYS = ("theta", "verts", "kp_2d", "kp_3d", "pred_avg", "pred_phase")


class BucketForward(nn.Module):
    """The runner's forward at one bucket, with the weights as inputs:
    (state_dict of a GRNetCore, SMPLParams, NHWC crops[, bbox, cimg,
    n_valid]) -> per-frame theta (N,85), verts, kp_2d, kp_3d (and the gait
    branch's pred_phase (N,4)), and pred_avg (1,3). With `raw_uint8` the
    crops are uint8 and normalized here. The trunk is held outside the
    module's parameters, so a `torch.export` of it carries no weights."""

    def __init__(self, core: GRNetCore, joint_mode: str = "spin2",
                 raw_uint8: bool = True):
        super().__init__()
        self.__dict__["core"] = core  # not a submodule: no parameters
        self.joint_mode = joint_mode
        self.raw_uint8 = raw_uint8

    def forward(self, state: dict, smpl: body_smpl.SMPLParams,
                images: torch.Tensor, bbox: Optional[torch.Tensor] = None,
                cimg: Optional[torch.Tensor] = None,
                n_valid: Optional[torch.Tensor] = None) -> dict:
        x = normalize_image(images) if self.raw_uint8 else images
        kw = (dict(bbox=bbox, cimg=cimg, n_valid=n_valid)
              if self.core.use_gait_feat else {})
        patt = torch.func.functional_call(
            self.core, state, (x.permute(0, 3, 1, 2).contiguous(),), kw)
        out = vp_regress(smpl, patt, joint_mode=self.joint_mode)[0]
        return {k: v if k == "pred_avg" else v[0]
                for k, v in out.items() if k in BUCKET_KEYS}


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
                J_regressor: Optional[torch.Tensor] = None,
                bbox=None, cimg=None, n_valid: Optional[int] = None
                ) -> list[dict]:
        """images: (B,T,3,H,W) or (T,3,H,W) crops, or NHWC (N,H,W,3), on the
        model's device. Runs in float32 with TF32 off. bbox (N,4) [cx,cy,w,h]
        and cimg (N,2) image centres (arrays or tensors) feed the gait
        branch; n_valid (an int) marks the real frames of a padded track."""
        if images.dim() == 5:  # (B,T,3,H,W)
            b = images.shape[0]
            x = images.reshape((-1,) + tuple(images.shape[2:]))
        elif images.dim() == 4 and images.shape[1] == 3:  # (T,3,H,W)
            b, x = 1, images
        elif images.dim() == 4:  # (N,H,W,3)
            b, x = 1, images.permute(0, 3, 1, 2)
        else:
            raise ValueError(f"Wrong input rank: {tuple(images.shape)}")
        kw = {}
        if self.module.use_gait_feat:
            kw = {k: upload(torch.as_tensor(v, dtype=torch.float32),
                            self.device)
                  for k, v in (("bbox", bbox), ("cimg", cimg))
                  if v is not None}
            if n_valid is not None:
                kw["n_valid"] = upload(torch.tensor(n_valid), self.device)
        with float32_math(), torch.inference_mode():
            patt = self.module(x.contiguous(), **kw)
            return vp_regress(self.smpl, patt, batch_size=b,
                              J_regressor=J_regressor,
                              joint_mode=self.joint_mode)
