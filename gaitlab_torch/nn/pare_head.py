"""PARE part-attention regression head (NCHW).

Counterpart of gaitlab/nn/pare_head.py for the deployed single-shot
configuration (part-segmentation heatmaps, one iteration, keypoint
attention without post-conv). The attention pooling always goes through
`ops.keypoint_attention_fused` (the CUDA kernel on the card).

The shape and camera MLPs take the pooled (N, C, J) features flattened
channel-major, as the reference does, so reference checkpoints load as
they are (gaitlab flattens token-major and permutes the Dense kernels at
import instead).
"""

from __future__ import annotations

import torch
from torch import nn

from gaitlab_torch.core import geometry
from gaitlab_torch.nn.layers import LocallyConnected2d, batch_norm, conv
from gaitlab_torch.ops.keypoint_attention import keypoint_attention_fused


def _deconv_layers(in_ch: int, ch: int) -> nn.Sequential:
    """2x [3x3 conv (no bias) -> BN -> ReLU]."""
    return nn.Sequential(conv(in_ch, ch, 3), batch_norm(ch),
                         nn.ReLU(inplace=True), conv(ch, ch, 3),
                         batch_norm(ch), nn.ReLU(inplace=True))


class PareHead(nn.Module):
    def __init__(self, num_joints: int = 24, num_input_features: int = 480,
                 num_features_pare: int = 128, num_features_smpl: int = 64):
        super().__init__()
        self.num_joints = num_joints
        f = num_features_pare
        self.keypoint_deconv_layers = _deconv_layers(num_input_features, f)
        self.smpl_deconv_layers = _deconv_layers(num_input_features, f)
        self.keypoint_final_layer = conv(f, num_joints + 1, 1, bias=True)
        self.smpl_final_layer = conv(f, num_features_smpl, 1, bias=True)
        self.pose_mlp = LocallyConnected2d(f, 6, num_joints)
        self.shape_mlp = nn.Linear(num_features_smpl * num_joints, 10)
        self.cam_mlp = nn.Linear(num_features_smpl * num_joints, 3)

    def feature_extractor(self, features: torch.Tensor) -> dict:
        """Backbone features (N,480,56,56) -> pooled per-part features."""
        heatmaps = self.keypoint_final_layer(
            self.keypoint_deconv_layers(features))           # (N,J+1,H,W)
        smpl_feats = self.smpl_deconv_layers(features)       # (N,128,H,W)
        cam_shape_feats = self.smpl_final_layer(smpl_feats)  # (N,64,H,W)
        # background channel dropped; NHWC views, no copies
        point_local_feat, cam_shape_pooled = keypoint_attention_fused(
            smpl_feats.permute(0, 2, 3, 1), cam_shape_feats.permute(0, 2, 3, 1),
            heatmaps[:, 1:].permute(0, 2, 3, 1))
        return {
            "point_local_feat": point_local_feat,   # (N,J,128)
            "cam_shape_feats": cam_shape_pooled,    # (N,J,64)
            "pred_segm_mask": heatmaps,
        }

    def predict(self, point_local_feat: torch.Tensor,
                cam_shape_feats: torch.Tensor) -> dict:
        """Final regressors from the pooled (N,J,C) features."""
        n = point_local_feat.shape[0]
        pred_pose6d = self.pose_mlp(point_local_feat)  # (N,J,6)
        shape_flat = cam_shape_feats.transpose(1, 2).reshape(n, -1)
        pred_shape = self.shape_mlp(shape_flat)
        pred_cam = self.cam_mlp(shape_flat)
        pred_rotmat = geometry.rot6d_to_rotmat(
            pred_pose6d.reshape(-1, 6)).reshape(n, self.num_joints, 3, 3)
        return {
            "pred_rotmat": pred_rotmat,
            "pred_pose": pred_rotmat,
            "pred_cam": pred_cam,
            "pred_shape": pred_shape,
            "pred_rot6d": pred_pose6d,
        }

    def forward(self, features: torch.Tensor) -> dict:
        feats = self.feature_extractor(features)
        out = self.predict(feats["point_local_feat"], feats["cam_shape_feats"])
        out.update(feats)
        return out
