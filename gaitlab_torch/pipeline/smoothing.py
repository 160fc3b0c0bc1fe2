"""Pose smoothing: the one-euro filter, then one batched SMPL re-evaluation.

Counterpart of gaitlab/pipeline/smoothing.py. The filter and the SMPL pass
run on the device of the SMPL tensors (the model's device in the demo), so
on the card the re-evaluation launches the blendshapes kernel once for all
frames of a track.

Kept from the reference for output parity:
  * the betas of frame 0 are used for every re-evaluated frame;
  * out[0] == in[0] (the filter starts at the first frame);
  * the joints are spin2, with an optional spin2 -> kinectv2 conversion.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gaitlab_torch.body import joints as joints_mod
from gaitlab_torch.body import smpl as body_smpl
from gaitlab_torch.core import filters, geometry
from gaitlab_torch.device import float32_math, resolve_device


def smooth_pose(pred_pose: np.ndarray, pred_betas: np.ndarray,
                smpl_params: Optional[body_smpl.SMPLParams] = None,
                min_cutoff: float = 0.004, beta: float = 0.7,
                kinectv2: bool = False, device=None):
    """Filter a (T,72) axis-angle (or (T,96) quaternion) pose sequence and
    regenerate vertices and joints.

    Runs on the device of `smpl_params`; without them, on synthetic SMPL
    tensors placed on `device` (default: the card).
    Returns numpy (verts (T,V,3), pose_hat (T,72|96), joints3d (T,J,3))."""
    pred_pose = np.asarray(pred_pose, np.float32)
    pred_betas = np.asarray(pred_betas, np.float32)
    T = pred_betas.shape[0]
    pshape = pred_pose.shape
    if pshape[-1] == 72:
        pose_seq = pred_pose.reshape(T, 24, 3)
    elif pshape[-1] == 96:
        pose_seq = pred_pose.reshape(T, 24, 4)
    else:
        raise ValueError(f"Invalid pred_pose format: {pshape}")
    if smpl_params is None:
        smpl_params = body_smpl.synthetic_smpl_params().to(
            resolve_device(device))
    dev = smpl_params.v_template.device

    with float32_math(), torch.inference_mode():
        pose_hat = filters.one_euro(torch.from_numpy(pose_seq).to(dev),
                                    min_cutoff=min_cutoff, beta=beta)
        if pshape[-1] == 72:
            pose_aa = pose_hat.reshape(T, 72)
        else:
            pose_aa = geometry.quat_to_axis_angle(
                pose_hat.reshape(-1, 4)).reshape(T, 72)
        betas = torch.from_numpy(pred_betas[0]).to(dev).expand(T, 10)
        out = body_smpl.smpl_forward_axis_angle(smpl_params, betas, pose_aa,
                                                joint_mode="spin2")
        verts = out["vertices"].cpu().numpy()
        joints3d = out["joints"].cpu().numpy()
        pose_hat = pose_hat.cpu().numpy()
    if kinectv2:
        joints3d = joints_mod.convert_kps(joints3d, src="spin2",
                                          dst="kinectv2")
    return verts, pose_hat.reshape(pshape), joints3d
