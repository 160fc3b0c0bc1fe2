"""The toy's system: a trunk in the ViT's layout at a size the CPU runs
in a moment (a 16x16 patch embedding with stride 16, a learned position
embedding, one pre-LayerNorm GELU MLP block, a final LayerNorm, the mean
token and a linear head that corrects mean parameters: 6D pose, betas
and camera), then SMPL through the port's vp_regress. The port's
GRNetRunner runs it, its crops, ForwardStream and spans as they are: a
runner whose `_live` hands the forward the toy's trunk and model."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from benchmark.harness.system import SMPL_KEYS
from benchmark.tests.toy import counts as toy_counts
from benchmark.tests.toy import reference

LN_EPS = 1e-6
POSE_6D = 24 * 6
MEAN_6D = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)  # the identity's two columns
MEAN_CAM = (0.9, 0.0, 0.0)


class ToyTrunk(nn.Module):
    use_gait_feat = False

    def __init__(self, width: int, patch: int, grid: int, mlp: int,
                 betas: int):
        super().__init__()
        self.patch_embed = nn.Conv2d(3, width, patch, stride=patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid, width))
        self.norm1 = nn.LayerNorm(width, eps=LN_EPS)
        self.fc1 = nn.Linear(width, mlp)
        self.fc2 = nn.Linear(mlp, width)
        self.norm = nn.LayerNorm(width, eps=LN_EPS)
        self.head = nn.Linear(width, POSE_6D + betas + 3)

    def forward(self, x: torch.Tensor) -> dict:
        from gaitlab_torch.core.geometry import rot6d_to_rotmat

        t = self.patch_embed(x).flatten(2).transpose(1, 2) + self.pos_embed
        t = t + self.fc2(F.gelu(self.fc1(self.norm1(t))))
        d = self.head(self.norm(t).mean(1))
        n = d.shape[0]
        pose = d[:, :POSE_6D].reshape(n, 24, 6) + d.new_tensor(MEAN_6D)
        return {"pred_pose": rot6d_to_rotmat(pose).reshape(n, 24, 3, 3),
                "pred_shape": d[:, POSE_6D:-3],
                "pred_cam": d[:, -3:] + d.new_tensor(MEAN_CAM)}


@dataclass
class ToyModel:
    module: ToyTrunk
    smpl: object
    device: torch.device
    joint_mode: str

    def forward(self, images: torch.Tensor) -> list:
        """NHWC normalised crops -> vp_regress's outputs, as GRNet's."""
        from gaitlab_torch.nn.grnet import vp_regress

        with torch.inference_mode():
            patt = self.module(images.permute(0, 3, 1, 2).contiguous())
            return vp_regress(self.smpl, patt, joint_mode=self.joint_mode)


def _trunk_kwargs(cfg: dict) -> dict:
    m = cfg["model"]
    return dict(width=m["width"], patch=m["patch"], mlp=m["mlp"],
                grid=cfg["crop_size"] // m["patch"],
                betas=cfg["smpl"]["num_betas"])


def skeleton(cfg: dict) -> ToyTrunk:
    with torch.device("meta"):
        return ToyTrunk(**_trunk_kwargs(cfg))


def calibrate(sd, cfg, frames, boxes, device) -> None:
    """No BatchNorm: nothing to calibrate."""


def build(cfg: dict, sd: dict, smpl: dict, device, precision: str):
    from gaitlab_torch.body.smpl import SMPLParams
    from gaitlab_torch.pipeline.runner import GRNetRunner

    class ToyRunner(GRNetRunner):
        def _live(self, check: bool = True) -> dict:
            return {"core": self.model.module, "model": self.model}

    trunk = skeleton(cfg).to_empty(device=device)
    trunk.load_state_dict(sd)
    model = ToyModel(trunk.eval(),
                     SMPLParams(*(smpl[k].clone() for k in SMPL_KEYS)),
                     torch.device(device), cfg["smpl"]["joint_mode"])
    run = cfg["runner"]
    runner = ToyRunner(model, buckets=tuple(run["buckets"]),
                       crop_size=cfg["crop_size"], crop_on=run["crop_on"],
                       precision=precision)
    return model, runner


def trunk(runner) -> ToyTrunk:
    return runner.model.module


def reference_track(sd, smpl, cfg, track, device) -> dict:
    return reference.run_track(sd, smpl, cfg, track, device)


def counts(cfg: dict, sd: dict) -> toy_counts.ToyCounts:
    return toy_counts.ToyCounts(cfg, sd)
