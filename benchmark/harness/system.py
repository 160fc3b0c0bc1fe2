"""The system under test, built from a configuration: gaitlab_torch's GRNet
(trunk, SMPL tensors) and the GRNetRunner that every entry point uses,
with the benchmark's weights. Nothing else of the program is imported."""

from __future__ import annotations

import torch

from benchmark.reference.crop import crops_uint8, normalize
from benchmark.reference.model import Reference

SMPL_KEYS = ("v_template", "shapedirs", "posedirs", "J_regressor",
             "lbs_weights", "J_regressor_extra")


def model_kwargs(cfg: dict) -> dict:
    kw = dict(cfg["model"])
    kw["backbone_modules"] = tuple(kw["backbone_modules"])
    return kw


def skeleton(cfg: dict):
    """The program's trunk on the meta device: names, shapes and roles of
    its tensors, no storage."""
    from gaitlab_torch.nn.grnet import GRNetCore

    with torch.device("meta"):
        return GRNetCore(**model_kwargs(cfg))


def calibrate(sd: dict, cfg: dict, frames, boxes, device) -> None:
    """BatchNorm statistics for the random weights: the reference's forward
    over crops of the traffic's frames, every BatchNorm normalising by its
    input's batch statistics and keeping them. Fresh (0, 1) statistics
    make a random HRNet all but independent of its input, and a
    comparison of its outputs vacuous."""
    ref = Reference(sd, cfg, calibrate=True)
    with torch.no_grad(), tf32(False):
        x = normalize(crops_uint8(frames, boxes, cfg["crop_size"]), device)
        ref.head_features(ref.backbone(x))


class tf32:
    """cuDNN's and cuBLAS's TF32 switches set for a block, then restored."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.old = (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.on
        torch.backends.cuda.matmul.allow_tf32 = self.on

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.old


def build(cfg: dict, sd: dict, smpl: dict, device, precision: str):
    """(GRNet, GRNetRunner) with the benchmark's weights copied in."""
    from gaitlab_torch.body.smpl import SMPLParams
    from gaitlab_torch.nn.grnet import GRNet, GRNetCore
    from gaitlab_torch.pipeline.runner import GRNetRunner

    with torch.device("meta"):
        core = GRNetCore(**model_kwargs(cfg))
    core = core.to_empty(device=device)
    core.load_state_dict(sd)
    core.eval()
    params = SMPLParams(*(smpl[k].clone() for k in SMPL_KEYS))
    model = GRNet(module=core, smpl=params, device=torch.device(device),
                  joint_mode=cfg["smpl"]["joint_mode"])
    run = cfg["runner"]
    runner = GRNetRunner(model, buckets=tuple(run["buckets"]),
                         crop_size=cfg["crop_size"], crop_on=run["crop_on"],
                         precision=precision)
    return model, runner
