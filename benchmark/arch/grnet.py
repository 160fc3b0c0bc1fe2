"""GRNet and MAX-GRNet: gaitlab_torch's GRNetCore trunk (HRNet, the PARE
head, the gait corrector) in a GRNet with SMPL's tensors, run by the
GRNetRunner that every entry point uses. The plain reference is
reference/model.py through reference/track.py, the counts are
counts/flops.py. The configuration's "model" holds GRNetCore's keyword
arguments, which the reference reads too."""

from __future__ import annotations

import torch

from benchmark.counts.flops import StepCounts
from benchmark.harness.system import SMPL_KEYS, tf32
from benchmark.reference.crop import crops_uint8, normalize
from benchmark.reference.model import Reference
from benchmark.reference.track import run_track


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


def build(cfg: dict, sd: dict, smpl: dict, device, precision: str):
    """(GRNet, GRNetRunner) with the benchmark's weights copied in."""
    from gaitlab_torch.body.smpl import SMPLParams
    from gaitlab_torch.nn.grnet import GRNet
    from gaitlab_torch.pipeline.runner import GRNetRunner

    core = skeleton(cfg).to_empty(device=device)
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


def trunk(runner):
    """The trunk the runner's forwards run: its view at the resolved
    precision modes."""
    return runner._live()["core"]


def reference_track(sd: dict, smpl: dict, cfg: dict, track, device) -> dict:
    """One track through reference/track.run_track, in forwards of the
    runner's largest bucket and blocks of `ref_block` frames."""
    run = cfg["runner"]
    return run_track(Reference(sd, cfg), smpl, track.frames(), track.boxes,
                     track.image_hw, cfg["crop_size"], max(run["buckets"]),
                     run["ref_block"], device)


def counts(cfg: dict, sd: dict) -> StepCounts:
    """counts/flops.py's StepCounts: besides forward_flops and b2, the
    GRNet-only hrnet, hr_head and b1 that their rooflines read."""
    return StepCounts(cfg, sd)
