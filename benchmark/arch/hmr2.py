"""HMR 2.0: gaitlab_torch's HMR2Core trunk (nn/hmr2.py: the ViT-H of
nn/vit.py and the transformer decoder head) in a GRNet bundle with SMPL's
tensors, run by the GRNetRunner that every entry point uses, at the
configuration's crop. The plain reference is reference/hmr2.py, the
counts are counts/hmr2.py. The configuration's "model" holds HMR2Core's
keyword arguments but `img_res`, which is its "crop_size"; the reference
reads the same sizes."""

from __future__ import annotations

import torch

from benchmark.counts.hmr2 import StepCounts
from benchmark.harness.system import SMPL_KEYS
from benchmark.reference import hmr2 as reference


def model_kwargs(cfg: dict) -> dict:
    return dict(cfg["model"], img_res=cfg["crop_size"])


def skeleton(cfg: dict):
    """The program's trunk on the meta device: names, shapes and roles of
    its tensors, no storage."""
    from gaitlab_torch.nn.hmr2 import HMR2Core

    with torch.device("meta"):
        return HMR2Core(**model_kwargs(cfg))


def calibrate(sd: dict, cfg: dict, frames, boxes, device) -> None:
    """LayerNorms and no BatchNorm: nothing to calibrate."""


def build(cfg: dict, sd: dict, smpl: dict, device, precision: str):
    """(GRNet, GRNetRunner) with the benchmark's weights copied in and the
    head's mean parameters as the program assumes them (the reference
    writes the same ones itself)."""
    from gaitlab_torch.body.smpl import SMPLParams
    from gaitlab_torch.nn.grnet import GRNet
    from gaitlab_torch.nn.hmr2 import mean_params
    from gaitlab_torch.pipeline.runner import GRNetRunner

    core = skeleton(cfg).to_empty(device=device)
    m = cfg["model"]
    means = mean_params(m["num_joints"], m["num_betas"])
    core.load_state_dict({**sd, **{"smpl_head." + k: v.to(device)
                                   for k, v in means.items()}})
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
    """One track through reference/hmr2.py in blocks of `ref_block`
    frames (the reference runs frames independently: no forward size)."""
    return reference.run_track(sd, smpl, cfg, track,
                               cfg["runner"]["ref_block"], device)


def counts(cfg: dict, sd: dict) -> StepCounts:
    """counts/hmr2.py's StepCounts: besides forward_flops and b2, the ViT's
    that vit_roofline reads."""
    return StepCounts(cfg, sd)
