"""Training for GRNet's PARE head and for the gait branch.

Counterpart of gaitlab/training.py: the canonical loss (2D/3D keypoint MSE
and SMPL pose/shape supervision), gait-parameter supervision, optimizers
with gaitlab's learning-rate schedules step for step, the train steps,
synthetic data, and BatchNorm calibration for random-weight models.

The backbone stays frozen (`GRNetCore.freeze_backbone`): gradients reach
the head only. The core stays in eval mode while it trains, as gaitlab
applies it with train=False, so every BatchNorm normalises with its
running statistics and no BN buffer changes. Unlike gaitlab's step, which
hands `batch_stats` to the optimizer with the parameters, BN buffers are
never optimized. Both kernels run forward in every step (B1 in the head,
B2 in SMPL); their backwards are the ops' registered torch code.
`make_dp_train_step` takes the same update data-parallel over a list of
devices (parallel/replicas.py), for `cli.train --use_mesh`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from gaitlab_torch.body import smpl as body_smpl
from gaitlab_torch.device import float32_math, resolve_device, upload
from gaitlab_torch.nn.gait import camera_reparam
from gaitlab_torch.nn.grnet import GRNetCore, vp_regress
from gaitlab_torch.nn.layers import standard_blocks
from gaitlab_torch.parallel.replicas import Replicas, gather, scatter
from gaitlab_torch.pipeline.crop import generate_patch_image, normalize_image
from gaitlab_torch.weights import cache as wcache


class LossWeights(NamedTuple):
    kp_2d: float = 300.0
    kp_3d: float = 300.0
    pose: float = 60.0
    shape: float = 0.06


def lr_factor(schedule: Optional[str], total_steps: int,
              warmup_steps: int = 0) -> Callable[[int], float]:
    """The factor on the peak learning rate at each update, counted from 0,
    as gaitlab's optax schedules give it: "cosine" is a linear warmup from
    0 over max(warmup_steps, 1) updates, then a cosine to 0 at
    total_steps; "step" scales by 0.1 from the updates int(0.6 *
    total_steps) and int(0.8 * total_steps) on (once where the two are
    equal); None is constant."""
    if schedule is None:
        return lambda count: 1.0
    if schedule == "cosine":
        warm = max(warmup_steps, 1)
        decay = total_steps - warm
        if decay <= 0:
            raise ValueError(f"the cosine schedule needs total_steps > "
                             f"{warm}, got {total_steps}")

        def cosine(count: int) -> float:
            if count < warm:
                return count / warm
            return 0.5 * (1.0 + math.cos(math.pi * min(count - warm, decay)
                                         / decay))
        return cosine
    if schedule == "step":
        boundaries = sorted({int(total_steps * 0.6), int(total_steps * 0.8)})
        return lambda count: 0.1 ** sum(count >= b for b in boundaries)
    raise ValueError(f"unknown schedule: {schedule}")


def make_optimizer(params, lr: float = 5e-5, kind: str = "adam",
                   schedule: Optional[str] = None, total_steps: int = 10000,
                   warmup_steps: int = 0, weight_decay: float = 0.0,
                   momentum: float = 0.9):
    """(optimizer over `params`, its LambdaLR scheduler): gaitlab's
    make_optimizer on torch.optim. kind: adam | adamw | sgd (with
    momentum); schedule: None | "cosine" | "step" (see lr_factor). Step
    the scheduler once after each optimizer step."""
    if kind == "adam":
        opt = torch.optim.Adam(params, lr=lr)
    elif kind == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)
    elif kind == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum)
    else:
        raise ValueError(f"unknown optimizer kind: {kind}")
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lr_factor(schedule, total_steps, warmup_steps))


def trainable_parameters(core: GRNetCore) -> list:
    """The core's parameters that training moves: all but the backbone's
    when it is frozen."""
    return [p for name, p in core.named_parameters()
            if not (core.freeze_backbone and name.startswith("backbone."))]


@dataclass
class TrainState:
    """The module being trained, its optimizer and scheduler, and the
    number of steps taken."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0

    def save(self, path: str) -> None:
        wcache.save({"module": self.module.state_dict(),
                     "optimizer": self.optimizer.state_dict(),
                     "scheduler": self.scheduler.state_dict(),
                     "step": self.step}, path)

    def load(self, path: str) -> None:
        """Restore what `save` wrote, onto the module's device."""
        tree = wcache.load(path)
        self.module.load_state_dict(tree["module"])
        self.optimizer.load_state_dict(tree["optimizer"])
        self.scheduler.load_state_dict(tree["scheduler"])
        self.step = int(tree["step"])


def create_train_state(module: nn.Module, optimizer: tuple) -> TrainState:
    """A TrainState at step 0 of `module` and make_optimizer's (optimizer,
    scheduler) pair (gaitlab's create_train_state of params and an optax
    transformation)."""
    return TrainState(module, *optimizer)


def grnet_loss(outputs: dict, batch: dict,
               weights: LossWeights = LossWeights()) -> tuple:
    """Keypoint + parameter loss over one flat frame batch.

    outputs: vp_regress's output dict at batch_size=1; batch: {"kp_2d":
    (N,J,3) with a confidence column, "kp_3d": (N,J,4) with one, "pose":
    (N,24,3,3) rotmats, "betas": (N,10), "has_smpl": (N,)}. Returns
    (total, metrics)."""
    gt_2d, conf_2d = batch["kp_2d"][..., :2], batch["kp_2d"][..., 2:]
    gt_3d, conf_3d = batch["kp_3d"][..., :3], batch["kp_3d"][..., 3:]
    l2d = torch.mean(conf_2d * (outputs["kp_2d"] - gt_2d) ** 2)

    def center(x):  # pelvis-aligned, the MPJPE convention
        return x - (x[..., 2:3, :] + x[..., 3:4, :]) / 2.0

    l3d = torch.mean(conf_3d * (center(outputs["kp_3d"]) - center(gt_3d)) ** 2)
    has = batch["has_smpl"]
    lpose = torch.mean(has[:, None, None, None]
                       * (outputs["rotmat"][0] - batch["pose"]) ** 2)
    lshape = torch.mean(has[:, None]
                        * (outputs["theta"][0, :, 75:] - batch["betas"]) ** 2)
    total = (weights.kp_2d * l2d + weights.kp_3d * l3d
             + weights.pose * lpose + weights.shape * lshape)
    return total, {"loss": total, "loss_kp_2d": l2d, "loss_kp_3d": l3d,
                   "loss_pose": lpose, "loss_shape": lshape}


def gait_loss(pred_avg, pred_phase, gt_avg, gt_phase, w_avg: float = 1.0,
              w_phase: float = 1.0) -> tuple:
    """Gait-parameter supervision for the corrector's encoder: MSE on the
    (B,3) averages, and 1 - cos between predicted and target phase for
    each of the two unit-circle pairs of the (B,T,4) phases."""
    l_avg = torch.mean((pred_avg - gt_avg) ** 2)

    def cos_loss(p, g):
        def nrm(v):
            return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True)
                        + 1e-9)
        return 1.0 - (nrm(p) * nrm(g)).sum(-1)

    l_phase = torch.mean(cos_loss(pred_phase[..., :2], gt_phase[..., :2])
                         + cos_loss(pred_phase[..., 2:], gt_phase[..., 2:]))
    return w_avg * l_avg + w_phase * l_phase, {"loss_gait_avg": l_avg,
                                               "loss_gait_phase": l_phase}


def _step(optimizer, scheduler, loss_fn, reduce=None) -> dict:
    """One update in float32 with TF32 off: zero the gradients, backward
    from loss_fn()'s total, reduce() (where given), step optimizer and
    scheduler; the metrics come back detached."""
    with float32_math():
        optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn()
        total.backward()
        if reduce is not None:
            reduce()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(core: GRNetCore, smpl: body_smpl.SMPLParams,
                    optimizer: torch.optim.Optimizer,
                    joint_mode: str = "spin2",
                    weights: LossWeights = LossWeights(),
                    scheduler=None) -> Callable[[dict], dict]:
    """step(batch) -> metrics, one update of the optimizer's parameters.
    batch["images"] holds (N,3,H,W) normalized crops, the other keys are
    grnet_loss's, all on the core's device."""

    def loss_fn(batch):
        core.eval()  # gaitlab applies the trunk with train=False
        out = vp_regress(smpl, core(batch["images"]), batch_size=1,
                         joint_mode=joint_mode)[0]
        return grnet_loss(out, batch, weights)

    return lambda batch: _step(optimizer, scheduler, lambda: loss_fn(batch))


def make_dp_train_step(core: GRNetCore, smpl: body_smpl.SMPLParams,
                       optimizer: torch.optim.Optimizer, devices,
                       joint_mode: str = "spin2",
                       weights: LossWeights = LossWeights(),
                       scheduler=None) -> Callable[[dict], dict]:
    """make_train_step's update, data-parallel over `devices` (one replica
    of the core each, the first the core itself, on devices[0] where the
    batch lies). The batch's images are split in equal row blocks, each
    replica's forward is launched from its own thread on its own stream,
    and the outputs are gathered in order onto the first device, where the
    loss is computed on the whole batch, the unsharded math that gaitlab's
    GSPMD step computes. One backward reaches every replica;
    the replicas' gradients are summed onto the core's in replica order,
    the optimizer (over the core's parameters) steps once, and the trained
    parameters are copied back into the replicas (`step.replicas`). BN
    buffers never change: every replica stays in eval mode."""
    reps = Replicas(core, devices)
    if reps.modules[0] is not core:
        raise ValueError(f"the core must lie on devices[0] ({devices[0]})")
    smpls = [smpl.to(d) for d in reps.devices]
    params = [trainable_parameters(m) for m in reps.modules]

    def forward(module, smpl_i, images):
        module.eval()  # gaitlab applies the trunk with train=False
        return vp_regress(smpl_i, module(images), batch_size=1,
                          joint_mode=joint_mode)[0]

    def loss_fn(batch):
        outs = reps.apply(forward, list(zip(
            smpls, scatter(batch["images"], reps.devices))))
        return grnet_loss(gather(outs, reps.devices[0], dim=1), batch,
                          weights)

    def reduce():
        for i, p in enumerate(params[0]):
            for replica in params[1:]:
                g = replica[i].grad
                if g is not None:
                    g = g.to(p.device)
                    p.grad = g if p.grad is None else p.grad + g

    def step(batch):
        for replica in params[1:]:
            for q in replica:
                q.grad = None
        metrics = _step(optimizer, scheduler, lambda: loss_fn(batch), reduce)
        with torch.no_grad():
            for replica in params[1:]:
                for p, q in zip(params[0], replica):
                    q.copy_(p)
        return metrics

    step.replicas = reps
    return step


def make_gait_train_step(module: nn.Module, optimizer: torch.optim.Optimizer,
                         w_avg: float = 1.0, w_phase: float = 1.0,
                         w_feat: float = 1.0,
                         scheduler=None) -> Callable[[dict], dict]:
    """step(batch) -> metrics for the gait branch's FeatCorrector. batch:
    "features" (B,T,J,C) noisy pose features, "clean_features" (B,T,J,C)
    their targets, "cparams" (B,T,3), "gait_avg" (B,3), "gait_phase"
    (B,T,4). The loss is the gait supervision of the encoder's heads plus
    the reconstruction of the corrected features, so the correction itself
    trains too."""

    def loss_fn(batch):
        corrected, pred_avg, pred_phase = module(batch["features"],
                                                 batch["cparams"])
        total, metrics = gait_loss(pred_avg, pred_phase, batch["gait_avg"],
                                   batch["gait_phase"], w_avg, w_phase)
        l_feat = torch.mean((corrected - batch["clean_features"]) ** 2)
        total = total + w_feat * l_feat
        metrics.update({"loss": total, "loss_feat": l_feat})
        return total, metrics

    return lambda batch: _step(optimizer, scheduler, lambda: loss_fn(batch))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def synthetic_gait_batch(b: int, t: int = 32, j: int = 24, c: int = 16,
                         noise: float = 0.5, seed: int = 0,
                         freq_range=(0.05, 0.25), amp_range=(0.5, 2.0),
                         duty_range=(0.3, 0.7), cam_sway: float = 0.1) -> dict:
    """Synthetic gait-labelled sequences (numpy float32, gaitlab's arrays).

    A walking cycle is per-joint sinusoids riding a shared phase; the
    labels are the generating parameters: walk speed (about the cycle
    frequency), two step parameters (amplitude, duty) and the per-frame
    phase as [cos th, sin th, cos th/2, sin th/2]. "features" carries
    white noise; "clean_features" is the corrector's target. The joints'
    offsets and gains are fixed (seeded apart from `seed`), so the
    features-to-phase mapping is the same in every batch."""
    rng = np.random.default_rng(seed)
    freq = rng.uniform(*freq_range, size=(b, 1))         # cycles/frame
    amp = rng.uniform(*amp_range, size=(b, 1))
    duty = rng.uniform(*duty_range, size=(b, 1))
    phase0 = rng.uniform(0, 2 * np.pi, size=(b, 1))
    theta = 2 * np.pi * freq * np.arange(t)[None, :] + phase0  # (B,T)

    srng = np.random.default_rng(12345)  # skeleton structure: fixed
    joint_off = srng.uniform(0, 2 * np.pi, size=(j, c))
    joint_gain = srng.normal(size=(j, c)) * 0.5 + 1.0
    clean = (amp[:, :, None, None] * joint_gain[None, None]
             * np.sin(theta[:, :, None, None] + joint_off[None, None]))
    feats = clean + noise * rng.normal(size=clean.shape)

    cparams = np.stack([
        np.ones((b, t)), 0.1 * np.cos(theta), 0.1 * np.sin(theta)], axis=-1)
    gait_avg = np.concatenate([freq * 10.0, amp, duty], axis=1)  # (B,3)
    gait_phase = np.stack([np.cos(theta), np.sin(theta),
                           np.cos(theta / 2), np.sin(theta / 2)], axis=-1)
    return {k: np.asarray(v, np.float32) for k, v in (
        ("features", feats), ("clean_features", clean), ("cparams", cparams),
        ("gait_avg", gait_avg), ("gait_phase", gait_phase))}


def synthetic_walker_clip(t: int, h: int = 128, w: int = 192,
                          freq: float = 0.12, amp_deg: float = 28.0,
                          speed: float = 1.5, seed: int = 0,
                          phase0: float = 0.0):
    """A t-frame clip of a 2D articulated walker with a known gait:
    a torso box, two legs swinging with sin(theta) and two arms with
    cos(theta) (quadrature, so that the phase is observable from pixels)
    on theta(i) = 2 pi freq i + phase0, moving `speed` px/frame over a
    uniform background (a textured one would leak position, hence phase,
    into the tracked crop).

    Returns (frames uint8 (t,h,w,3), bboxes (t,4) cxcywh squares,
    theta (t,))."""
    import cv2

    bg = np.full((h, w, 3), 55, np.uint8)
    frames = np.empty((t, h, w, 3), np.uint8)
    bboxes = np.empty((t, 4), np.float32)
    theta = 2 * np.pi * freq * np.arange(t) + phase0
    body_h, leg_len = int(h * 0.28), int(h * 0.3)
    for i in range(t):
        f = bg.copy()
        cx = int(w * 0.2 + speed * i) % (w - 40) + 20
        top = int(h * 0.12)
        hip = (cx, top + body_h)
        sh = (cx, top + int(body_h * 0.25))
        cv2.rectangle(f, (cx - 9, top), (cx + 9, hip[1]),
                      (205, 185, 175), -1)
        cv2.circle(f, (cx, top - 10), 11, (198, 168, 158), -1)
        a = np.deg2rad(amp_deg) * np.sin(theta[i])   # legs
        b = np.deg2rad(amp_deg) * np.cos(theta[i])   # arms: quadrature
        for ang, origin, ln, col in (
                (+a, hip, leg_len, (215, 195, 185)),
                (-a, hip, leg_len, (185, 170, 160)),
                (+b, sh, int(leg_len * 0.8), (225, 205, 195)),
                (-b, sh, int(leg_len * 0.8), (175, 160, 150))):
            end = (int(origin[0] + ln * np.sin(ang)),
                   int(origin[1] + ln * np.cos(ang)))
            cv2.line(f, origin, end, col, 7)
        frames[i] = f
        side = body_h + leg_len + 30
        bboxes[i] = (cx, top + (body_h + leg_len) / 2.0, side, side)
    return frames, bboxes, theta


def walker_crops(frames: np.ndarray, bboxes: np.ndarray, img: int
                 ) -> np.ndarray:
    """Square uint8 crops (T,img,img,3) of a walker clip, as gaitlab's
    trainer takes them (scale 1)."""
    return np.stack([generate_patch_image(f, *bb, img, img, scale=1.0)[0]
                     for f, bb in zip(frames, bboxes)])


def to_input(crops, device) -> torch.Tensor:
    """uint8 (N,H,W,3) crops -> normalized (N,3,H,W) float32 on `device`."""
    x = upload(np.asarray(crops), device)
    return normalize_image(x).permute(0, 3, 1, 2).contiguous()


def trunk_gait_batch(model, b: int = 4, t: int = 32, img: int = 64,
                     seed: int = 0, noise: float = 0.1) -> dict:
    """A gait training batch from the real trunk: b walker clips with
    known speed and phase (synthetic_walker_clip), cropped at `img`,
    through the model's backbone, the PARE feature extractor and camera
    head (the features the gait branch reads), labelled with the
    generator's parameters. `model` is a GRNet on its device, BN-calibrated
    (calibrate_backbone_bn). Returns make_gait_train_step's batch as
    numpy float32."""
    core = model.module
    rng = np.random.default_rng(seed)
    feats, cps, avgs, phases = [], [], [], []
    for k in range(b):
        freq = float(rng.uniform(0.06, 0.2))
        amp = float(rng.uniform(18.0, 38.0))
        speed = float(rng.uniform(0.8, 2.5))
        phase0 = float(rng.uniform(0, 2 * np.pi))
        frames, bboxes, theta = synthetic_walker_clip(
            t, freq=freq, amp_deg=amp, speed=speed, seed=seed + 7 * k,
            phase0=phase0)
        h, w = frames.shape[1:3]
        cimg = np.full((t, 2), [w * 0.5, h * 0.5], np.float32)
        with float32_math(), torch.inference_mode():
            x = to_input(walker_crops(frames, bboxes, img), model.device)
            fx = core.head.feature_extractor(core.backbone(x))
            patt = core.head.predict(fx["point_local_feat"],
                                     fx["cam_shape_feats"])
            cp = camera_reparam(patt["pred_cam"],
                                upload(bboxes, model.device),
                                upload(cimg, model.device))
            feats.append(fx["point_local_feat"].cpu().numpy())
            cps.append(cp.cpu().numpy())
        avgs.append([freq * 10.0, amp / 20.0, speed / 2.0])
        # leg phase and arm (quadrature) phase: appearance is 2 pi-periodic
        # in theta, so a half-rate phase could not be read from pixels
        phases.append(np.stack(
            [np.cos(theta), np.sin(theta),
             np.cos(theta - np.pi / 2), np.sin(theta - np.pi / 2)], axis=-1))
    clean = np.stack(feats)
    # feature scale normalized, so the reconstruction loss is comparable
    # across random-weight trunks
    clean = clean / (np.abs(clean).mean() + 1e-9)
    noisy = clean + noise * rng.normal(size=clean.shape)
    return {k: np.asarray(v, np.float32) for k, v in (
        ("features", noisy), ("clean_features", clean),
        ("cparams", np.stack(cps)), ("gait_avg", avgs),
        ("gait_phase", np.stack(phases)))}


def synthetic_batch(n: int, img: int = 224, num_joints: int = 29,
                    seed: int = 0, device=None) -> dict:
    """A random supervised batch in make_train_step's contract, made from a
    torch.Generator seeded with `seed` on the CPU and moved to `device`
    (None: the card). gaitlab's draws from jax.random: the two streams
    differ."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    ones = torch.ones(n, num_joints, 1)
    batch = {
        "images": torch.randn(n, 3, img, img, generator=gen),
        "kp_2d": torch.cat([torch.randn(n, num_joints, 2, generator=gen),
                            ones], -1),
        "kp_3d": torch.cat([torch.randn(n, num_joints, 3, generator=gen),
                            ones], -1),
        "pose": torch.eye(3).repeat(n, 24, 1, 1),
        "betas": torch.randn(n, 10, generator=gen) * 0.03,
        "has_smpl": torch.ones(n),
    }
    return {k: v.to(device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# BatchNorm calibration
# ---------------------------------------------------------------------------

def _calibrate(bns: list, run: Callable[[], None]) -> None:
    """Set each BatchNorm's running statistics to the exact statistics of
    its input in one pass of run(): the batch mean and the biased batch
    variance, which the pass also normalizes with (as a train-mode pass
    does); afterwards the variances are clamped at 1e-6, as gaitlab
    clamps them. The pass takes the backbone's standard blocks, as
    gaitlab's train-mode pass does, so that every BatchNorm2d is called."""
    def take_batch_stats(bn, args):
        var, mean = torch.var_mean(args[0], dim=(0, 2, 3), unbiased=False)
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)

    handles = [bn.register_forward_pre_hook(take_batch_stats) for bn in bns]
    try:
        with torch.no_grad(), float32_math(), standard_blocks():
            run()
    finally:
        for h in handles:
            h.remove()
    with torch.no_grad():
        for bn in bns:
            bn.running_var.clamp_(min=1e-6)


def _batch_norms(module: nn.Module) -> list:
    return [m for m in module.modules() if isinstance(m, nn.BatchNorm2d)]


def calibrate_backbone_bn(core: GRNetCore, images: torch.Tensor
                          ) -> GRNetCore:
    """Replace the backbone's BN running statistics with the exact batch
    statistics of one pass over `images` (N,3,H,W normalized, on the
    core's device), in place. Fresh-init statistics (mean 0, var 1)
    collapse a deep random-weight conv stack into an input-independent
    function. The head's statistics stay as they are."""
    core.eval()
    _calibrate(_batch_norms(core.backbone), lambda: core.backbone(images))
    return core


def calibrate_all_bn(core: GRNetCore, images: torch.Tensor) -> GRNetCore:
    """Calibrate the PARE head's BN statistics over the backbone's
    features, in place (as calibrate_backbone_bn does the backbone's).
    The backbone runs on its running statistics here, as in gaitlab's
    calibrate_all_bn, so calibrating both takes calibrate_backbone_bn
    first, then this."""
    core.eval()
    _calibrate(_batch_norms(core.head),
               lambda: core.head.feature_extractor(core.backbone(images)))
    return core
