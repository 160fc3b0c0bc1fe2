"""Training CLI: fine-tune the PARE head, or train the gait branch.

Counterpart of gaitlab/cli/train.py, with gaitlab's flags:

  * data: .npz shards with images (N,H,W,3 uint8, or normalized float32),
    kp_2d (N,J,3 with confidence), kp_3d (N,J,4 with confidence), pose
    (N,24,3,3), betas (N,10), has_smpl (N,); with --gait, shards with
    features, clean_features, cparams, gait_avg and gait_phase, or
    `--data synthetic` for walker clips through the real trunk;
  * step: gaitlab_torch.training (the head only; the backbone is frozen
    and every BatchNorm keeps its statistics), on the card unless the
    caller asks for the CPU (`main(args, device="cpu")`);
  * checkpoints: model, optimizer, scheduler and step in one torch file,
    <workdir>/ckpt.pt (ckpt_gait.pt for --gait), every --save_every steps
    and at the last; --resume restores them and restarts the batch
    stream at --seed, as gaitlab does.

--use_mesh (data parallel over several devices) raises: it waits for the
port's parallelism (ROADMAP A18).
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import time

import numpy as np

SHARD_KEYS = ("images", "kp_2d", "kp_3d", "pose", "betas", "has_smpl")
GAIT_KEYS = ("features", "clean_features", "cparams", "gait_avg",
             "gait_phase")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, required=True,
                   help="glob of .npz training shards")
    p.add_argument("--workdir", type=str, default="runs/train",
                   help="checkpoints + logs directory")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_every", type=int, default=200)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init_ckpt", type=str, default="",
                   help="torch checkpoint to initialise from")
    p.add_argument("--smpl_model", type=str, default=None)
    p.add_argument("--use_mesh", action="store_true",
                   help="data parallel over all visible devices (not "
                        "ported: raises)")
    p.add_argument("--gait", action="store_true",
                   help="train the gait-branch FeatCorrector on real trunk "
                        "pose features (training.trunk_gait_batch): "
                        "--data 'synthetic' renders walker clips with known "
                        "speed/phase and runs the backbone+PARE extractor; "
                        "otherwise --data globs .npz shards with keys "
                        "features/clean_features/cparams/gait_avg/gait_phase")
    p.add_argument("--gait_clips", type=int, default=6,
                   help="walker clips per generated batch (--data synthetic)")
    p.add_argument("--gait_seq_len", type=int, default=32)
    p.add_argument("--gait_img", type=int, default=64,
                   help="crop size for trunk feature extraction")
    p.add_argument("--gait_h_size", type=int, default=256)
    return p


def _load_shards(pattern: str, keys=SHARD_KEYS) -> dict:
    files = sorted(glob.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no shards match {pattern}")
    parts = [np.load(f) for f in files]
    return {k: np.concatenate([p[k] for p in parts], axis=0) for k in keys}


def _batches(data: dict, batch_size: int, steps: int, seed: int):
    """`steps` batches of `batch_size` samples drawn with replacement, as
    numpy arrays (images as stored)."""
    n = data["images"].shape[0]
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        idx = rng.integers(0, n, batch_size)
        yield {k: v[idx] for k, v in data.items()}


def _to_device(batch: dict, device) -> dict:
    """A numpy batch on `device`, images NCHW; uint8 images are normalized
    as the demo's crops are."""
    from gaitlab_torch.device import upload
    from gaitlab_torch.training import to_input

    out = {k: upload(np.asarray(v, np.float32), device)
           for k, v in batch.items() if k != "images"}
    img = batch["images"]
    out["images"] = (to_input(img, device) if img.dtype == np.uint8 else
                     upload(np.asarray(img, np.float32), device
                            ).permute(0, 3, 1, 2).contiguous())
    return out


def _train(state, step_fn, batches, first: int, args, logger, ckpt: str,
           what: str, unit: str, per_step: int) -> None:
    """Steps `first`..args.steps over `batches`, gaitlab's log lines and
    checkpoints."""
    from gaitlab_torch.utils import AverageMeter

    meter = AverageMeter()
    t0 = time.time()
    for i, batch in zip(range(first, args.steps + 1), batches):
        metrics = step_fn(batch)
        state.step = i
        meter.update(float(metrics["loss"]))
        if i % args.log_every == 0:
            rate = per_step * args.log_every / (time.time() - t0)
            logger.info(f"step {i}: {what}loss {meter.avg:.4f} "
                        f"({rate:.1f} {unit}/s)")
            meter.reset()
            t0 = time.time()
        if i % args.save_every == 0 or i == args.steps:
            state.save(ckpt)
            logger.info(f"{what}checkpoint saved at step {i}")


def _resume(state, args, ckpt: str, logger) -> int:
    if args.resume and osp.isfile(ckpt):
        state.load(ckpt)
        logger.info(f"resumed from step {state.step}")
    return state.step


def main(args, device=None):
    """Train as the flags say; returns (model, state). `device` None is the
    card."""
    from gaitlab_torch import training
    from gaitlab_torch.cli.demo import build_model
    from gaitlab_torch.utils import create_logger

    if args.use_mesh:
        raise NotImplementedError(
            "--use_mesh: data-parallel training is not ported yet (ROADMAP "
            "A18, parallelism)")
    os.makedirs(args.workdir, exist_ok=True)
    logger = create_logger(args.workdir, phase="train")
    if args.gait:
        return main_gait(args, logger, device)

    model = build_model(args.init_ckpt, args.smpl_model, device=device)
    optimizer, scheduler = training.make_optimizer(
        training.trainable_parameters(model.module), lr=args.lr)
    state = training.TrainState(model.module, optimizer, scheduler)
    ckpt = osp.abspath(osp.join(args.workdir, "ckpt.pt"))
    start_step = _resume(state, args, ckpt, logger)
    step_fn = training.make_train_step(model.module, model.smpl, optimizer,
                                       joint_mode=model.joint_mode,
                                       scheduler=scheduler)

    data = _load_shards(args.data)
    logger.info(f"{data['images'].shape[0]} samples loaded")
    batches = (_to_device(b, model.device) for b in _batches(
        data, args.batch_size, args.steps - start_step, args.seed))
    _train(state, step_fn, batches, start_step + 1, args, logger, ckpt,
           "", "samples", args.batch_size)
    return model, state


def main_gait(args, logger, device=None):
    """The gait branch's trainer: a FeatCorrector on trunk pose features,
    from walker clips with known speed and phase through the real backbone
    and PARE feature extractor (`--data synthetic`), or from .npz shards
    with the same keys."""
    import torch

    from gaitlab_torch import training
    from gaitlab_torch.device import resolve_device, upload
    from gaitlab_torch.nn.gait import FeatCorrector

    device = resolve_device(device)
    if args.data == "synthetic":
        from gaitlab_torch.nn.grnet import GRNet

        model = GRNet.create(device=device)
        frames, bboxes, _ = training.synthetic_walker_clip(
            16, seed=args.seed + 99)
        training.calibrate_backbone_bn(model.module, training.to_input(
            training.walker_crops(frames, bboxes, args.gait_img), device))
        logger.info("rendering walker clips + extracting trunk features...")
        batches = [training.trunk_gait_batch(
            model, b=args.gait_clips, t=args.gait_seq_len,
            img=args.gait_img, seed=args.seed + 31 * s) for s in range(4)]
        del model
    else:
        files = sorted(glob.glob(args.data))
        if not files:
            raise FileNotFoundError(f"no gait shards match {args.data}")
        batches = [_load_shards(f, GAIT_KEYS) for f in files]
    batches = [{k: upload(np.asarray(v, np.float32), device)
                for k, v in b.items()} for b in batches]
    _, _, j, c = batches[0]["features"].shape
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        module = FeatCorrector(num_joints=j, feat_dim=c,
                               h_size=args.gait_h_size, num_heads=2,
                               stop_gaitfeat_grad=False).to(device)
    optimizer, scheduler = training.make_optimizer(module.parameters(),
                                                   lr=args.lr)
    state = training.TrainState(module, optimizer, scheduler)
    ckpt = osp.abspath(osp.join(args.workdir, "ckpt_gait.pt"))
    start_step = _resume(state, args, ckpt, logger)
    step_fn = training.make_gait_train_step(module, optimizer,
                                            scheduler=scheduler)
    cycle = (batches[(i - 1) % len(batches)]
             for i in range(start_step + 1, args.steps + 1))
    _train(state, step_fn, cycle, start_step + 1, args, logger, ckpt,
           "gait ", "steps", 1)
    return module, state


def main_cli(argv=None, device=None):
    return main(build_parser().parse_args(argv), device=device)


if __name__ == "__main__":
    main_cli()
