"""2-stage pipeline parallelism for GRNet inference.

Counterpart of gaitlab/parallel/pipeline.py. Stage 0 (the HRNet backbone,
images -> (N, 480, S, S) features) and stage 1 (the PARE head and the SMPL
regression, features -> verts/joints/theta) run on two device groups,
each data-parallel over its own group (parallel/replicas.py), and each
group holds only its stage's weights. Microbatches stream through them
GPipe-style. The features are the only tensor that crosses the boundary.

gaitlab's schedule is a host loop that relies on asynchronous dispatch to
overlap the two stages. A torch host loop would block inside stage 0 (the
card's launch queue holds fewer launches than one backbone forward), so
each stage has its own worker thread and its own stream on each of its
devices, with a queue one microbatch deep between them, as gaitlab's
1-deep schedule. Stage 0 records an event on its stream after each
microbatch; stage 1's stream waits on it before the boundary copy
(`features.to(stage-1 device, non_blocking=True)`), which on one card is
no copy at all: the event alone orders the stages. A device list may
name a card twice, so that both stages share it on separate streams.

Each stage runs at its module's modes: the backbone's regions and the
head set the TF32 gate (device.math_mode) themselves, and the SMPL
regression runs with TF32 off, so the two stages' threads take turns at
the gate when their modes differ. (gaitlab builds its pipeline without
the runner's precision, so its pp path runs at the backend's default: a
fault of the reference, not copied.)
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from gaitlab_torch.device import upload
from gaitlab_torch.nn.grnet import vp_regress
from gaitlab_torch.parallel import mesh as mesh_mod
from gaitlab_torch.parallel.replicas import Replicas, scatter

__all__ = ["split_state_dict", "GRNetPipeline"]


def split_state_dict(state: dict) -> tuple[dict, dict]:
    """A GRNetCore state_dict split into (the backbone's keys, the rest):
    what each stage's group holds."""
    stage0 = {k: v for k, v in state.items() if k.startswith("backbone.")}
    stage1 = {k: v for k, v in state.items() if not k.startswith("backbone.")}
    return stage0, stage1


class _Stage:
    """One stage: its replicas, and one stream per distinct device that the
    stage's thread makes current, so that its work and the event that ends
    each microbatch are ordered apart from the other stage and the
    caller."""

    def __init__(self, module, devices: Sequence):
        self.replicas = Replicas(module, devices)
        self.streams = {d: torch.cuda.Stream(d)
                        for d in self.replicas.devices if d.type == "cuda"}

    def current(self) -> contextlib.ExitStack:
        stack = contextlib.ExitStack()
        for stream in self.streams.values():
            stack.enter_context(torch.cuda.stream(stream))
        return stack

    def wait_for(self, streams) -> None:
        for s in self.streams.values():
            for other in streams:
                s.wait_stream(other)

    def record(self) -> list:
        """An event on each of the stage's streams."""
        return [s.record_event() for s in self.streams.values()]

    def wait_events(self, events: list) -> None:
        for s in self.streams.values():
            for e in events:
                s.wait_event(e)


def _reshard(pieces: list, devices: list) -> list:
    """Stage 0's row blocks re-split into len(devices) equal blocks, block
    j on devices[j], in row order (gaitlab's device_put onto the stage-1
    sharding). Each source is recorded on its device's current stream,
    which the copies use."""
    n = sum(len(p) for p in pieces)
    k = n // len(devices)
    out, at = [], 0  # `at`: the first row of the next block
    for j, dev in enumerate(devices):
        parts, start = [], 0
        for p in pieces:
            lo, hi = max(at - start, 0), min(at + k - start, len(p))
            if lo < hi:
                if p.device.type == "cuda":
                    p.record_stream(torch.cuda.current_stream(p.device))
                parts.append(p[lo:hi].to(dev, non_blocking=True))
            start += len(p)
        out.append(parts[0] if len(parts) == 1 else torch.cat(parts))
        at += k
    return out


class GRNetPipeline:
    """GPipe-style 2-stage inference pipeline over two device groups.

    model: a GRNet (the gait branch is refused: it is track-sequential and
    belongs to the track-level pass, not the per-frame trunk that this
    pipeline parallelises). devices: the devices to split (default: the
    model's, `mesh.devices_for`: every visible card); the first `n_stage0`
    run the backbone, the rest the head and SMPL (default: half)."""

    def __init__(self, model, devices: Optional[Sequence] = None,
                 n_stage0: Optional[int] = None):
        devices, n_stage0 = self.check_devices(model, n_stage0, devices)
        self.model = model
        self._dp0 = n_stage0
        self._dp1 = len(devices) - n_stage0
        core = model.module
        self._stage0 = _Stage(core.backbone, devices[:n_stage0])
        self._stage1 = _Stage(core.head, devices[n_stage0:])
        self._smpl = [model.smpl.to(d) for d in self._stage1.replicas.devices]

    @staticmethod
    def check_devices(model, n_stage0: Optional[int] = None,
                      devices: Optional[Sequence] = None) -> tuple:
        """(devices, n_stage0) for a pipeline of `model`, or ValueError (the
        gait branch, fewer than two devices, a group left empty)."""
        if model.module.use_gait_feat:
            raise ValueError(
                "GRNetPipeline parallelises the per-frame trunk; the gait "
                "branch is track-sequential — run it with the DP runner")
        devices = list(devices if devices is not None
                       else mesh_mod.devices_for(model.device))
        if len(devices) < 2:
            raise ValueError(f"need >= 2 devices, have {len(devices)}")
        if n_stage0 is None:
            n_stage0 = len(devices) // 2
        if not 0 < n_stage0 < len(devices):
            raise ValueError(f"n_stage0={n_stage0} of {len(devices)}")
        return devices, n_stage0

    def default_microbatch(self, n: int, target: int = 32) -> int:
        """Smallest valid microbatch >= min(target, n): a multiple of the
        lcm of both group sizes (each stage splits a microbatch evenly over
        its group), at or above `target`, capped so that a short clip does
        not get one large padded microbatch."""
        base = int(np.lcm(self._dp0, self._dp1))
        want = max(1, min(target, n if n > 0 else target))
        return base * max(1, -(-want // base))

    def _run_stage0(self, crops, microbatch: int, n_mb: int,
                    handoff: queue.Queue, errors: list) -> None:
        """Stage 0's thread: the backbone on each microbatch, its features
        and the event that ends it handed to stage 1; None at the end."""
        stage = self._stage0
        devices = stage.replicas.devices
        try:
            with stage.current(), torch.inference_mode():
                for t in range(n_mb):
                    mb = crops[t * microbatch:(t + 1) * microbatch]
                    feats = stage.replicas.apply(
                        lambda m, x: m(x.permute(0, 3, 1, 2).contiguous()),
                        [(x,) for x in scatter(mb, devices)])
                    handoff.put((feats, stage.record()))
        except BaseException as e:  # raised again in __call__
            errors.append(e)
        finally:
            handoff.put(None)

    def _run_stage1(self, handoff: queue.Queue, outs: list,
                    errors: list) -> None:
        """Stage 1's thread: the head and SMPL on each microbatch's
        features once stage 0's event has passed; after an error it
        drains the queue so that stage 0 ends."""
        stage = self._stage1
        joint_mode = self.model.joint_mode

        def head(module, smpl, features):
            out = vp_regress(smpl, module(features), batch_size=1,
                             joint_mode=joint_mode)[0]
            return {k: v[0] for k, v in out.items()}

        with stage.current(), torch.inference_mode():
            while (item := handoff.get()) is not None:
                if errors:
                    continue
                feats, events = item
                try:
                    stage.wait_events(events)
                    pieces = _reshard(feats, stage.replicas.devices)
                    outs.append(stage.replicas.apply(
                        head, list(zip(self._smpl, pieces))))
                except BaseException as e:  # raised again in __call__
                    errors.append(e)

    def __call__(self, crops_nhwc, microbatch: Optional[int] = None) -> dict:
        """N normalized NHWC crops (an array or a tensor) through the
        pipeline. `microbatch` is the per-tick batch (default:
        default_microbatch); the tail microbatch is zero-padded and the
        padding sliced off. Returns numpy arrays in GRNet.forward's
        layout: every value (1, N, ...), one track of N frames."""
        crops = crops_nhwc
        if not isinstance(crops, torch.Tensor):
            crops = upload(np.asarray(crops, np.float32),
                           self._stage0.replicas.devices[0])
        n = crops.shape[0]
        if n == 0:
            raise ValueError("GRNetPipeline needs at least one frame")
        if microbatch is None:
            microbatch = self.default_microbatch(n)
        if microbatch % self._dp0 or microbatch % self._dp1:
            raise ValueError(
                f"microbatch={microbatch} must divide by both stage "
                f"groups ({self._dp0}, {self._dp1}); "
                f"default_microbatch() picks one")
        n_mb = -(-n // microbatch)
        pad = n_mb * microbatch - n
        if pad:
            crops = torch.cat([crops,
                               crops.new_zeros((pad,) + crops.shape[1:])])

        # each stage's streams start after the caller's (the crops), and
        # the caller's stream waits for stage 1's before the read-back
        callers = {d: torch.cuda.current_stream(d)
                   for d in {*self._stage0.streams, *self._stage1.streams}}
        self._stage0.wait_for(callers.values())
        self._stage1.wait_for(callers.values())
        handoff: queue.Queue = queue.Queue(maxsize=1)
        outs, errors0, errors1 = [], [], []
        threads = [
            threading.Thread(target=self._run_stage0, daemon=True,
                             args=(crops, microbatch, n_mb, handoff, errors0)),
            threading.Thread(target=self._run_stage1, daemon=True,
                             args=(handoff, outs, errors1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for caller in callers.values():
            for s in self._stage1.streams.values():
                caller.wait_stream(s)
        for e in errors0 + errors1:
            raise e
        merged = {k: np.concatenate([o[k].cpu().numpy() for mb in outs
                                     for o in mb])
                  for k in outs[0][0]}
        return {k: v[:n][None] for k, v in merged.items()}
