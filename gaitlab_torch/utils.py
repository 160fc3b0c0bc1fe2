"""Logging, meters, profiling and per-stage wall-clock telemetry.

Counterpart of gaitlab/utils.py: `create_logger`, `AverageMeter`,
`StageTimer` (one structured report of the demo's stages in place of
scattered time brackets) and `profile_trace`, on torch.profiler here.
gaitlab's `enable_compile_cache` has no counterpart: the port compiles
nothing at run time but its CUDA kernels, which ops/_build.py caches by
source hash.
"""

from __future__ import annotations

import contextlib
import logging
import os
import os.path as osp
import time
from typing import Optional


def create_logger(logdir: str, phase: str = "train") -> logging.Logger:
    """File+console logger (reference utils.py:138-151)."""
    os.makedirs(logdir, exist_ok=True)
    log_file = osp.join(logdir,
                        f"{time.strftime('%Y-%m-%d_%H-%M-%S')}_{phase}.log")
    logging.basicConfig(filename=log_file, format="%(asctime)-15s %(message)s")
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    console = logging.StreamHandler()
    logging.getLogger("").addHandler(console)
    return logger


class AverageMeter:
    """Running average (reference utils.py:154-168)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0


class StageTimer:
    """Seconds spent per named stage, summed over repeats."""

    def __init__(self):
        self.stages: dict[str, float] = {}
        self._t0 = time.time()

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.time()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.time() - t

    def total(self) -> float:
        return time.time() - self._t0

    def report(self) -> str:
        lines = [f"  {k}: {v:.2f}s" for k, v in self.stages.items()]
        return "\n".join(lines + [f"  total: {self.total():.2f}s"])

    def fps(self, num_frames: int, stage: Optional[str] = None) -> float:
        dt = self.stages.get(stage, self.total()) if stage else self.total()
        return num_frames / dt if dt > 0 else 0.0


@contextlib.contextmanager
def profile_trace(logdir: Optional[str] = None):
    """torch.profiler trace of the enclosed work (host, and the card's
    kernels when CUDA is there), written to `logdir` or $GAITLAB_PROFILE as
    a TensorBoard/Chrome trace file; a no-op when neither is set."""
    logdir = logdir or os.environ.get("GAITLAB_PROFILE")
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
