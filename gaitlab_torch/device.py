"""Device selection and float32 math for the port.

Entry points run on the card unless the caller asks for the CPU; they
never drop to the CPU on their own.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA. Raises when CUDA is absent and the caller did not
    ask for the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' (demo: --cpu_only) to "
            "run on the CPU")
    return device


def upload(x, device) -> torch.Tensor:
    """A host array or tensor on `device`. To the card it goes through
    pinned memory as an asynchronous copy: a copy from pageable memory
    makes the host wait until the card has run everything queued before
    it. The pinned block is the caching host allocator's, which reuses it
    only once the copy has run, so the caller need not keep it."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    device = torch.device(device)
    if device.type != "cuda" or x.device.type != "cpu":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


def constant(values: tuple, dtype: str, device) -> torch.Tensor:
    """A tensor of fixed values (an index list, a normalisation constant)
    on `device`, made once per device and shared: never write to it. A
    Python list turned into a card tensor, or used to index one, is copied
    to the card at every call, and that copy waits for the card's queue.
    Made outside inference mode, so that autograd may save it. While
    `torch.export` traces, the tensor is made on `device` as a constant of
    the program and not cached (the trace's tensors are fake)."""
    if torch.compiler.is_exporting():
        return torch.tensor(np.asarray(values, dtype), device=device)
    return _constant(values, dtype, device)


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, dtype: str, device) -> torch.Tensor:
    with torch.inference_mode(False):
        return upload(np.asarray(values, dtype), device)


_f32_lock = threading.Lock()
_f32_users = 0
_f32_prev = None


@contextlib.contextmanager
def float32_math():
    """Full float32 for cuDNN convolutions and cuBLAS matmuls: TF32 off for
    both (cuDNN convolutions default to TF32 on Hopper). The flags are
    process-wide, and forwards may run on several threads at once: the
    previous flags come back when the last thread inside has left."""
    global _f32_users, _f32_prev
    with _f32_lock:
        if _f32_users == 0:
            _f32_prev = (torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32)
        _f32_users += 1
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        with _f32_lock:
            _f32_users -= 1
            if _f32_users == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _f32_prev
