"""Device selection and float32 math for the port.

Entry points run on the card unless the caller asks for the CPU; they
never drop to the CPU on their own.
"""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def float32_math():
    """Full float32 for cuDNN convolutions and cuBLAS matmuls: TF32 off for
    both (cuDNN convolutions default to TF32 on Hopper). The previous flags
    are restored on exit."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
