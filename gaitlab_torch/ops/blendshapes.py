"""Fused SMPL blendshapes: v_template + shapedirs.beta + posedirs.pose.

The CUDA kernel (csrc/blendshapes.cu) replaces the Pallas TPU kernel
gaitlab/ops/lbs_pallas.py::blendshapes. On the card it is bound by its
FP32 multiply-adds (about 17 us at B = 128 on an H100); the source note
says how the design meets that. CPU tensors take the plain version.
"""

from __future__ import annotations

import torch

from gaitlab_torch.ops import _build


def blendshapes_plain(v_template: torch.Tensor, shapedirs: torch.Tensor,
                      posedirs: torch.Tensor, betas: torch.Tensor,
                      pose_feature: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `blendshapes`, in the same layouts."""
    v = v_template.shape[0]
    b = betas.shape[0]
    shaped = torch.einsum("vds,bs->bvd", shapedirs, betas)
    posed = torch.einsum("pr,bp->br", posedirs, pose_feature).reshape(b, v, 3)
    return v_template[None] + shaped + posed


def blendshapes(v_template: torch.Tensor, shapedirs: torch.Tensor,
                posedirs: torch.Tensor, betas: torch.Tensor,
                pose_feature: torch.Tensor) -> torch.Tensor:
    """(V,3) + (V,3,S).(B,S) + (P,V*3).(B,P) -> (B,V,3) float32.

    On CUDA tensors this launches the kernel (or raises); on CPU tensors
    it runs `blendshapes_plain`."""
    args = (v_template, shapedirs, posedirs, betas, pose_feature)
    if all(a.device.type == "cpu" for a in args):
        return blendshapes_plain(*args)
    dev = v_template.device
    if dev.type != "cuda" or any(a.device != dev for a in args):
        raise ValueError("blendshapes: all inputs must be on one CUDA device "
                         f"(got {[str(a.device) for a in args]})")
    if any(a.dtype != torch.float32 or not a.is_contiguous() for a in args):
        raise ValueError("blendshapes: inputs must be contiguous float32")
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        raise NotImplementedError("blendshapes: the kernel has no backward")
    v = v_template.shape[0]
    b, s = betas.shape
    p = pose_feature.shape[1]
    if (v_template.shape != (v, 3) or shapedirs.shape != (v, 3, s)
            or posedirs.shape != (p, v * 3) or pose_feature.shape != (b, p)):
        raise ValueError(
            "blendshapes: shapes "
            f"{[tuple(a.shape) for a in args]} do not match "
            "(V,3), (V,3,S), (P,V*3), (B,S), (B,P)")
    out = torch.empty((b, v, 3), device=dev, dtype=torch.float32)
    if b == 0:
        return out
    lib = _build.library("blendshapes")
    with torch.cuda.device(dev):
        code = lib.gaitlab_blendshapes(
            v_template.data_ptr(), shapedirs.data_ptr(), posedirs.data_ptr(),
            betas.data_ptr(), pose_feature.data_ptr(), out.data_ptr(),
            v * 3, b, s, p, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "blendshapes")
    blendshapes.launches += 1
    return out


blendshapes.launches = 0
