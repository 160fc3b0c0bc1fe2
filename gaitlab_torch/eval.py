"""Pose-estimation evaluation metrics: MPJPE, PA-MPJPE, PVE, acceleration.

Counterpart of gaitlab/eval.py (the 3DPW/SPIN evaluation protocol). All
metrics take batched float32 tensors on any device, run there in full
float32, and return per-sample values in the input units (metres ->
multiply by 1000 for mm); `evaluate_batch` reports means in mm as Python
floats.
"""

from __future__ import annotations

from typing import Optional

import torch

from gaitlab_torch.device import float32_math


def mpjpe(pred: torch.Tensor, gt: torch.Tensor, pelvis_idx=None
          ) -> torch.Tensor:
    """Mean per-joint position error, (B,J,3) -> (B,).

    pelvis_idx: joint index (or list of indices) to root-align both
    skeletons first."""
    if pelvis_idx is not None:
        idx = torch.as_tensor(pelvis_idx, device=pred.device).reshape(-1)
        pred = pred - pred[:, idx].mean(dim=1, keepdim=True)
        gt = gt - gt[:, idx].mean(dim=1, keepdim=True)
    return torch.linalg.vector_norm(pred - gt, dim=-1).mean(dim=-1)


def procrustes_align(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-sample similarity (Procrustes) alignment of pred onto gt,
    (B,J,3) -> (B,J,3): batched SVD with the reflection fix."""
    mu_p = pred.mean(dim=1, keepdim=True)
    mu_g = gt.mean(dim=1, keepdim=True)
    p = pred - mu_p
    g = gt - mu_g
    var_p = (p ** 2).sum(dim=(1, 2))
    with float32_math():
        K = torch.einsum("bji,bjk->bik", g, p)  # (B,3,3)
        U, s, Vt = torch.linalg.svd(K)
        det = torch.linalg.det(U @ Vt)
        D = torch.eye(3, dtype=pred.dtype, device=pred.device).repeat(
            pred.shape[0], 1, 1)
        D[:, 2, 2] = det
        R = U @ D @ Vt
        scale = (s[:, :2].sum(-1) + s[:, 2] * det) / (var_p + 1e-12)
        return scale[:, None, None] * torch.einsum("bij,bkj->bki", R, p) + mu_g


def pa_mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Procrustes-aligned MPJPE, (B,J,3) -> (B,)."""
    return torch.linalg.vector_norm(procrustes_align(pred, gt) - gt,
                                    dim=-1).mean(dim=-1)


def pve(pred_verts: torch.Tensor, gt_verts: torch.Tensor) -> torch.Tensor:
    """Per-vertex error (B,V,3) -> (B,)."""
    return torch.linalg.vector_norm(pred_verts - gt_verts,
                                    dim=-1).mean(dim=-1)


def accel_error(pred: torch.Tensor, gt: torch.Tensor, fps: float = 30.0
                ) -> torch.Tensor:
    """Acceleration error over a (T,J,3) sequence -> (T-2,) per frame (the
    jitter metric of the VIBE family)."""
    def accel(x):
        return (x[2:] - 2 * x[1:-1] + x[:-2]) * (fps ** 2)
    return torch.linalg.vector_norm(accel(pred) - accel(gt),
                                    dim=-1).mean(dim=-1)


def evaluate_batch(pred_joints: torch.Tensor, gt_joints: torch.Tensor,
                   pred_verts: Optional[torch.Tensor] = None,
                   gt_verts: Optional[torch.Tensor] = None,
                   to_mm: float = 1000.0) -> dict:
    """The standard report dict (means over the batch, in mm)."""
    out = {
        "mpjpe": float(mpjpe(pred_joints, gt_joints).mean() * to_mm),
        "pa_mpjpe": float(pa_mpjpe(pred_joints, gt_joints).mean() * to_mm),
    }
    if pred_verts is not None and gt_verts is not None:
        out["pve"] = float(pve(pred_verts, gt_verts).mean() * to_mm)
    return out
