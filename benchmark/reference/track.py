"""One track through the reference: host crops, the trunk in blocks of
frames, the gait corrector over each forward's frames, SMPL.

The program runs a track as forwards of at most `chunk` frames (its
largest batch), and its gait branch sees one forward's frames at a time:
the corrector's GRU and attention run over each forward's real frames,
and the track's pred_avg is the mean of the forwards' estimates weighted
by their frame counts. The reference does the same on the real frames
alone (no padding)."""

from __future__ import annotations

import numpy as np
import torch

from . import crop, smpl as smpl_ref
from .model import Reference, camera_reparam


@torch.no_grad()
def run_track(ref: Reference, smpl: dict, frames, boxes: np.ndarray,
              frame_hw: tuple, size: int, chunk: int, block: int,
              device) -> dict:
    """frames: the track's (H,W,3) uint8 images in order; boxes (N,4)
    [cx, cy, w, h], cropped to size x size -> numpy {"pred_cam", "pose_rotmat" (N,24,3,3),
    "betas", "verts", "joints3d", "joints2d"[, "pred_avg", "pred_phase"]}."""
    n = len(boxes)
    point, cam = [], []
    for s in range(0, n, block):
        x = crop.normalize(crop.crops_uint8(frames[s:s + block],
                                            boxes[s:s + block], size), device)
        p, c = ref.head_features(ref.backbone(x))
        point.append(p)
        cam.append(c)
    point, cam = torch.cat(point), torch.cat(cam)
    rot, betas, pcam = ref.head_predict(point, cam)
    out = {}
    if ref.m.get("use_gait_feat"):
        bbox = torch.as_tensor(boxes, dtype=torch.float32, device=device)
        h, w = frame_hw
        cimg = torch.tensor([w * 0.5, h * 0.5], device=device).expand(n, 2)
        cparams = camera_reparam(pcam, bbox, cimg)
        rots, bets, cams, avgs, phases, lens = [], [], [], [], [], []
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            corrected, avg, phase = ref.corrector(point[s:e], cparams[s:e])
            r, b, c = ref.head_predict(corrected, cam[s:e])
            rots.append(r)
            bets.append(b)
            cams.append(c)
            avgs.append(avg)
            phases.append(phase)
            lens.append(e - s)
        rot, betas, pcam = torch.cat(rots), torch.cat(bets), torch.cat(cams)
        weights = torch.tensor(lens, dtype=torch.float64, device=device)
        out["pred_avg"] = ((torch.stack(avgs).double() * weights[:, None])
                           .sum(0) / weights.sum()).cpu().numpy()
        out["pred_phase"] = torch.cat(phases).cpu().numpy()
    verts, j3d, j2d = [], [], []
    for s in range(0, n, block):
        r = smpl_ref.regress(smpl, rot[s:s + block], betas[s:s + block],
                             pcam[s:s + block])
        verts.append(r["verts"].cpu())
        j3d.append(r["joints3d"].cpu())
        j2d.append(r["joints2d"].cpu())
    out.update(pred_cam=pcam.cpu().numpy(), betas=betas.cpu().numpy(),
               pose_rotmat=rot.cpu().numpy(),
               verts=torch.cat(verts).numpy(),
               joints3d=torch.cat(j3d).numpy(),
               joints2d=torch.cat(j2d).numpy())
    return out
