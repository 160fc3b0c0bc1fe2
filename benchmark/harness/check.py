"""Whether the timed path's outputs are correct: the kept tracks' outputs,
as run_track returned them in the window, against the plain reference
(the architecture's `reference_track`) run afterwards on the same
frames, boxes and weights.

Each number compared is a widest gap, relative to the reference's
largest magnitude of that output over all kept tracks:
  <key>_gap = max |program - reference| / max |reference|
for verts, joints3d, joints2d, betas, pred_cam and, with the gait branch,
pred_avg and pred_phase; pose_gap is the widest gap between the rotation
matrices that the program's axis-angle pose encodes and the reference's
(entries of rotations need no scale). The configuration's "limits" name
the numbers compared, each with its limit."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness.system import tf32
from benchmark.reference.smpl import axis_angle_to_rotmat

KEYS = ("verts", "joints3d", "joints2d", "betas", "pred_cam", "pred_avg",
        "pred_phase")


def reference_outputs(kept: dict, schedule, sd: dict, smpl: dict, cfg: dict,
                      arch, device) -> dict:
    """{track index: reference outputs} for the kept tracks, float32 with
    TF32 off."""
    with tf32(False):
        return {i: arch.reference_track(sd, smpl, cfg, schedule[i], device)
                for i in sorted(kept)}


def gaps(kept: dict, refs: dict) -> dict:
    """{number: value} over the kept tracks (module docstring)."""
    res = {}
    for key in KEYS:
        if key not in refs[min(refs)]:
            continue
        p = np.concatenate([np.ravel(kept[i][key]) for i in sorted(refs)])
        r = np.concatenate([np.ravel(refs[i][key]) for i in sorted(refs)])
        res[f"{key}_gap"] = _gap(p.astype(np.float64), r.astype(np.float64))
    rp = np.concatenate([axis_angle_to_rotmat(torch.from_numpy(
        kept[i]["pose"].reshape(-1, 24, 3))).numpy() for i in sorted(refs)])
    rr = np.concatenate([refs[i]["pose_rotmat"] for i in sorted(refs)])
    res["pose_gap"] = float(np.max(np.abs(rp - rr))) if rp.shape == rr.shape \
        else float("inf")
    return res


def _gap(p: np.ndarray, r: np.ndarray) -> float:
    if p.shape != r.shape or not np.isfinite(p).all():
        return float("inf")
    return float(np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-30))


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}) over the numbers that the
    configuration's `limits` name: every one at or under its limit. A
    named number that the run did not produce reads inf and fails; a
    number the configuration names no limit for is not compared (one
    whose program and control readings do not separate, PERF.md)."""
    table = {k: {"value": values.get(k, float("inf")), "limit": limits[k]}
             for k in sorted(limits)}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
