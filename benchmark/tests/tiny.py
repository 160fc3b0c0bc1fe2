"""A cell of the manifest cut to a size the CPU runs in seconds: HRNet at
width 8 with one module and one block a stage, 64-pixel crops, buckets 4,
8 and 16, 120x160 frames, tracks of 3 to 20 frames. For the tests of the
harness's control flow only: no number of it stands for the card."""

from __future__ import annotations

import types

from benchmark.harness import spec

TINY_LIMIT = 1e-3  # CPU float32 against CPU float32, at this size


def tiny_cell(cell_name: str = "grnet_w32.clinic_tracks",
              length=(3, 20)) -> types.SimpleNamespace:
    man = spec.manifest()
    entry = {w["name"]: w for w in man["workloads"]}[cell_name]
    cfg = spec.load_json("configs", entry["config"])
    cfg["model"].update(backbone_width=8, backbone_modules=[1, 1, 1],
                        backbone_blocks=1, num_input_features=120)
    if cfg["model"].get("use_gait_feat"):
        cfg["model"]["featcorr_h_size"] = 64
    cfg["crop_size"] = 64
    cfg["runner"].update(buckets=[4, 8, 16], ref_block=8)
    cfg["calibration_frames"] = 8
    names = ["verts", "joints3d", "joints2d", "betas", "pred_cam", "pose"]
    if cfg["model"].get("use_gait_feat"):
        names += ["pred_avg", "pred_phase"]
    cfg["limits"] = {f"{k}_gap": TINY_LIMIT for k in names}
    tr = tiny_traffic(entry["traffic"], length)
    return types.SimpleNamespace(
        name=cell_name, cfg=cfg, arch=spec.load_arch(entry["config"], cfg),
        traffic=tr, chips=1,
        end_to_end=[m for m in man["end_to_end"]
                    if m.get("workloads") is None
                    or cell_name in m["workloads"]],
        per_layer=[m for m in man["per_layer"]
                   if m.get("workloads") is None
                   or cell_name in m["workloads"]])


def tiny_traffic(name: str, length=(3, 20)) -> dict:
    """The traffic mix `name` at 120x160 frames and 3-20-frame tracks."""
    tr = spec.load_json("traffic", name)
    tr.update(frame_hw=[120, 160], pool_frames=40, check_share=0.5,
              trace_seconds=1.5,
              length={"dist": "uniform", "min": length[0],
                      "max": length[1], "deck": 4})
    return tr
