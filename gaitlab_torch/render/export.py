"""Animated SMPL export: GLB (glTF 2.0) and OBJ, without Blender.

Counterpart of gaitlab/render/export.py. The reference exports keyframed
skinned SMPL meshes through Blender's bpy (lib/utils/fbx_output.py); this
module writes the same animated skinned mesh directly in the glTF 2.0
binary format (GLB): rest-pose mesh + 24-joint skeleton + 4-influence skin
weights + per-frame joint-rotation (and root-translation) animation
channels. `export_obj` covers the demo's --save_obj per-frame meshes.
The shaped rest mesh, its joints and the joint quaternions are computed on
`device` (None: the card), the rest on the host.

Input contract matches the reference pkl schema: pose (T,72) axis-angle,
betas (10,) or (T,10), optional trans (T,3).
"""

from __future__ import annotations

import json
import struct
from typing import Optional

import numpy as np

import torch

from gaitlab_torch.body import smpl as body_smpl
from gaitlab_torch.core import geometry
from gaitlab_torch.device import resolve_device, upload

GLB_MAGIC = 0x46546C67
SMPL_BONE_NAMES = [
    "Pelvis", "L_Hip", "R_Hip", "Spine1", "L_Knee", "R_Knee", "Spine2",
    "L_Ankle", "R_Ankle", "Spine3", "L_Foot", "R_Foot", "Neck",
    "L_Collar", "R_Collar", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow",
    "R_Elbow", "L_Wrist", "R_Wrist", "L_Hand", "R_Hand",
]  # the reference's bone order (m_avg_* prefix stripped)


def _align(b: bytes, n: int = 4, pad: bytes = b"\x00") -> bytes:
    return b + pad * (-len(b) % n)


class _Buffer:
    def __init__(self):
        self.blob = b""
        self.views = []
        self.accessors = []

    def add(self, arr: np.ndarray, component: int, acc_type: str,
            target: Optional[int] = None, minmax: bool = False) -> int:
        arr = np.ascontiguousarray(arr)
        off = len(self.blob)
        self.blob += _align(arr.tobytes())
        self.views.append({"buffer": 0, "byteOffset": off,
                           "byteLength": arr.nbytes,
                           **({"target": target} if target else {})})
        acc = {
            "bufferView": len(self.views) - 1,
            "componentType": component,
            "count": int(arr.shape[0]),
            "type": acc_type,
        }
        if minmax:
            acc["min"] = np.min(arr, axis=0).tolist()
            acc["max"] = np.max(arr, axis=0).tolist()
        self.accessors.append(acc)
        return len(self.accessors) - 1


def anim_skin_data(
    pose: np.ndarray,
    betas: np.ndarray,
    smpl_params: Optional[body_smpl.SMPLParams] = None,
    trans: Optional[np.ndarray] = None,
    device=None,
) -> dict:
    """Shared skinned-animation prep for the GLB and FBX writers.

    Returns host numpy: rest vertices at the given shape, faces, rest
    joints, parents, top-4 skin influences, and per-frame local joint
    quaternions (w,x,y,z) — the data both container formats keyframe.
    The shaped mesh, its joints and the quaternions are computed on
    `device` (None: the card)."""
    if smpl_params is None:
        smpl_params = body_smpl.synthetic_smpl_params()
    device = resolve_device(device)
    pose = np.asarray(pose, np.float32).reshape(-1, 24, 3)
    T = pose.shape[0]
    betas = np.asarray(betas, np.float32)
    if betas.ndim == 2:
        betas = betas[0]
    if trans is None:
        trans = np.zeros((T, 3), np.float32)

    # rest-pose geometry at the given shape
    v_template, shapedirs, j_reg = (
        x.to(device) for x in (smpl_params.v_template, smpl_params.shapedirs,
                               smpl_params.J_regressor))
    v_shaped = v_template + torch.einsum("vkl,l->vk", shapedirs,
                                         upload(betas, device))
    joints_rest = body_smpl.vertices2joints(j_reg, v_shaped[None])[0]  # (24,3)
    quats_wxyz = geometry.axis_angle_to_quat(
        upload(pose.reshape(-1, 3), device)).reshape(T, 24, 4)
    parents = list(body_smpl.PARENTS)

    faces = smpl_params.faces
    if faces is None:
        raise ValueError("SMPLParams.faces required for mesh export")
    weights = smpl_params.lbs_weights.cpu().numpy()  # (V,24)
    top4 = np.argsort(-weights, axis=1)[:, :4].astype(np.uint8)
    w4 = np.take_along_axis(weights, top4.astype(np.int64), axis=1)
    w4 = (w4 / np.clip(w4.sum(1, keepdims=True), 1e-9, None)).astype(np.float32)
    return {
        "T": T, "trans": np.asarray(trans, np.float32),
        "v_shaped": v_shaped.cpu().numpy(), "faces": np.asarray(faces),
        "joints_rest": joints_rest.cpu().numpy(), "parents": parents,
        "top4": top4, "w4": w4, "quats_wxyz": quats_wxyz.cpu().numpy(),
    }


def export_glb(
    out_path: str,
    pose: np.ndarray,
    betas: np.ndarray,
    smpl_params: Optional[body_smpl.SMPLParams] = None,
    trans: Optional[np.ndarray] = None,
    fps: float = 30.0,
    device=None,
) -> str:
    """Write an animated skinned SMPL GLB (the reference's process_poses
    and export_animated_mesh roles); the skinning data is computed on
    `device` (None: the card)."""
    d = anim_skin_data(pose, betas, smpl_params, trans, device=device)
    T, trans = d["T"], d["trans"]
    v_shaped, faces, joints_rest = d["v_shaped"], d["faces"], d["joints_rest"]
    parents, top4, w4, quats_wxyz = (
        d["parents"], d["top4"], d["w4"], d["quats_wxyz"])

    # glTF wants (x,y,z,w)
    quats = np.concatenate(
        [quats_wxyz[..., 1:], quats_wxyz[..., :1]], axis=-1).astype(np.float32)
    n = np.linalg.norm(quats, axis=-1, keepdims=True)
    quats = quats / np.clip(n, 1e-9, None)

    buf = _Buffer()
    pos_acc = buf.add(v_shaped.astype(np.float32), 5126, "VEC3",
                      target=34962, minmax=True)
    idx_acc = buf.add(np.asarray(faces, np.uint32).reshape(-1, 1), 5125,
                      "SCALAR", target=34963)
    joints_acc = buf.add(top4.reshape(-1, 4), 5121, "VEC4", target=34962)
    weights_acc = buf.add(w4.reshape(-1, 4), 5126, "VEC4", target=34962)

    # inverse bind matrices: rest transforms are pure translations
    ibm = np.tile(np.eye(4, dtype=np.float32), (24, 1, 1))
    ibm[:, :3, 3] = -joints_rest
    ibm_acc = buf.add(ibm.transpose(0, 2, 1).reshape(24, 16), 5126, "MAT4")

    times = (np.arange(T, dtype=np.float32) / fps).reshape(-1, 1)
    time_acc = buf.add(times, 5126, "SCALAR", minmax=True)

    # nodes: 0 = mesh node, 1..24 = joints, 25 = armature root
    nodes = [{"name": "smpl_mesh", "mesh": 0, "skin": 0}]
    for j in range(24):
        local_t = (joints_rest[j] - (joints_rest[parents[j]]
                                     if j else np.zeros(3))).tolist()
        node = {"name": SMPL_BONE_NAMES[j], "translation": local_t}
        nodes.append(node)
    for j in range(24):
        kids = [1 + c for c in range(24) if c and parents[c] == j]
        if kids:
            nodes[1 + j]["children"] = kids

    channels, samplers = [], []
    for j in range(24):
        rot_acc = buf.add(quats[:, j], 5126, "VEC4")
        samplers.append({"input": time_acc, "output": rot_acc,
                         "interpolation": "LINEAR"})
        channels.append({"sampler": len(samplers) - 1,
                         "target": {"node": 1 + j, "path": "rotation"}})
    tr_acc = buf.add(np.asarray(trans, np.float32)
                     + joints_rest[0][None], 5126, "VEC3")
    samplers.append({"input": time_acc, "output": tr_acc,
                     "interpolation": "LINEAR"})
    channels.append({"sampler": len(samplers) - 1,
                     "target": {"node": 1, "path": "translation"}})

    gltf = {
        "asset": {"version": "2.0", "generator": "gaitlab"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": nodes,
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": pos_acc, "JOINTS_0": joints_acc,
                           "WEIGHTS_0": weights_acc},
            "indices": idx_acc, "mode": 4,
        }]}],
        "skins": [{"inverseBindMatrices": ibm_acc, "skeleton": 1,
                   "joints": list(range(1, 25))}],
        "animations": [{"name": "gait", "channels": channels,
                        "samplers": samplers}],
        "buffers": [{"byteLength": len(buf.blob)}],
        "bufferViews": buf.views,
        "accessors": buf.accessors,
    }

    json_bytes = _align(json.dumps(gltf, separators=(",", ":")).encode(),
                        4, b" ")
    bin_bytes = _align(buf.blob)
    total = 12 + 8 + len(json_bytes) + 8 + len(bin_bytes)
    with open(out_path, "wb") as f:
        f.write(struct.pack("<III", GLB_MAGIC, 2, total))
        f.write(struct.pack("<II", len(json_bytes), 0x4E4F534A))  # JSON
        f.write(json_bytes)
        f.write(struct.pack("<II", len(bin_bytes), 0x004E4942))   # BIN
        f.write(bin_bytes)
    return out_path


def export_obj(out_path: str, verts: np.ndarray, faces: np.ndarray) -> str:
    """One mesh frame as OBJ (the demo's --save_obj)."""
    with open(out_path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in np.asarray(faces) + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")
    return out_path


def export_from_pkl(pkl_path: str, out_path: str,
                    smpl_params: Optional[body_smpl.SMPLParams] = None,
                    person_id: Optional[int] = None, fps: float = 30.0,
                    device=None) -> str:
    """Demo pkl -> animated GLB of one person (default: the longest
    track), computed on `device` (None: the card)."""
    from gaitlab_torch.cli.demo import load_pickle

    results = load_pickle(pkl_path)
    if person_id is None:
        person_id = max(results.keys(),
                        key=lambda k: len(results[k]["frame_ids"]))
    person = results[person_id]
    return export_glb(out_path, person["pose"], person["betas"],
                      smpl_params=smpl_params, fps=fps, device=device)
