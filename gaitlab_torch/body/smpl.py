"""SMPL body model: blendshapes, kinematic chain, skinning, joint assembly.

Counterpart of gaitlab/body/smpl.py. The model is a tuple of tensors
(`SMPLParams`) and plain functions over them. `lbs` always takes the
kernel-structured path: the blendshape sum runs in `ops.blendshapes`
(the CUDA kernel on the card) and the rest-pose joints come from the
regressor folded through the shape blendshapes, so the shaped vertices are
never built.

Joint assembly modes:
  'smpl24'  the 24 kinematic-tree joints
  'smplx45' 24 + 21 vertex-picked joints (smplx layout)
  'spin2'   29-joint clinical set: SMPL 24 + L thumb/middle + R
            thumb/middle + MPII thorax (the deployed mode)
  'spin'    49-joint SPIN set via the JOINT_MAP gather
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple, Optional

import numpy as np
import torch

from gaitlab_torch.core import geometry
from gaitlab_torch.ops.blendshapes import blendshapes

NUM_VERTS = 6890
NUM_JOINTS = 24
NUM_BETAS = 10

# Standard SMPL kinematic tree.
PARENTS: tuple = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
    19, 20, 21,
)

# smplx VertexJointSelector layout: face+feet, then hand tips -> joints 24..44.
EXTRA_VERTEX_IDS: tuple = (
    332, 6260, 2800, 4071, 583,            # 24 nose, 25 reye, 26 leye, 27 rear, 28 lear
    3216, 3226, 3387, 6617, 6624, 6787,    # 29-34 LBigToe..RHeel
    2746, 2319, 2445, 2556, 2673,          # 35-39 left thumb/index/middle/ring/pinky
    6191, 5782, 5905, 6016, 6133,          # 40-44 right thumb/index/middle/ring/pinky
)

# JOINT_MAP indices into the 54-joint (45 smplx + 9 extra-regressor) stack,
# in JOINT_NAMES order.
SPIN49_GATHER: tuple = (
    24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34,                    # 0-24: OpenPose 25
    8, 5, 45, 46, 4, 7,                        # 25-30 R ankle/knee/hip, L hip/knee/ankle
    21, 19, 17, 16, 18, 20,                    # 31-36 arms
    47, 48, 49, 50, 51, 52, 53,                # 37-43 LSP/MPII/H36M extras
    24, 35, 40, 10, 11,                        # 44-48 nose, thumbs, feet
)

# spin2 (29-joint) assembly:
#   smplx joints[:24] ++ joints[[35,37]] ++ joints[[40,42]] ++ extra[5 (thorax)]
SPIN2_HAND_GATHER: tuple = (35, 37, 40, 42)
THORAX_EXTRA_ROW = 5  # JOINT_MAP['Thorax (MPII)'] - 45

H36M_TO_J17 = (6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9)
H36M_TO_J14 = H36M_TO_J17[:14]


class SMPLParams(NamedTuple):
    """SMPL model tensors (float32, all on one device)."""

    v_template: torch.Tensor      # (V, 3)
    shapedirs: torch.Tensor       # (V, 3, 10)
    posedirs: torch.Tensor        # (207, V*3)
    J_regressor: torch.Tensor     # (24, V)
    lbs_weights: torch.Tensor     # (V, 24)
    J_regressor_extra: Optional[torch.Tensor] = None  # (9, V)
    faces: Optional[np.ndarray] = None                # (F, 3) host-side

    def to(self, device) -> "SMPLParams":
        return SMPLParams(*(x.to(device) if isinstance(x, torch.Tensor) else x
                            for x in self))


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

class _ChumpyStubUnpickler(pickle.Unpickler):
    """Unpickle official SMPL .pkl files without chumpy installed."""

    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChArray
        if module in ("scipy.sparse.csc", "scipy.sparse._csc"):
            import scipy.sparse

            return scipy.sparse.csc_matrix
        return super().find_class(module, name)


class _ChArray:
    """Minimal chumpy.Ch stand-in: keeps the wrapped ndarray."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.__dict__.get("x"), dtype=dtype)


def _to_np(x) -> np.ndarray:
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray())
    return np.asarray(x)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def load_smpl_params(path: str) -> SMPLParams:
    """Load official SMPL .pkl / .npz model files (or a synthetic pickle)
    onto the CPU. `path` may be the file itself or a directory holding
    SMPL_NEUTRAL.pkl / smpl_model.pkl / SMPL_NEUTRAL.npz."""
    if os.path.isdir(path):
        for cand in ("SMPL_NEUTRAL.pkl", "smpl_model.pkl", "SMPL_NEUTRAL.npz",
                     "basicmodel_neutral_lbs_10_207_0_v1.0.0.pkl"):
            p = os.path.join(path, cand)
            if os.path.isfile(p):
                path = p
                break
    if path.endswith(".npz"):
        data = dict(np.load(path, allow_pickle=True))
    else:
        with open(path, "rb") as f:
            data = _ChumpyStubUnpickler(f, encoding="latin1").load()

    posedirs = _to_np(data["posedirs"])
    if posedirs.shape[0] == NUM_VERTS:
        posedirs = posedirs.reshape(NUM_VERTS * 3, -1).T  # (207, V*3)
    weights = data["weights"] if "weights" in data else data["lbs_weights"]
    return SMPLParams(
        v_template=_t(_to_np(data["v_template"])),
        shapedirs=_t(_to_np(data["shapedirs"])[:, :, :NUM_BETAS]),
        posedirs=_t(posedirs),
        J_regressor=_t(_to_np(data["J_regressor"])),
        lbs_weights=_t(_to_np(weights)),
        faces=_to_np(data.get("f", data.get("faces"))).astype(np.int64),
    )


def with_extra_regressor(params: SMPLParams, path_or_array) -> SMPLParams:
    """Attach J_regressor_extra (9, V)."""
    arr = (np.load(path_or_array) if isinstance(path_or_array, str)
           else np.asarray(path_or_array))
    return params._replace(
        J_regressor_extra=_t(arr).to(params.v_template.device))


def synthetic_smpl_params(seed: int = 0, with_extra: bool = True) -> SMPLParams:
    """Random-but-plausible params on the CPU, drawn exactly as
    gaitlab.body.smpl.synthetic_smpl_params draws them (same arrays)."""
    rng = np.random.default_rng(seed)
    V, J = NUM_VERTS, NUM_JOINTS
    jr = rng.random(size=(J, V)) ** 8
    w = rng.random(size=(V, J)) ** 4
    p = SMPLParams(
        v_template=_t(rng.normal(size=(V, 3)) * 0.3),
        shapedirs=_t(rng.normal(size=(V, 3, 10)) * 0.01),
        posedirs=_t((rng.normal(size=(V * 3, 207)) * 0.001).T),
        J_regressor=_t(jr / jr.sum(1, keepdims=True)),
        lbs_weights=_t(w / w.sum(1, keepdims=True)),
        faces=rng.integers(0, V, size=(100, 3)).astype(np.int64),
    )
    if with_extra:
        rng2 = np.random.default_rng(seed + 100)
        jre = rng2.random(size=(9, V)) ** 8
        p = p._replace(J_regressor_extra=_t(jre / jre.sum(1, keepdims=True)))
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def vertices2joints(J_regressor: torch.Tensor,
                    vertices: torch.Tensor) -> torch.Tensor:
    """(J,V) x (B,V,3) -> (B,J,3)."""
    return torch.einsum("jv,bvk->bjk", J_regressor, vertices)


def _rigid_transforms(rot_mats: torch.Tensor, joints: torch.Tensor):
    """Forward kinematics over the SMPL tree.

    rot_mats: (B,24,3,3); joints: (B,24,3) rest-pose joint locations.
    Returns (posed_joints (B,24,3), rel_transforms (B,24,4,4)), where the
    transforms have the rest pose removed (the LBS `A` matrices)."""
    B = rot_mats.shape[0]
    rel = torch.cat([joints[:, :1],
                     joints[:, 1:] - joints[:, list(PARENTS[1:])]], dim=1)
    Rs = [rot_mats[:, 0]]
    ts = [rel[:, 0]]
    for j in range(1, NUM_JOINTS):
        p = PARENTS[j]
        Rs.append(Rs[p] @ rot_mats[:, j])
        ts.append((Rs[p] @ rel[:, j, :, None])[..., 0] + ts[p])
    Rg = torch.stack(Rs, dim=1)  # (B,24,3,3)
    tg = torch.stack(ts, dim=1)  # (B,24,3)

    corr = tg - torch.einsum("bjik,bjk->bji", Rg, joints)
    A = torch.zeros((B, NUM_JOINTS, 4, 4), dtype=rot_mats.dtype,
                    device=rot_mats.device)
    A[:, :, :3, :3] = Rg
    A[:, :, :3, 3] = corr
    A[:, :, 3, 3] = 1.0
    return tg, A


def lbs(params: SMPLParams, betas: torch.Tensor, rot_mats: torch.Tensor):
    """(B,10) betas + (B,24,3,3) rotmats -> (verts (B,V,3), joints24 (B,24,3))."""
    B = betas.shape[0]
    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)  # (B,207)

    v_posed = blendshapes(params.v_template, params.shapedirs,
                          params.posedirs, betas.contiguous(),
                          pose_feature.contiguous())
    # J(beta) = Jr @ v_template + (Jr @ shapedirs) @ beta
    j0 = params.J_regressor @ params.v_template
    j_dirs = torch.einsum("jv,vkl->jkl", params.J_regressor, params.shapedirs)
    joints = j0[None] + torch.einsum("bl,jkl->bjk", betas, j_dirs)

    posed_joints, A = _rigid_transforms(rot_mats, joints)

    # skinning: T = W @ A -> (B,V,4,4), applied to homogeneous v_posed
    T = torch.einsum("vj,bjik->bvik", params.lbs_weights, A)
    verts = (torch.einsum("bvik,bvk->bvi", T[:, :, :3, :3], v_posed)
             + T[:, :, :3, 3])
    return verts, posed_joints


def smpl_forward(params: SMPLParams, betas: torch.Tensor,
                 rot_mats: torch.Tensor, joint_mode: str = "spin2") -> dict:
    """Full SMPL forward with the reference's joint assembly.

    rot_mats: (B,24,3,3) full pose (global orient at index 0).
    Returns {'vertices': (B,V,3), 'joints': (B,J,3)} with J per joint_mode."""
    verts, joints24 = lbs(params, betas, rot_mats)
    if joint_mode == "smpl24":
        return {"vertices": verts, "joints": joints24}
    joints45 = torch.cat([joints24, verts[:, list(EXTRA_VERTEX_IDS)]], dim=1)
    if joint_mode == "smplx45":
        joints = joints45
    elif joint_mode in ("spin2", "spin"):
        if params.J_regressor_extra is None:
            raise ValueError(f"joint_mode={joint_mode!r} needs "
                             "J_regressor_extra")
        if joint_mode == "spin2":
            thorax = vertices2joints(
                params.J_regressor_extra[THORAX_EXTRA_ROW:THORAX_EXTRA_ROW + 1],
                verts)
            hands = joints45[:, list(SPIN2_HAND_GATHER)]
            joints = torch.cat([joints45[:, :24], hands, thorax], dim=1)
        else:
            extra9 = vertices2joints(params.J_regressor_extra, verts)
            joints = torch.cat([joints45, extra9], dim=1)[:, list(SPIN49_GATHER)]
    else:
        raise ValueError(f"unknown joint_mode: {joint_mode}")
    return {"vertices": verts, "joints": joints}


def smpl_forward_axis_angle(params: SMPLParams, betas: torch.Tensor,
                            pose_aa: torch.Tensor,
                            joint_mode: str = "spin2") -> dict:
    """Axis-angle entry: pose_aa (B,72) or (B,24,3)."""
    B = betas.shape[0]
    rot = geometry.axis_angle_to_rotmat(pose_aa.reshape(-1, 3)).reshape(
        B, 24, 3, 3)
    return smpl_forward(params, betas, rot, joint_mode)


def smpl_head(params: SMPLParams, rotmat: torch.Tensor, shape: torch.Tensor,
              cam: Optional[torch.Tensor] = None, focal_length: float = 5000.0,
              img_res: int = 224, normalize_joints2d: bool = False,
              joint_mode: str = "spin2") -> dict:
    """SMPL forward + weak-perspective projection of the joints.

    rotmat: (N,24,3,3); shape: (N,10); cam: (N,3) weak-perspective [s,tx,ty]."""
    out = smpl_forward(params, shape, rotmat, joint_mode=joint_mode)
    result = {"smpl_vertices": out["vertices"], "smpl_joints3d": out["joints"]}
    if cam is not None:
        joints3d = out["joints"]
        B = joints3d.shape[0]
        kw = dict(dtype=joints3d.dtype, device=joints3d.device)
        cam_t = geometry.convert_weak_perspective_to_perspective(
            cam, focal_length=focal_length, img_res=img_res)
        joints2d = geometry.perspective_projection(
            joints3d, torch.eye(3, **kw).expand(B, 3, 3), cam_t, focal_length,
            torch.zeros((B, 2), **kw))
        if normalize_joints2d:
            joints2d = joints2d / (img_res / 2.0)
        result["smpl_joints2d"] = joints2d
    return result
