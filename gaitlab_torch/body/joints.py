"""Joint-format registry and keypoint-format conversion (numpy).

Counterpart of gaitlab/body/joints.py: the same name tables, so that
`convert_kps(x, src, dst)` gathers by joint name and zero-fills joints the
source lacks, as the reference's kp_utils.convert_kps does, and the same
bone lists (`get_skeleton`), which the overlay draws. The demo uses it for
`--joint_type` other than spin. `get_perm_idxs`, `get_left_right_index`
and `keypoint_hflip` serve flip augmentation of keypoint data.

Deployed formats: 'spin' (49), 'spin2' (29), 'kinectv2' (25); the rest are
kept for dataset interchange.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# joint-name tables (kp_utils.py:44-931)
# ---------------------------------------------------------------------------

JOINT_FORMATS: dict[str, list[str]] = {}
SKELETONS: dict[str, np.ndarray] = {}


def register_format(name: str, joints: list[str], skeleton=None):
    JOINT_FORMATS[name] = joints
    if skeleton is not None:
        SKELETONS[name] = np.asarray(skeleton)


register_format("spin", [
    "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
    "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "rhip (SMPL)",
    "OP RKnee", "OP RAnkle", "lhip (SMPL)", "OP LKnee", "OP LAnkle",
    "reye", "leye", "rear", "lear", "OP LBigToe", "OP LSmallToe",
    "OP LHeel", "OP RBigToe", "OP RSmallToe", "OP RHeel",
    "rankle", "rknee", "rhip", "lhip", "lknee", "lankle",
    "rwrist", "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist",
    "neck", "headtop", "hip", "thorax", "Spine (H36M)", "Jaw (H36M)",
    "Head (H36M)", "nose", "leftThumb", "rightThumb", "leftFoot",
    "rightFoot",
], skeleton=[
    [0, 1], [1, 2], [1, 5], [2, 3], [5, 6], [3, 4], [6, 7], [1, 8],
    [8, 12], [8, 9], [12, 13], [9, 10], [13, 14], [10, 11], [0, 16],
    [0, 15], [16, 18], [15, 17], [21, 20], [24, 23], [19, 20], [22, 23],
    [19, 21], [22, 24], [14, 21], [11, 24], [0, 38],
])

register_format("spin2", [
    "hip", "lhip (SMPL)", "rhip (SMPL)", "spine (SMPL)", "lknee", "rknee",
    "Spine (H36M)", "lankle", "rankle", "spine2", "leftFoot", "rightFoot",
    "neck", "lcollar", "rcollar", "Head (H36M)", "lshoulder", "rshoulder",
    "lelbow", "relbow", "lwrist", "rwrist", "leftHand", "rightHand",
    "leftThumb", "leftHandTip", "rightThumb", "rightHandTip", "thorax",
])

register_format("kinectv2", [
    "hip", "Spine (H36M)", "neck", "Head (H36M)", "lshoulder", "lelbow",
    "lwrist", "leftHand", "rshoulder", "relbow", "rwrist", "rightHand",
    "lhip (SMPL)", "lknee", "lankle", "leftFoot", "rhip (SMPL)", "rknee",
    "rankle", "rightFoot", "thorax", "leftHandTip", "leftThumb",
    "rightHandTip", "rightThumb",
], skeleton=[
    [0, 1], [20, 2], [1, 20], [2, 3],
    [20, 4], [20, 8], [4, 5], [8, 9], [5, 6], [9, 10],
    [6, 7], [10, 11], [7, 21], [11, 23], [6, 22], [10, 24],
    [0, 12], [0, 16], [12, 13], [16, 17], [13, 14], [17, 18],
    [14, 15], [18, 19],
])

register_format("smpl", [
    "hips", "leftUpLeg", "rightUpLeg", "spine", "leftLeg", "rightLeg",
    "spine1", "leftFoot", "rightFoot", "spine2", "leftToeBase",
    "rightToeBase", "neck", "leftShoulder", "rightShoulder", "head",
    "leftArm", "rightArm", "leftForeArm", "rightForeArm", "leftHand",
    "rightHand", "leftHandIndex1", "rightHandIndex1",
], skeleton=[
    [0, 1], [0, 2], [0, 3], [2, 5], [1, 4], [3, 6], [4, 7], [5, 8],
    [6, 9], [8, 11], [7, 10], [9, 13], [9, 12], [9, 14], [12, 15],
    [14, 17], [13, 16], [17, 19], [16, 18], [19, 21], [18, 20],
    [21, 23], [20, 22],
])

register_format("smpl2", [
    "hip", "lhip (SMPL)", "rhip (SMPL)", "spine (SMPL)", "lknee", "rknee",
    "Spine (H36M)", "lankle", "rankle", "spine2", "leftFoot", "rightFoot",
    "neck", "lcollar", "rcollar", "Jaw (H36M)", "lshoulder", "rshoulder",
    "lelbow", "relbow", "lwrist", "rwrist", "leftHand", "rightHand",
])

register_format("h36m", [
    "hip", "rhip (H36M)", "rknee", "rankle", "lhip (H36M)", "lknee",
    "lankle", "Spine (H36M)", "Jaw (H36M)", "Head (H36M)", "headtop",
    "lshoulder", "lelbow", "lwrist", "rshoulder", "relbow", "rwrist",
], skeleton=[
    [0, 4], [0, 1], [4, 5], [1, 2], [5, 6], [2, 3], [0, 7], [8, 9],
    [7, 8], [9, 10], [8, 11], [8, 14], [11, 12], [14, 15], [12, 13],
    [15, 16],
])

register_format("shcommon", [
    "hip", "rhip", "rknee", "rankle", "lhip", "lknee", "lankle",
    "Spine (H36M)", "neck", "Jaw (H36M)", "lshoulder", "lelbow", "lwrist",
    "rshoulder", "relbow", "rwrist",
])

register_format("common", [
    "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "rwrist",
    "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist", "neck",
    "headtop",
], skeleton=[
    [0, 1], [1, 2], [3, 4], [4, 5], [6, 7], [7, 8], [8, 2], [8, 9],
    [9, 3], [2, 3], [8, 12], [9, 10], [12, 9], [10, 11], [12, 13],
])

register_format("coco", [
    "nose", "leye", "reye", "lear", "rear", "lshoulder", "rshoulder",
    "lelbow", "relbow", "lwrist", "rwrist", "lhip", "rhip", "lknee",
    "rknee", "lankle", "rankle",
], skeleton=[
    [15, 13], [13, 11], [16, 14], [14, 12], [11, 12], [5, 11], [6, 12],
    [5, 6], [5, 7], [6, 8], [7, 9], [8, 10], [1, 2], [0, 1], [0, 2],
    [1, 3], [2, 4], [3, 5], [4, 6],
])

register_format("mpii", [
    "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "hip", "thorax",
    "neck", "headtop", "rwrist", "relbow", "rshoulder", "lshoulder",
    "lelbow", "lwrist",
], skeleton=[
    [0, 1], [1, 2], [2, 6], [6, 3], [3, 4], [4, 5], [6, 7], [7, 8],
    [8, 9], [7, 12], [12, 11], [11, 10], [7, 13], [13, 14], [14, 15],
])

register_format("mpii3d", [
    "spine3", "spine4", "spine2", "Spine (H36M)", "hip", "neck",
    "Head (H36M)", "headtop", "left_clavicle", "lshoulder", "lelbow",
    "lwrist", "left_hand", "right_clavicle", "rshoulder", "relbow",
    "rwrist", "right_hand", "lhip", "lknee", "lankle", "left_foot",
    "left_toe", "rhip", "rknee", "rankle", "right_foot", "right_toe",
])

register_format("mpii3d_test", [
    "headtop", "neck", "rshoulder", "relbow", "rwrist", "lshoulder",
    "lelbow", "lwrist", "rhip", "rknee", "rankle", "lhip", "lknee",
    "lankle", "hip", "Spine (H36M)", "Head (H36M)",
])

register_format("insta", [
    "OP RHeel", "OP RKnee", "rhip (SMPL)", "lhip (SMPL)", "OP LKnee",
    "OP LHeel", "OP RWrist", "OP RElbow", "OP RShoulder", "OP LShoulder",
    "OP LElbow", "OP LWrist", "OP Neck", "headtop", "OP Nose", "reye",
    "leye", "lear", "rear", "OP LBigToe", "OP RBigToe", "OP LSmallToe",
    "OP RSmallToe", "OP LAnkle", "OP RAnkle",
], skeleton=[
    [0, 1], [1, 2], [2, 3], [3, 4], [4, 5], [6, 7], [7, 8], [8, 9],
    [9, 10], [2, 8], [3, 9], [10, 11], [8, 12], [9, 12], [12, 13],
    [12, 14], [14, 15], [14, 16], [15, 17], [16, 18], [0, 20], [20, 22],
    [5, 19], [19, 21], [5, 23], [0, 24],
])

register_format("OP21a", [
    "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
    "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip",
    "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle",
    "OP REye", "OP LEye", "OP REar", "OP LEar", "Jaw (H36M)", "headtop",
], skeleton=[
    [1, 19], [0, 19], [1, 8], [0, 20], [1, 5], [1, 2], [5, 6], [2, 3],
    [6, 7], [3, 4], [8, 12], [1, 8], [12, 13], [8, 9], [13, 14], [9, 10],
    [0, 16], [10, 11], [16, 18], [0, 15],
])  # kp_utils.py:861-906

register_format("aich", [
    "rshoulder", "relbow", "rwrist", "lshoulder", "lelbow", "lwrist",
    "rhip", "rknee", "rankle", "lhip", "lknee", "lankle", "headtop", "neck",
], skeleton=[
    [0, 1], [1, 2], [3, 4], [4, 5], [6, 7], [7, 8], [9, 10], [10, 11],
    [12, 13], [13, 0], [13, 3], [0, 6], [3, 9],
])  # kp_utils.py:576-614

register_format("staf", [
    "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
    "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip",
    "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle",
    "OP REye", "OP LEye", "OP REar", "OP LEar", "Neck (LSP)",
    "Top of Head (LSP)",
], skeleton=[
    [0, 1], [1, 2], [2, 3], [3, 4], [1, 5], [5, 6], [6, 7], [1, 8],
    [8, 9], [9, 10], [10, 11], [8, 12], [12, 13], [13, 14], [0, 15],
    [0, 16], [15, 17], [16, 18], [2, 9], [5, 12], [1, 19], [20, 19],
])

register_format("posetrack", [
    "nose", "neck", "headtop", "lear", "rear", "lshoulder", "rshoulder",
    "lelbow", "relbow", "lwrist", "rwrist", "lhip", "rhip", "lknee",
    "rknee", "lankle", "rankle",
])

# Raw PoseTrack annotation names (kp_utils.py:396-415). Unlike "posetrack"
# above (canonical interchange names), this is the dataset's own naming —
# kept for annotation-file parity; convert by position, not by name.
register_format("posetrack_original", [
    "nose", "head_bottom", "head_top", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
    "right_knee", "left_ankle", "right_ankle",
])

register_format("pennaction", [
    "headtop", "lshoulder", "rshoulder", "lelbow", "relbow", "lwrist",
    "rwrist", "lhip", "rhip", "lknee", "rknee", "lankle", "rankle",
])

register_format("smplcoco", [
    "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "rwrist",
    "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist", "neck",
    "headtop", "nose", "leye", "reye", "lear", "rear",
], skeleton=[
    [0, 1], [1, 2], [3, 4], [4, 5], [6, 7], [7, 8], [8, 12], [12, 9],
    [9, 10], [10, 11], [12, 13], [14, 15], [15, 17], [16, 18], [14, 16],
    [8, 2], [9, 3], [2, 3],
])

register_format("3dpw", [
    "nose", "thorax", "rshoulder", "relbow", "rwrist", "lshoulder",
    "lelbow", "lwrist", "rhip", "rknee", "rankle", "lhip", "lknee",
    "lankle",
], skeleton=[
    [0, 1], [1, 2], [2, 3], [3, 4], [1, 5], [5, 6], [6, 7], [2, 8],
    [5, 11], [8, 11], [8, 9], [9, 10], [11, 12], [12, 13],
])

register_format("cmu21", [
    "hip", "rhip", "rknee", "rankle", "rightFoot", "lhip", "lknee",
    "lankle", "leftFoot", "thorax", "Spine (H36M)", "neck", "Jaw (H36M)",
    "rshoulder", "relbow", "rwrist", "rightHand", "lshoulder", "lelbow",
    "lwrist", "leftHand",
])

register_format("h36m32", [
    "hip", "rhip", "rknee", "rankle", "rightFoot", "rightToe", "lhip",
    "lknee", "lankle", "leftFoot", "leftToe", "spine", "Spine (H36M)",
    "neck", "Jaw (H36M)", "Head (H36M)", "headtop (H36M)", "lshoulder",
    "lelbow", "lwrist", "leftHand", "leftThumb", "leftHandTip",
    "leftHand2", "necklow2", "rshoulder", "relbow", "rwrist", "rightHand",
    "rightThumb", "rightHandTip", "rightHand2",
])

# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------

def get_joint_names(fmt: str) -> list[str]:
    return JOINT_FORMATS[fmt]


def get_skeleton(fmt: str) -> np.ndarray:
    return SKELETONS[fmt]


def conversion_indices(src: str, dst: str) -> tuple[np.ndarray, np.ndarray]:
    """(gather_idx, valid_mask): dst[i] = src[gather_idx[i]] where valid."""
    src_names = JOINT_FORMATS[src]
    dst_names = JOINT_FORMATS[dst]
    idx = np.zeros(len(dst_names), dtype=np.int64)
    valid = np.zeros(len(dst_names), dtype=bool)
    for i, n in enumerate(dst_names):
        if n in src_names:
            idx[i] = src_names.index(n)
            valid[i] = True
    return idx, valid


def convert_kps(joints: np.ndarray, src: str, dst: str) -> np.ndarray:
    """(N, J_src, C) -> (N, J_dst, 3); missing joints zero-filled (the
    reference's 3-channel zero-padded output)."""
    idx, valid = conversion_indices(src, dst)
    out = np.zeros((joints.shape[0], len(idx), 3), dtype=joints.dtype)
    out[:, :, :joints.shape[-1]] = np.where(valid[None, :, None],
                                            joints[:, idx], 0.0)
    return out


def get_perm_idxs(src: str, dst: str) -> list[int]:
    """Indices into `src`'s joints of the `dst` joints it has, in `dst`'s
    order."""
    src_names = JOINT_FORMATS[src]
    return [src_names.index(n) for n in JOINT_FORMATS[dst] if n in src_names]


def get_left_right_index(fmt: str) -> tuple[list[int], list[int]]:
    """Left and right joint index lists (the reference's kp_utils)."""
    left, right = [], []
    for idx, name in enumerate(JOINT_FORMATS[fmt]):
        jn = name.split(" ")[1] if " " in name else name
        if jn[0] in "Rr":
            right.append(idx)
        elif jn[0] in "Ll":
            left.append(idx)
    if len(left) != len(right):
        raise ValueError(f"{fmt}: {len(left)} left joints, {len(right)} right")
    return left, right


def keypoint_hflip(kp, img_width: float) -> np.ndarray:
    """Horizontal flip of 2D keypoints (x -> img_width - 1 - x), on a
    copy."""
    kp = np.array(kp, copy=True)
    kp[..., 0] = (img_width - 1.0) - kp[..., 0]
    return kp
