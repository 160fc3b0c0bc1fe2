"""Clinical gait features from 3D joint sequences.

Counterpart of gaitlab/gait/features.py: walk speed, cadence, step length
and time with their variation, stride width, step asymmetry, arm swing and
trunk sway, from a (T, 25, 3) kinectv2 joint track. A clip's joints are a
few KB, so this is host code in numpy float32 (gaitlab moves them to numpy
halfway through as well); heel strikes are the peaks of the smoothed
forward ankle excursion relative to the pelvis (Zeni et al. 2008).
"""

from __future__ import annotations

import numpy as np

from gaitlab_torch.body import joints as joints_mod

K = {name: i for i, name in enumerate(joints_mod.get_joint_names("kinectv2"))}
HIP = K["hip"]
L_ANKLE, R_ANKLE = K["lankle"], K["rankle"]
L_FOOT, R_FOOT = K["leftFoot"], K["rightFoot"]
L_HIP, R_HIP = K["lhip (SMPL)"], K["rhip (SMPL)"]
L_KNEE, R_KNEE = K["lknee"], K["rknee"]

FEATURE_NAMES = (
    "walk_speed",        # leg-length-normalized pelvis speed
    "cadence",           # steps per second
    "step_length",       # leg-length-normalized mean step length
    "step_length_cv",    # step length coefficient of variation
    "step_time",         # mean step duration (s)
    "step_time_cv",      # step time coefficient of variation
    "stride_width",      # lateral ankle separation (normalized)
    "step_asymmetry",    # |left - right| step length asymmetry ratio
    "arm_swing",         # mean wrist excursion (normalized)
    "trunk_sway",        # lateral spine oscillation rms (normalized)
)


def _norm(v: np.ndarray, axis=-1) -> np.ndarray:
    return np.sqrt(np.sum(v * v, axis=axis))


def leg_length(joints3d: np.ndarray) -> np.float32:
    """Mean hip -> knee -> ankle chain length over the clip."""
    def chain(hip, knee, ankle):
        return (_norm(joints3d[:, knee] - joints3d[:, hip])
                + _norm(joints3d[:, ankle] - joints3d[:, knee]))

    left = chain(L_HIP, L_KNEE, L_ANKLE)
    right = chain(R_HIP, R_KNEE, R_ANKLE)
    return np.mean((left + right) / np.float32(2.0))


def _smooth(x: np.ndarray, win: int = 5) -> np.ndarray:
    """Moving average over frames with edge padding, per column."""
    x = np.asarray(x, np.float32)
    k = np.full(win, 1.0 / win, np.float32)
    pad = win // 2
    xp = np.pad(x, ((pad, pad),) + ((0, 0),) * (x.ndim - 1), mode="edge")
    cols = xp.reshape(xp.shape[0], -1)
    out = np.stack([np.convolve(cols[:, i], k, mode="valid")
                    for i in range(cols.shape[1])], axis=-1)
    return out.reshape(x.shape).astype(np.float32)


def heel_strikes(joints3d: np.ndarray, side: str = "left") -> np.ndarray:
    """Heel-strike mask (T,): local maxima of the ankle-minus-pelvis
    excursion along the walking direction (the dominant horizontal pelvis
    displacement)."""
    joints3d = np.asarray(joints3d, np.float32)
    ankle = joints3d[:, L_ANKLE if side == "left" else R_ANKLE]
    rel = ankle - joints3d[:, HIP]
    disp = joints3d[-1, HIP] - joints3d[0, HIP]
    disp[1] = 0.0  # ignore vertical
    direction = disp / (_norm(disp) + np.float32(1e-9))
    ds = np.diff(_smooth(rel @ direction))
    peaks = (ds[:-1] > 0) & (ds[1:] <= 0)
    return np.concatenate([[False], peaks, [False]])


def _event_stats(times: np.ndarray):
    if len(times) < 2:
        return 0.0, 0.0
    dt = np.diff(times)
    return float(dt.mean()), float(dt.std() / (dt.mean() + 1e-9))


def gait_features(joints3d, fps: float = 20.0) -> dict:
    """(T, 25, 3) kinectv2 joints -> dict of clinical gait features.

    Returns a dict with FEATURE_NAMES keys plus 'feature_vector'
    (np.float32 (len(FEATURE_NAMES),)) and 'events' (per-side heel-strike
    frame indices)."""
    joints3d = np.asarray(joints3d, np.float32)
    t = joints3d.shape[0]
    ll = leg_length(joints3d) + np.float32(1e-9)

    pelvis = joints3d[:, HIP]
    duration = (t - 1) / fps
    walk_dist = _norm((pelvis[-1] - pelvis[0])
                      * np.array([1.0, 0.0, 1.0], np.float32))
    walk_speed = walk_dist / np.float32(duration) / ll

    strikes = {side: np.nonzero(heel_strikes(joints3d, side))[0]
               for side in ("left", "right")}
    all_strikes = np.sort(np.concatenate([strikes["left"], strikes["right"]]))
    cadence = len(all_strikes) / duration if duration > 0 else 0.0
    step_time, step_time_cv = _event_stats(all_strikes / fps)

    # step length: signed forward lead of the striking foot over the other
    # foot at each heel strike
    la, ra = joints3d[:, L_ANKLE], joints3d[:, R_ANKLE]
    disp = (pelvis[-1] - pelvis[0]) * np.array([1.0, 0.0, 1.0])
    fwd = disp / (np.linalg.norm(disp) + 1e-9)
    lat = np.cross(np.array([0.0, 1.0, 0.0]), fwd)

    lead_l = (la - ra) @ fwd  # how far the left foot leads
    left_steps = (np.clip(lead_l[strikes["left"]], 0, None) / float(ll)
                  if len(strikes["left"]) else np.zeros(1))
    right_steps = (np.clip(-lead_l[strikes["right"]], 0, None) / float(ll)
                   if len(strikes["right"]) else np.zeros(1))
    step_lengths = np.concatenate([left_steps, right_steps])
    step_length = float(np.mean(step_lengths))
    step_length_cv = float(np.std(step_lengths) / (step_length + 1e-9))

    lm, rm = float(np.mean(left_steps)), float(np.mean(right_steps))
    step_asymmetry = abs(lm - rm) / (max(lm, rm) + 1e-9)
    stride_width = float(np.mean(np.abs((la - ra) @ lat)) / float(ll))

    lw = joints3d[:, K["lwrist"]] - pelvis
    rw = joints3d[:, K["rwrist"]] - pelvis
    arm_swing = float((np.ptp(lw @ fwd) + np.ptp(rw @ fwd)) / 2.0 / float(ll))

    spine = joints3d[:, K["Spine (H36M)"]] - pelvis
    trunk_sway = float(np.std(spine @ lat) / float(ll))

    feats = {
        "walk_speed": float(walk_speed),
        "cadence": float(cadence),
        "step_length": step_length,
        "step_length_cv": step_length_cv,
        "step_time": step_time,
        "step_time_cv": step_time_cv,
        "stride_width": stride_width,
        "step_asymmetry": step_asymmetry,
        "arm_swing": arm_swing,
        "trunk_sway": trunk_sway,
    }
    feats["feature_vector"] = np.array(
        [feats[k] for k in FEATURE_NAMES], np.float32)
    feats["events"] = strikes
    return feats


def batch_gait_features(db: dict, fps: float = 20.0) -> dict:
    """Per-video features from a batch_generation database
    ({vid_name (N,), joints3D (N,25,3)}); clips under a second skipped."""
    names = np.asarray(db["vid_name"])
    joints = np.asarray(db["joints3D"])
    out = {}
    for vid in np.unique(names):
        seq = joints[names == vid]
        if seq.shape[0] < int(fps):
            continue
        out[str(vid)] = gait_features(seq, fps=fps)
    return out
