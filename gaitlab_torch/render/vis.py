"""Skeleton drawing utilities (2D overlay via cv2, 3D via matplotlib).

Counterpart of gaitlab/render/vis.py: the reference's drawing helpers
(lib/utils/vis.py) on top of the port's skeleton registry. Host-side
visualisation only; the mesh panels use the host painter.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gaitlab_torch.body import joints as joints_mod


def draw_2d_skeleton(img: np.ndarray, kp_2d: np.ndarray, fmt: str = "spin2",
                     color=(0, 255, 0), radius: int = 3,
                     thickness: int = 2) -> np.ndarray:
    """Draw joints + bones of one person on an image (in place)."""
    import cv2

    try:
        skeleton = joints_mod.get_skeleton(fmt)
    except Exception:
        skeleton = np.zeros((0, 2), np.int64)
    h, w = img.shape[:2]
    lim = 4 * max(h, w)  # keep cv2 int coords sane even for wild outputs
    kp = np.clip(np.nan_to_num(np.asarray(kp_2d, np.float64)), -lim, lim)
    for x, y in kp[:, :2]:
        cv2.circle(img, (int(x), int(y)), radius, color, -1)
    for a, b in skeleton:
        if a < len(kp) and b < len(kp):
            pa, pb = kp[a, :2], kp[b, :2]
            cv2.line(img, (int(pa[0]), int(pa[1])),
                     (int(pb[0]), int(pb[1])), color, thickness)
    return img


def draw_3d_skeleton(joints3d: np.ndarray, ax, dataset: str = "spin2",
                     color: str = "tab:blue"):
    """Plot a 3D skeleton on a matplotlib 3D axis (reference
    vis.py:571-588 role)."""
    try:
        skeleton = joints_mod.get_skeleton(dataset)
    except Exception:
        skeleton = np.zeros((0, 2), np.int64)
    j = np.asarray(joints3d)
    ax.scatter(j[:, 0], j[:, 1], j[:, 2], s=8, c=color)
    for a, b in skeleton:
        if a < len(j) and b < len(j):
            ax.plot([j[a, 0], j[b, 0]], [j[a, 1], j[b, 1]],
                    [j[a, 2], j[b, 2]], c=color, linewidth=1.5)
    return ax


def render_image(img: np.ndarray, verts: np.ndarray, cam,
                 faces: np.ndarray, color=(0.9, 0.9, 0.8)) -> np.ndarray:
    """Standalone mesh-on-image render (reference vis.py:77-120 role),
    via the software rasterizer."""
    from gaitlab_torch.render import raster

    return raster.render_mesh(np.asarray(img), verts, cam, faces, color=color)


def denormalize_image(norm_img: np.ndarray) -> np.ndarray:
    """Invert the ImageNet normalization of a crop -> uint8 RGB (reference
    torch2numpy, img_utils.py:300-312)."""
    from gaitlab_torch.pipeline.crop import IMAGENET_MEAN, IMAGENET_STD

    img = norm_img * np.asarray(IMAGENET_STD) + np.asarray(IMAGENET_MEAN)
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def visualize_preds(image: np.ndarray, pred_kp2d: np.ndarray,
                    target_kp2d: Optional[np.ndarray] = None,
                    fmt: str = "spin2", crop_size: int = 224,
                    pred_verts: Optional[np.ndarray] = None,
                    cam: Optional[np.ndarray] = None,
                    faces: Optional[np.ndarray] = None) -> np.ndarray:
    """Pred-vs-target panel (reference visualize_preds, vis.py:221-286):
    [image | pred skeleton | (target skeleton) | (render) | (render_side)]
    as one horizontal uint8 strip. The two mesh panels appear when
    pred_verts + cam + faces are given, mirroring the reference's
    render/render_side columns (vis.py:264-280)."""
    from gaitlab_torch.pipeline.crop import normalize_2d_kp

    base = (denormalize_image(image) if image.dtype != np.uint8
            else image.copy())
    panels = [base.copy()]
    pred_px = normalize_2d_kp(np.asarray(pred_kp2d)[:, :2], crop_size,
                              inv=True)
    p = base.copy()
    draw_2d_skeleton(p, pred_px, fmt=fmt, color=(0, 255, 0))
    panels.append(p)
    if target_kp2d is not None:
        t = base.copy()
        tgt_px = normalize_2d_kp(np.asarray(target_kp2d)[:, :2], crop_size,
                                 inv=True)
        draw_2d_skeleton(t, tgt_px, fmt=fmt, color=(0, 0, 255))
        panels.append(t)
    if pred_verts is not None and cam is not None and faces is not None:
        from gaitlab_torch.render import raster

        cam = np.asarray(cam, np.float64).reshape(-1)
        if cam.shape[0] == 3:  # crop weak-perspective (s,tx,ty) -> orig_cam
            cam = np.array([cam[0], cam[0], cam[1], cam[2]])
        panels.append(raster.render_mesh(base.copy(), pred_verts, cam, faces))
        side = raster.render_mesh(np.zeros_like(base), pred_verts, cam,
                                  faces, angle=90, axis=[0, 1, 0])
        panels.append(side)
    return np.concatenate(panels, axis=1)


def visualize_batch_preds(images: np.ndarray, pred_kp2d: np.ndarray,
                          target_kp2d: Optional[np.ndarray] = None,
                          fmt: str = "spin2", max_items: int = 4,
                          pred_verts: Optional[np.ndarray] = None,
                          cam: Optional[np.ndarray] = None,
                          faces: Optional[np.ndarray] = None) -> np.ndarray:
    """Batch variant (reference batch_visualize_preds, vis.py:288-326):
    stack per-frame panels vertically."""
    rows = []
    n = min(len(images), max_items)
    for i in range(n):
        tgt = target_kp2d[i] if target_kp2d is not None else None
        pv = pred_verts[i] if pred_verts is not None else None
        cm = cam[i] if cam is not None else None
        rows.append(visualize_preds(images[i], pred_kp2d[i], tgt, fmt=fmt,
                                    pred_verts=pv, cam=cm, faces=faces))
    return np.concatenate(rows, axis=0)


def visualize_batch_vid_preds(video: np.ndarray, preds: dict,
                              target: Optional[dict] = None,
                              max_video: int = 4, fmt: str = "spin2",
                              faces: Optional[np.ndarray] = None) -> np.ndarray:
    """Video-batch panel variant (reference batch_visualize_vid_preds,
    vis.py:359-409): (N,T,H,W,3) videos + per-frame pred dicts ->
    (N,T,H',W',3) uint8 panel videos.

    preds/target: {'kp_2d': (N,T,J,2[+conf]), optional 'verts': (N,T,V,3),
    'theta': (N,T,85)} — the vp_regress output layout. NHWC throughout
    (the reference round-trips NTCHW for torch; irrelevant here).
    """
    video = np.asarray(video)[:max_video]
    n, t = video.shape[:2]
    kp = np.asarray(preds["kp_2d"])[:max_video]
    verts = (np.asarray(preds["verts"])[:max_video]
             if "verts" in preds and faces is not None else None)
    cams = (np.asarray(preds["theta"])[:max_video, :, :3]
            if "theta" in preds else None)
    tgt_kp = (np.asarray(target["kp_2d"])[:max_video]
              if target is not None else None)

    out = []
    for b in range(n):
        frames = []
        for i in range(t):
            frames.append(visualize_preds(
                video[b, i], kp[b, i],
                tgt_kp[b, i] if tgt_kp is not None else None, fmt=fmt,
                pred_verts=verts[b, i] if verts is not None else None,
                cam=cams[b, i] if (cams is not None and verts is not None)
                else None,
                faces=faces))
        out.append(np.stack(frames))
    return np.stack(out)


def write_panel_video(panel_video: np.ndarray, path: str,
                      fps: float = 20.0) -> str:
    """(T,H,W,3) uint8 RGB panel frames -> mp4 on disk."""
    import cv2

    t, h, w = panel_video.shape[:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    for i in range(t):
        writer.write(cv2.cvtColor(panel_video[i], cv2.COLOR_RGB2BGR))
    writer.release()
    return path


# ---------------------------------------------------------------------------
# Debug / inspection utilities (reference vis.py:154-569)
# ---------------------------------------------------------------------------

# Named color table (reference get_colors, vis.py:58-75) — RGB uint8.
COLORS = {
    "pink": (197, 27, 125),
    "light_pink": (233, 163, 201),
    "light_green": (161, 215, 106),
    "green": (77, 146, 33),
    "red": (215, 48, 39),
    "light_red": (252, 146, 114),
    "light_orange": (252, 141, 89),
    "purple": (118, 42, 131),
    "light_purple": (175, 141, 195),
    "light_blue": (145, 191, 219),
    "blue": (69, 117, 180),
    "gray": (130, 130, 130),
    "white": (255, 255, 255),
}


def draw_smpl_joints2d(image: np.ndarray, joints2d: np.ndarray,
                       parents=None, thickness: int = 2,
                       radius: int = 4) -> np.ndarray:
    """Draw the 24-joint SMPL kinematic tree on an image, in place
    (reference draw_SMPL_joints2D, vis.py:154-176: bone i gets the
    left/right alternating red/blue color; joint coords are pixels).

    parents: SMPL parent table; default gaitlab_torch.body.smpl.PARENTS
    (equivalent to the reference's kintree_table rows [parent, child])."""
    import cv2

    if parents is None:
        from gaitlab_torch.body.smpl import PARENTS
        parents = PARENTS
    rcolor, lcolor = COLORS["red"], COLORS["blue"]
    kp = np.nan_to_num(np.asarray(joints2d, np.float64))
    for i in range(1, len(parents)):
        color = lcolor if i % 2 == 0 else rcolor
        p1 = (int(kp[parents[i], 0]), int(kp[parents[i], 1]))
        p2 = (int(kp[i, 0]), int(kp[i, 1]))
        cv2.line(image, p1, p2, color, thickness)
        cv2.circle(image, p1, radius, color, -1)
        cv2.circle(image, p2, radius, color, -1)
    return image


# H36M 17-joint connectivity + left/right flags (reference show3Dpose,
# vis.py:178-200).
_H36M17_EDGES = ((0, 1), (1, 2), (2, 3), (0, 4), (4, 5), (5, 6), (0, 7),
                 (7, 8), (8, 9), (9, 10), (8, 11), (11, 12), (12, 13),
                 (8, 14), (14, 15), (15, 16))
_H36M17_LR = (0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0)


def show_3d_pose(channels: np.ndarray, ax, radius: float = 40.0,
                 lcolor: str = "#ff0000", rcolor: str = "#0000ff"):
    """Plot one H36M-17 pose on a matplotlib 3D axis, limits centered on
    the root (reference show3Dpose, vis.py:178-200)."""
    vals = np.asarray(channels, np.float64).reshape(-1, 3)
    for ind, (i, j) in enumerate(_H36M17_EDGES):
        xs, ys, zs = ([vals[i, c], vals[j, c]] for c in range(3))
        ax.plot(xs, ys, zs, lw=2, c=lcolor if _H36M17_LR[ind] else rcolor)
    xr, yr, zr = vals[0]
    ax.set_xlim3d([-radius + xr, radius + xr])
    ax.set_zlim3d([-radius + zr, radius + zr])
    ax.set_ylim3d([-radius + yr, radius + yr])
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    return ax


def visualize_sequence(sequence: np.ndarray, radius: float = 0.6,
                       elev: float = -75.0, azim: float = -90.0,
                       out_path: Optional[str] = None,
                       fps: float = 25.0) -> np.ndarray:
    """Render a (T, J*3) or (T, J, 3) pose sequence to a (T, H, W, 3)
    uint8 frame array via the Agg backend (reference visualize_sequence,
    vis.py:202-219 — which plt.pause()-animates on screen; here frames
    are returned, so that a headless host can use it, and optionally
    written as mp4 with write_panel_video)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    seq = np.asarray(sequence, np.float64)
    seq = seq.reshape(seq.shape[0], -1, 3)
    frames = []
    fig = plt.figure(figsize=(6, 4), dpi=80)
    try:
        for pose in seq:
            ax = fig.add_subplot(111, projection="3d")
            show_3d_pose(pose, ax, radius=radius)
            ax.view_init(elev, azim)
            fig.canvas.draw()
            buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
            frames.append(buf.copy())
            fig.clf()
    finally:
        plt.close(fig)
    video = np.stack(frames)
    if out_path is not None:
        write_panel_video(video, out_path, fps=fps)
    return video


def batch_check_preds(images: np.ndarray, preds: dict, fmt: str = "spin2",
                      crop_size: int = 224,
                      faces: Optional[np.ndarray] = None) -> np.ndarray:
    """Annotation sanity-check panel: one visualize_preds row per frame of
    a batch, vertically stacked (reference batch_check_preds, vis.py:331-357
    — which is broken as shipped: it references the undefined
    `target_exists`/`single_target` inside its key loop; gaitlab fixed it
    and the port keeps the fix).

    preds: {'kp_2d': (N,J,2[+conf]), optional 'verts': (N,V,3),
    'theta': (N,85)} host arrays (the vp_regress layout)."""
    kp = np.asarray(preds["kp_2d"])
    verts = np.asarray(preds["verts"]) if "verts" in preds else None
    cams = np.asarray(preds["theta"])[:, :3] if "theta" in preds else None
    rows = []
    for i in range(len(images)):
        rows.append(visualize_preds(
            images[i], kp[i], fmt=fmt, crop_size=crop_size,
            pred_verts=verts[i] if verts is not None else None,
            cam=cams[i] if (cams is not None and verts is not None) else None,
            faces=faces))
    return np.concatenate(rows, axis=0)


def regressor_output_from_features(features: np.ndarray, hmr=None,
                                   joint_mode: str = "spin2"):
    """The SPIN iterative regressor + SMPL on precomputed backbone features
    (B,T,2048) -> (verts (B,T,V,3), cam (B,T,3)) (the reference's
    get_regressor_output, vis.py:473-508, which loads models/model_best
    .pth.tar; pass an `nn.spin.HMR` with imported weights for that: the
    default builds a fresh one on the card, enough for shape and plumbing
    checks)."""
    import torch

    from gaitlab_torch.nn import spin as spin_mod

    if hmr is None:
        hmr = spin_mod.HMR.create(joint_mode=joint_mode)
    feats = torch.as_tensor(np.asarray(features, np.float32))
    b, t = feats.shape[:2]
    out = hmr.regress(feats.reshape(b * t, -1).to(hmr.device))[0]
    verts = out["verts"].cpu().numpy().reshape(b, t, -1, 3)
    cam = out["theta"][:, :3].cpu().numpy().reshape(b, t, -1)
    return verts, cam


def show_video(video: np.ndarray, fps: float = 25.0,
               window: str = "gaitlab") -> bool:
    """Play a (T,H,W,3) RGB frame array in a cv2 window (reference
    show_video, vis.py:510-520). Headless-safe: returns False without
    raising when no display exists (a headless cv2 build's imshow
    abort()s rather than raising, so the guard must run before any GUI
    call)."""
    import os as _os
    import sys as _sys
    import time as _time

    import cv2

    if _sys.platform.startswith("linux") and not (
            _os.environ.get("DISPLAY") or _os.environ.get("WAYLAND_DISPLAY")):
        return False
    try:
        for frame in video:
            cv2.imshow(window, cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
            if cv2.waitKey(1) & 0xFF == ord("q"):
                break
            _time.sleep(1.0 / fps)
        cv2.destroyAllWindows()
        return True
    except cv2.error:
        return False


def show_preds(video: np.ndarray, preds: dict, max_video: int = 4,
               fmt: str = "spin2",
               faces: Optional[np.ndarray] = None) -> np.ndarray:
    """Prediction panel videos for a batch of clips: (N,T,H,W,3) uint8 in,
    per-frame visualize_preds panels out, stacked back to (N,T,H',W',3)
    (reference show_preds, vis.py:522-569 — NTCHW there for torch; NHWC
    here). Equivalent to visualize_batch_vid_preds without targets."""
    return visualize_batch_vid_preds(video, preds, target=None,
                                     max_video=max_video, fmt=fmt,
                                     faces=faces)


def body_orientation_rotmat(joints3d_frame: np.ndarray) -> np.ndarray:
    """Procrustes rotation aligning the body to +x for matplotlib display
    (reference demo.py:239-247: hip x shoulder cross product, 49-joint
    spin indices 27/28/39/40)."""
    from scipy.linalg import orthogonal_procrustes

    j = np.asarray(joints3d_frame)
    if j.shape[0] >= 41:  # spin 49-joint layout
        h = j[28] - j[27]
        v = j[40] - j[39]
    else:  # spin2 29-joint: right/left hip 2,3; shoulders 17,16
        h = j[3] - j[2]
        v = j[16] - j[2]
    h = h / np.linalg.norm(h)
    v = v / np.linalg.norm(v)
    init_orient = np.cross(h, v).reshape(1, 3)
    rot, _ = orthogonal_procrustes(np.array([[1.0, 0.0, 0.0]]), init_orient)
    return rot
