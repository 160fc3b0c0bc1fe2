"""Host mesh painter (numpy + cv2, no GL/EGL dependency).

Counterpart of gaitlab/render/raster.py, copied with its camera
convention. The reference renders SMPL overlays through pyrender + EGL;
this is the same weak-perspective overlay as a painter's-algorithm
rasterizer: depth-sort faces, Lambert-shade, cv2.fillConvexPoly. Camera
convention of the reference's WeakPerspectiveCamera:

    mesh is rotated 180 deg about x, then
    ndc_x = sx * (x + tx);  ndc_y = sy * y - sy * ty  (note the -ty)
    pixel = ((ndc_x+1) * W/2, (1-ndc_y) * H/2)

The z-buffer on the card (render/raster_torch.py) shares the projection
and the shading.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

AMBIENT = 0.35
LIGHT_DIR = np.array([0.2, 0.3, 1.0])
LIGHT_DIR = LIGHT_DIR / np.linalg.norm(LIGHT_DIR)


def _rotation_matrix(angle_deg: float, axis) -> np.ndarray:
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    t = math.radians(angle_deg)
    c, s = math.cos(t), math.sin(t)
    C = 1 - c
    x, y, z = a
    return np.array([
        [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
    ])


def project_weak_perspective(verts: np.ndarray, cam, width: int, height: int):
    """verts (V,3) SMPL space -> (V,2) pixels + (V,) depth (camera -z)."""
    sx, sy, tx, ty = cam
    v = verts.copy()
    v[:, 1] *= -1  # 180deg about x
    v[:, 2] *= -1
    ndc_x = sx * (v[:, 0] + tx)
    ndc_y = sy * v[:, 1] - sy * ty
    px = (ndc_x + 1.0) * width / 2.0
    py = (1.0 - ndc_y) * height / 2.0
    depth = v[:, 2]  # camera looks along -z after P[2,2] = -1
    return np.stack([px, py], axis=1), depth


def render_mesh(
    img: np.ndarray,
    verts: np.ndarray,
    cam,
    faces: np.ndarray,
    color=(1.0, 1.0, 0.9),
    wireframe: bool = False,
    angle: Optional[float] = None,
    axis=None,
) -> np.ndarray:
    """Overlay one SMPL mesh on `img` (H,W,3 uint8, any channel order —
    color is given in the same order). Returns a new image."""
    import cv2

    h, w = img.shape[:2]
    verts = np.asarray(verts, np.float64)
    if angle and axis is not None:
        # the reference's extra view rotation (--sideview), applied in the
        # same flipped frame pyrender uses
        flip = np.diag([1.0, -1.0, -1.0])
        R = _rotation_matrix(angle, axis)
        verts = (flip @ R @ flip @ verts.T).T
    pix, depth = project_weak_perspective(verts, cam, w, h)

    tri = faces.astype(np.int64)
    tri_pix = pix[tri]              # (F,3,2)
    tri_depth = depth[tri].mean(1)  # (F,)

    # backface cull + normals in camera space for shading
    v0, v1, v2 = (verts[tri[:, i]] for i in range(3))
    n = np.cross(v1 - v0, v2 - v0)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.clip(norm, 1e-9, None)
    # camera-space normal z after the 180x flip: flip y,z
    n_cam = n * np.array([1.0, -1.0, -1.0])
    shade = AMBIENT + (1 - AMBIENT) * np.clip(n_cam @ LIGHT_DIR, 0, None)

    # visible & on-screen faces only
    inside = (
        (tri_pix[..., 0].max(1) >= 0) & (tri_pix[..., 0].min(1) < w)
        & (tri_pix[..., 1].max(1) >= 0) & (tri_pix[..., 1].min(1) < h)
    )
    order = np.argsort(tri_depth)  # far (most negative z_cam? sort asc) first
    order = order[inside[order]]

    base = np.array(color, np.float64) * 255.0
    out = img.copy()
    lim = 4.0 * max(h, w)  # keep cv2 int coords sane even for wild outputs
    pts_all = np.round(
        np.clip(np.nan_to_num(tri_pix), -lim, lim)).astype(np.int32)
    if wireframe:
        for fidx in order:
            cv2.polylines(out, [pts_all[fidx]], True,
                          tuple((base * shade[fidx]).tolist()), 1)
    else:
        for fidx in order:
            cv2.fillConvexPoly(out, pts_all[fidx],
                               tuple((base * shade[fidx]).tolist()),
                               lineType=cv2.LINE_8)
    return out
