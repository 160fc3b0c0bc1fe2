"""Z-buffered mesh rasterizer as torch tensor code on the card.

Counterpart of gaitlab/render/raster_jax.py: correct hidden-surface
removal by a two-pass scatter-min z-buffer, vectorized over faces with no
Python loop over them, so that overlay rendering runs on the device that
ran the model. Same weak-perspective camera and shading as the host painter
(render/raster.py).

Algorithm:
  1. project vertices on the host; per face, rasterize a KxK window
     anchored at the face's bbox corner: barycentric coverage and
     interpolated depth (`_fragments`);
  2. scatter-min every fragment's key into the z-buffer (`zbuffer_pass`);
  3. a fragment whose key is within 1e-7 of the z-buffer owns its pixel;
     each pixel takes the shaded colour of its LAST owning fragment in
     face order (`color_pass`).
Faces are rasterized in extent classes (a small window for the bulk of the
mesh, a large one for the few stretched faces) against one shared
z-buffer, and each class in chunks of at most MAX_FRAGMENTS fragments, so
that memory follows the chunk, not the whole mesh at the largest window.

Depth convention: `project_weak_perspective` returns z in the render
frame, where the camera looks along -z, so NEARER = LARGER depth. The
z-buffer stores key = -depth and scatter-mins, so the nearest fragment
wins.

Ownership ties: at shared edges several fragments tie on depth within
1e-7. gaitlab's colour pass is a scatter-set, which on XLA:CPU applies
duplicate indices in order, so the last owning fragment wins. A CUDA
scatter with duplicate indices has no defined order. Here every fragment
has an ordinal in gaitlab's order (face, then window row, then column),
each pixel keeps the largest owning ordinal (scatter-max, exact in any
order), and classes paint in order, later over earlier: the same last
writer, on any device, bit-identical from run to run.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gaitlab_torch.device import resolve_device, upload
from gaitlab_torch.render.raster import (AMBIENT, LIGHT_DIR, _rotation_matrix,
                                         project_weak_perspective)

FAR = 1e9
MAX_FRAGMENTS = 1 << 22  # fragments per chunk: ~100 MB of temporaries


def _fragments(verts_pix: torch.Tensor, depth: torch.Tensor,
               faces: torch.Tensor, height: int, width: int, window: int):
    """Per-face KxK fragment grid, flattened in (face, row, column) order:
    (flat pixel index int64, z key, validity). key = -depth where valid
    (scatter-MIN keeps the nearest = largest depth), FAR elsewhere."""
    tri = verts_pix[faces]           # (F,3,2)
    tri_z = depth[faces]             # (F,3)
    x0 = torch.floor(tri[..., 0].amin(1)).clamp(0, width - 1)
    y0 = torch.floor(tri[..., 1].amin(1)).clamp(0, height - 1)

    dx = torch.arange(window, dtype=torch.float32, device=faces.device)
    px = (x0[:, None] + dx[None, :])[:, None, :]   # (F,1,K)
    py = (y0[:, None] + dx[None, :])[:, :, None]   # (F,K,1)

    ax, ay = tri[:, 0, 0], tri[:, 0, 1]
    bx, by = tri[:, 1, 0], tri[:, 1, 1]
    cx, cy = tri[:, 2, 0], tri[:, 2, 1]
    area = (bx - ax) * (cy - ay) - (cx - ax) * (by - ay)
    degenerate = area.abs() < 1e-9
    inv_area = torch.where(degenerate, 0.0, 1.0 / area)

    def edge(x1, y1, x2, y2):
        return ((x2 - x1)[:, None, None] * (py - y1[:, None, None])
                - (y2 - y1)[:, None, None] * (px - x1[:, None, None]))

    w0 = edge(bx, by, cx, cy) * inv_area[:, None, None]
    w1 = edge(cx, cy, ax, ay) * inv_area[:, None, None]
    w2 = 1.0 - w0 - w1
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & ~degenerate[:, None, None]

    frag_z = (w0 * tri_z[:, 0, None, None] + w1 * tri_z[:, 1, None, None]
              + w2 * tri_z[:, 2, None, None])
    ix = px.to(torch.int64).clamp(0, width - 1)
    iy = py.to(torch.int64).clamp(0, height - 1)
    on_screen = (px < width) & (py < height)  # px, py >= 0 by the clamps
    valid = (inside & on_screen).reshape(-1)
    flat_idx = (iy * width + ix).expand(inside.shape).reshape(-1)
    key = torch.where(valid, -frag_z.reshape(-1), FAR)
    return flat_idx, key, valid


def _chunks(n_faces: int, window: int):
    """[start, end) face ranges of at most MAX_FRAGMENTS fragments."""
    step = max(1, MAX_FRAGMENTS // (window * window))
    return [(s, min(s + step, n_faces)) for s in range(0, n_faces, step)]


def zbuffer_pass(verts_pix, depth, faces, zbuf, *, height: int, width: int,
                 window: int) -> torch.Tensor:
    """Scatter-min this face group's fragment keys into zbuf (H*W,), in
    place; returns zbuf."""
    for s, e in _chunks(faces.shape[0], window):
        flat_idx, key, _ = _fragments(verts_pix, depth, faces[s:e], height,
                                      width, window)
        zbuf.scatter_reduce_(0, flat_idx, key, reduce="amin")
    return zbuf


def color_pass(verts_pix, depth, faces, shade, color, zbuf, canvas, *,
               height: int, width: int, window: int) -> torch.Tensor:
    """Paint each pixel that a fragment of this group owns under the FINAL
    zbuf with the shaded colour of its last owning fragment in (face, row,
    column) order. canvas (H*W, 3) float32, in place; returns canvas."""
    kk = window * window
    owner = torch.full((height * width,), -1, dtype=torch.int64,
                       device=faces.device)
    for s, e in _chunks(faces.shape[0], window):
        flat_idx, key, valid = _fragments(verts_pix, depth, faces[s:e],
                                          height, width, window)
        owns = valid & (key <= zbuf[flat_idx] + 1e-7)
        ordinal = torch.arange(s * kk, e * kk, device=faces.device)
        # a fragment that does not own its pixel offers -1 there, which
        # changes nothing: one dummy slot for all of them would serialize
        # millions of atomics on one address
        owner.scatter_reduce_(0, flat_idx, torch.where(owns, ordinal, -1),
                              reduce="amax")
    face = (owner // kk).clamp(min=0)
    painted = shade[face][:, None] * color[None, :]
    return canvas.copy_(torch.where((owner >= 0)[:, None], painted, canvas))


def _rasterize(verts_pix, depth, faces, shade, color, background, groups,
               device) -> tuple[torch.Tensor, torch.Tensor]:
    """Host inputs -> (canvas (H,W,3) float32, zbuf (H,W)) on `device`:
    one z pass per group against a shared z-buffer, then one colour pass
    per group in order. groups: [(face indices, window)]."""
    h, w = background.shape[:2]
    pix_t = upload(np.asarray(verts_pix, np.float32), device)
    dep_t = upload(np.asarray(depth, np.float32), device)
    col_t = upload(np.asarray(color, np.float32), device)
    faces = np.asarray(faces, np.int64)
    shade = np.asarray(shade, np.float32)
    g_faces = [upload(faces[idx], device) for idx, _ in groups]
    g_shade = [upload(shade[idx], device) for idx, _ in groups]
    zbuf = torch.full((h * w,), FAR, dtype=torch.float32, device=device)
    for fc, (_, k) in zip(g_faces, groups):
        zbuffer_pass(pix_t, dep_t, fc, zbuf, height=h, width=w, window=k)
    canvas = upload(np.asarray(background), device).reshape(-1, 3).float()
    for fc, sh, (_, k) in zip(g_faces, g_shade, groups):
        color_pass(pix_t, dep_t, fc, sh, col_t, zbuf, canvas, height=h,
                   width=w, window=k)
    return canvas.reshape(h, w, 3), zbuf.reshape(h, w)


def rasterize_zbuffer(verts_pix, depth, faces, shade, color, background,
                      height: int, width: int, window: int = 32,
                      device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-group rasterization: verts_pix (V,2) pixels, depth (V,)
    (larger = nearer), faces (F,3), shade (F,) Lambert factors, color (3,)
    0..255, background (H,W,3). Returns (canvas (H,W,3) float32, zbuf
    (H,W)) on `device` (None: the card)."""
    if tuple(np.shape(background)[:2]) != (height, width):
        raise ValueError(f"background {np.shape(background)} is not "
                         f"{height}x{width}")
    n = np.shape(faces)[0]
    return _rasterize(verts_pix, depth, faces, shade, color, background,
                      [(np.arange(n), int(window))], resolve_device(device))


def _window_classes(extents: np.ndarray, cap: int = 128):
    """Split faces into (small, large) window classes: the bulk at the p97
    extent, the tail at the max, each rounded up to a multiple of 8 (with
    2 px of margin) and capped."""
    def rnd(e):
        return int(np.clip(8 * np.ceil((e + 2.0) / 8.0), 8, cap))

    if extents.size == 0:
        return [(np.zeros(0, np.int64), 8)]
    k_small = rnd(np.percentile(extents, 97.0))
    k_big = rnd(extents.max())
    small = extents <= (k_small - 2.0)
    if k_big <= k_small or small.all():
        return [(np.arange(extents.size), rnd(extents.max()))]
    return [(np.nonzero(small)[0], k_small),
            (np.nonzero(~small)[0], k_big)]


def mesh_inputs(height: int, width: int, verts, cam, faces, window: int = 0,
                angle=None, axis=None):
    """Host half of render_mesh_zbuffer: (pixels (V,2), depth (V,), faces
    (F,3) int64, shade (F,), groups [(face indices, window)])."""
    verts = np.asarray(verts, np.float64)
    if angle and axis is not None:
        # extra view rotation in the same flipped frame the painter uses
        flip = np.diag([1.0, -1.0, -1.0])
        R = _rotation_matrix(angle, axis)
        verts = (flip @ R @ flip @ verts.T).T
    pix, depth = project_weak_perspective(verts, cam, width, height)

    tri = np.asarray(faces, np.int64)
    v0, v1, v2 = (verts[tri[:, i]] for i in range(3))
    n = np.cross(v1 - v0, v2 - v0)
    n = n / np.clip(np.linalg.norm(n, axis=1, keepdims=True), 1e-9, None)
    n_cam = n * np.array([1.0, -1.0, -1.0])
    shade = AMBIENT + (1 - AMBIENT) * np.clip(n_cam @ LIGHT_DIR, 0, None)

    tp = np.clip(np.nan_to_num(pix[tri]), [0, 0], [width - 1, height - 1])
    extents = (tp.max(axis=1) - tp.min(axis=1)).max(axis=1)
    if window:
        groups = [(np.arange(tri.shape[0]), int(window))]
    else:
        groups = _window_classes(extents)
    return pix, depth, tri, shade, groups


def render_mesh_zbuffer(img: np.ndarray, verts: np.ndarray, cam,
                        faces: np.ndarray, color=(1.0, 1.0, 0.9),
                        window: int = 0, angle=None, axis=None,
                        device: Optional[str] = None) -> np.ndarray:
    """Z-buffered counterpart of raster.render_mesh: overlay one mesh on
    `img` (H,W,3 uint8, color in the image's channel order) on `device`
    (None: the card), return a new uint8 image.

    window=0 sizes per-face windows in two extent classes (multiples of 8).
    angle/axis apply the reference's extra view rotation (--sideview)."""
    h, w = img.shape[:2]
    pix, depth, tri, shade, groups = mesh_inputs(h, w, verts, cam, faces,
                                                 window, angle, axis)
    canvas, _ = _rasterize(pix, depth, tri, shade,
                           np.asarray(color, np.float32) * 255.0, img,
                           groups, resolve_device(device))
    return canvas.clamp(0, 255).to(torch.uint8).cpu().numpy()
