"""Per-frame overlay rendering + video assembly (the reference demo's
render loop).

Counterpart of gaitlab/render/overlay.py. Two modes, like the reference:
  * mesh_render: SMPL mesh per person, by the host painter
    (render/raster.py, in place of pyrender/EGL) or, with
    renderer="zbuffer", by the z-buffer on the card
    (render/raster_torch.py);
  * skeleton mode (default): input frame with a 2D overlay beside a
    3D-skeleton panel, drawn with matplotlib in the reference's figure
    layout.
"""

from __future__ import annotations

import colorsys
import os
import os.path as osp
import shutil
from typing import Optional

import numpy as np

from gaitlab_torch.pipeline import coords as coords_mod
from gaitlab_torch.pipeline import video as video_mod
from gaitlab_torch.render import raster, vis


def render_video(
    results: dict,
    num_frames_list: list,
    image_folder: str,
    save_name: str,
    orig_size: tuple,
    mesh_render: bool = False,
    wireframe: bool = False,
    sideview: bool = False,
    joint_type: str = "spin2",
    smpl_faces: Optional[np.ndarray] = None,
    seed: int = 0,
    # Mesh renderer: "auto" resolves to the host painter, as in gaitlab;
    # "zbuffer" is the exact hidden-surface rasterizer on `device` (None:
    # the card).
    renderer: str = "auto",
    display: bool = False,
    device=None,
) -> str:
    """Write the overlay video `save_name` from the frames of
    `image_folder` (the reference demo's render loop).

    display=True shows each rendered frame in a cv2 window; without a
    display server it warns once and goes on without."""
    import cv2

    rng = np.random.default_rng(seed)
    frame_results = coords_mod.prepare_rendering_results(
        results, list(num_frames_list))
    mesh_color = {k: colorsys.hsv_to_rgb(rng.random(), 0.5, 1.0)
                  for k in results.keys()}

    image_files = video_mod.list_image_files(image_folder)
    output_img_folder = f"{image_folder}_output"
    os.makedirs(output_img_folder, exist_ok=True)

    if not mesh_render:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure("Video", figsize=(10, 5))
        ax_in = fig.add_subplot(1, 2, 1)
        ax_3d = fig.add_subplot(1, 2, 2, projection="3d")
        # body orientation for the 3D panel (demo.py:239-247)
        some_person = next(iter(results.values()))
        rot_mat_body = vis.body_orientation_rotmat(
            some_person["joints3d"][min(10, len(some_person["joints3d"]) - 1)])

    import sys

    if display and sys.platform.startswith("linux") \
            and not os.environ.get("DISPLAY"):
        # headless OpenCV aborts the process inside imshow (no catchable
        # exception), so the capability check must happen up front
        print("WARNING: --display requires a display server ($DISPLAY is "
              "unset); continuing without display.")
        display = False

    def show(frame_path):
        nonlocal display
        if not display:
            return
        try:
            cv2.imshow("Video", cv2.imread(frame_path))
            cv2.waitKey(1)
        except cv2.error:
            print("WARNING: --display needs a GUI-capable OpenCV/host; "
                  "continuing without display.")
            display = False

    for frame_idx in range(len(image_files)):
        img = cv2.imread(image_files[frame_idx])
        out_path = osp.join(output_img_folder, f"{frame_idx:06d}.png")
        people = frame_results.get(frame_idx, {})

        if mesh_render and not people:
            if sideview:  # keep frame sizes uniform for the encoder
                img = np.concatenate([img, np.zeros_like(img)], axis=1)
            cv2.imwrite(out_path, img)  # passthrough frame
            continue

        if mesh_render:
            if renderer == "zbuffer" and not wireframe:
                from gaitlab_torch.render.raster_torch import \
                    render_mesh_zbuffer
                draw = lambda im, pd, c, **kw: render_mesh_zbuffer(
                    im, pd["verts"], pd["cam"], smpl_faces, color=c,
                    device=device, **kw)
            else:
                draw = lambda im, pd, c, **kw: raster.render_mesh(
                    im, pd["verts"], pd["cam"], smpl_faces, color=c,
                    wireframe=wireframe, **kw)
            side = np.zeros_like(img) if sideview else None
            for person_id, pd in people.items():
                img = draw(img, pd, mesh_color[person_id][::-1])  # BGR image
                if sideview:
                    side = draw(side, pd, mesh_color[person_id][::-1],
                                angle=270, axis=[0, 1, 0])
            if sideview:
                img = np.concatenate([img, side], axis=1)
            cv2.imwrite(out_path, img)
            show(out_path)
        else:
            ax_in.clear()
            ax_in.set_axis_off()
            ax_in.set_title("Input")
            shown = img.copy()
            for person_id, pd in people.items():
                c = tuple(int(255 * v) for v in mesh_color[person_id][::-1])
                vis.draw_2d_skeleton(shown, pd["j2d"], fmt=joint_type, color=c)
            ax_in.imshow(cv2.cvtColor(shown, cv2.COLOR_BGR2RGB), aspect="equal")
            ax_3d.clear()
            ax_3d.set_title("Output")
            ax_3d.view_init(elev=200, azim=-27)
            ax_3d.set_xlim3d([-0.6, 0.6])
            ax_3d.set_ylim3d([-1.0, 1.0])
            ax_3d.set_zlim3d([-1.0, 1.0])
            for person_id, pd in people.items():
                j3d = np.einsum("ij,kj->ki", rot_mat_body, pd["j3d"])
                vis.draw_3d_skeleton(j3d, ax_3d, dataset=joint_type)
            fig.savefig(out_path)
            show(out_path)

    if not mesh_render:
        plt.close(fig)  # a later call starts from a new figure
    video_mod.images_to_video(output_img_folder, save_name)
    shutil.rmtree(output_img_folder)
    return save_name
