"""Host-side video decode and frame-folder IO (cv2).

Counterpart of the parts of gaitlab/pipeline/video.py that the demo's
`--tracking_path` path calls.
"""

from __future__ import annotations

import os
import os.path as osp
import tempfile
from typing import Optional, Tuple

import numpy as np


def get_video_info(vid_file: str) -> Tuple[int, float, int, int]:
    """(num_frames, fps, width, height)."""
    import cv2

    cap = cv2.VideoCapture(vid_file)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {vid_file}")
    try:
        return (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                cap.get(cv2.CAP_PROP_FPS) or 30.0,
                int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    finally:
        cap.release()


def video_to_images(vid_file: str, img_folder: Optional[str] = None,
                    return_info: bool = False):
    """Extract frames to `<folder>/%06d.png`, 1-based (the reference's
    frame-folder contract). The default folder lies under the system's
    temporary directory."""
    import cv2

    if img_folder is None:
        img_folder = osp.join(tempfile.gettempdir(),
                              osp.basename(vid_file).replace(".", "_") + "_mpt")
    os.makedirs(img_folder, exist_ok=True)
    cap = cv2.VideoCapture(vid_file)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {vid_file}")
    n, shape = 0, None
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            n += 1
            shape = frame.shape
            cv2.imwrite(osp.join(img_folder, f"{n:06d}.png"), frame)
    finally:
        cap.release()
    print(f"Images saved to \"{img_folder}\"")
    if return_info:
        return img_folder, n, shape
    return img_folder


def list_image_files(image_folder: str) -> list[str]:
    """Sorted frame paths of a folder (.png / .jpg)."""
    return sorted(
        osp.join(image_folder, x) for x in os.listdir(image_folder)
        if x.endswith(".png") or x.endswith(".jpg")
    )


def load_frames(paths, as_rgb: bool = True) -> np.ndarray:
    """Read a list of image files -> (N,H,W,3) uint8."""
    import cv2

    out = []
    for p in paths:
        img = cv2.imread(p)
        if img is None:
            raise FileNotFoundError(p)
        out.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB) if as_rgb else img)
    return np.stack(out)
