"""Host-side video decode and frame-folder IO (cv2).

Counterpart of gaitlab/pipeline/video.py: frame extraction to a PNG
folder (optionally resampled, as batch_generation extracts at 20 fps),
trimming, folder listing and loading, and decoding straight from the
container in chunks (`VideoChunkReader`, the --stream path).
"""

from __future__ import annotations

import os
import os.path as osp
import tempfile
from typing import Iterator, Optional, Tuple

import numpy as np


def _fps_resample_indices(n_in: int, fps_in: float, fps_out: float) -> np.ndarray:
    """Frame indices emulating ffmpeg's `fps=` filter (round=near)."""
    if fps_out is None or fps_in <= 0 or abs(fps_in - fps_out) < 1e-6:
        return np.arange(n_in)
    duration = n_in / fps_in
    n_out = max(1, int(round(duration * fps_out)))
    t_out = np.arange(n_out) / fps_out
    idx = np.round(t_out * fps_in).astype(int)
    return np.clip(idx, 0, n_in - 1)


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


def read_frames(vid_file: str, fps: Optional[float] = None
                ) -> Iterator[np.ndarray]:
    """Decode a video to RGB uint8 frames, optionally resampled to `fps`."""
    import cv2

    cap = cv2.VideoCapture(vid_file)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {vid_file}")
    try:
        fps_in = cap.get(cv2.CAP_PROP_FPS) or 30.0
        counts = None
        if fps is not None:
            n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            # multiplicity per source frame (the fps filter can also
            # duplicate frames)
            counts = np.bincount(_fps_resample_indices(n, fps_in, fps),
                                 minlength=n)
        i = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if counts is None:
                yield rgb
            else:
                for _ in range(int(counts[i]) if i < len(counts) else 0):
                    yield rgb
            i += 1
    finally:
        cap.release()


class VideoChunkReader:
    """Stream selected frames straight from a video file in decoded
    chunks, with one-chunk prefetch on a worker thread.

    The --stream path's frame source: a clip goes decode -> crop -> device
    without the PNG folder round trip. Feed it to GRNetRunner.run_track in
    place of a path list.

    frame_ids: sorted frame indices to keep (a track's frames); None = all.
    Yields (k, H, W, 3) uint8 RGB chunks covering frame_ids in order.

    Frames are always decoded straight into a 3-deep preallocated ring.
    reuse_buffers=True yields views into it, with no allocation per chunk.
    CONTRACT: such a chunk is valid only until the next chunk is pulled
    from the iterator; consumers that hold chunks across iterations must
    copy them. The runner's crop stream and the detectors consume one
    chunk at a time. reuse_buffers=False (gaitlab's default, kept for the
    same callers' sake) yields a copy of each chunk, which stays valid.
    """

    def __init__(self, vid_file: str, frame_ids=None, chunk: int = 32,
                 reuse_buffers: bool = False):
        self.vid_file = vid_file
        self.chunk = chunk
        self.reuse_buffers = reuse_buffers
        self.frame_ids = (None if frame_ids is None
                          else np.asarray(frame_ids, np.int64))
        if self.frame_ids is not None and np.any(np.diff(self.frame_ids) < 0):
            raise ValueError("frame_ids must be sorted")
        n, fps, w, h = get_video_info(vid_file)
        self.image_hw = (h, w)
        self.num_frames = (n if self.frame_ids is None
                           else len(self.frame_ids))

    def __len__(self):
        return -(-self.num_frames // self.chunk)

    def __iter__(self) -> Iterator[np.ndarray]:
        import queue
        import threading

        import cv2

        # ring safety: the worker fills slot j%3 for chunk j. With queue
        # maxsize=1 the worker is at most (consumed + 1 queued + 1 being
        # filled) ahead, so the consumer's CURRENT chunk slot is never
        # rewritten before the next pull.
        q: queue.Queue = queue.Queue(maxsize=1)
        stop = threading.Event()
        h, w = self.image_hw
        ring = [np.empty((self.chunk, h, w, 3), np.uint8) for _ in range(3)]

        def worker():
            cap = cv2.VideoCapture(self.vid_file)
            try:
                if not cap.isOpened():
                    raise FileNotFoundError(self.vid_file)
                want = self.frame_ids
                wi = 0
                i = 0
                bi = 0   # ring slot
                k = 0    # frames in current slot

                def put(item):
                    # bounded put that notices a stopped consumer, so an
                    # early break on the consumer side can't leave this
                    # thread blocked forever holding the capture
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.2)
                            return True
                        except queue.Full:
                            continue
                    return False

                def flush(full_only: bool):
                    nonlocal bi, k
                    if k and (not full_only or k >= self.chunk):
                        if not put(ring[bi][:k]):
                            return
                        bi = (bi + 1) % 3
                        k = 0

                while not stop.is_set():
                    ok, frame = cap.read()
                    if not ok:
                        break
                    take = 0
                    if want is None:
                        take = 1
                    else:
                        while wi < len(want) and want[wi] == i:
                            take += 1  # duplicated ids allowed
                            wi += 1
                    if take:
                        cv2.cvtColor(frame, cv2.COLOR_BGR2RGB,
                                     dst=ring[bi][k])
                        first = ring[bi][k]
                        k += 1
                        flush(True)
                        for _ in range(take - 1):
                            np.copyto(ring[bi][k], first)
                            k += 1
                            flush(True)
                    i += 1
                    if want is not None and wi >= len(want):
                        break
                flush(False)
                put(None)
            except Exception as e:
                try:
                    q.put(e, timeout=1.0)
                except queue.Full:
                    pass
            finally:
                cap.release()

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item if self.reuse_buffers else item.copy()
        finally:
            stop.set()


def video_to_images(vid_file: str, img_folder: Optional[str] = None,
                    return_info: bool = False, fps: Optional[float] = None):
    """Extract frames to `<folder>/%06d.png`, 1-based (the reference's
    frame-folder contract), resampled to `fps` as `read_frames` selects
    them (all frames when None). The default folder lies under the
    system's temporary directory."""
    import cv2

    if img_folder is None:
        img_folder = osp.join(tempfile.gettempdir(),
                              osp.basename(vid_file).replace(".", "_") + "_mpt")
    os.makedirs(img_folder, exist_ok=True)
    n, shape = 0, None
    for n, frame in enumerate(read_frames(vid_file, fps=fps), start=1):
        shape = frame.shape
        cv2.imwrite(osp.join(img_folder, f"{n:06d}.png"),
                    cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    print(f"Images saved to \"{img_folder}\"")
    if return_info:
        return img_folder, n, shape
    return img_folder


def trim_video(vid_file: str, start_time: float, end_time: float,
               output_vid_file: str) -> int:
    """Cut [start_time, end_time) seconds out of a video into a new mp4v
    file with cv2 (the reference's trim_videos shells out to an ffmpeg
    binary). Returns the number of frames written."""
    import cv2

    cap = cv2.VideoCapture(vid_file)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {vid_file}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    first = int(round(start_time * fps))
    last = int(round(end_time * fps))  # exclusive
    os.makedirs(osp.dirname(output_vid_file) or ".", exist_ok=True)
    writer = cv2.VideoWriter(output_vid_file, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
    n = 0
    try:
        for idx in range(last):
            ok, frame = cap.read()
            if not ok:
                break
            if idx >= first:
                writer.write(frame)
                n += 1
    finally:
        cap.release()
        writer.release()
    return n


trim_videos = trim_video  # the reference's name


def images_to_video(img_folder: str, output_vid_file: str,
                    fps: float = 30.0) -> None:
    """Encode `<folder>/%06d.png` to an mp4 (cv2, mp4v)."""
    import cv2

    names = sorted(f for f in os.listdir(img_folder)
                   if f.endswith((".png", ".jpg")))
    if not names:
        raise ValueError(f"no frames in {img_folder}")
    first = cv2.imread(osp.join(img_folder, names[0]))
    h, w = first.shape[:2]
    os.makedirs(osp.dirname(output_vid_file) or ".", exist_ok=True)
    writer = cv2.VideoWriter(output_vid_file, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
    try:
        for name in names:
            writer.write(cv2.imread(osp.join(img_folder, name)))
    finally:
        writer.release()
    print(f"Video saved to \"{output_vid_file}\"")


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
