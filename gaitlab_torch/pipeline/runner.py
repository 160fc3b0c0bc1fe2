"""Track-level inference: frames -> crops -> bucketed GRNet -> numpy.

Counterpart of gaitlab/pipeline/runner.py for one card in float32. Frames
arrive in chunks (from memory, from image files through the prefetching
native loader, `ingest_chunk` at a time, or as a video reader decodes
them) and are cropped on the device (small
frames: only full frames cross to the card) or with cv2 on the host (large
frames: only 224^2 crops cross). The model runs at a small set of batch
sizes ("buckets"), with the tail padded by repeating its last crop, so
that every forward has one of a few shapes. The weights stay on the
model's device.

Forwards go through a `ForwardStream` session (`open_stream`): crop chunks
are fed as they come, a forward runs on the session's worker thread
whenever a largest bucket has filled, and the outputs stay on the device
until `finish` reads them back once. Host data crosses to the card as
asynchronous copies from pinned memory (`device.upload`). With the gait
branch each forward also takes the chunk's bbox and image-centre rows and
its real-frame count (n_valid); the track-level gait estimate (pred_avg)
of each forward is then averaged with weights equal to its real frames,
and pred_phase is concatenated.
"""

from __future__ import annotations

import bisect
import os
import queue
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from gaitlab_torch.device import upload
from gaitlab_torch.nn.grnet import GRNet
from gaitlab_torch.pipeline import crop as crop_mod
from gaitlab_torch.pipeline import loader

DEFAULT_BUCKETS = (32, 64, 128, 256, 450)
OUTPUT_KEYS = ("theta", "verts", "kp_2d", "kp_3d")
GAIT_KEYS = ("pred_avg", "pred_phase")


@dataclass
class GRNetRunner:
    model: GRNet
    buckets: Optional[Sequence[int]] = None  # None -> $GAITLAB_BUCKETS or default
    crop_size: int = 224
    bbox_scale: float = 1.0
    ingest_chunk: int = 32   # full-res frames decoded / staged at once
    # only "float32" (TF32 off) is ported; the faster modes come later
    precision: str = "float32"
    # "device": crop on the card; "host": cv2 on the CPU; "auto": host for
    # frames larger than twice the crop area, the device otherwise
    crop_on: str = "auto"
    parallel: Optional[str] = None

    def __post_init__(self):
        if self.precision != "float32":
            raise NotImplementedError(
                f"precision={self.precision!r} is not ported yet; "
                "use 'float32'")
        if self.parallel is not None:
            raise NotImplementedError(
                f"parallel={self.parallel!r} is not ported yet")
        if self.crop_on not in ("auto", "device", "host"):
            raise ValueError(f"crop_on={self.crop_on!r}: use auto/device/host")
        if self.buckets is None:
            env = os.environ.get("GAITLAB_BUCKETS", "")
            self.buckets = (tuple(int(x) for x in env.split(",") if x)
                            if env else DEFAULT_BUCKETS)
        self.buckets = tuple(sorted(set(self.buckets)))

    def _bucket(self, n: int) -> int:
        i = bisect.bisect_left(self.buckets, n)
        return self.buckets[min(i, len(self.buckets) - 1)]

    # -- model forward at bucket sizes -------------------------------------

    def _forward_bucket(self, crops: torch.Tensor, bbox=None, cimg=None
                        ) -> dict:
        """One forward of m <= max-bucket normalized NHWC crops (and, for
        the gait branch, their bbox/cimg rows), padded to the bucket size by
        repeating the last row; per-frame outputs sliced back to m frames,
        on the device. The gait branch is told that m frames are real."""
        m = crops.shape[0]
        b = self._bucket(m)
        if b > m:
            crops = torch.cat([crops, crops[-1:].expand(b - m, -1, -1, -1)])
        kw = {}
        if self.model.module.use_gait_feat:
            kw = dict(bbox=_pad_rows(bbox, b), cimg=_pad_rows(cimg, b),
                      n_valid=m)
        out = self.model.forward(crops, **kw)[0]
        res = {k: out[k][0, :m] for k in OUTPUT_KEYS + ("pred_phase",)
               if k in out}
        if "pred_avg" in out:
            res["pred_avg"] = out["pred_avg"]  # (1,3): one per forward
        return res

    def open_stream(self) -> "ForwardStream":
        """An incremental forward session: feed() crop chunks (and, for
        the gait branch, their bbox/cimg rows) as they come, finish()
        once."""
        return ForwardStream(self)

    def _forward_stream(self, crop_chunks, bbox=None, cimg=None) -> dict:
        """Feed each crop chunk with its slice of the track's rows."""
        session = self.open_stream()
        s = 0
        for chunk in crop_chunks:
            e = s + chunk.shape[0]
            session.feed(chunk, bbox=None if bbox is None else bbox[s:e],
                         cimg=None if cimg is None else cimg[s:e])
            s = e
        return session.finish()

    def forward_crops(self, crops, bbox=None, cimg=None) -> dict:
        """Normalized NHWC crops (N,224,224,3) -> output dict of numpy
        arrays, run at bucket sizes. bbox/cimg (N,4)/(N,2) feed the gait
        branch when the model has one."""
        return self._forward_stream([crops], bbox=bbox, cimg=cimg)

    # -- crops ---------------------------------------------------------------

    def _frame_hw(self, frames_or_paths) -> tuple[int, int]:
        """(H, W) of a track's frames: an array, a chunked frame source or
        image paths (the first image is read)."""
        if isinstance(frames_or_paths, np.ndarray):
            return tuple(frames_or_paths.shape[1:3])
        if hasattr(frames_or_paths, "image_hw"):
            return tuple(frames_or_paths.image_hw)
        return tuple(loader.image_size(list(frames_or_paths)[0]))

    def _crop_stream(self, frames_or_paths, bboxes: np.ndarray,
                     scale: Optional[float] = None):
        """Yield normalized NHWC crop chunks on the model's device for a
        track given as an (N,H,W,3) uint8 array, a chunked frame source
        (video.VideoChunkReader) or a list of image paths."""
        scale = self.bbox_scale if scale is None else scale
        n = len(bboxes)
        hh, ww = self._frame_hw(frames_or_paths)
        crop_on = self.crop_on
        if crop_on == "auto":
            crop_on = ("device" if hh * ww <= 2 * self.crop_size ** 2
                       else "host")
        device = self.model.device
        if isinstance(frames_or_paths, np.ndarray):
            chunks = (frames_or_paths[s:s + self.ingest_chunk]
                      for s in range(0, n, self.ingest_chunk))
        elif hasattr(frames_or_paths, "image_hw"):
            chunks = iter(frames_or_paths)
        else:
            # image paths: chunk i+1 is decoded on the loader's worker while
            # chunk i is cropped; into pinned memory when the frames go to
            # the card
            chunks = iter(loader.PrefetchLoader(
                frames_or_paths, chunk=self.ingest_chunk,
                pin=crop_on == "device" and device.type == "cuda"))
        # a reader with reuse_buffers=True hands out views that its next
        # chunk rewrites: both crops have read a chunk before the next is
        # decoded (the upload to the card copies it into pinned memory at
        # once, and the CPU crop gathers it into new tensors)
        s = 0
        for chunk in chunks:
            e = s + len(chunk)
            if crop_on == "host":
                yield crop_mod.normalize_image(upload(
                    self._host_crop(chunk, bboxes[s:e], scale), device))
            else:
                yield crop_mod.crop_and_normalize(
                    chunk, bboxes[s:e], scale=scale,
                    crop_size=self.crop_size, device=device)
            s = e
        if s != n:
            raise ValueError(f"{s} frames for {n} bboxes")

    def _host_crop(self, chunk: np.ndarray, bboxes: np.ndarray,
                   scale: float) -> np.ndarray:
        """cv2 warpAffine crops (uint8), the reference's host preprocessing."""
        cs = self.crop_size
        out = np.empty((len(chunk), cs, cs, 3), np.uint8)
        for i, bb in enumerate(bboxes):
            out[i], _ = crop_mod.generate_patch_image(
                chunk[i], bb[0], bb[1], bb[2], bb[3], cs, cs, scale=scale)
        return out

    def crop_track(self, frames_or_paths, bboxes: np.ndarray,
                   scale: Optional[float] = None) -> torch.Tensor:
        """Frames + per-frame square bboxes -> normalized NHWC crops on the
        model's device."""
        return torch.cat(list(self._crop_stream(frames_or_paths, bboxes,
                                                scale)))

    # -- full track ----------------------------------------------------------

    def run_track(self, frames_or_paths, bboxes: np.ndarray,
                  scale: Optional[float] = None) -> dict:
        """The reference demo's model loop for one track.

        Returns numpy {'pred_cam' (N,3), 'verts' (N,6890,3), 'pose' (N,72),
        'betas' (N,10), 'joints3d' (N,J,3), 'joints2d' (N,J,2) normalized
        crop coords}, and with the gait branch 'pred_avg' (3,) and
        'pred_phase' (N,4); the branch gets each frame's bbox and the
        image centre."""
        bb = ci = None
        if self.model.module.use_gait_feat:
            h, w = self._frame_hw(frames_or_paths)
            bb = np.asarray(bboxes, np.float32)
            ci = np.full((len(bb), 2), [w * 0.5, h * 0.5], np.float32)
        out = self._forward_stream(
            self._crop_stream(frames_or_paths, bboxes, scale),
            bbox=bb, cimg=ci)
        return track_outputs(out)


def track_outputs(out: dict) -> dict:
    """Forward outputs (theta, verts, kp_3d, ...) -> run_track's keys."""
    if not out:
        return {}
    res = {"pred_cam": out["theta"][:, :3], "pose": out["theta"][:, 3:75],
           "betas": out["theta"][:, 75:], "verts": out["verts"],
           "joints3d": out["kp_3d"], "joints2d": out["kp_2d"]}
    res.update({k: out[k] for k in GAIT_KEYS if k in out})
    return res


def _pad_rows(rows: torch.Tensor, b: int) -> torch.Tensor:
    return torch.cat([rows, rows[-1:].expand(b - len(rows), -1)])


class ForwardStream:
    """Incremental bucketed-forward session (GRNetRunner.open_stream).

    feed() takes crop chunks, as host uint8 crops (normalized on the
    device) or as normalized float crops (host or device), and for the gait
    branch the aligned bbox/cimg rows. Whenever a largest bucket has
    gathered, its forward goes to one worker thread, which copies the host
    chunks to the device (`device.upload`: pinned, asynchronous), normalizes
    and launches; feed() launches nothing. A forward launches a few
    thousand kernels, more than the card's launch queue holds, so the
    launching thread waits for the card through most of each forward: on
    the worker, that wait overlaps the caller's host work (decode,
    detection, crops). A fed chunk is read by the worker later, so the
    caller must not write to it afterwards. finish() launches the tail,
    waits for the worker, reads every output back once and merges. An
    error of a forward raises at the next feed() or at finish()."""

    def __init__(self, runner: GRNetRunner):
        self.runner = runner
        self.device = runner.model.device
        self.gait = runner.model.module.use_gait_feat
        self.max_b = runner.buckets[-1]
        self._buf: list = []  # chunks (or their tails) not yet dispatched
        self._rows = {"bbox": [], "cimg": []}  # host rows not yet dispatched
        self._buffered = 0
        self._outs: list = []
        self._lengths: list = []
        self._err: list = []
        self._queue = None
        self._thread = None
        self._done = False

    def _to_device(self, chunk) -> torch.Tensor:
        if isinstance(chunk, np.ndarray) and chunk.dtype == np.uint8:
            return crop_mod.normalize_image(upload(chunk, self.device))
        return upload(chunk, self.device)

    def _work(self) -> None:
        """The worker: one forward per queued bucket, in order, until None;
        after an error it skips the rest."""
        while True:
            item = self._queue.get()
            if item is None:
                return
            if self._err:
                continue
            try:
                self._outs.append(self._forward(*item))
            except BaseException as e:  # raised at the next feed/finish
                self._err.append(e)

    def _forward(self, pieces: list, rows: dict) -> dict:
        """One bucket's forward from its chunk slices and host rows."""
        crops = torch.cat([self._to_device(p) for p in pieces])
        rows = {k: upload(v, self.device) for k, v in rows.items()}
        return self.runner._forward_bucket(crops, **rows)

    def _check_err(self) -> None:
        if self._err:
            raise self._err[0]

    def _take(self, m: int) -> list:
        """The first m buffered frames, as slices of the fed chunks."""
        pieces, n = [], 0
        while n < m:
            chunk = self._buf.pop(0)
            k = min(len(chunk), m - n)
            pieces.append(chunk[:k])
            if k < len(chunk):
                self._buf.insert(0, chunk[k:])
            n += k
        self._buffered -= m
        return pieces

    def _take_rows(self, m: int) -> dict:
        """The next m bbox and cimg rows (host)."""
        rows = {}
        for k, bufs in self._rows.items():
            cat = np.concatenate(bufs) if bufs else np.zeros((0, 0), np.float32)
            if len(cat) < m:
                raise ValueError(f"the gait branch needs a bbox/cimg row for "
                                 f"each of {m} frames, got {len(cat)} {k}")
            self._rows[k] = [cat[m:]] if len(cat) > m else []
            rows[k] = cat[:m]
        return rows

    def _dispatch(self, m: int) -> None:
        self._check_err()
        rows = self._take_rows(m) if self.gait else {}
        if self._thread is None:
            self._queue = queue.Queue(maxsize=2)
            self._thread = threading.Thread(target=self._work, daemon=True)
            self._thread.start()
        self._queue.put((self._take(m), rows))
        self._lengths.append(m)

    def feed(self, chunk, bbox=None, cimg=None) -> None:
        """Add a crop chunk (and, for the gait branch, its rows)."""
        if self._done:
            raise RuntimeError("feed() after finish()")
        self._check_err()
        self._buf.append(chunk)
        self._buffered += chunk.shape[0]
        for k, rows in (("bbox", bbox), ("cimg", cimg)):
            if rows is not None:
                self._rows[k].append(np.asarray(rows, np.float32))
        while self._buffered >= self.max_b:
            self._dispatch(self.max_b)

    def finish(self) -> dict:
        """Launch the tail, wait for the worker, read the outputs back once,
        merge them."""
        if self._done:
            raise RuntimeError("finish() called twice")
        self._done = True
        if self._buffered:
            self._dispatch(self._buffered)
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join()
            self._thread = None
        self._check_err()
        if not self._outs:  # no frame fed
            return {}
        fetched = [{k: v.cpu().numpy() for k, v in out.items()}
                   for out in self._outs]
        self._outs = []
        merged = {}
        for k in fetched[0]:
            if k == "pred_avg":
                # a track-level estimate per forward, weighted by its real
                # frames (the tail forward may be mostly padding)
                merged[k] = np.average([o[k][0] for o in fetched], axis=0,
                                       weights=self._lengths)
            else:
                merged[k] = np.concatenate([o[k] for o in fetched])
        return merged
