"""Track-level inference: frames -> crops -> bucketed GRNet -> numpy.

Counterpart of gaitlab/pipeline/runner.py for one card in float32. Frames
arrive in chunks (from memory or image files, `ingest_chunk` at a time, or
as a video reader decodes them) and are cropped on the device (small
frames: only full frames cross to the card) or with cv2 on the host (large
frames: only 224^2 crops cross). The model runs at a small set of batch
sizes ("buckets"), with the tail padded by repeating its last crop, so
that every forward has one of a few shapes. The weights stay on the
model's device.
"""

from __future__ import annotations

import bisect
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from gaitlab_torch.nn.grnet import GRNet
from gaitlab_torch.pipeline import crop as crop_mod
from gaitlab_torch.pipeline import video

DEFAULT_BUCKETS = (32, 64, 128, 256, 450)
OUTPUT_KEYS = ("theta", "verts", "kp_2d", "kp_3d")


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

    def _forward_bucket(self, crops: torch.Tensor) -> dict:
        """One forward of m <= max-bucket normalized NHWC crops, padded to
        the bucket size; outputs sliced back to m frames, on the device."""
        m = crops.shape[0]
        b = self._bucket(m)
        if b > m:
            crops = torch.cat([crops, crops[-1:].expand(b - m, -1, -1, -1)])
        out = self.model.forward(crops)[0]
        return {k: out[k][0, :m] for k in OUTPUT_KEYS}

    def _forward_stream(self, crop_chunks) -> dict:
        """Crop chunks -> forwards of max-bucket slices as they fill, then
        the tail; one readback of every output at the end."""
        max_b = self.buckets[-1]
        outs, pending, n_pending = [], [], 0
        for chunk in crop_chunks:
            pending.append(chunk)
            n_pending += chunk.shape[0]
            while n_pending >= max_b:
                cat = torch.cat(pending)
                outs.append(self._forward_bucket(cat[:max_b]))
                pending, n_pending = [cat[max_b:]], n_pending - max_b
        if n_pending:
            outs.append(self._forward_bucket(torch.cat(pending)))
        if not outs:
            return {}
        return {k: torch.cat([o[k] for o in outs]).cpu().numpy()
                for k in OUTPUT_KEYS}

    def forward_crops(self, crops: torch.Tensor) -> dict:
        """Normalized NHWC crops (N,224,224,3) -> output dict of numpy
        arrays, run at bucket sizes."""
        return self._forward_stream([crops.to(self.model.device)])

    # -- crops ---------------------------------------------------------------

    def _crop_stream(self, frames_or_paths, bboxes: np.ndarray,
                     scale: Optional[float] = None):
        """Yield normalized NHWC crop chunks on the model's device for a
        track given as an (N,H,W,3) uint8 array, a chunked frame source
        (video.VideoChunkReader) or a list of image paths."""
        scale = self.bbox_scale if scale is None else scale
        n = len(bboxes)
        if isinstance(frames_or_paths, np.ndarray):
            chunks = (frames_or_paths[s:s + self.ingest_chunk]
                      for s in range(0, n, self.ingest_chunk))
            frame_hw = frames_or_paths.shape[1] * frames_or_paths.shape[2]
        elif hasattr(frames_or_paths, "image_hw"):
            chunks = iter(frames_or_paths)
            hh, ww = frames_or_paths.image_hw
            frame_hw = hh * ww
        else:
            paths = list(frames_or_paths)
            chunks = (video.load_frames(paths[s:s + self.ingest_chunk])
                      for s in range(0, n, self.ingest_chunk))
            hh, ww = video.load_frames(paths[:1]).shape[1:3]
            frame_hw = hh * ww
        crop_on = self.crop_on
        if crop_on == "auto":
            crop_on = ("device" if frame_hw <= 2 * self.crop_size ** 2
                       else "host")
        device = self.model.device
        # a reader with reuse_buffers=True hands out views that its next
        # chunk rewrites: the host crop reads them at once, but the device
        # crop gets a copy, so that no tensor (nor a later asynchronous
        # upload) aliases the ring
        ring = bool(getattr(frames_or_paths, "reuse_buffers", False))
        s = 0
        for chunk in chunks:
            e = s + len(chunk)
            if crop_on == "host":
                yield crop_mod.normalize_image(torch.from_numpy(
                    self._host_crop(chunk, bboxes[s:e], scale)).to(device))
            else:
                if ring:
                    chunk = np.array(chunk)
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
        crop coords}."""
        out = self._forward_stream(
            self._crop_stream(frames_or_paths, bboxes, scale))
        if not out:
            return {}
        return {
            "pred_cam": out["theta"][:, :3],
            "pose": out["theta"][:, 3:75],
            "betas": out["theta"][:, 75:],
            "verts": out["verts"],
            "joints3d": out["kp_3d"],
            "joints2d": out["kp_2d"],
        }
