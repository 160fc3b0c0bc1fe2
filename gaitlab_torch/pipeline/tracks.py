"""Multi-person tracking: SORT (Kalman filter + IoU Hungarian matching) on
host numpy, and tracklet splitting at large frame gaps.

Counterpart of gaitlab/pipeline/tracks.py. Tracking is sequential,
low-FLOP host work, so it stays in numpy; the detector is pluggable
(gaitlab_torch.pipeline.detect).

`track_video` returns {person_id: {'bbox': (N, 4) [cx, cy, w, h] square
boxes, 'frames': (N,)}}; `smooth_tracking` splits those tracks at large
gaps and renumbers them from 0 (the reference's smooth_tracking).
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

MIN_NUM_FRAMES = 25


# ---------------------------------------------------------------------------
# Kalman box tracker (SORT: constant-velocity on [u, v, s, r])
# ---------------------------------------------------------------------------

def _xyxy_to_z(bb):
    w = bb[2] - bb[0]
    h = bb[3] - bb[1]
    return np.array([bb[0] + w / 2.0, bb[1] + h / 2.0, w * h,
                     w / max(h, 1e-6)], np.float64)


def _z_to_xyxy(z):
    w = np.sqrt(max(z[2] * z[3], 0.0))
    h = z[2] / max(w, 1e-6)
    return np.array([z[0] - w / 2.0, z[1] - h / 2.0,
                     z[0] + w / 2.0, z[1] + h / 2.0], np.float64)


class KalmanBoxTracker:
    """Constant-velocity Kalman filter over [u,v,s,r,du,dv,ds]."""

    _count = 0

    def __init__(self, bbox_xyxy):
        dim_x, dim_z = 7, 4
        self.F = np.eye(dim_x)
        for i in range(3):
            self.F[i, i + 4] = 1.0
        self.H = np.zeros((dim_z, dim_x))
        self.H[:4, :4] = np.eye(4)
        self.R = np.diag([1.0, 1.0, 10.0, 10.0])
        self.P = np.diag([10.0, 10.0, 10.0, 10.0, 1e4, 1e4, 1e4])
        self.Q = np.diag([1.0, 1.0, 1.0, 1.0, 0.01, 0.01, 1e-4])
        self.x = np.zeros(dim_x)
        self.x[:4] = _xyxy_to_z(bbox_xyxy)
        KalmanBoxTracker._count += 1
        self.id = KalmanBoxTracker._count
        self.time_since_update = 0
        self.hits = 0
        self.hit_streak = 0
        self.age = 0

    def predict(self):
        if self.x[6] + self.x[2] <= 0:  # scale would go negative
            self.x[6] *= 0.0
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q
        self.age += 1
        if self.time_since_update > 0:
            self.hit_streak = 0
        self.time_since_update += 1
        return _z_to_xyxy(self.x[:4])

    def update(self, bbox_xyxy):
        self.time_since_update = 0
        self.hits += 1
        self.hit_streak += 1
        z = _xyxy_to_z(bbox_xyxy)
        y = z - self.H @ self.x
        S = self.H @ self.P @ self.H.T + self.R
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.x = self.x + K @ y
        self.P = (np.eye(7) - K @ self.H) @ self.P

    def get_state(self):
        return _z_to_xyxy(self.x[:4])


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of (N,4) and (M,4) xyxy boxes."""
    a = a[:, None, :]
    b = b[None, :, :]
    xx1 = np.maximum(a[..., 0], b[..., 0])
    yy1 = np.maximum(a[..., 1], b[..., 1])
    xx2 = np.minimum(a[..., 2], b[..., 2])
    yy2 = np.minimum(a[..., 3], b[..., 3])
    inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / np.clip(area_a + area_b - inter, 1e-9, None)


class Sort:
    """SORT multi-object tracker (Bewley et al. 2016 algorithm).

    reconfirm=True is the published behaviour: after ANY missed frame the
    hit_streak resets and a track must re-earn min_hits consecutive
    detections before being emitted again — so a single m-frame occlusion
    leaves an (m + min_hits - 2 + 2)-frame hole. reconfirm=False keeps a
    once-confirmed track (total hits >= min_hits) emitting immediately on
    re-detection, so an m-frame occlusion leaves exactly an (m+1)-id gap,
    which smooth_tracking then bridges."""

    def __init__(self, max_age: int = 1, min_hits: int = 3,
                 iou_threshold: float = 0.3, reconfirm: bool = True):
        self.max_age = max_age
        self.min_hits = min_hits
        self.iou_threshold = iou_threshold
        self.reconfirm = reconfirm
        self.trackers: list[KalmanBoxTracker] = []
        self.frame_count = 0

    def update(self, dets: np.ndarray) -> np.ndarray:
        """dets: (N, 4|5) xyxy[+score]. Returns (M, 5) [x1,y1,x2,y2,id]."""
        self.frame_count += 1
        dets = np.asarray(dets, np.float64)
        dets = dets.reshape(-1, dets.shape[-1] if dets.size else 5)

        preds = np.array([t.predict() for t in self.trackers]).reshape(-1, 4)
        matched, unmatched_dets = [], list(range(len(dets)))
        if len(preds) and len(dets):
            iou = iou_matrix(dets[:, :4], preds)
            from scipy.optimize import linear_sum_assignment

            rows, cols = linear_sum_assignment(-iou)
            unmatched_dets = [d for d in range(len(dets)) if d not in rows]
            for r, c in zip(rows, cols):
                if iou[r, c] < self.iou_threshold:
                    unmatched_dets.append(r)
                else:
                    matched.append((r, c))

        for r, c in matched:
            self.trackers[c].update(dets[r, :4])
        for d in unmatched_dets:
            self.trackers.append(KalmanBoxTracker(dets[d, :4]))

        out = []
        for t in list(self.trackers):
            confirmed = (t.hit_streak >= self.min_hits
                         or self.frame_count <= self.min_hits)
            if not self.reconfirm:
                confirmed = confirmed or t.hits >= self.min_hits
            if t.time_since_update < 1 and confirmed:
                out.append(np.concatenate([t.get_state(), [t.id]]))
            if t.time_since_update > self.max_age:
                self.trackers.remove(t)
        return np.array(out).reshape(-1, 5)


# ---------------------------------------------------------------------------
# Video-level tracking driver
# ---------------------------------------------------------------------------

def xyxy_to_cxcywh_square(bb: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """xyxy -> square [cx, cy, side, side]."""
    cx = (bb[0] + bb[2]) / 2.0
    cy = (bb[1] + bb[3]) / 2.0
    side = max(bb[2] - bb[0], bb[3] - bb[1]) * scale
    return np.array([cx, cy, side, side], np.float32)


def track_video(
    detections: Iterable[np.ndarray],
    max_age: int = 1,
    min_hits: int = 3,
    iou_threshold: float = 0.3,
    bbox_scale: float = 1.0,
    reconfirm: bool = True,
) -> dict:
    """Per-frame detections -> tracking dict (multi_person_tracker's
    output_format='dict').

    detections: iterable over frames of (N_i, 4|5) xyxy[+score] arrays.
    Returns {person_id: {'bbox': (N,4) square cxcywh, 'frames': (N,) int}}.
    """
    sort = Sort(max_age=max_age, min_hits=min_hits,
                iou_threshold=iou_threshold, reconfirm=reconfirm)
    acc: dict[int, dict] = {}
    for frame_idx, dets in enumerate(detections):
        dets = np.asarray(dets, np.float64)
        dets = dets.reshape(-1, dets.shape[-1] if dets.size else 5)
        tracks = sort.update(dets)
        for row in tracks:
            pid = int(row[4])
            entry = acc.setdefault(pid, {"bbox": [], "frames": []})
            entry["bbox"].append(xyxy_to_cxcywh_square(row[:4], bbox_scale))
            entry["frames"].append(frame_idx)
    return {
        pid: {"bbox": np.array(v["bbox"], np.float32),
              "frames": np.array(v["frames"], np.int64)}
        for pid, v in acc.items()
    }


# ---------------------------------------------------------------------------
# Gap interpolation / segment splitting (the reference's smooth_tracking)
# ---------------------------------------------------------------------------

def smooth_tracking(tracking_results: dict, interv: int = 5,
                    min_num_frames: int = MIN_NUM_FRAMES):
    """Split tracks at large frame gaps, keeping segments longer than
    `min_num_frames`; behaviour matches demo_utils.py:249-297:

      * gaps of 2..interv-1 frames are left in place (the segment simply
        carries non-contiguous frame ids — the reference never interpolates
        small gaps despite its docstring);
      * a gap > interv-1 flushes the segment if it is long enough,
        otherwise the gap is linearly interpolated (frame ids and bboxes)
        and the segment continues across it;
      * the final frame joins the segment only when contiguous with its
        predecessor; the end of a track forces a flush decision;
      * a gap immediately after frame id 0 is absorbed silently (the
        reference guards with `prev_frame and ...`, demo_utils.py:265,
        which is falsy for frame 0 — kept for parity).

    Deviations from the reference (latent defects not replicated): no
    phantom frame ids beyond a track's real range are added to the returned
    frame list, and interpolated entries carry real frame ids rather than
    being reused as array indices (demo_utils.py:286-288 conflates the two).

    Returns (results {new_id: {'frames', 'bbox'}}, sorted frame-id list).
    """
    if any("joints2d" in r for r in tracking_results.values()):
        raise ValueError("tracklets with joints2d are not supported")
    num_frames: set[int] = set()
    results: dict[int, dict] = {}
    p_id = 0
    for result in tracking_results.values():
        frames = np.asarray(result["frames"])
        bboxes = np.asarray(result["bbox"], np.float32)
        assert frames.shape[0] == bboxes.shape[0]
        n = frames.shape[0]

        seg_frames: list[int] = []
        seg_bbox: list[np.ndarray] = []

        def flush():
            nonlocal p_id, seg_frames, seg_bbox
            if len(seg_frames) > min_num_frames:
                results[p_id] = {
                    "frames": np.asarray(seg_frames, frames.dtype),
                    "bbox": np.asarray(seg_bbox, np.float32),
                }
                p_id += 1
            seg_frames, seg_bbox = [], []

        def interpolate(prev_bbox, bbox, prev_frame, frame):
            n_interp = frame - prev_frame - 1
            ids = np.linspace(prev_frame, frame,
                              n_interp + 2).astype(np.int64).tolist()[1:-1]
            interp = np.stack(
                [np.linspace(p, c, n_interp + 2)
                 for p, c in zip(prev_bbox, bbox)]).T[1:-1]
            seg_frames.extend(ids)
            num_frames.update(ids)
            seg_bbox.extend(np.asarray(interp, np.float32))

        prev: Optional[int] = None
        for idx, (frame, bbox) in enumerate(zip(frames.tolist(), bboxes)):
            frame = int(frame)
            num_frames.add(frame)
            last = idx == n - 1
            if (prev and frame - prev > 1) or last:
                appended = False
                if last and prev is not None and frame - prev == 1:
                    seg_frames.append(frame)
                    seg_bbox.append(np.asarray(bbox, np.float32))
                    appended = True
                eff = frame + interv + 10 if last else frame
                if prev is not None and eff - prev > interv - 1:
                    if len(seg_frames) > min_num_frames:
                        flush()
                    elif not last:
                        interpolate(seg_bbox[-1], bbox, prev, frame)
                    else:
                        seg_frames, seg_bbox = [], []
                if last:
                    break  # trailing non-contiguous frame is dropped (ref)
                if appended:
                    continue
            seg_frames.append(frame)
            seg_bbox.append(np.asarray(bbox, np.float32))
            prev = frame
    return results, sorted(num_frames)
