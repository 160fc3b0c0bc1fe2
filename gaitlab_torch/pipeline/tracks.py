"""Tracklet splitting at large frame gaps (the reference's smooth_tracking).

Counterpart of the `smooth_tracking` half of gaitlab/pipeline/tracks.py;
detection and SORT are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

MIN_NUM_FRAMES = 25


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
