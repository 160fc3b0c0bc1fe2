"""One-pass video pipeline: decode -> detect -> track -> crop -> model,
with a single read of the video.

Counterpart of gaitlab/pipeline/stream.py. SORT is causal, so detection,
tracking, cropping and the bucketed forward run in one pass: each decoded
chunk is detected, the tracks are updated frame by frame, each track's
224-crops (cv2 on the host) wait until the track has MIN_NUM_FRAMES
frames, and from then on they feed a GRNetRunner.open_stream() session,
whose forwards run on the card while the host decodes the next chunk.

Gaps: SORT at max_age = 3 with reconfirm=False reproduces the segments of
the two-pass flow's smooth_tracking (interv 5): a track survives up to 3
missed frames, so one id spans gaps of at most 4 frame ids, and a longer
occlusion starts a new id. Differences from the two-pass flow, as in
gaitlab: a long gap in a still-short segment splits it instead of being
interpolated (frames already decoded cannot be cropped again), and the
median-background detector, when not fitted beforehand, is fitted on the
first FIT_FRAMES decoded frames.

gaitlab's operating point is fixed here (its knobs chunk, min_frames,
fit_frames and SORT's max_age / min_hits / iou_threshold, which no caller
sets, are module constants).
"""

from __future__ import annotations

import contextlib

import numpy as np

from gaitlab_torch.pipeline import tracks as tracks_mod
from gaitlab_torch.pipeline import video as video_mod
from gaitlab_torch.pipeline.runner import GRNetRunner, track_outputs
from gaitlab_torch.pipeline.tracks import MIN_NUM_FRAMES, xyxy_to_cxcywh_square

CHUNK = 32        # frames decoded at once
FIT_FRAMES = 64   # head frames the median background is fitted on
SORT_MAX_AGE, SORT_MIN_HITS, SORT_IOU = 3, 3, 0.3


class _TrackState:
    """One person: crops buffered until the track qualifies, then a live
    ForwardStream session."""

    __slots__ = ("frames", "bboxes", "crop_buf", "session")

    def __init__(self):
        self.frames: list[int] = []
        self.bboxes: list[np.ndarray] = []
        self.crop_buf: list[np.ndarray] = []  # uint8 (224,224,3) host crops
        self.session = None


def run_video_onepass(runner: GRNetRunner, vid_file: str, detector=None,
                      timer=None) -> dict:
    """Single-decode video -> per-track model outputs.

    Returns {person_id: run_track-style output dict + 'frames' (N,) int +
    'bboxes' (N,4) cxcywh}. Tracks shorter than MIN_NUM_FRAMES are dropped.
    `timer`, any object whose `.stage(name)` is a context manager, gets the
    host stages decode / detect / sort / crop / feed / finish."""
    def stage(name):
        return (timer.stage(name) if timer is not None
                else contextlib.nullcontext())

    if detector is None:
        from gaitlab_torch.pipeline.detect import MedianBackgroundDetector

        detector = MedianBackgroundDetector()

    reader = video_mod.VideoChunkReader(vid_file, chunk=CHUNK,
                                        reuse_buffers=True)
    h, w = reader.image_hw
    gait = runner.model.module.use_gait_feat
    cimg_row = np.array([w * 0.5, h * 0.5], np.float32)
    # reconfirm=False: a confirmed track emits again right after an
    # occlusion, so an m <= max_age miss leaves an (m+1)-id gap
    sort = tracks_mod.Sort(max_age=SORT_MAX_AGE, min_hits=SORT_MIN_HITS,
                           iou_threshold=SORT_IOU, reconfirm=False)
    states: dict[int, _TrackState] = {}
    frame_base = 0
    fit_buf: list[np.ndarray] = []
    fitted = getattr(detector, "background", None) is not None

    def open_or_feed(st: _TrackState):
        """Once a track has MIN_NUM_FRAMES, open its session and feed it
        all buffered crops; from then on feed as crops come."""
        if st.session is None:
            if len(st.frames) < MIN_NUM_FRAMES:
                return
            st.session = runner.open_stream()
        if st.crop_buf:
            n = len(st.crop_buf)
            bb = ci = None
            if gait:
                bb = np.asarray(st.bboxes[-n:], np.float32)
                ci = np.broadcast_to(cimg_row, (n, 2))
            st.session.feed(np.stack(st.crop_buf), bbox=bb, cimg=ci)
            st.crop_buf = []

    def process(frames: np.ndarray):
        nonlocal frame_base
        with stage("detect"):
            dets_per_frame = detector(frames)
        for i, dets in enumerate(dets_per_frame):
            with stage("sort"):
                rows = sort.update(dets)
            for row in rows:
                st = states.setdefault(int(row[4]), _TrackState())
                # the square is stored unscaled; runner.bbox_scale is
                # applied once, at crop time, as in run_track
                bb = xyxy_to_cxcywh_square(row[:4], 1.0)
                st.frames.append(frame_base + i)
                st.bboxes.append(bb)
                with stage("crop"):
                    st.crop_buf.append(runner._host_crop(
                        frames[i:i + 1], bb[None], runner.bbox_scale)[0])
        # one flush per decoded chunk: feed() gathers up to a bucket anyway
        with stage("feed"):
            for st in states.values():
                open_or_feed(st)
        frame_base += len(frames)

    frames_iter = iter(reader)
    while True:
        with stage("decode"):
            frames = next(frames_iter, None)
        if frames is None:
            break
        if not fitted and hasattr(detector, "fit"):
            fit_buf.append(np.array(frames))  # ring views: copy
            if sum(len(c) for c in fit_buf) >= FIT_FRAMES:
                head = np.concatenate(fit_buf)
                with stage("detect"):
                    detector.fit(head)
                fitted, fit_buf = True, []
                process(head)
            continue
        process(frames)
    if fit_buf:  # a clip shorter than FIT_FRAMES: fit on what there is
        head = np.concatenate(fit_buf)
        with stage("detect"):
            detector.fit(head)
        process(head)

    results = {}
    for pid, st in states.items():
        if st.session is None:
            continue  # never reached MIN_NUM_FRAMES
        open_or_feed(st)
        with stage("finish"):
            out = st.session.finish()
        result = track_outputs(out)
        result["frames"] = np.asarray(st.frames, np.int64)
        result["bboxes"] = np.asarray(st.bboxes, np.float32)
        results[pid] = result
    return results
