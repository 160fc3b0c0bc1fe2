"""Detection-free tracking, the median-background detector, the video
readers and the demo's tracking front end against gaitlab's, on the CPU.

All of it is host numpy / cv2 in both packages, so the results must be
identical: SORT and smooth_tracking bit for bit on the same detection
streams, the detector's boxes, the readers' frames, and the tracks that
`run_tracking` builds from a frame folder or straight from the video.
KalmanBoxTracker numbers tracks with a class-wide counter, so both sides
reset it before each run.
"""

import os
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

from gaitlab.cli import demo as jax_demo
from gaitlab.pipeline import detect as jax_detect
from gaitlab.pipeline import tracks as jax_tracks
from gaitlab.pipeline import video as jax_video
from gaitlab_torch.cli import demo as pt_demo
from gaitlab_torch.pipeline import detect as pt_detect
from gaitlab_torch.pipeline import tracks as pt_tracks
from gaitlab_torch.pipeline import video as pt_video
from gaitlab_torch.pipeline.runner import GRNetRunner


def walkers(n=40, occluded=(), blank=(), seed=0):
    """Two walkers crossing (xyxy + score per frame, jittered); walker a
    is missing on `occluded` frames, nobody is detected on `blank`."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        dets = []
        if i not in blank:
            if i not in occluded:
                dets.append([20 + 5 * i, 50, 60 + 5 * i, 150, 0.9])
            dets.append([260 - 5 * i, 60, 300 - 5 * i, 165, 0.8])
        d = np.array(dets, np.float32).reshape(-1, 5)
        d[:, :4] += rng.normal(scale=1.5, size=d[:, :4].shape)
        out.append(d)
    return out


def run_both(fn_name, stream, **kw):
    jax_tracks.KalmanBoxTracker._count = 0
    want = getattr(jax_tracks, fn_name)(stream, **kw)
    pt_tracks.KalmanBoxTracker._count = 0
    got = getattr(pt_tracks, fn_name)(stream, **kw)
    return got, want


def assert_same_tracks(got: dict, want: dict):
    assert list(got) == list(want)
    for pid in want:
        assert set(got[pid]) == set(want[pid])
        for k in want[pid]:
            assert got[pid][k].dtype == want[pid][k].dtype, (pid, k)
            np.testing.assert_array_equal(got[pid][k], want[pid][k])


@pytest.mark.parametrize("reconfirm", [True, False])
@pytest.mark.parametrize("occlusion", [0, 1, 2, 3])
def test_sort_matches_gaitlab(reconfirm, occlusion):
    """Crossing walkers, walker a occluded for `occlusion` frames from frame
    12, and two frames without any detection."""
    stream = walkers(occluded=range(12, 12 + occlusion), blank=(30, 31))
    got, want = run_both("track_video", stream, reconfirm=reconfirm)
    assert len(want) >= 2
    assert_same_tracks(got, want)
    got_s, want_s = pt_tracks.smooth_tracking(got), jax_tracks.smooth_tracking(
        want)
    assert got_s[1] == want_s[1]
    assert_same_tracks(got_s[0], want_s[0])


def test_sort_update_and_helpers_match_gaitlab():
    bb = np.array([10.0, 20.0, 50.0, 120.0])
    np.testing.assert_array_equal(pt_tracks._xyxy_to_z(bb),
                                  jax_tracks._xyxy_to_z(bb))
    z = jax_tracks._xyxy_to_z(bb)
    np.testing.assert_array_equal(pt_tracks._z_to_xyxy(z),
                                  jax_tracks._z_to_xyxy(z))
    np.testing.assert_array_equal(
        pt_tracks.xyxy_to_cxcywh_square(bb, 1.1),
        jax_tracks.xyxy_to_cxcywh_square(bb, 1.1))
    a = np.random.default_rng(1).uniform(0, 100, (5, 4))
    a[:, 2:] += a[:, :2]
    np.testing.assert_array_equal(pt_tracks.iou_matrix(a, a[:3]),
                                  jax_tracks.iou_matrix(a, a[:3]))
    jax_tracks.KalmanBoxTracker._count = pt_tracks.KalmanBoxTracker._count = 0
    js, ps = jax_tracks.Sort(max_age=2, min_hits=2), pt_tracks.Sort(
        max_age=2, min_hits=2)
    for d in walkers(n=15, occluded=(5, 6)):
        np.testing.assert_array_equal(ps.update(d), js.update(d))


def synthetic_frames(n=30, h=120, w=160, seed=2):
    rng = np.random.default_rng(seed)
    bg = rng.integers(40, 70, size=(h, w, 3)).astype(np.uint8)
    frames = np.repeat(bg[None], n, axis=0)
    for i in range(n):
        x = w // 16 + (w // 2) * i // n
        cv2.rectangle(frames[i], (x, h // 6), (x + w // 8, h - h // 6),
                      (210, 190, 180), -1)
    return frames


@pytest.mark.parametrize("h,w", [(120, 160), (480, 400)])
def test_median_background_detector_matches_gaitlab(h, w):
    """(480, 400) exceeds max_pixels: detection runs subsampled and maps
    the boxes back."""
    frames = synthetic_frames(h=h, w=w)
    want = jax_detect.MedianBackgroundDetector().fit(frames[::2])(frames)
    got = pt_detect.MedianBackgroundDetector().fit(frames[::2])(frames)
    assert sum(len(b) for b in want) >= len(frames) - 2
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g, wnt)
    one_shot = pt_detect.MedianBackgroundDetector()
    for g, wnt in zip(one_shot(frames),
                      jax_detect.MedianBackgroundDetector()(frames)):
        np.testing.assert_array_equal(g, wnt)
    assert one_shot.background is None


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 20 fps clip of 130 frames (> two chunks of 64) with one walker,
    and the same frames as a PNG folder."""
    d = tmp_path_factory.mktemp("torch_tracking")
    vid = str(d / "tracking_walk.mp4")
    rng = np.random.default_rng(7)
    bg = rng.integers(40, 70, size=(120, 240, 3)).astype(np.uint8)
    writer = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 20.0,
                             (240, 120))
    for i in range(130):
        frame = bg.copy()
        cv2.rectangle(frame, (10 + i, 20), (40 + i, 100), (210, 190, 180), -1)
        writer.write(frame)
    writer.release()
    folder = pt_video.video_to_images(vid, str(d / "frames"))
    return vid, folder


@pytest.mark.parametrize("frame_ids,chunk", [(None, 64), (None, 7),
                                             ([0, 0, 3, 4, 4, 4, 70, 129], 3)])
@pytest.mark.parametrize("reuse", [False, True])
def test_video_chunk_reader_matches_gaitlab(clip, frame_ids, chunk, reuse):
    vid, _ = clip

    def frames(mod):
        r = mod.VideoChunkReader(vid, frame_ids=frame_ids, chunk=chunk,
                                 reuse_buffers=reuse)
        chunks = [np.array(c) for c in r]  # copies: views are rewritten
        assert len(chunks) == len(r)
        assert all(len(c) == chunk for c in chunks[:-1])
        return r, np.concatenate(chunks)

    (pr, got), (jr, want) = frames(pt_video), frames(jax_video)
    assert pr.image_hw == jr.image_hw == (120, 240)
    assert len(got) == (130 if frame_ids is None else len(frame_ids))
    np.testing.assert_array_equal(got, want)


def test_video_reader_contracts(clip):
    vid, _ = clip
    with pytest.raises(ValueError, match="sorted"):
        pt_video.VideoChunkReader(vid, frame_ids=[3, 1])
    for fps in (None, 10.0, 30.0):
        got = np.stack(list(pt_video.read_frames(vid, fps=fps)))
        want = np.stack(list(jax_video.read_frames(vid, fps=fps)))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pt_video._fps_resample_indices(100, 30, 20),
                                  jax_video._fps_resample_indices(100, 30, 20))


@pytest.mark.parametrize("crop_on", ["device", "host"])
def test_runner_crops_from_a_video_reader(clip, crop_on):
    """A track read through a ring-buffer reader crops as the same frames
    from memory do: each chunk is taken before the next is pulled."""
    vid, _ = clip
    ids = np.arange(3, 120, 2)
    frames = np.stack(list(pt_video.read_frames(vid)))[ids]
    bboxes = np.stack([25.0 + ids, np.full(len(ids), 60.0),
                       np.full(len(ids), 90.0), np.full(len(ids), 90.0)], 1)
    runner = GRNetRunner(SimpleNamespace(device=torch.device("cpu")),
                         crop_on=crop_on, ingest_chunk=16)
    reader = pt_video.VideoChunkReader(vid, frame_ids=ids, chunk=16,
                                       reuse_buffers=True)
    got = runner.crop_track(reader, bboxes)
    want = runner.crop_track(frames, bboxes)
    assert got.shape == (len(ids), 224, 224, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def tracking_args(mod, *extra):
    return mod.build_parser().parse_args(
        ["--vid_file", "unused.mp4", "--detector", "median_bg", *extra])


def test_folder_tracking_is_chunked_and_matches_gaitlab(clip, monkeypatch):
    """The folder path loads at most 64 frames at a time, never the whole
    clip, and gives gaitlab's tracks."""
    _, folder = clip
    max_loaded = {"n": 0}
    orig = pt_video.load_frames

    def counting(paths, **kw):
        max_loaded["n"] = max(max_loaded["n"], len(list(paths)))
        return orig(paths, **kw)

    monkeypatch.setattr(pt_video, "load_frames", counting)
    got = pt_demo.run_tracking(tracking_args(pt_demo, "--img_folder", folder),
                               folder, device="cpu")
    assert max_loaded["n"] <= 64
    want = jax_demo.run_tracking(tracking_args(jax_demo, "--img_folder",
                                               folder), folder)
    assert got[1] == want[1]
    assert_same_tracks(got[0], want[0])
    frames = got[0][0]["frames"]
    assert len(got[0]) == 1 and len(frames) >= 100
    assert np.all(np.diff(frames) >= 1)


def test_stream_tracking_matches_gaitlab(clip):
    vid, _ = clip
    got = pt_demo.run_tracking(tracking_args(pt_demo, "--stream"), None,
                               video_file=vid, device="cpu")
    want = jax_demo.run_tracking(tracking_args(jax_demo, "--stream"), None,
                                 video_file=vid)
    assert got[1] == want[1]
    assert_same_tracks(got[0], want[0])
    assert len(got[0]) >= 1


def test_precomputed_tracklets(clip, tmp_path):
    import pickle

    track = {"frames": np.arange(40), "bbox": np.tile([50.0, 60, 90, 90],
                                                      (40, 1))}
    path = str(tmp_path / "t.pkl")
    with open(path, "wb") as f:
        pickle.dump(track, f)  # a single track: wrapped as person 0
    args = pt_demo.build_parser().parse_args(["--tracking_path", path])
    res, frames = pt_demo.run_tracking(args, None)
    assert list(res) == [0] and frames == list(range(40))
    args.tracking_path = os.path.join(str(tmp_path), "missing.pkl")
    with pytest.raises(FileNotFoundError):
        pt_demo.run_tracking(args, None)
