"""gaitlab_torch's ForwardStream and one-pass pipeline against gaitlab's.

- ForwardStream: ragged feeds crossing bucket boundaries give what one
  forward_crops call gives (with and without the gait branch, whose rows
  come with each feed); an empty session finishes with {}; an error of a
  forward on the worker thread raises at a later feed or at finish.
- run_video_onepass on a synthetic clip of two walkers: the same persons,
  frame ids and boxes as gaitlab's, model outputs within
  test_torch_models' tolerances, and (port alone) the outputs run_track
  gives on the same frames and boxes with host crops.
- demo --onepass against gaitlab's at pkl level, and --onepass ignored
  with --tracking_path, as in gaitlab.
- The one-pass operating point (gaitlab's defaults, the port's constants),
  device.upload / device.constant on the CPU, and float32_math's flags
  across threads.

Both packages get the same small models (tests/test_torch_gait.gait_pair,
tests/test_torch_models.tiny_pair) and run on the CPU in float32.
"""

import os

import cv2
import joblib
import numpy as np
import pytest
import torch

from gaitlab.body import smpl as jax_smpl
from gaitlab.cli import demo as jax_demo
from gaitlab.nn.grnet import GRNet as JaxGRNet
from gaitlab.pipeline import stream as jax_stream
from gaitlab.pipeline.runner import GRNetRunner as JaxRunner
from gaitlab_torch.cli import demo as pt_demo
from gaitlab_torch.pipeline import stream as pt_stream
from gaitlab_torch.pipeline.runner import GRNetRunner as PtRunner
from test_torch_gait import gait_pair
from test_torch_models import assert_close, tiny_pair
from torch_threads import torch_threads  # noqa: F401

N_FRAMES = 40
PKL_KEYS = ("pred_cam", "orig_cam", "verts", "pose", "betas", "joints3d",
            "joints2d", "bboxes", "frame_ids")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """320x240, N_FRAMES frames: walker 0 goes right in the upper band,
    walker 1 left in the lower band."""
    d = tmp_path_factory.mktemp("torch_stream")
    vid = str(d / "stream_walk.mp4")
    rng = np.random.default_rng(0)
    bg = rng.integers(40, 70, size=(240, 320, 3)).astype(np.uint8)
    writer = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 20.0,
                             (320, 240))
    for i in range(N_FRAMES):
        frame = bg.copy()
        cv2.rectangle(frame, (20 + 5 * i, 10), (50 + 5 * i, 105),
                      (210, 190, 180), -1)
        cv2.rectangle(frame, (270 - 5 * i, 130), (300 - 5 * i, 230),
                      (150, 200, 160), -1)
        writer.write(frame)
    writer.release()
    return d, vid


@pytest.fixture(scope="module")
def models():
    """{'plain': (gaitlab GRNet, port GRNet), 'gait': ...}"""
    out = {}
    for kind, (module, variables, port) in (("plain", tiny_pair(seed=8)),
                                            ("gait", gait_pair(seed=8))):
        out[kind] = (JaxGRNet(module=module, variables=variables,
                              smpl=jax_smpl.synthetic_smpl_params()), port)
    return out


def test_onepass_operating_point_matches_gaitlab():
    """The port fixes as constants what gaitlab's run_video_onepass takes
    as defaults that no caller changes."""
    import inspect

    from gaitlab.pipeline.tracks import MIN_NUM_FRAMES

    defaults = {k: p.default for k, p in inspect.signature(
        jax_stream.run_video_onepass).parameters.items()}
    assert (defaults["chunk"], defaults["fit_frames"], defaults["max_age"],
            defaults["min_hits"], defaults["iou_threshold"]) == (
        pt_stream.CHUNK, pt_stream.FIT_FRAMES, pt_stream.SORT_MAX_AGE,
        pt_stream.SORT_MIN_HITS, pt_stream.SORT_IOU)
    assert defaults["min_frames"] == MIN_NUM_FRAMES == pt_stream.MIN_NUM_FRAMES
    assert list(inspect.signature(pt_stream.run_video_onepass).parameters) \
        == ["runner", "vid_file", "detector", "timer"]


def test_upload_and_constant_on_the_cpu():
    """device.upload on the CPU: the array's values, float or uint8, and a
    tensor passes through. device.constant: made once per device, and an
    ordinary tensor even when first asked for in inference mode."""
    from gaitlab_torch.device import constant, upload

    cpu = torch.device("cpu")
    with torch.inference_mode():
        c = constant((4, 5, 7), "int64", cpu)
    assert c is constant((4, 5, 7), "int64", cpu)
    assert c.dtype == torch.int64 and c.tolist() == [4, 5, 7]
    assert not c.is_inference()

    for a in (np.arange(12, dtype=np.float32).reshape(3, 4),
              np.broadcast_to(np.float32([1.0, 2.0]), (5, 2)),
              np.arange(24, dtype=np.uint8).reshape(2, 4, 3)[:, ::2]):
        t = upload(a, "cpu")
        assert t.device.type == "cpu" and t.dtype == torch.from_numpy(
            np.ascontiguousarray(a)).dtype
        np.testing.assert_array_equal(t.numpy(), a)
    x = torch.ones(2)
    assert upload(x, "cpu") is x


def test_float32_math_restores_flags_after_the_last_thread():
    """The TF32 flags are process-wide: a thread leaving float32_math while
    another (a ForwardStream worker) is inside leaves them off."""
    import threading

    from gaitlab_torch.device import float32_math

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        inside, release = threading.Event(), threading.Event()

        def hold():
            with float32_math():
                inside.set()
                release.wait(10)

        worker = threading.Thread(target=hold)
        worker.start()
        assert inside.wait(10)
        with float32_math():
            assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        release.set()
        worker.join(10)
        assert torch.backends.cudnn.allow_tf32
    finally:
        release.set()
        torch.backends.cudnn.allow_tf32 = prev


def _crops(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, 64, 64, 3)).astype(np.float32))


@pytest.mark.parametrize("kind", ["plain", "gait"])
def test_forward_stream_matches_forward_crops(models, kind):
    runner = PtRunner(models[kind][1], buckets=(4, 8), crop_size=64)
    crops = _crops(13)
    rng = np.random.default_rng(1)
    bbox = np.column_stack([rng.uniform(20, 40, (13, 2)),
                            np.full((13, 2), 50.0)]).astype(np.float32)
    cimg = np.tile(np.float32([32.0, 32.0]), (13, 1))
    gait = kind == "gait"
    whole = runner.forward_crops(crops, bbox=bbox if gait else None,
                                 cimg=cimg if gait else None)
    session = runner.open_stream()
    for s, e in ((0, 3), (3, 4), (4, 11), (11, 13)):  # ragged feeds
        session.feed(crops[s:e], bbox=bbox[s:e] if gait else None,
                     cimg=cimg[s:e] if gait else None)
    fed = session.finish()
    assert set(fed) == set(whole)
    assert ({"pred_avg", "pred_phase"} <= set(fed)) == gait
    assert fed["theta"].shape == (13, 85)
    for k in whole:
        np.testing.assert_allclose(fed[k], whole[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_forward_stream_empty_and_closed(models):
    runner = PtRunner(models["plain"][1], buckets=(8,), crop_size=64)
    session = runner.open_stream()
    assert session.finish() == {}
    with pytest.raises(RuntimeError, match="after finish"):
        session.feed(_crops(1))
    with pytest.raises(RuntimeError, match="twice"):
        session.finish()


def test_forward_stream_error_surfaces(models, monkeypatch):
    """An error of a forward on the session's worker thread raises at the
    next feed() or at the latest at finish(), as in gaitlab, not never;
    the forwards after it do not run."""
    runner = PtRunner(models["plain"][1], buckets=(8,), crop_size=64)
    calls = []

    def boom(crops, **kw):
        calls.append(len(crops))
        raise RuntimeError("forward boom")

    monkeypatch.setattr(runner, "_forward_bucket", boom)
    session = runner.open_stream()
    session.feed(_crops(5))  # not a full bucket yet: nothing launched
    with pytest.raises(RuntimeError, match="forward boom"):
        session.feed(_crops(5))  # fills a bucket: its forward fails
        session.feed(_crops(8))  # the error raises here...
        session.finish()         # ...or at the latest here
    assert calls == [8]
    session = runner.open_stream()
    session.feed(_crops(5))
    with pytest.raises(RuntimeError, match="forward boom"):
        session.finish()


def _outputs_close(got: dict, want: dict, what: str):
    for k in ("pred_cam", "betas", "verts", "joints3d", "joints2d"):
        assert_close(got[k], want[k], rtol=1e-4, atol=2e-5, what=f"{what} {k}")
    for k in ("pred_avg", "pred_phase"):
        if k in want:
            assert_close(got[k], want[k], what=f"{what} {k}")


@pytest.mark.parametrize("kind", ["plain", "gait"])
def test_onepass_matches_gaitlab(clip, models, kind):
    _, vid = clip
    jax_model, port = models[kind]
    got = pt_stream.run_video_onepass(
        PtRunner(port, buckets=(16,), crop_size=64), vid)
    want = jax_stream.run_video_onepass(
        JaxRunner(jax_model, buckets=(16,), precision="float32",
                  crop_size=64), vid)
    # SORT numbers tracks with a process-wide counter in each package:
    # persons are compared in the order they were found
    assert len(got) == len(want) == 2
    for pid, g, w in zip(want, got.values(), want.values()):
        assert set(g) == set(w)
        np.testing.assert_array_equal(g["frames"], w["frames"])
        np.testing.assert_array_equal(g["bboxes"], w["bboxes"])
        assert len(g["frames"]) >= 25
        _outputs_close(g, w, f"person {pid}")


class _Timer:
    def __init__(self):
        self.names = []

    def stage(self, name):
        import contextlib

        self.names.append(name)
        return contextlib.nullcontext()


def test_onepass_matches_run_track(clip, models):
    """One pass gives what run_track gives on the same frames and boxes
    (host crops in both), the gait rows fed chunk by chunk included."""
    _, vid = clip
    runner = PtRunner(models["gait"][1], buckets=(16,), crop_size=64,
                      crop_on="host")
    timer = _Timer()
    one = pt_stream.run_video_onepass(runner, vid, timer=timer)
    assert {"decode", "detect", "sort", "crop", "feed",
            "finish"} <= set(timer.names)
    frames = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2RGB) for f in
                       _decode(vid)])
    for pid, res in one.items():
        ref = runner.run_track(frames[res["frames"]], res["bboxes"])
        assert set(ref) == set(res) - {"frames", "bboxes"}
        for k in ref:
            np.testing.assert_allclose(res[k], ref[k], rtol=0, atol=1e-5,
                                       err_msg=f"{pid} {k}")


def _decode(vid):
    cap = cv2.VideoCapture(vid)
    while True:
        ok, f = cap.read()
        if not ok:
            break
        yield f
    cap.release()


def _run_demo(mod, model, vid, out, monkeypatch, *extra):
    monkeypatch.setattr(mod, "load_model", lambda args, cfg: model)
    monkeypatch.setenv("GAITLAB_BUCKETS", "24")
    args = mod.build_parser().parse_args(
        ["--vid_file", vid, "--detector", "median_bg", "--output_folder",
         out, "--save_vid", "--cpu_only", "--precision", "float32",
         "--joint_type", "kinectv2", *extra])
    mod.main(args)
    return joblib.load(os.path.join(out, "stream_walk_mp4", "grnet.pkl"))


def test_demo_onepass_matches_gaitlab(clip, models, monkeypatch):
    d, vid = clip
    jax_model, port = models["plain"]
    got = _run_demo(pt_demo, port, vid, str(d / "pt_onepass"), monkeypatch,
                    "--onepass")
    want = _run_demo(jax_demo, jax_model, vid, str(d / "jax_onepass"),
                     monkeypatch, "--onepass")
    assert len(got) == len(want) == 2  # SORT ids: see above
    for pid, g, w in zip(want, got.values(), want.values()):
        assert set(g) == set(w) == set(PKL_KEYS)
        np.testing.assert_array_equal(g["frame_ids"], w["frame_ids"])
        np.testing.assert_array_equal(g["bboxes"], w["bboxes"])
        assert g["joints3d"].shape == (len(g["frame_ids"]), 25, 3)
        for k in ("pred_cam", "betas", "verts", "joints3d"):
            assert_close(g[k], w[k], rtol=1e-4, atol=2e-5, what=f"{pid} {k}")
        for k in ("orig_cam", "joints2d"):
            assert_close(g[k], w[k], rtol=1e-4, atol=1e-3, what=f"{pid} {k}")


def test_demo_onepass_ignored_with_tracking_path(clip, models, monkeypatch):
    """--onepass with --tracking_path runs the tracklets' path, as in
    gaitlab: the same pkl as without --onepass."""
    d, vid = clip
    port = models["plain"][1]
    fr = np.arange(26)  # one more than MIN_NUM_FRAMES
    trackfile = str(d / "tracks.pkl")
    joblib.dump({0: {"frames": fr, "bbox": np.stack(
        [35 + 5.0 * fr, np.full(26, 57.0), np.full(26, 100.0),
         np.full(26, 100.0)], 1)}}, trackfile)
    runs = [_run_demo(pt_demo, port, vid, str(d / f"tracked_{i}"),
                      monkeypatch, "--tracking_path", trackfile, *extra)
            for i, extra in enumerate(((), ("--onepass",)))]
    assert list(runs[0]) == list(runs[1]) == [0]
    for k in PKL_KEYS:
        np.testing.assert_array_equal(runs[0][0][k], runs[1][0][k], k)
