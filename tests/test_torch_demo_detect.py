"""gaitlab_torch.cli.demo from a raw video (no --tracking_path) against
gaitlab's demo at pkl level: median-background detection, SORT, gap
splitting and GRNet per track, with and without --smooth, from the frame
folder and with --stream.

Both demos get the same small model (tests/test_torch_models.tiny_pair)
through `load_model` and run on the CPU on one synthetic clip of two
walkers. The same persons, frame ids and bboxes must come out; the model
outputs agree within test_torch_demo.py's tolerances (1e-4 relative with
2e-5 absolute, 1e-3 absolute for pixel coordinates, `pose` through its
rotations).
"""

import os

import cv2
import joblib
import numpy as np
import pytest

from gaitlab.body import smpl as jax_smpl
from gaitlab.cli import demo as jax_demo
from gaitlab.core import geometry as jax_geometry
from gaitlab.nn.grnet import GRNet as JaxGRNet
from gaitlab_torch.cli import demo as pt_demo
from test_torch_models import assert_close, tiny_pair
from torch_threads import torch_threads  # noqa: F401

N_FRAMES = 32
PKL_KEYS = ("pred_cam", "orig_cam", "verts", "pose", "betas", "joints3d",
            "joints2d", "bboxes", "frame_ids")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """320x240, N_FRAMES frames: walker 0 goes right in the upper band,
    walker 1 left in the lower band; the bands never touch, so the
    median-background detector sees two blobs on every frame."""
    d = tmp_path_factory.mktemp("torch_demo_detect")
    vid = str(d / "detect_walk.mp4")
    rng = np.random.default_rng(0)
    bg = rng.integers(40, 70, size=(240, 320, 3)).astype(np.uint8)
    writer = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 20.0,
                             (320, 240))
    for i in range(N_FRAMES):
        frame = bg.copy()
        cv2.rectangle(frame, (20 + 6 * i, 10), (50 + 6 * i, 105),
                      (210, 190, 180), -1)
        cv2.rectangle(frame, (270 - 6 * i, 130), (300 - 6 * i, 230),
                      (150, 200, 160), -1)
        writer.write(frame)
    writer.release()
    return d, vid


@pytest.fixture(scope="module")
def models():
    module, variables, port = tiny_pair(seed=7)
    jax_model = JaxGRNet(module=module, variables=variables,
                         smpl=jax_smpl.synthetic_smpl_params())
    return jax_model, port


def run_demo(mod, model, vid, out, monkeypatch, *extra):
    monkeypatch.setattr(mod, "load_model", lambda args, cfg: model)
    # 32 frames per track: one forward at bucket 24, then 8 padded to 24
    monkeypatch.setenv("GAITLAB_BUCKETS", "24")
    args = mod.build_parser().parse_args(
        ["--vid_file", vid, "--detector", "median_bg", "--output_folder",
         out, "--save_vid", "--cpu_only", "--precision", "float32", *extra])
    mod.main(args)
    return joblib.load(os.path.join(out, "detect_walk_mp4", "grnet.pkl"))


@pytest.fixture(scope="module")
def port_runs(clip, models):
    """The port's demo on the clip, run once for each set of flags: the
    parity cases and the stream check read the same runs."""
    d, vid = clip
    runs = {}

    def run(*extra):
        if extra not in runs:
            tag = "_".join(x.strip("-") for x in extra) or "plain"
            with pytest.MonkeyPatch.context() as mp:
                runs[extra] = run_demo(pt_demo, models[1], vid,
                                       str(d / f"pt_{tag}"), mp, *extra)
        return runs[extra]

    return run


def rot(aa):
    return np.asarray(jax_geometry.axis_angle_to_rotmat(aa.reshape(-1, 3)))


@pytest.mark.parametrize("extra", [(), ("--smooth",), ("--stream",),
                                   ("--stream", "--smooth")],
                         ids=["folder", "smooth", "stream", "stream_smooth"])
def test_demo_from_video_matches_gaitlab(clip, models, port_runs,
                                        monkeypatch, extra):
    d, vid = clip
    tag = "_".join(x.strip("-") for x in extra) or "plain"
    got = port_runs(*extra)
    want = run_demo(jax_demo, models[0], vid, str(d / f"jax_{tag}"),
                    monkeypatch, *extra)
    assert list(got) == list(want) == [0, 1]
    for pid in want:
        g, w = got[pid], want[pid]
        assert set(g) == set(w) == set(PKL_KEYS)
        np.testing.assert_array_equal(g["frame_ids"], w["frame_ids"])
        np.testing.assert_array_equal(g["bboxes"], w["bboxes"])
        assert len(g["frame_ids"]) > 25
        assert g["verts"].shape == (len(g["frame_ids"]), 6890, 3)
        assert g["joints3d"].shape == (len(g["frame_ids"]), 29, 3)
        for k in ("pred_cam", "betas", "verts", "joints3d"):
            assert_close(g[k], w[k], rtol=1e-4, atol=2e-5, what=f"{pid} {k}")
        for k in ("orig_cam", "joints2d"):
            assert_close(g[k], w[k], rtol=1e-4, atol=1e-3, what=f"{pid} {k}")
        assert_close(rot(g["pose"]), rot(w["pose"]), rtol=1e-4, atol=2e-5,
                     what=f"{pid} pose")


def test_stream_gives_the_folder_run_s_persons(port_runs):
    """--stream fits the background on the clip's head and decodes from
    the video; on this clip it finds the folder run's persons, frames and
    boxes, and --smooth changes the pose but no track."""
    folder = port_runs()
    stream = port_runs("--stream", "--smooth")
    assert list(folder) == list(stream) == [0, 1]
    for pid in folder:
        np.testing.assert_array_equal(stream[pid]["frame_ids"],
                                      folder[pid]["frame_ids"])
        np.testing.assert_array_equal(stream[pid]["bboxes"],
                                      folder[pid]["bboxes"])
        np.testing.assert_array_equal(stream[pid]["pose"][0],
                                      folder[pid]["pose"][0])
        assert not np.array_equal(stream[pid]["pose"], folder[pid]["pose"])
