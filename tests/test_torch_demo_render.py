"""gaitlab_torch.cli.demo with video output on against gaitlab's demo, on
the CPU: the default flags (skeleton overlay), --mesh_render --sideview
--save_obj (the host painter), and --stream with video output on, which
falls back to the frame folder with gaitlab's warning (gaitlab's run is
stopped once it has printed it).

Both demos get the same small model (tests/test_torch_models.tiny_pair)
through `load_model` and run on one synthetic clip of two walkers with the
median-background detector. The pkl matches as in test_torch_demo.py
(1e-4 relative with 2e-5 absolute, 1e-3 absolute for pixel coordinates,
`pose` through its rotations); the mp4 has gaitlab's frame count and
frame size; the .obj files have gaitlab's names and counts, and their
vertices agree within the pkl tolerance.
"""

import os
import tempfile

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

N_FRAMES = 30
PKL_KEYS = ("pred_cam", "orig_cam", "verts", "pose", "betas", "joints3d",
            "joints2d", "bboxes", "frame_ids")
STEM = "render_walk_mp4"
WARNING = "WARNING: --stream/--onepass need rendering/display off"


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """320x240, N_FRAMES frames, two walkers in bands that never touch."""
    d = tmp_path_factory.mktemp("torch_demo_render")
    vid = str(d / "render_walk.mp4")
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
    module, variables, port = tiny_pair(seed=11)
    jax_model = JaxGRNet(module=module, variables=variables,
                         smpl=jax_smpl.synthetic_smpl_params())
    return jax_model, port


def run_demo(mod, model, vid, out, *extra):
    """One demo run with video output on; returns (pkl, run dir, stdout
    lines). `load_model` and the buckets are patched for the run only."""
    import contextlib
    import io

    mp = pytest.MonkeyPatch()
    mp.setattr(mod, "load_model", lambda args, cfg: model)
    # two tracks of under 30 frames: one forward each at bucket 32
    mp.setenv("GAITLAB_BUCKETS", "32")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            mod.main(mod.build_parser().parse_args(
                ["--vid_file", vid, "--detector", "median_bg",
                 "--output_folder", out, "--cpu_only", "--precision",
                 "float32", *extra]))
    finally:
        mp.undo()
    run_dir = os.path.join(out, STEM)
    return (joblib.load(os.path.join(run_dir, "grnet.pkl")), run_dir,
            buf.getvalue().splitlines())


CASES = {"video": (), "mesh": ("--mesh_render", "--sideview", "--save_obj")}


@pytest.fixture(scope="module")
def runs(clip, models):
    d, vid = clip
    jax_model, port = models
    out = {}
    for case, extra in CASES.items():
        out[case] = (run_demo(pt_demo, port, vid, str(d / f"pt_{case}"),
                              *extra),
                     run_demo(jax_demo, jax_model, vid, str(d / f"jax_{case}"),
                              *extra))
    return out


class _Stop(Exception):
    pass


def jax_stream_warning(vid, out):
    """gaitlab's demo with --stream and video output on, stopped where it
    starts to decode the frame folder: what it printed up to there."""
    import contextlib
    import io

    from gaitlab.pipeline import video as jax_video

    def stop(*a, **kw):
        raise _Stop

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_video, "video_to_images", stop)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf), pytest.raises(_Stop):
            jax_demo.main(jax_demo.build_parser().parse_args(
                ["--vid_file", vid, "--detector", "median_bg", "--stream",
                 "--mesh_render", "--output_folder", out, "--cpu_only"]))
    finally:
        mp.undo()
    return buf.getvalue().splitlines()


def rot(aa):
    return np.asarray(jax_geometry.axis_angle_to_rotmat(aa.reshape(-1, 3)))


def video_shape(path):
    cap = cv2.VideoCapture(path)
    n, shape = 0, None
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        n, shape = n + 1, frame.shape
    cap.release()
    return n, shape


@pytest.mark.parametrize("case", list(CASES))
def test_pkl_matches_gaitlab(runs, case):
    (got, _, _), (want, _, _) = runs[case]
    assert list(got) == list(want) == [0, 1]
    for pid in want:
        g, w = got[pid], want[pid]
        assert set(g) == set(w) == set(PKL_KEYS)
        np.testing.assert_array_equal(g["frame_ids"], w["frame_ids"])
        np.testing.assert_array_equal(g["bboxes"], w["bboxes"])
        for k in ("pred_cam", "betas", "verts", "joints3d"):
            assert_close(g[k], w[k], rtol=1e-4, atol=2e-5, what=f"{pid} {k}")
        for k in ("orig_cam", "joints2d"):
            assert_close(g[k], w[k], rtol=1e-4, atol=1e-3, what=f"{pid} {k}")
        assert_close(rot(g["pose"]), rot(w["pose"]), rtol=1e-4, atol=2e-5,
                     what=f"{pid} pose")


@pytest.mark.parametrize("case", list(CASES))
def test_video_matches_gaitlab(runs, case):
    (_, got_dir, got_out), (_, want_dir, _) = runs[case]
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    got = video_shape(os.path.join(got_dir, "grnet.mp4"))
    want = video_shape(os.path.join(want_dir, "grnet.mp4"))
    assert got == want
    assert got[0] == N_FRAMES
    if case == "mesh":
        assert got[1] == (240, 640, 3)  # the side view beside the clip
    else:
        assert got[1] == (500, 1000, 3)  # the 10x5 in matplotlib figure
    stages = [line.split(":")[0].strip() for line in got_out
              if line.startswith("  ") and ":" in line]
    assert "render" in stages and "model" in stages
    # the frame folder and the rendered frames are gone
    folder = os.path.join(tempfile.gettempdir(), f"{STEM}_mpt")
    assert not os.path.exists(folder)
    assert not os.path.exists(f"{folder}_output")


def test_save_obj_matches_gaitlab(runs):
    (got_pkl, got_dir, _), (_, want_dir, _) = runs["mesh"]
    got_root = os.path.join(got_dir, "rendered")
    want_root = os.path.join(want_dir, "rendered")
    assert sorted(os.listdir(got_root)) == sorted(os.listdir(want_root)) == [
        "0000", "0001"]
    n = 0
    for person in os.listdir(want_root):
        names = sorted(os.listdir(os.path.join(want_root, person)))
        assert sorted(os.listdir(os.path.join(got_root, person))) == names
        assert names == [f"{int(f):06d}.obj"
                         for f in got_pkl[int(person)]["frame_ids"]]
        for name in names[::7]:
            g, w = (open(os.path.join(root, person, name)).read().split("\n")
                    for root in (got_root, want_root))
            assert [x for x in g if x.startswith("f ")] == \
                [x for x in w if x.startswith("f ")]
            gv, wv = (np.array([x.split()[1:] for x in lines
                                if x.startswith("v ")], np.float64)
                      for lines in (g, w))
            assert gv.shape == (6890, 3)
            assert_close(gv, wv, rtol=1e-4, atol=2e-5, what=name)
        n += len(names)
    assert n == sum(len(p["frame_ids"]) for p in got_pkl.values())


def test_stream_with_video_output_takes_the_folder_path(clip, models, runs):
    """--stream with video output on (here --mesh_render) warns as gaitlab
    does and runs the frame-folder pipeline: the folder run's results."""
    d, vid = clip
    got, got_dir, got_out = run_demo(pt_demo, models[1], vid,
                                     str(d / "pt_stream"), "--stream",
                                     "--mesh_render")
    warn = [line for line in got_out if line.startswith(WARNING)]
    assert warn and warn == [
        line for line in jax_stream_warning(vid, str(d / "jax_stream"))
        if line.startswith(WARNING)]
    assert any(line.startswith("Images saved to") for line in got_out)
    assert video_shape(os.path.join(got_dir, "grnet.mp4")) == (
        N_FRAMES, (240, 320, 3))
    folder = runs["mesh"][0][0]
    for pid in folder:
        for k in ("frame_ids", "bboxes", "verts"):
            np.testing.assert_array_equal(got[pid][k], folder[pid][k])


@pytest.mark.parametrize("extra,refused", [
    ((), True), (("--mesh_render",), False), (("--save_vid",), False)],
    ids=["skeleton", "mesh", "no_video"])
def test_skeleton_video_without_matplotlib_stops_first(monkeypatch, extra,
                                                       refused):
    """Without matplotlib the skeleton overlay cannot be drawn: the demo
    stops before any decode or model work; the mesh overlay and no video
    need no matplotlib."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises
    args = pt_demo.build_parser().parse_args(
        ["--vid_file", "x.mp4", "--cpu_only", *extra])
    if refused:
        with pytest.raises(ModuleNotFoundError, match="--mesh_render"):
            pt_demo.check_render_deps(args)
    else:
        pt_demo.check_render_deps(args)
