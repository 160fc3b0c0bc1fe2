"""gaitlab_torch.api against gaitlab.api: analyze_video from a raw video,
two-pass and one-pass, with the gait pipeline, and gait_report on its
results; load_pipeline's refusals.

Both packages get the same small gait model (tests/test_torch_gait.
gait_pair) as a runner= on the CPU in float32, with 64-px host crops in
both (cv2, bit-identical) at bucket 24. The same persons, frame ids and boxes
must come out; the model outputs agree within test_torch_demo.py's
tolerances (1e-4 relative with 2e-5 absolute, 1e-3 absolute for pixel
coordinates), the gait features within rtol 1e-4 (atol 1e-6) and their
heel-strike frames exactly.
"""

import cv2
import numpy as np
import pytest
import torch

from gaitlab import api as jax_api
from gaitlab.body import smpl as jax_smpl
from gaitlab.nn.grnet import GRNet as JaxGRNet
from gaitlab.pipeline.runner import GRNetRunner as JaxRunner
from gaitlab_torch import api as pt_api
from gaitlab_torch.pipeline.runner import GRNetRunner as PtRunner
from test_torch_gait import gait_pair
from test_torch_models import assert_close

N_FRAMES = 44
RESULT_KEYS = ("pred_cam", "orig_cam", "verts", "pose", "betas", "joints3d",
               "joints2d", "bboxes", "frame_ids")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """320x240, one walker crossing the frame at 5 px a frame."""
    vid = str(tmp_path_factory.mktemp("torch_api") / "api_walk.mp4")
    rng = np.random.default_rng(2)
    bg = rng.integers(40, 70, size=(240, 320, 3)).astype(np.uint8)
    writer = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 20.0,
                             (320, 240))
    for i in range(N_FRAMES):
        frame = bg.copy()
        x = 15 + 5 * i
        cv2.rectangle(frame, (x, 50), (x + 40, 210), (210, 190, 180), -1)
        cv2.circle(frame, (x + 20, 62), 12, (200, 170, 160), -1)
        writer.write(frame)
    writer.release()
    return vid


@pytest.fixture(scope="module")
def runners():
    module, variables, port = gait_pair(seed=12)
    jax_model = JaxGRNet(module=module, variables=variables,
                         smpl=jax_smpl.synthetic_smpl_params())
    return (JaxRunner(jax_model, buckets=(24,), precision="float32",
                      crop_on="host", crop_size=64),
            PtRunner(port, buckets=(24,), crop_on="host", crop_size=64))


@pytest.fixture(scope="module")
def analyses(clip, runners):
    """{onepass: (port results, gaitlab results)}"""
    jax_runner, pt_runner = runners
    return {onepass: (
        pt_api.analyze_video(clip, runner=pt_runner, joint_type="kinectv2",
                             onepass=onepass),
        jax_api.analyze_video(clip, runner=jax_runner, joint_type="kinectv2",
                              onepass=onepass))
        for onepass in (False, True)}


@pytest.mark.parametrize("onepass", [False, True], ids=["twopass", "onepass"])
def test_analyze_video_matches_gaitlab(analyses, onepass):
    got, want = analyses[onepass]
    assert len(got) == len(want) == 1  # SORT ids differ between packages
    g, w = next(iter(got.values())), next(iter(want.values()))
    assert set(g) == set(w) == set(RESULT_KEYS)
    np.testing.assert_array_equal(g["frame_ids"], w["frame_ids"])
    np.testing.assert_array_equal(g["bboxes"], w["bboxes"])
    n = len(g["frame_ids"])
    assert n >= 25 and g["joints3d"].shape == (n, 25, 3)
    for k in ("pred_cam", "betas", "verts", "joints3d"):
        assert_close(g[k], w[k], rtol=1e-4, atol=2e-5, what=k)
    for k in ("orig_cam", "joints2d"):
        assert_close(g[k], w[k], rtol=1e-4, atol=1e-3, what=k)


def test_onepass_agrees_with_twopass(analyses):
    """The same person and frames either way (walker in view from the first
    frame; SORT's first confirmed frames are the two-pass ones)."""
    two = next(iter(analyses[False][0].values()))
    one = next(iter(analyses[True][0].values()))
    np.testing.assert_array_equal(one["frame_ids"], two["frame_ids"])
    np.testing.assert_allclose(one["bboxes"], two["bboxes"], atol=1e-4)


@pytest.mark.parametrize("onepass", [False, True], ids=["twopass", "onepass"])
def test_gait_report_matches_gaitlab(analyses, onepass):
    got, want = analyses[onepass]
    rep_g = pt_api.gait_report(got, fps=20.0)
    rep_w = jax_api.gait_report(want, fps=20.0)
    (fg,), (fw,) = ([r["features"] for r in rep.values()]
                    for rep in (rep_g, rep_w))
    np.testing.assert_allclose(fg["feature_vector"], fw["feature_vector"],
                               rtol=1e-4, atol=1e-6)
    for side in ("left", "right"):
        np.testing.assert_array_equal(fg["events"][side], fw["events"][side])


def test_gait_report_on_spin2_joints_matches_gaitlab():
    """Joints that are not kinectv2's 25 are taken as spin2 and converted
    before the features, in both packages."""
    from gaitlab_torch.body.joints import conversion_indices
    from test_gait_features import synthetic_walk

    j25 = synthetic_walk(n=100)
    spin2 = np.zeros((100, 29, 3), np.float32)
    idx, valid = conversion_indices("kinectv2", "spin2")
    spin2[:, valid] = j25[:, idx[valid]]
    got = pt_api.gait_report({0: {"joints3d": spin2}}, fps=20.0)[0]
    want = jax_api.gait_report({0: {"joints3d": spin2}}, fps=20.0)[0]
    np.testing.assert_allclose(got["features"]["feature_vector"],
                               want["features"]["feature_vector"],
                               rtol=1e-4, atol=1e-6)
    assert len(got["features"]["events"]["left"]) >= 3


def test_load_pipeline_on_the_cpu_and_its_refusals(monkeypatch):
    model, runner = pt_api.load_pipeline(device="cpu", use_gait_feat=True)
    assert model.device == torch.device("cpu")
    assert model.module.use_gait_feat and runner.model is model
    # precision="high" reaches the runner (its head resolves to "default",
    # the upsample heads to w2x) and runs a full-width crop
    monkeypatch.setenv("GAITLAB_BUCKETS", "1")
    model, runner = pt_api.load_pipeline(device="cpu", precision="high")
    assert (runner.precision, runner.resolved_head_precision(),
            runner.resolved_region_precision()) == (
                "high", "default", (("heads", "w2x"),))
    crop = np.random.default_rng(0).normal(size=(1, 224, 224, 3))
    out = runner.forward_crops(torch.from_numpy(crop.astype(np.float32)))
    assert out["kp_3d"].shape == (1, 29, 3)
    assert np.isfinite(out["kp_3d"]).all()
    with pytest.raises(ValueError, match="precision"):
        pt_api.load_pipeline(device="cpu", precision="bf16")
    with pytest.raises(FileNotFoundError):
        pt_api.load_pipeline(ckpt="no/such.pth", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt_api.load_pipeline()
    with pytest.raises(ValueError, match="onepass"):
        pt_api.analyze_video("x.mp4", runner=runner, onepass=True, fps=10.0)
