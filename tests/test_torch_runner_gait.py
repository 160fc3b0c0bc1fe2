"""gaitlab_torch's GRNetRunner with the gait branch against gaitlab's:
run_track on a track of one bucket, on a 7-frame track at bucket 4 (two
forwards whose pred_avg is merged with weights equal to their real
frames), and 5 frames padded to bucket 8 against exactly 5.

Both runners get the same small model (tests/test_torch_gait.gait_pair)
and run on the CPU in float32 on 64-px crops. Tolerances: the per-frame
outputs as in test_torch_models.assert_outputs_close; the gait estimates
(pred_avg, pred_phase) within 1e-4, relative to their largest value with
1e-5 absolute, as the padded-vs-exact comparison in gaitlab's own tests.
"""

import numpy as np
import pytest
import torch

from gaitlab.nn.grnet import GRNet as JaxGRNet
from gaitlab.body import smpl as jax_smpl
from gaitlab.pipeline.runner import GRNetRunner as JaxRunner
from gaitlab_torch.pipeline.runner import GRNetRunner as PtRunner
from test_torch_gait import gait_pair
from test_torch_models import assert_close, assert_outputs_close
from torch_threads import torch_threads  # noqa: F401

RUN_KEYS = ("pred_cam", "pose", "betas", "verts", "joints3d", "joints2d")


@pytest.fixture(scope="module")
def models():
    module, variables, port = gait_pair(seed=3)
    jax_model = JaxGRNet(module=module, variables=variables,
                         smpl=jax_smpl.synthetic_smpl_params())
    return jax_model, port


def track(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (n, 96, 128, 3)).astype(np.uint8)
    bboxes = np.stack([60 + 2.0 * np.arange(n), np.full(n, 48.0),
                       np.full(n, 70.0), np.full(n, 70.0)], 1)
    return frames, bboxes.astype(np.float32)


def runners(models, buckets):
    jax_model, port = models
    return (JaxRunner(jax_model, buckets=buckets, precision="float32",
                      crop_size=64),
            PtRunner(port, buckets=buckets, crop_size=64))


def assert_run_close(got: dict, want: dict):
    assert set(got) == set(want) == set(RUN_KEYS) | {"pred_avg",
                                                     "pred_phase"}
    assert got["pred_avg"].shape == want["pred_avg"].shape == (3,)
    assert_close(got["pred_avg"], want["pred_avg"], what="pred_avg")
    assert_close(got["pred_phase"], want["pred_phase"], what="pred_phase")
    for k in ("pred_cam", "betas", "verts", "joints3d", "joints2d"):
        assert_close(got[k], want[k], rtol=1e-4, atol=2e-5, what=k)
    assert_outputs_close(
        {"theta": np.concatenate([got["pred_cam"], got["pose"],
                                  got["betas"]], 1), "verts": got["verts"],
         "kp_2d": got["joints2d"], "kp_3d": got["joints3d"],
         "rotmat": np.zeros(1)},
        {"theta": np.concatenate([want["pred_cam"], want["pose"],
                                  want["betas"]], 1), "verts": want["verts"],
         "kp_2d": want["joints2d"], "kp_3d": want["joints3d"],
         "rotmat": np.zeros(1)})


@pytest.mark.parametrize("n,buckets", [(6, (8,)), (7, (4,))],
                         ids=["one_bucket", "two_forwards"])
def test_run_track_gait_matches_gaitlab(models, n, buckets):
    frames, bboxes = track(n)
    jax_runner, pt_runner = runners(models, buckets)
    want = jax_runner.run_track(frames, bboxes)
    got = pt_runner.run_track(frames, bboxes)
    assert got["pred_phase"].shape == (n, 4)
    assert_run_close(got, want)


def test_padded_track_matches_exact_bucket(models):
    """5 frames padded to bucket 8 give the gait estimates and outputs of
    a bucket of exactly 5 (the padded frames are masked out of the GRU
    and attention), and gaitlab's padded run."""
    frames, bboxes = track(5, seed=1)
    jax_runner, padded = runners(models, (8,))
    exact = PtRunner(models[1], buckets=(5,), crop_size=64)
    got = padded.run_track(frames, bboxes)
    ref = exact.run_track(frames, bboxes)
    np.testing.assert_allclose(got["pred_avg"], ref["pred_avg"], atol=1e-4)
    np.testing.assert_allclose(got["pred_phase"], ref["pred_phase"],
                               atol=1e-4)
    np.testing.assert_allclose(got["joints3d"], ref["joints3d"], atol=1e-4)
    assert_run_close(got, jax_runner.run_track(frames, bboxes))


def test_pred_avg_merge_is_length_weighted(models, monkeypatch):
    """The per-forward gait estimate is averaged with weights equal to each
    forward's real frames: 4 + 1 frames at bucket 4 give (4*4 + 1*1) / 5."""
    runner = PtRunner(models[1], buckets=(4,), crop_size=64)
    seen = []

    def fake_forward(crops, bbox=None, cimg=None):
        m = crops.shape[0]
        seen.append((m, tuple(bbox.shape), tuple(cimg.shape)))
        return {"theta": torch.zeros(m, 85),
                "pred_avg": torch.full((1, 3), float(m)),
                "pred_phase": torch.zeros(m, 4)}

    monkeypatch.setattr(runner, "_forward_bucket", fake_forward)
    out = runner.forward_crops(torch.zeros(5, 8, 8, 3),
                               bbox=np.ones((5, 4), np.float32),
                               cimg=np.ones((5, 2), np.float32))
    np.testing.assert_allclose(out["pred_avg"], 3.4, atol=1e-6)
    assert out["pred_phase"].shape == (5, 4)
    assert seen == [(4, (4, 4), (4, 2)), (1, (1, 4), (1, 2))]


def test_gait_rows_come_with_each_frame(models):
    """The gait branch refuses a stream whose bbox/cimg rows lag its
    crops, instead of running on made-up camera context."""
    runner = PtRunner(models[1], buckets=(4,), crop_size=64)
    session = runner.open_stream()
    with pytest.raises(ValueError, match="bbox/cimg row"):
        session.feed(torch.zeros(4, 64, 64, 3),
                     bbox=np.ones((3, 4), np.float32),
                     cimg=np.ones((4, 2), np.float32))
