"""gaitlab_torch.pipeline against gaitlab.pipeline: crop (device and host),
tracklet splitting, coordinates, video IO, config, and GRNetRunner.

Crop tolerance: both packages build the same float64 sampling tables on
the host and run the same float32 gather-lerp, so the resampled
intensities agree to float32 rounding; after `round_uint8` a sample that
lands within rounding of .5 may round the other way, which moves one
normalised value by 1/(255*std) < 0.018. The tests allow that on at most
0.1% of the values and 1e-5 elsewhere.
"""

import os
import tempfile
import types

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaitlab import config as jax_config
from gaitlab.nn.grnet import GRNet as JaxGRNet
from gaitlab.pipeline import coords as jax_coords
from gaitlab.pipeline import crop as jax_crop
from gaitlab.pipeline import runner as jax_runner
from gaitlab.pipeline import tracks as jax_tracks
from gaitlab.pipeline import video as jax_video
from gaitlab.body import smpl as jax_smpl
from gaitlab_torch import config as pt_config
from gaitlab_torch.pipeline import coords as pt_coords
from gaitlab_torch.pipeline import crop as pt_crop
from gaitlab_torch.pipeline import runner as pt_runner
from gaitlab_torch.pipeline import tracks as pt_tracks
from gaitlab_torch.pipeline import video as pt_video
from test_torch_models import assert_close, tiny_pair

ONE_COUNT = 1.0 / (255 * 0.224)  # one uint8 step after normalisation


def crops_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert err.max() <= ONE_COUNT * 1.01, err.max()
    assert np.mean(err > 1e-5) <= 1e-3, np.mean(err > 1e-5)


def _frames(rng, n, h, w):
    return rng.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)


def _bboxes(rng, n, h, w, side=(40, 120)):
    # square boxes, some partly outside the frame
    return np.stack([rng.uniform(-10, w + 10, n), rng.uniform(-10, h + 10, n),
                     *(2 * [rng.uniform(*side, n)])], 1).astype(np.float32)


def test_gen_trans_from_patch(rng):
    for _ in range(5):
        args = (*rng.uniform(0, 300, 2), *rng.uniform(20, 200, 2), 224, 224,
                rng.uniform(0.8, 1.3), rng.uniform(-30, 30))
        for inv in (False, True):
            np.testing.assert_array_equal(
                pt_crop.gen_trans_from_patch(*args, inv=inv),
                jax_crop.gen_trans_from_patch(*args, inv=inv))


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("crop_size", [224, 64])
def test_device_crop_matches(rng, quantize, crop_size):
    frames = _frames(rng, 6, 120, 160)
    bboxes = _bboxes(rng, 6, 120, 160)
    want = jax_crop.crop_and_normalize(frames, bboxes, scale=1.1,
                                       crop_size=crop_size, quantize=quantize)
    got = pt_crop.crop_and_normalize(frames, bboxes, scale=1.1,
                                     crop_size=crop_size, quantize=quantize)
    assert got.dtype == torch.float32
    crops_close(got.numpy(), want)
    # the raw (un-rounded, un-normalised) resample agrees to float32
    raw = dict(crop_size=crop_size, quantize=quantize, normalize=False,
               round_uint8=False)
    assert_close(pt_crop.crop_and_normalize(frames, bboxes, **raw).numpy(),
                 jax_crop.crop_and_normalize(frames, bboxes, **raw),
                 rtol=1e-6, atol=1e-4, what="raw resample")


def test_normalize_and_single_image_crop(rng):
    img = _frames(rng, 1, 90, 130)[0]
    np.testing.assert_allclose(
        pt_crop.normalize_image(torch.from_numpy(img)).numpy(),
        np.asarray(jax_crop.normalize_image(jnp.asarray(img))),
        rtol=1e-6, atol=1e-6)
    kp = rng.uniform(0, 90, size=(5, 3)).astype(np.float32)
    for bbox in ([60, 45, 70, 70], [60, 45, 50, 80]):  # square, letterbox
        got = pt_crop.get_single_image_crop_demo(img, bbox, kp_2d=kp)
        want = jax_crop.get_single_image_crop_demo(img, bbox, kp_2d=kp)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-5)


def test_host_crop_on_large_frames(rng):
    """Frames above twice the crop area take the cv2 host crop in both
    runners (crop_on="auto"); the crops are bit-identical uint8 before the
    same normalisation."""
    frames = _frames(rng, 5, 480, 640)
    bboxes = _bboxes(rng, 5, 480, 640, side=(150, 300))
    want = jax_runner.GRNetRunner(None, precision="float32",
                                  ingest_chunk=2).crop_track(frames, bboxes)
    model = types.SimpleNamespace(device=torch.device("cpu"))
    got = pt_runner.GRNetRunner(model, ingest_chunk=2).crop_track(frames,
                                                                  bboxes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_smooth_tracking_matches(rng):
    tracks = {}
    for pid in range(4):
        frames = np.sort(rng.choice(200, size=rng.integers(20, 120),
                                    replace=False))
        if pid == 0:
            frames = np.arange(0, 80)  # one long contiguous track
        tracks[pid] = {"frames": frames,
                       "bbox": rng.uniform(50, 150, size=(len(frames), 4))}
    got, got_frames = pt_tracks.smooth_tracking(tracks)
    want, want_frames = jax_tracks.smooth_tracking(tracks)
    assert got_frames == want_frames
    assert got.keys() == want.keys() and len(got) >= 1
    for pid in want:
        np.testing.assert_array_equal(got[pid]["frames"], want[pid]["frames"])
        np.testing.assert_array_equal(got[pid]["bbox"], want[pid]["bbox"])


def test_coords_match(rng):
    cam = np.concatenate([rng.uniform(0.5, 1.5, (7, 1)),
                          rng.normal(size=(7, 2))], 1).astype(np.float32)
    bbox = _bboxes(rng, 7, 240, 320)
    np.testing.assert_allclose(
        pt_coords.convert_crop_cam_to_orig_img(cam, bbox, 320, 240),
        jax_coords.convert_crop_cam_to_orig_img(cam, bbox, 320, 240),
        rtol=1e-6)
    kp = rng.uniform(-1, 1, size=(7, 29, 2)).astype(np.float32)
    np.testing.assert_allclose(
        pt_coords.convert_crop_coords_to_orig_img(bbox, kp, 224),
        jax_coords.convert_crop_coords_to_orig_img(bbox, kp, 224), rtol=1e-6)


def test_video_io_matches(rng):
    with tempfile.TemporaryDirectory() as d:
        vid = os.path.join(d, "clip.mp4")
        writer = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 25.0,
                                 (64, 48))
        for f in _frames(rng, 6, 48, 64):
            writer.write(f)
        writer.release()
        assert pt_video.get_video_info(vid) == jax_video.get_video_info(vid)
        a, n_a, shape_a = pt_video.video_to_images(
            vid, os.path.join(d, "a"), return_info=True)
        b, n_b, shape_b = jax_video.video_to_images(
            vid, os.path.join(d, "b"), return_info=True)
        assert (n_a, shape_a) == (n_b, shape_b) == (6, (48, 64, 3))
        files_a = pt_video.list_image_files(a)
        files_b = jax_video.list_image_files(b)
        assert [os.path.basename(f) for f in files_a] == [
            os.path.basename(f) for f in files_b]
        np.testing.assert_array_equal(pt_video.load_frames(files_a),
                                      jax_video.load_frames(files_b))
        with pytest.raises(FileNotFoundError):
            pt_video.load_frames([os.path.join(d, "missing.png")])


def test_config_matches():
    args = types.SimpleNamespace(cfg=jax_config.DEFAULT_CFG_FILE)
    got, got_file = pt_config.parse_args(args)
    want, want_file = jax_config.parse_args(args)
    assert dict(got) == dict(want)
    assert os.path.basename(got_file or "") == os.path.basename(
        want_file or "")
    # the one default that differs: the port's device is the card
    got = dict(pt_config.parse_args(types.SimpleNamespace(cfg=None))[0])
    want = dict(jax_config.get_cfg_defaults())
    assert (got.pop("DEVICE"), want.pop("DEVICE")) == ("cuda", "tpu")
    assert got == want
    with pytest.raises(KeyError):
        pt_config.get_cfg_defaults()._merge({"NOPE": 1})


def test_runner_refuses_unported_modes():
    model = types.SimpleNamespace(device=torch.device("cpu"))
    for kw in ({"precision": "high"}, {"precision": "default"},
               {"parallel": "dp"}):
        with pytest.raises(NotImplementedError):
            pt_runner.GRNetRunner(model, **kw)
    with pytest.raises(ValueError):
        pt_runner.GRNetRunner(model, crop_on="gpu")


def test_runner_buckets(monkeypatch):
    model = types.SimpleNamespace(device=torch.device("cpu"))
    assert pt_runner.GRNetRunner(model).buckets == pt_runner.DEFAULT_BUCKETS
    assert pt_runner.DEFAULT_BUCKETS == jax_runner.DEFAULT_BUCKETS
    monkeypatch.setenv("GAITLAB_BUCKETS", "16,8,16")
    r = pt_runner.GRNetRunner(model)
    assert r.buckets == (8, 16)
    assert [r._bucket(n) for n in (1, 8, 9, 16, 40)] == [8, 8, 16, 16, 16]


@pytest.fixture(scope="module")
def runners():
    module, variables, port = tiny_pair(seed=2)
    jax_model = JaxGRNet(module=module, variables=variables,
                         smpl=jax_smpl.synthetic_smpl_params())
    return (jax_runner.GRNetRunner(jax_model, buckets=(8, 16),
                                   precision="float32"),
            pt_runner.GRNetRunner(port, buckets=(8, 16)))


def test_run_track_matches(rng, runners):
    """20 frames at crop 224: one forward at bucket 16, then 4 frames
    padded to bucket 8."""
    jr, pr = runners
    frames = _frames(rng, 20, 120, 160)
    bboxes = _bboxes(rng, 20, 120, 160, side=(60, 100))
    want = jr.run_track(frames, bboxes)
    got = pr.run_track(frames, bboxes)
    assert set(got) == {"pred_cam", "pose", "betas", "verts", "joints3d",
                        "joints2d"}
    assert got["verts"].shape == (20, 6890, 3)
    assert got["joints3d"].shape == (20, 29, 3)
    for k in ("pred_cam", "betas", "verts", "joints3d", "joints2d"):
        assert_close(got[k], want[k], rtol=1e-4, atol=2e-5, what=k)
    from gaitlab.core import geometry as jg

    def rot(aa):  # pose through the rotations it encodes
        return np.asarray(jg.axis_angle_to_rotmat(
            jnp.asarray(aa.reshape(-1, 3))))

    assert_close(rot(got["pose"]), rot(want["pose"]), rtol=1e-4, atol=2e-5,
                 what="pose")
    # forward_crops: the model loop on crops already made
    crops = pr.crop_track(frames, bboxes)
    got = pr.forward_crops(crops)
    want = jr.forward_crops(jnp.asarray(crops.numpy()))
    assert set(got) == {"theta", "verts", "kp_2d", "kp_3d"}
    for k in ("verts", "kp_2d", "kp_3d"):
        assert_close(got[k], want[k], rtol=1e-4, atol=2e-5, what=k)


def test_run_track_from_image_files(rng, runners):
    """A track given as frame files streams through load_frames in ingest
    chunks and gives what the same frames as an array give."""
    _, pr = runners
    frames = _frames(rng, 11, 120, 160)
    bboxes = _bboxes(rng, 11, 120, 160, side=(60, 100))
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i, f in enumerate(frames):
            paths.append(os.path.join(d, f"{i + 1:06d}.png"))
            cv2.imwrite(paths[-1], cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        pr.ingest_chunk = 4
        try:
            got = pr.run_track(paths, bboxes)
        finally:
            pr.ingest_chunk = 32
    want = pr.run_track(frames, bboxes)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert pr.run_track(frames[:0], bboxes[:0]) == {}
