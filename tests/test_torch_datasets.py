"""gaitlab_torch's training-data and dataset helpers against gaitlab's on
the CPU: bboxes from keypoints (pipeline/boxes.py), the Inference and
ImageFolder datasets, windows and augmentation (pipeline/data.py), frame
extraction at 20 fps and trimming (pipeline/video.py), and the PARE and
HRNet checkpoint flavours (weights/torch_import.py).

Host numpy code must agree exactly, or to float32 rounding where the
filters sum in another order (1e-5); crops on the device follow
test_torch_pipeline.py's crop tolerance; loaded weights must be equal.
"""

import os
import random

import cv2
import numpy as np
import pytest
import torch

from gaitlab.pipeline import boxes as jax_boxes
from gaitlab.pipeline import data as jax_data
from gaitlab.pipeline import datasets as jax_datasets
from gaitlab.pipeline import video as jax_video
from gaitlab.weights import torch_import as jax_ti
from gaitlab_torch.nn.grnet import GRNet as PtGRNet
from gaitlab_torch.pipeline import boxes as pt_boxes
from gaitlab_torch.pipeline import data as pt_data
from gaitlab_torch.pipeline import datasets as pt_datasets
from gaitlab_torch.pipeline import video as pt_video
from gaitlab_torch.weights import torch_import as pt_ti
from gaitlab_torch.weights.convert import state_dict_from_flax
from test_torch_models import TINY, tiny_pair
from test_torch_pipeline import crops_close


@pytest.fixture(scope="module")
def frame_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_ds_frames"))
    rng = np.random.default_rng(0)
    for i in range(6):
        cv2.imwrite(os.path.join(d, f"{i + 1:06d}.png"),
                    rng.integers(0, 255, (120, 160, 3), dtype=np.uint8))
    return d


def keypoints(rng, n=12, k=21, gaps=(3, 4, 8)):
    """(n, k, 3) keypoints in pixels; frames in `gaps` have none visible,
    frame 0 too, so the window starts at frame 1."""
    kp = np.zeros((n, k, 3), np.float32)
    kp[:, :, 0] = rng.uniform(40, 120, (n, k))
    kp[:, :, 1] = rng.uniform(20, 100, (n, k))
    kp[:, :, 2] = rng.uniform(0.5, 3.0, (n, k))
    kp[(0,) + tuple(gaps), :, 2] = 0.0
    return kp


# -- boxes -------------------------------------------------------------------

@pytest.mark.parametrize("squared", [True, False])
def test_bbox_params_match_gaitlab(rng, squared):
    kp = keypoints(rng)
    for frame in (kp[1], kp[0], None):
        got = pt_boxes.kp_to_bbox_param(frame, vis_thresh=0.3,
                                        squared=squared)
        want = jax_boxes.kp_to_bbox_param(frame, vis_thresh=0.3,
                                          squared=squared)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)
    got = pt_boxes.get_all_bbox_params(kp, vis_thresh=0.3, squared=squared)
    want = jax_boxes.get_all_bbox_params(kp, vis_thresh=0.3, squared=squared)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] == (1, 12)
    got = pt_boxes.get_smooth_bbox_params(kp, vis_thresh=0.3,
                                          squared=squared)
    want = jax_boxes.get_smooth_bbox_params(kp, vis_thresh=0.3,
                                            squared=squared)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert got[1:] == want[1:]


def test_track_window_matches_gaitlab(rng):
    kp = keypoints(rng, gaps=(11,))  # the last frame drops out too
    got = pt_boxes.track_window_from_joints2d(np.arange(12), kp)
    want = jax_boxes.track_window_from_joints2d(np.arange(12), kp)
    np.testing.assert_array_equal(got[0], np.arange(1, 11))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- datasets ----------------------------------------------------------------

def test_inference_dataset_matches_gaitlab(frame_dir):
    bb = np.tile([80.0, 60.0, 70.0, 70.0], (6, 1)).astype(np.float32)
    orig = bb.copy()
    got = pt_datasets.Inference(frame_dir, np.arange(6), bboxes=bb,
                                scale=1.1)
    want = jax_datasets.Inference(frame_dir, np.arange(6), bboxes=bb,
                                  scale=1.1)
    np.testing.assert_array_equal(bb, orig)  # the caller's bboxes stay
    assert len(got) == len(want) == 6
    np.testing.assert_array_equal(got.bboxes, want.bboxes)
    np.testing.assert_array_equal(got[2], want[2])
    batch = got.batch([0, 2, 5], device="cpu")
    assert batch.dtype == torch.float32 and batch.shape == (3, 224, 224, 3)
    crops_close(batch.numpy(), np.asarray(want.batch([0, 2, 5])))
    # the host crop and the device crop of one frame
    np.testing.assert_allclose(batch[1].numpy(), got[2], atol=2e-2)


def test_inference_keypoint_path_matches_gaitlab(frame_dir, rng):
    kp = keypoints(rng, n=6, gaps=())
    got = pt_datasets.Inference(frame_dir, np.arange(6), joints2d=kp,
                                scale=1.2)
    want = jax_datasets.Inference(frame_dir, np.arange(6), joints2d=kp,
                                  scale=1.2)
    np.testing.assert_array_equal(got.frames, want.frames)
    np.testing.assert_array_equal(got.bboxes, want.bboxes)
    (g_img, g_kp), (w_img, w_kp) = got[0], want[0]
    np.testing.assert_array_equal(g_img, w_img)
    np.testing.assert_allclose(g_kp, w_kp, rtol=1e-6, atol=1e-4)


def test_image_folder_matches_gaitlab(frame_dir):
    got, want = pt_datasets.ImageFolder(frame_dir), \
        jax_datasets.ImageFolder(frame_dir)
    assert len(got) == len(want) == 6
    assert got[3].dtype == np.float32
    np.testing.assert_array_equal(got[3], want[3])


# -- data --------------------------------------------------------------------

def test_split_into_chunks_matches_gaitlab():
    names = np.array(["b"] * 7 + ["a"] * 3 + ["c"] * 9)
    for seqlen, stride in ((3, 1), (4, 2), (8, 8)):
        got = pt_data.split_into_chunks(names, seqlen, stride)
        assert got == jax_data.split_into_chunks(names, seqlen, stride)
    # video b (frames 0-6) then c (10-18), a is too short for 4
    assert pt_data.split_into_chunks(names, 4, 2) == [
        [0, 3], [2, 5], [10, 13], [12, 15], [14, 17]]


def test_augmentation_matches_gaitlab():
    got = pt_data.do_augmentation(rng=random.Random(3))
    want = jax_data.do_augmentation(rng=random.Random(3))
    assert got == want
    img = np.random.default_rng(1).integers(0, 255, (40, 60, 3),
                                            dtype=np.uint8)
    np.testing.assert_array_equal(pt_data.color_jitter(img, got[3]),
                                  jax_data.color_jitter(img, want[3]))
    bbox = [30.0, 20.0, 24.0, 30.0]
    masked = pt_data.get_image_masked(img, bbox,
                                      rng=np.random.default_rng(5))
    np.testing.assert_array_equal(
        masked, jax_data.get_image_masked(img, bbox,
                                          rng=np.random.default_rng(5)))
    assert (masked == 0).sum() > (img == 0).sum()


# -- video -------------------------------------------------------------------

@pytest.fixture(scope="module")
def clip30(tmp_path_factory):
    """30 frames at 30 fps, each with its own shade."""
    d = tmp_path_factory.mktemp("torch_ds_clip")
    path = str(d / "clip30.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0,
                             (96, 64))
    for i in range(30):
        frame = np.full((64, 96, 3), 20 + 7 * i, np.uint8)
        cv2.circle(frame, (10 + 2 * i, 32), 8, (250, 40, 40), -1)
        writer.write(frame)
    writer.release()
    return d, path


def read_all(folder):
    return [cv2.imread(p) for p in pt_video.list_image_files(folder)]


def test_video_to_images_at_20_fps_matches_gaitlab(clip30):
    d, path = clip30
    got = pt_video.video_to_images(path, str(d / "pt"), return_info=True,
                                   fps=20)
    want = jax_video.video_to_images(path, str(d / "jax"), return_info=True,
                                     fps=20)
    assert got[1:] == want[1:] == (20, (64, 96, 3))
    for g, w in zip(read_all(got[0]), read_all(want[0])):
        np.testing.assert_array_equal(g, w)


def test_trim_video_matches_gaitlab(clip30):
    d, path = clip30
    n = pt_video.trim_videos(path, 0.2, 0.6, str(d / "cut" / "pt.mp4"))
    assert n == jax_video.trim_video(path, 0.2, 0.6,
                                     str(d / "cut" / "jax.mp4"))
    assert n == 12  # frames 6..17
    frames = {k: list(pt_video.read_frames(str(d / "cut" / f"{k}.mp4")))
              for k in ("pt", "jax")}
    assert len(frames["pt"]) == 12
    for g, w in zip(frames["pt"], frames["jax"]):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(FileNotFoundError):
        pt_video.trim_video(str(d / "absent.mp4"), 0, 1, str(d / "x.mp4"))


# -- checkpoint flavours -----------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(gaitlab's variables, the port's model with the same weights)."""
    _, variables, port = tiny_pair(seed=5)
    return variables, port


def fresh():
    return PtGRNet.create(device="cpu", seed=99, **TINY).module


def sub_template(variables, name):
    return {c: variables[c][name] for c in ("params", "batch_stats")}


def as_torch(flax_vars, name):
    """gaitlab's head or backbone variables -> the port's keys."""
    sd = state_dict_from_flax({c: {name: flax_vars[c]}
                               for c in ("params", "batch_stats")})
    return {k[len(name) + 1:]: v for k, v in sd.items()}


def assert_loaded(module, want: dict):
    got = module.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(got[k], torch.as_tensor(v), rtol=0,
                                       atol=0, msg=k)


def test_pare_checkpoint_matches_gaitlab(pair):
    """Flavour 2: 'model.head.*' keys with the init parameters; keys of
    other models and extra head keys are reported as unused."""
    variables, port = pair
    head = port.module.head.state_dict()
    init = {"init_pose": torch.randn(1, 144), "init_shape": torch.randn(1, 10),
            "init_cam": torch.randn(1, 3), "temperature": torch.tensor(0.5)}
    state = {f"model.head.{k}": v for k, v in {**head, **init}.items()}
    state["model.backbone.conv1.weight"] = torch.zeros(1)  # dropped
    state["model.head.extra_branch.weight"] = torch.zeros(2)
    state["epoch"] = torch.tensor(3)

    module = fresh().head
    got_init, missing, unused = pt_ti.import_pare_head_ckpt(state, module)
    want_vars, want_init, want_missing, want_unused = \
        jax_ti.import_pare_head_ckpt(state, sub_template(variables, "head"))
    assert missing == want_missing == []
    assert set(got_init) == set(want_init) == set(init)
    for k in init:
        np.testing.assert_array_equal(got_init[k], want_init[k])
    assert unused == ["extra_branch.weight", "epoch"]
    assert {jax_ti._norm_key(k) for k in unused} == {
        k for k in want_unused if k[-1] != "tracked"}
    assert_loaded(module, head)
    assert_loaded(module, as_torch(want_vars, "head"))

    # a missing head weight: reported, or raised with strict
    del state["model.head.cam_mlp.bias"]
    module = fresh().head
    _, missing, _ = pt_ti.import_pare_head_ckpt(state, module)
    want_missing = jax_ti.import_pare_head_ckpt(
        state, sub_template(variables, "head"))[2]
    assert missing == ["cam_mlp.bias"] and want_missing == ["cam_mlp/bias"]
    before = {k: v.clone() for k, v in module.state_dict().items()}
    with pytest.raises(KeyError):
        pt_ti.import_pare_head_ckpt(state, module, strict=True)
    with pytest.raises(KeyError):
        jax_ti.import_pare_head_ckpt(state, sub_template(variables, "head"),
                                     strict=True)
    assert_loaded(module, before)  # nothing loaded on a strict failure


@pytest.mark.parametrize("wrapped,include_heads", [
    (False, True), (False, False), (True, False)],
    ids=["plain", "plain_no_heads", "state_dict_wrapper"])
def test_hrnet_checkpoint_matches_gaitlab(pair, wrapped, include_heads):
    """Flavour 3: only the pretrained layers are taken; the upsampling
    heads too with include_heads or the 'state_dict' wrapper."""
    variables, port = pair
    backbone = port.module.backbone.state_dict()
    state = {**backbone, "incre_modules.0.weight": torch.zeros(1),
             "classifier.weight": torch.zeros(1)}
    if wrapped:
        state = {"state_dict": state}
    module = fresh().backbone
    missing, unused = pt_ti.import_hrnet_ckpt(state, module,
                                              include_heads=include_heads)
    want_vars, want_missing, want_unused = jax_ti.import_hrnet_ckpt(
        state, sub_template(variables, "backbone"),
        include_heads=include_heads)
    heads = include_heads or wrapped
    assert unused == [] and {k for k in want_unused
                             if k[-1] != "tracked"} == set()
    assert len(missing) == len(want_missing)
    assert bool(missing) == (not heads)
    assert all(k.split(".")[0].startswith("upsample_stage") for k in missing)
    taken = {k: v for k, v in backbone.items()
             if heads or not k.startswith("upsample_stage")}
    assert_loaded(module, taken)
    assert_loaded(module, {k: v for k, v in as_torch(
        want_vars, "backbone").items() if k in taken})
