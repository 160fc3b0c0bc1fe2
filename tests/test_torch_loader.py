"""The port's frame loader (pipeline/loader.py, native/loader.cc) against
cv2 and gaitlab's loader, and the runner reading frame paths through it.

The native decoder must give cv2's pixels exactly, for PNG and JPEG; its
tests skip only where the toolchain or codec headers are missing, as
gaitlab's tests/test_loader.py does. The runner's outputs on frame paths
(decoded by PrefetchLoader on a worker thread) must equal its outputs on
the same frames passed as an array: the same uint8 frames reach the same
crop, so the tolerance is 0.
"""

import os
import threading

import cv2
import numpy as np
import pytest

from gaitlab.pipeline import loader as jax_loader
from gaitlab_torch.nn.grnet import GRNet as PtGRNet
from gaitlab_torch.pipeline import loader
from gaitlab_torch.pipeline.runner import GRNetRunner
from test_torch_models import TINY
from torch_threads import torch_threads  # noqa: F401

N, H, W = 10, 48, 64


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_frames")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(N):
        p = str(d / f"{i:06d}.png")
        cv2.imwrite(p, rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
        paths.append(p)
    jpgs = []
    for i in range(3):
        p = str(d / f"extra{i}.jpg")
        img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        cv2.imwrite(p, cv2.GaussianBlur(img, (7, 7), 3) if i else img)
        jpgs.append(p)
    return paths, jpgs


def cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


@pytest.fixture(scope="module")
def native():
    if loader._native() is None:
        pytest.skip(f"native toolchain unavailable: "
                    f"{loader.native_status()[1]}")
    return loader._native()


def test_native_builds_into_the_checkout(native):
    assert loader.native_status() == ("native", None)
    assert os.path.dirname(native.__file__) == loader.BUILD_DIR
    assert loader.BUILD_DIR.endswith(os.path.join("build",
                                                  "gaitlab_torch_native"))


@pytest.mark.parametrize("kind", ["png", "jpeg"])
def test_native_decode_equals_cv2(native, image_dir, kind):
    paths = image_dir[0] if kind == "png" else image_dir[1]
    out = loader.load_frames(paths, n_threads=4)
    assert out.shape == (len(paths), H, W, 3) and out.dtype == np.uint8
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(out[i], cv2_rgb(p))


def test_load_frames_matches_gaitlab(image_dir):
    paths = image_dir[0]
    np.testing.assert_array_equal(loader.load_frames(paths),
                                  jax_loader.load_frames(paths))
    assert loader.image_size(paths[0]) == jax_loader.image_size(paths[0]) \
        == (H, W)


@pytest.mark.parametrize("decoder", ["native", "cv2"])
def test_load_frames_decodes_into_out(image_dir, monkeypatch, decoder):
    """A caller-given buffer of the right shape is filled and returned; one
    of another shape is replaced. The cv2 fallback keeps the contract."""
    if decoder == "cv2":
        monkeypatch.setattr(loader, "_native", lambda: None)
    elif loader._native() is None:
        pytest.skip("native toolchain unavailable")
    paths = image_dir[0][:4]
    out = np.zeros((4, H, W, 3), np.uint8)
    got = loader.load_frames(paths, out=out)
    assert got is out
    np.testing.assert_array_equal(out, np.stack([cv2_rgb(p) for p in paths]))
    other = loader.load_frames(paths, out=np.zeros((3, H, W, 3), np.uint8))
    np.testing.assert_array_equal(other, out)


def test_decode_errors(native, image_dir, tmp_path):
    paths = image_dir[0]
    with pytest.raises(RuntimeError, match="cannot open"):
        loader.load_frames([paths[0], str(tmp_path / "missing.png")])
    big = str(tmp_path / "big.png")
    cv2.imwrite(big, np.zeros((H + 2, W, 3), np.uint8))
    with pytest.raises(RuntimeError, match="size mismatch"):
        loader.load_frames([paths[0], big])
    with pytest.raises(ValueError, match="empty"):
        loader.load_frames([])


def test_prefetch_loader_order(image_dir):
    paths = image_dir[0]
    chunks = list(loader.PrefetchLoader(paths, chunk=4))
    assert [c.shape[0] for c in chunks] == [4, 4, 2]
    assert len(loader.PrefetchLoader(paths, chunk=4)) == 3
    np.testing.assert_array_equal(np.concatenate(chunks),
                                  loader.load_frames(paths))
    want = list(jax_loader.PrefetchLoader(paths, chunk=4))
    for g, w in zip(chunks, want):
        np.testing.assert_array_equal(g, w)


def test_prefetch_loader_raises_in_the_consumer(image_dir, tmp_path):
    """A decode error of a later chunk reaches the consumer after the good
    chunks, and the worker thread has ended."""
    paths = image_dir[0][:8] + [str(tmp_path / "missing.png")]
    before = threading.active_count()
    got = []
    with pytest.raises((RuntimeError, FileNotFoundError)):
        for chunk in loader.PrefetchLoader(paths, chunk=4):
            got.append(chunk)
    assert [len(c) for c in got] == [4, 4]
    assert threading.active_count() == before


def test_prefetch_loader_stops_when_the_consumer_leaves(image_dir):
    before = threading.active_count()
    it = iter(loader.PrefetchLoader(image_dir[0], chunk=2))
    next(it)
    it.close()  # the worker is joined
    assert threading.active_count() == before


@pytest.fixture(scope="module")
def clip_frames(tmp_path_factory):
    """20 frames 120x160 on disk (a frame folder) and in memory."""
    d = tmp_path_factory.mktemp("runner_frames")
    rng = np.random.default_rng(1)
    bg = rng.integers(30, 80, (120, 160, 3)).astype(np.uint8)
    frames, paths = [], []
    for i in range(20):
        f = bg.copy()
        cv2.rectangle(f, (20 + 3 * i, 20), (60 + 3 * i, 110),
                      (200, 180, 170), -1)
        p = str(d / f"{i + 1:06d}.png")
        cv2.imwrite(p, f[..., ::-1])  # RGB frames stored as cv2 stores BGR
        frames.append(f)
        paths.append(p)
    bboxes = np.stack([40 + 3.0 * np.arange(20), np.full(20, 65.0),
                       np.full(20, 90.0), np.full(20, 90.0)], 1)
    return np.stack(frames), paths, bboxes.astype(np.float32)


@pytest.mark.parametrize("crop_on", ["device", "host"])
def test_runner_on_paths_equals_runner_on_arrays(clip_frames, crop_on):
    frames, paths, bboxes = clip_frames
    model = PtGRNet.create(device="cpu", seed=3, **TINY)
    runner = GRNetRunner(model, buckets=(8,), ingest_chunk=6, crop_on=crop_on)
    on_paths = runner.run_track(paths, bboxes)
    on_array = runner.run_track(frames, bboxes)
    assert set(on_paths) == set(on_array)
    assert on_paths["verts"].shape == (20, 6890, 3)
    for k in on_array:
        np.testing.assert_array_equal(on_paths[k], on_array[k], err_msg=k)
