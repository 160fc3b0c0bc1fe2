"""gaitlab_torch.core.filters and pipeline.smoothing against gaitlab's.

The same float32 inputs, made with numpy from a seed, go through both
packages on the CPU. Tolerances: 1e-6 (absolute and relative) for the
filters, which do the same float32 operations in the same order;
`smooth_pose` re-evaluates SMPL, whose vertices and joints are held at the
tolerance test_torch_smpl.py uses for `lbs` (2e-4 relative, 2e-5
absolute), and its filtered pose at 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter1d as scipy_gaussian
from scipy.signal import medfilt

from gaitlab.core import filters as jax_filters
from gaitlab.pipeline import smoothing as jax_smoothing
from gaitlab_torch.core import filters as pt_filters
from gaitlab_torch.pipeline import smoothing as pt_smoothing

TOL = 1e-6
SMPL_RTOL, SMPL_ATOL = 2e-4, 2e-5


def close(got, want, rtol=TOL, atol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("min_cutoff,beta", [(0.004, 0.7), (1.0, 0.0),
                                             (0.05, 1.5), (0.3, 0.02)])
def test_one_euro_matches_gaitlab(min_cutoff, beta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 24, 3)).astype(np.float32).cumsum(axis=0)
    want = np.asarray(jax_filters.one_euro(jnp.asarray(x),
                                           min_cutoff=min_cutoff, beta=beta))
    got = pt_filters.one_euro(torch.from_numpy(x), min_cutoff=min_cutoff,
                              beta=beta).numpy()
    close(got, want)
    np.testing.assert_array_equal(got[0], x[0])


def test_one_euro_with_timestamps():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(25, 6)).astype(np.float32)
    t = np.cumsum(rng.uniform(0.5, 2.0, size=25)).astype(np.float32)
    want = np.asarray(jax_filters.one_euro(jnp.asarray(x), jnp.asarray(t),
                                           min_cutoff=0.1, beta=0.5))
    got = pt_filters.one_euro(torch.from_numpy(x), torch.from_numpy(t),
                              min_cutoff=0.1, beta=0.5).numpy()
    close(got, want)


@pytest.mark.parametrize("shape,k", [((50,), 11), ((30, 3), 11), ((7, 2), 11),
                                     ((4,), 9), ((21, 4), 3)])
def test_median_filter_matches_gaitlab(shape, k):
    """Includes kernels longer than the sequence (zero padding all over)."""
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    want = np.asarray(jax_filters.median_filter1d(jnp.asarray(x), k))
    got = pt_filters.median_filter1d(torch.from_numpy(x), k).numpy()
    close(got, want)
    if x.ndim == 1:
        close(got, medfilt(x, k))
    with pytest.raises(ValueError, match="odd"):
        pt_filters.median_filter1d(torch.from_numpy(x), 4)


@pytest.mark.parametrize("n,sigma", [(50, 3.0), (50, 8.0), (12, 8.0),
                                     (3, 2.0), (1, 8.0)])
def test_gaussian_filter_matches_gaitlab_at_the_edges(n, sigma):
    """scipy's "reflect" repeats the edge sample (numpy's "symmetric"); a
    radius longer than the sequence reflects again and again. torch's
    F.pad(mode="reflect") would drop the edge sample and fail here."""
    x = np.random.default_rng(4).normal(size=(n, 3)).astype(np.float32)
    x += np.linspace(0, 5, n, dtype=np.float32)[:, None]  # a trend to reflect
    want = np.asarray(jax_filters.gaussian_filter1d(jnp.asarray(x), sigma))
    got = pt_filters.gaussian_filter1d(torch.from_numpy(x), sigma).numpy()
    close(got, want)
    ref = np.stack([scipy_gaussian(x[:, i], sigma) for i in range(3)], 1)
    close(got, ref, rtol=1e-5, atol=1e-5, what="scipy")
    got1 = pt_filters.gaussian_filter1d(torch.from_numpy(x[:, 0]), sigma)
    close(got1.numpy(), want[:, 0])


def test_reflect_index_is_numpy_symmetric():
    for n, r in ((5, 2), (5, 5), (3, 10), (1, 4)):
        want = np.pad(np.arange(n), r, mode="symmetric")
        np.testing.assert_array_equal(
            pt_filters._reflect_index(n, r).numpy(), want)


def test_smooth_bbox_params_matches_gaitlab():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(60, 3)).astype(np.float32) * 5 + 100).cumsum(0)
    want = jax_filters.smooth_bbox_params(x, kernel_size=11, sigma=8)
    got = pt_filters.smooth_bbox_params(x, kernel_size=11, sigma=8)
    assert got.dtype == np.float32 and got.shape == (60, 3)
    # values of ~6000: 1e-6 of the largest magnitude, a few float32 ulps
    close(got, want, rtol=0, atol=TOL * np.abs(want).max())


def _pose_seq(layout: str, T: int = 12):
    rng = np.random.default_rng(6)
    betas = (rng.normal(size=(T, 10)) * 0.03).astype(np.float32)
    aa = (rng.normal(size=(T, 24, 3)) * 0.2).cumsum(0) * 0.3
    if layout == "axisang":
        return aa.reshape(T, 72).astype(np.float32), betas
    q = rng.normal(size=(T, 24, 4))
    q[..., 0] = np.abs(q[..., 0]) + 1.0
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q.reshape(T, 96).astype(np.float32), betas


@pytest.mark.parametrize("layout,kinectv2", [("axisang", False),
                                             ("quater", False),
                                             ("axisang", True)])
def test_smooth_pose_matches_gaitlab(layout, kinectv2):
    pose, betas = _pose_seq(layout)
    want = jax_smoothing.smooth_pose(pose, betas, min_cutoff=0.004, beta=0.7,
                                     kinectv2=kinectv2)
    got = pt_smoothing.smooth_pose(pose, betas, min_cutoff=0.004, beta=0.7,
                                   kinectv2=kinectv2, device="cpu")
    verts, pose_hat, joints = got
    assert verts.shape == (12, 6890, 3)
    assert pose_hat.shape == pose.shape
    assert joints.shape == ((12, 25, 3) if kinectv2 else (12, 29, 3))
    np.testing.assert_array_equal(pose_hat[0], pose[0])
    close(pose_hat, want[1], what="pose_hat")
    close(verts, want[0], SMPL_RTOL, SMPL_ATOL, "verts")
    close(joints, want[2], SMPL_RTOL, SMPL_ATOL, "joints3d")


def test_smooth_pose_runs_where_its_smpl_tensors_are():
    """With SMPL tensors given, their device decides; without them the
    default device is the card, which raises here rather than fall back."""
    from gaitlab_torch.body import smpl as pt_smpl

    pose, betas = _pose_seq("axisang", T=5)
    got = pt_smoothing.smooth_pose(pose, betas,
                                   smpl_params=pt_smpl.synthetic_smpl_params())
    ref = pt_smoothing.smooth_pose(pose, betas, device="cpu")
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="Invalid pred_pose"):
        pt_smoothing.smooth_pose(pose[:, :70], betas, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt_smoothing.smooth_pose(pose, betas)
