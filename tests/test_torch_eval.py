"""gaitlab_torch.eval against gaitlab.eval on the CPU.

Random skeletons and their rotated, scaled, shifted and noisy copies, and
a mirrored copy (the case the SVD's reflection fix exists for), go through
both packages in float32. Tolerance: rtol 1e-5, atol 1e-6 of each metric
(the same float32 arithmetic, a 3x3 SVD taken by two libraries).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaitlab import eval as jax_eval
from gaitlab_torch import eval as pt_eval
from test_torch_models import assert_close
from torch_threads import torch_threads  # noqa: F401


def rotation(rng) -> np.ndarray:
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def skeletons(seed: int = 0, b: int = 5, j: int = 29, mirror: bool = False):
    """(pred, gt): gt random, pred a similarity transform of it with noise;
    with `mirror`, pred's x axis flipped (an improper transform)."""
    rng = np.random.default_rng(seed)
    gt = rng.normal(size=(b, j, 3)) * 0.3
    pred = np.stack([1.1 * g @ rotation(rng).T + rng.normal(size=3)
                     for g in gt]) + rng.normal(size=gt.shape) * 0.01
    if mirror:
        pred[..., 0] *= -1
    return pred.astype(np.float32), gt.astype(np.float32)


def both(name: str, *args, **kw):
    want = np.asarray(getattr(jax_eval, name)(*map(jnp.asarray, args), **kw))
    got = getattr(pt_eval, name)(*map(torch.from_numpy, args), **kw).numpy()
    return got, want


@pytest.mark.parametrize("mirror", [False, True], ids=["proper", "reflected"])
def test_procrustes_and_pa_mpjpe_match(mirror):
    pred, gt = skeletons(1, mirror=mirror)
    got, want = both("procrustes_align", pred, gt)
    assert_close(got, want, rtol=1e-5, atol=1e-6, what="aligned")
    got, want = both("pa_mpjpe", pred, gt)
    assert_close(got, want, rtol=1e-5, atol=1e-6, what="pa_mpjpe")
    if mirror:  # no rotation undoes a reflection
        assert got.min() > 0.05
    else:
        assert got.max() < 0.05


@pytest.mark.parametrize("pelvis", [None, 0, [2, 3]])
def test_mpjpe_matches(pelvis):
    pred, gt = skeletons(2)
    got, want = both("mpjpe", pred, gt, pelvis_idx=pelvis)
    assert got.shape == (5,)
    assert_close(got, want, rtol=1e-5, atol=1e-6, what="mpjpe")


def test_pve_and_accel_error_match():
    rng = np.random.default_rng(3)
    pv, gv = (rng.normal(size=(2, 300, 3)).astype(np.float32)
              for _ in range(2))
    got, want = both("pve", pv, gv)
    assert_close(got, want, rtol=1e-5, atol=1e-6, what="pve")
    seq, ref = (np.cumsum(rng.normal(size=(12, 29, 3)), 0).astype(np.float32)
                for _ in range(2))
    got, want = both("accel_error", seq, ref, fps=20.0)
    assert got.shape == (10,)
    assert_close(got, want, rtol=1e-5, atol=1e-6, what="accel_error")


@pytest.mark.parametrize("verts", [False, True])
def test_evaluate_batch_matches(verts):
    pred, gt = skeletons(4, mirror=True)
    rng = np.random.default_rng(5)
    pv, gv = (rng.normal(size=(5, 50, 3)).astype(np.float32)
              for _ in range(2))
    extra = (pv, gv) if verts else ()
    want = jax_eval.evaluate_batch(*map(jnp.asarray, (pred, gt) + extra))
    got = pt_eval.evaluate_batch(*map(torch.from_numpy, (pred, gt) + extra))
    assert set(got) == set(want) == ({"mpjpe", "pa_mpjpe", "pve"} if verts
                                     else {"mpjpe", "pa_mpjpe"})
    for k in want:
        assert isinstance(got[k], float)
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
