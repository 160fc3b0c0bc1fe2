"""gaitlab_torch.core.geometry against gaitlab.core.geometry on random
inputs drawn with numpy from a seed.

Tolerance 1e-5 relative / 1e-6 absolute: each function is the same short
chain of float32 operations in both packages; only the rounding of
library transcendentals and of reductions differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaitlab.core import geometry as jg
from gaitlab_torch.core import geometry as pg

RTOL, ATOL = 1e-5, 1e-6


def both(fn_name, *arrays, **kw):
    def conv(to):
        return [to(a) if isinstance(a, np.ndarray) else a for a in arrays]

    j = getattr(jg, fn_name)(*conv(jnp.asarray), **kw)
    p = getattr(pg, fn_name)(*conv(torch.from_numpy), **kw)
    return np.asarray(j), p.numpy()


def close(fn_name, *arrays, rtol=RTOL, atol=ATOL, **kw):
    want, got = both(fn_name, *arrays, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=fn_name)


def rotations(rng, n):
    aa = (rng.normal(size=(n, 3)) * 0.8).astype(np.float32)
    return np.asarray(jg.axis_angle_to_rotmat(jnp.asarray(aa)))


def test_axis_angle_quat_rotmat(rng):
    aa = (rng.normal(size=(64, 3)) * 0.8).astype(np.float32)
    aa[0] = 0.0  # the 1e-8 shift of the norm
    close("axis_angle_to_quat", aa)
    close("axis_angle_to_rotmat", aa)
    close("batch_rodrigues", aa)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    close("quat_to_rotmat", q)
    close("quat_to_axis_angle", q / np.linalg.norm(q, axis=-1,
                                                    keepdims=True))
    q[:4, 1:] = 0.0  # zero rotation: the k = 2 branch
    close("quat_to_axis_angle", q)


def test_rotmat_to_quat_and_axis_angle(rng):
    r = rotations(rng, 128)
    close("rotmat_to_quat", r)
    close("rotmat_to_axis_angle", r, rtol=1e-4, atol=1e-5)
    # a (N,3,4) input is read through its rotation block
    r34 = np.concatenate([r, rng.normal(size=(128, 3, 1)).astype(np.float32)],
                         axis=-1)
    close("rotmat_to_quat", r34)
    # the four Shepperd cases: rotations by pi about x, y, z, and identity
    special = np.stack([np.diag([1, -1, -1]), np.diag([-1, 1, -1]),
                        np.diag([-1, -1, 1]), np.eye(3)]).astype(np.float32)
    close("rotmat_to_quat", special)
    close("rotmat_to_axis_angle", special)


def test_rotmat_to_axis_angle_zeroes_nans():
    bad = np.full((2, 3, 3), np.nan, np.float32)
    want, got = both("rotmat_to_axis_angle", bad)
    assert np.all(got == 0) and np.all(want == 0)


@pytest.mark.parametrize("fn", ["rot6d_to_rotmat", "rot6d_to_rotmat_spin"])
def test_rot6d(rng, fn):
    x = rng.normal(size=(50, 6)).astype(np.float32)
    x[0] = 0.0  # the eps clamp of the normalisation
    x[1, ::2] = 1e-7
    close(fn, x)


def test_rotmat_to_rot6d(rng):
    close("rotmat_to_rot6d", rotations(rng, 10))


def test_quaternion_algebra(rng):
    q = rng.normal(size=(20, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    r = rng.normal(size=(20, 4)).astype(np.float32)
    v = rng.normal(size=(20, 3)).astype(np.float32)
    close("qmul", q, r)
    close("qrot", q, v)
    seq = rng.normal(size=(30, 5, 4)).astype(np.float32)
    close("qfix", seq)


def test_cameras(rng):
    cam = np.abs(rng.normal(size=(8, 3))).astype(np.float32) + 0.5
    close("convert_weak_perspective_to_perspective", cam)
    close("convert_weak_perspective_to_perspective", cam,
          focal_length=1000.0, img_res=256)
    pts = rng.normal(size=(8, 29, 3)).astype(np.float32)
    rot = rotations(rng, 8)
    t = np.concatenate([rng.normal(size=(8, 2)),
                        rng.uniform(20, 40, size=(8, 1))], 1).astype(np.float32)
    center = rng.normal(size=(8, 2)).astype(np.float32)
    close("perspective_projection", pts, rot, t, 5000.0, center, rtol=2e-5)
    close("projection", pts, cam, rtol=2e-5)


def test_estimate_translation(rng):
    s = rng.normal(size=(4, 49, 3)).astype(np.float32) * 0.3
    s[..., 2] += 5.0
    j2d = np.concatenate([rng.uniform(0, 224, size=(4, 49, 2)),
                          rng.uniform(0.1, 1.0, size=(4, 49, 1))],
                         -1).astype(np.float32)
    close("estimate_translation_single", s[0, 25:], j2d[0, 25:, :2],
          j2d[0, 25:, 2], rtol=1e-3, atol=1e-3)
    # a least-squares solve of an ill-conditioned 3x3 system: float32
    # rounding in the normal equations differs between the two libraries
    close("estimate_translation", s, j2d, rtol=1e-3, atol=1e-3)


def test_every_public_function_is_ported():
    import inspect

    public = {n for n, f in vars(jg).items()
              if inspect.isfunction(f) and not n.startswith("_")
              and f.__module__ == jg.__name__}
    assert public <= set(dir(pg)), sorted(public - set(dir(pg)))
