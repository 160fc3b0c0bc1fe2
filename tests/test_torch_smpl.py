"""gaitlab_torch.body (SMPL, joint formats) against gaitlab.body.

The port's `lbs` always takes the kernel-structured path (blendshapes,
plus rest joints from the regressor folded through shapedirs). It is held
against both of gaitlab's paths: `use_pallas=False` (v_shaped built, then
regressed), at the tolerance test_pallas_ops.py allows between gaitlab's
own two paths, 2e-4 relative / 2e-5 absolute; and `use_pallas=True` (the
Pallas kernel in interpret mode), the same structure, at the same
tolerance.
"""

import os
import pickle
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaitlab.body import joints as jax_joints
from gaitlab.body import smpl as jax_smpl
from gaitlab.core import geometry as jax_geometry
from gaitlab_torch.body import joints as pt_joints
from gaitlab_torch.body import smpl as pt_smpl

RTOL, ATOL = 2e-4, 2e-5
MODES = ("smpl24", "smplx45", "spin2", "spin")


@pytest.fixture(scope="module")
def params():
    return jax_smpl.synthetic_smpl_params(), pt_smpl.synthetic_smpl_params()


@pytest.fixture(scope="module")
def pose():
    rng = np.random.default_rng(11)
    b = 3
    betas = (rng.normal(size=(b, 10)) * 0.5).astype(np.float32)
    aa = (rng.normal(size=(b * 24, 3)) * 0.3).astype(np.float32)
    rot = np.asarray(jax_geometry.axis_angle_to_rotmat(jnp.asarray(aa))
                     ).reshape(b, 24, 3, 3)
    return betas, aa.reshape(b, 72), rot


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def test_synthetic_params_are_identical(params):
    jp, pp = params
    for name in jax_smpl.SMPLParams._fields:
        a, b = getattr(jp, name), getattr(pp, name)
        if name == "faces":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=name)
    assert pt_smpl.synthetic_smpl_params(with_extra=False
                                         ).J_regressor_extra is None


def test_constants_match():
    for name in ("PARENTS", "EXTRA_VERTEX_IDS", "SPIN49_GATHER",
                 "SPIN2_HAND_GATHER", "THORAX_EXTRA_ROW", "H36M_TO_J14",
                 "NUM_VERTS", "NUM_JOINTS", "NUM_BETAS"):
        assert tuple(np.atleast_1d(getattr(pt_smpl, name))) == tuple(
            np.atleast_1d(getattr(jax_smpl, name))), name


@pytest.mark.parametrize("use_pallas", [False, True])
def test_lbs_matches_both_gaitlab_paths(params, pose, use_pallas):
    jp, pp = params
    betas, _, rot = pose
    # gaitlab's Pallas kernel runs in interpret mode on the CPU backend
    v0, j0 = jax.jit(lambda b, r: jax_smpl.lbs(jp, b, r,
                                               use_pallas=use_pallas))(
        betas, rot)
    v1, j1 = pt_smpl.lbs(pp, torch.from_numpy(betas), torch.from_numpy(rot))
    close(v1, v0, "verts")
    close(j1, j0, "joints")


@pytest.mark.parametrize("mode", MODES)
def test_smpl_forward_joint_modes(params, pose, mode):
    jp, pp = params
    betas, _, rot = pose
    want = jax.jit(lambda b, r: jax_smpl.smpl_forward(jp, b, r, mode))(
        betas, rot)
    got = pt_smpl.smpl_forward(pp, torch.from_numpy(betas),
                               torch.from_numpy(rot), mode)
    n_joints = {"smpl24": 24, "smplx45": 45, "spin2": 29, "spin": 49}[mode]
    assert got["joints"].shape == (3, n_joints, 3)
    close(got["vertices"], want["vertices"], "vertices")
    close(got["joints"], want["joints"], "joints")


def test_smpl_forward_needs_extra_regressor(pose):
    pp = pt_smpl.synthetic_smpl_params(with_extra=False)
    betas, _, rot = pose
    with pytest.raises(ValueError, match="J_regressor_extra"):
        pt_smpl.smpl_forward(pp, torch.from_numpy(betas),
                             torch.from_numpy(rot), "spin2")
    with pytest.raises(ValueError, match="unknown joint_mode"):
        pt_smpl.smpl_forward(pt_smpl.synthetic_smpl_params(),
                             torch.from_numpy(betas), torch.from_numpy(rot),
                             "coco")


def test_smpl_forward_axis_angle(params, pose):
    jp, pp = params
    betas, aa, _ = pose
    want = jax_smpl.smpl_forward_axis_angle(jp, jnp.asarray(betas),
                                            jnp.asarray(aa))
    got = pt_smpl.smpl_forward_axis_angle(pp, torch.from_numpy(betas),
                                          torch.from_numpy(aa))
    close(got["vertices"], want["vertices"])
    close(got["joints"], want["joints"])


@pytest.mark.parametrize("normalize", [False, True])
def test_smpl_head(params, pose, normalize):
    jp, pp = params
    betas, _, rot = pose
    cam = np.array([[0.9, 0.1, -0.2], [1.2, 0.0, 0.1], [0.7, -0.3, 0.3]],
                   np.float32)
    want = jax.jit(lambda b, r, c: jax_smpl.smpl_head(
        jp, r, b, cam=c, normalize_joints2d=normalize))(betas, rot, cam)
    got = pt_smpl.smpl_head(pp, torch.from_numpy(rot), torch.from_numpy(betas),
                            cam=torch.from_numpy(cam),
                            normalize_joints2d=normalize)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], k)
    no_cam = pt_smpl.smpl_head(pp, torch.from_numpy(rot),
                               torch.from_numpy(betas))
    assert "smpl_joints2d" not in no_cam


def test_load_smpl_params_pickle_and_npz(params):
    """A model file in the official layout (posedirs (V,3,207), `weights`,
    `f`) loads to the same tensors in both packages, from .pkl and .npz,
    from the file or its folder; then the extra regressor attaches."""
    jp, _ = params
    data = {"v_template": np.asarray(jp.v_template, np.float64),
            "shapedirs": np.asarray(jp.shapedirs, np.float64),
            "posedirs": np.asarray(jp.posedirs).T.reshape(6890, 3, 207),
            "J_regressor": np.asarray(jp.J_regressor, np.float64),
            "weights": np.asarray(jp.lbs_weights, np.float64),
            "f": jp.faces}
    with tempfile.TemporaryDirectory() as d:
        pkl = os.path.join(d, "SMPL_NEUTRAL.pkl")
        with open(pkl, "wb") as f:
            pickle.dump(data, f)
        npz = os.path.join(d, "other", "SMPL_NEUTRAL.npz")
        os.makedirs(os.path.dirname(npz))
        np.savez(npz, **data)
        extra = os.path.join(d, "J_regressor_extra.npy")
        np.save(extra, np.asarray(jp.J_regressor_extra))
        for path in (pkl, d, npz):
            want = jax_smpl.load_smpl_params(path)
            got = pt_smpl.load_smpl_params(path)
            for name in ("v_template", "shapedirs", "posedirs",
                         "J_regressor", "lbs_weights"):
                np.testing.assert_array_equal(
                    getattr(got, name).numpy(),
                    np.asarray(getattr(want, name)), err_msg=name)
            np.testing.assert_array_equal(got.faces, want.faces)
        got = pt_smpl.with_extra_regressor(got, extra)
    np.testing.assert_array_equal(got.J_regressor_extra.numpy(),
                                  np.asarray(jp.J_regressor_extra))


def test_params_to_device(params):
    _, pp = params
    moved = pp.to("cpu")
    assert all(t.device.type == "cpu" for t in moved
               if isinstance(t, torch.Tensor))
    assert moved.faces is pp.faces


@pytest.mark.parametrize("dst", ["spin", "coco", "common", "h36m", "smplcoco",
                                 "mpii"])
def test_convert_kps_matches(rng, dst):
    x = rng.normal(size=(4, 29, 3)).astype(np.float32)
    np.testing.assert_array_equal(pt_joints.convert_kps(x, "spin2", dst),
                                  jax_joints.convert_kps(x, "spin2", dst))


def test_joint_tables_match():
    assert pt_joints.JOINT_FORMATS.keys() == jax_joints.JOINT_FORMATS.keys()
    for fmt in jax_joints.JOINT_FORMATS:
        assert pt_joints.get_joint_names(fmt) == jax_joints.get_joint_names(fmt)
    with pytest.raises(KeyError):
        pt_joints.convert_kps(np.zeros((1, 29, 3)), "spin2", "nope")
