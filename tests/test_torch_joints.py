"""gaitlab_torch.body.joints' flip helpers against gaitlab's
(get_perm_idxs, get_left_right_index, keypoint_hflip): exact equality."""

import numpy as np
import pytest

from gaitlab.body import joints as jax_joints
from gaitlab_torch.body import joints as pt_joints
from torch_threads import torch_threads  # noqa: F401

FORMATS = ["spin", "spin2", "kinectv2", "common", "smpl", "coco"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_left_right_index_matches(fmt):
    assert pt_joints.get_left_right_index(fmt) == \
        jax_joints.get_left_right_index(fmt)


@pytest.mark.parametrize("src,dst", [("spin", "common"), ("spin2", "kinectv2"),
                                     ("coco", "spin"), ("smpl", "spin2")])
def test_perm_idxs_match(src, dst):
    got = pt_joints.get_perm_idxs(src, dst)
    assert got == jax_joints.get_perm_idxs(src, dst)
    names = pt_joints.get_joint_names(src)
    assert [names[i] for i in got] == [
        n for n in pt_joints.get_joint_names(dst) if n in names]


def test_keypoint_hflip_matches():
    x = np.random.default_rng(1).uniform(0, 100, size=(4, 10, 3))
    got = pt_joints.keypoint_hflip(x, 224)
    np.testing.assert_array_equal(got, jax_joints.keypoint_hflip(x, 224))
    assert not np.shares_memory(got, x)
    np.testing.assert_array_equal(got[..., 1:], x[..., 1:])
