"""gaitlab_torch's legacy HMR (nn/resnet.py, nn/spin.py) against gaitlab's:
ResNet feature shapes, ResNet-50, the HMR forward, the regressor head with
SMPL, and render/vis.py::regressor_output_from_features, on the same
weights.

The weights are the port's random init read into gaitlab's variable tree
by gaitlab's own importer, with random BN statistics and affine terms set
on the gaitlab side (as test_torch_models.tiny_pair does for GRNet); the
port takes them back through weights.convert.hmr_state_dict_from_flax.
Both packages run float32 on the CPU (gaitlab under
jax.default_matmul_precision("float32")) on 64-pixel crops, and are held to
test_torch_models.assert_outputs_close's tolerances (rtol 1e-4, atol 2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaitlab.body import smpl as jax_smpl
from gaitlab.nn import resnet as jax_resnet
from gaitlab.nn import spin as jax_spin
from gaitlab.render import vis as jax_vis
from gaitlab.weights import torch_import as jax_torch_import
from gaitlab_torch.nn import resnet as pt_resnet
from gaitlab_torch.nn import spin as pt_spin
from gaitlab_torch.render import vis as pt_vis
from gaitlab_torch.weights.convert import hmr_state_dict_from_flax
from test_torch_models import _randomise_stats, assert_close, \
    assert_outputs_close
from torch_threads import torch_threads  # noqa: F401

CROP = 64


def gaitlab_variables(module, port_module, *init_args):
    """gaitlab variables with the port module's weights and random BN
    statistics and affine terms."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args)
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      dict(shapes))
    variables, missing, _ = jax_torch_import.flax_tree_from_torch(
        port_module.state_dict(), template, strict=True)
    assert missing == []
    return _randomise_stats(variables, seed=5)


def crops(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, CROP, CROP, 3)).astype(np.float32)


@pytest.mark.parametrize("name,feat", [("resnet18", 512), ("resnet34", 512),
                                       ("resnet50", 2048)])
def test_resnet_feature_shapes(name, feat):
    net = getattr(pt_resnet, name)().eval()
    x = torch.from_numpy(crops(2)).permute(0, 3, 1, 2)
    with torch.no_grad():
        pooled, spatial = net(x, return_spatial=True)
    assert pooled.shape == (2, feat) and net.out_features == feat
    assert spatial.shape == (2, feat, CROP // 32, CROP // 32)


@pytest.fixture(scope="module")
def hmr_pair():
    """(gaitlab HMR bundle, the port's HMR on the CPU), same weights and
    synthetic SMPL."""
    port = pt_spin.HMR.create(device="cpu", seed=2)
    module = jax_spin.HMRCore()
    p, s, c = jax_spin.default_init_params(1)
    variables = gaitlab_variables(module, port.module,
                                  jnp.zeros((1, CROP, CROP, 3)), p, s, c)
    port.module.load_state_dict(hmr_state_dict_from_flax(variables),
                                strict=True)
    jax_hmr = jax_spin.HMR(module, variables, jax_smpl.synthetic_smpl_params())
    return jax_hmr, port


def test_resnet50_matches(hmr_pair):
    jax_hmr, port = hmr_pair
    x = crops(2, seed=1)
    bb = {k: v["backbone"] for k, v in jax_hmr.variables.items()}
    with jax.default_matmul_precision("float32"):
        want = jax_resnet.resnet50().apply(bb, jnp.asarray(x))
    with torch.no_grad():
        got = port.module.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert_close(got.numpy(), np.asarray(want), rtol=1e-4, atol=2e-5,
                 what="resnet50 features")


def test_hmr_forward_matches(hmr_pair):
    jax_hmr, port = hmr_pair
    x = crops(2, seed=2)
    with jax.default_matmul_precision("float32"):
        want = jax.jit(lambda v, x: jax_spin.HMR(
            jax_hmr.module, v, jax_hmr.smpl).forward(x)[0])(
                jax_hmr.variables, jnp.asarray(x))
    got = port.forward(torch.from_numpy(x))[0]
    assert_outputs_close({k: v.numpy() for k, v in got.items()},
                         {k: np.asarray(v) for k, v in want.items()})


def test_regressor_output_from_features_matches(hmr_pair):
    jax_hmr, port = hmr_pair
    rng = np.random.default_rng(3)
    feats = np.abs(rng.normal(size=(2, 3, 2048))).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want_v, want_c = jax_vis.regressor_output_from_features(
            feats, hmr=jax_hmr)
    got_v, got_c = pt_vis.regressor_output_from_features(feats, hmr=port)
    assert got_v.shape == (2, 3, 6890, 3) and got_c.shape == (2, 3, 3)
    assert_close(got_v, want_v, rtol=1e-4, atol=2e-5, what="verts")
    assert_close(got_c, want_c, rtol=1e-4, atol=2e-5, what="cam")


def test_default_init_params_match():
    mean = {"pose": np.linspace(-1, 1, 144, dtype=np.float32),
            "shape": np.arange(10, dtype=np.float64),
            "cam": np.float32([0.8, 0.1, -0.1])}
    for mp in (None, mean):
        for g, w in zip(pt_spin.default_init_params(3, mp),
                        jax_spin.default_init_params(3, mp)):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_hmr_default_device_is_the_card():
    """Without device= the HMR (and so regressor_output_from_features
    without an hmr) runs on the card, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt_vis.regressor_output_from_features(np.zeros((1, 1, 2048),
                                                       np.float32))
