"""gaitlab_torch's gait branch against gaitlab's: the token-major
LocallyConnected, BiGRU, positional encoding, TSAttention, TSAttnBlock,
FeatCorrector, camera_reparam, the converter of the 'pfeat_corrector'
subtree, and the gait GRNet.forward.

Both packages run on the CPU in float32. gaitlab's parameters are drawn
with numpy from a seed into the shapes of its Flax init (cheaper than a
traced init): kernels scaled by 1/sqrt(fan-in), and every bias and
LayerNorm scale random too (Flax initialises them to 0 and 1, which would
hide a swapped or dropped leaf). They reach the port through
gaitlab_torch.weights.convert.gait_state_dict_from_flax.

Tolerances: the same float32 products summed in other orders (XLA:CPU
against ATen/oneDNN), through a GRU of up to 2 layers and one attention
block: outputs agree within `atol + rtol * max|want|` with rtol 1e-4,
atol 1e-5 (module tests) and test_torch_models.assert_outputs_close for
the whole model. With `seq_lengths`, only real frames are compared: the
port's GRU leaves zeros at padded frames, gaitlab's GRU does not, and
nothing reads them.

The helpers `gait_pair` and `jax_gait_forward` are shared by the other
test_torch_* files of the gait branch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaitlab.body import smpl as jax_smpl
from gaitlab.nn import gait as jg
from gaitlab.nn import layers as jax_layers
from gaitlab.nn.grnet import GRNetCore as JaxGRNetCore
from gaitlab.nn.grnet import vp_regress as jax_vp_regress
from gaitlab_torch.nn import gait as pg
from gaitlab_torch.nn.grnet import GRNet as PtGRNet
from gaitlab_torch.nn.layers import LocallyConnected
from gaitlab_torch.weights.convert import (gait_state_dict_from_flax,
                                           state_dict_from_flax)
from test_torch_models import (TINY, assert_close, assert_outputs_close,
                               tiny_pair)

GAIT = dict(use_gait_feat=True, featcorr_h_size=64)


def flax_init(module, seed: int, *args):
    """Random parameters in the shapes of `module.init(key, *args)`."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def leaf(path, s):
        name = path[-1].key
        parent = path[-2].key if len(path) > 1 else ""
        if name == "bias":
            return (rng.normal(size=s.shape) * 0.1).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        # kernels (I,O), attention (I,H,D) and (H,D,O), LC weight (J,I,O)
        fan_in = (s.shape[1] if name == "weight"
                  else s.shape[0] * s.shape[1] if parent == "out"
                  and len(s.shape) == 3 else s.shape[0])
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes["params"])


def port_module(module: torch.nn.Module, params, prefix=None):
    """Load converted params into a port module (strict), in eval mode."""
    tree = params if prefix is None else {prefix: params}
    sd, _ = gait_state_dict_from_flax(tree)
    if prefix is not None:
        sd = {k[len(prefix) + 1:]: v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def run(module, *args, **kw):
    with torch.no_grad():
        return module(*(torch.from_numpy(np.asarray(a)) if isinstance(
            a, np.ndarray) else a for a in args), **kw)


@pytest.mark.parametrize("bias", [False, True])
def test_locally_connected_matches(bias):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    lc = jax_layers.LocallyConnected(num_tokens=5, features=6, use_bias=bias)
    params = flax_init(lc, 0, jnp.asarray(x))
    want = np.asarray(lc.apply({"params": params}, jnp.asarray(x)))
    got = run(port_module(LocallyConnected(5, 4, 6, bias), params), x)
    assert_close(got.numpy(), want, rtol=1e-5, atol=1e-6, what="lc")


@pytest.mark.parametrize("lengths", [None, [9, 5, 2]], ids=["full", "ragged"])
def test_bigru_matches(lengths):
    b, t, d, h = 3, 9, 12, 5
    x = np.random.default_rng(1).normal(size=(b, t, d)).astype(np.float32)
    seq = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    gru = jg.BiGRU(hidden_size=h, num_layers=2)
    params = flax_init(gru, 1, jnp.asarray(x), seq)
    out_w, fin_w = gru.apply({"params": params}, jnp.asarray(x),
                             seq_lengths=seq)
    port = port_module(pg.BiGRU(d, h, 2), params, prefix="rnn")
    out_g, fin_g = run(port, x, lengths)
    assert fin_g.shape == (b, 2 * 2 * h)
    assert_close(fin_g.numpy(), fin_w, rtol=1e-4, atol=1e-5, what="finals")
    for i, n in enumerate(lengths or [t] * b):
        assert_close(out_g[i, :n].numpy(), np.asarray(out_w)[i, :n],
                     rtol=1e-4, atol=1e-5, what=f"outputs {i}")


def test_positional_encoding_matches():
    want = np.asarray(jg.positional_encoding(20, 32))
    got = pg.positional_encoding(20, 32).numpy()
    assert_close(got, want, rtol=1e-6, atol=1e-6, what="pe")
    x = np.random.default_rng(2).normal(size=(2, 20, 32)).astype(np.float32)
    assert_close(pg.add_positional_encoding(torch.from_numpy(x)).numpy(),
                 np.asarray(jg.add_positional_encoding(jnp.asarray(x))),
                 rtol=1e-6, atol=1e-6, what="add_pe")


def _tokens(b=2, t=7, nt=5, c=8, seed=3):
    return np.random.default_rng(seed).normal(
        size=(b, t, nt, c)).astype(np.float32)


MASK = np.array([[True] * 7, [True] * 4 + [False] * 3])


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_tsattention_matches(masked):
    x = _tokens()
    mask = MASK if masked else None
    # encode_dim 18 is rounded down to 16 for 4 heads, as in gaitlab
    att = jg.TSAttention(encode_dim=18, num_heads=4)
    params = flax_init(att, 4, jnp.asarray(x),
                       None if mask is None else jnp.asarray(mask))
    want = np.asarray(att.apply({"params": params}, jnp.asarray(x),
                                frame_mask=None if mask is None
                                else jnp.asarray(mask)))
    port = port_module(pg.TSAttention(18, 4, num_tokens=5, feat_dim=8),
                       params)
    got = run(port, x, None if mask is None else torch.from_numpy(mask))
    rows = [7, 4] if masked else [7, 7]
    for i, n in enumerate(rows):
        assert_close(got[i, :n].numpy(), want[i, :n], rtol=1e-4, atol=1e-5,
                     what=f"frames of {i}")


@pytest.mark.parametrize("use_jwff", [False, True], ids=["pwff", "jwff"])
def test_tsattnblock_matches(use_jwff):
    x = _tokens(seed=5)
    blk = jg.TSAttnBlock(encode_dim=16, num_heads=4, use_jwff=use_jwff,
                         num_tokens=5)
    params = flax_init(blk, 5, jnp.asarray(x), jnp.asarray(MASK))
    want = np.asarray(blk.apply({"params": params}, jnp.asarray(x),
                                frame_mask=jnp.asarray(MASK)))
    port = port_module(pg.TSAttnBlock(16, 4, use_jwff, 5, 8), params)
    got = run(port, x, torch.from_numpy(MASK))
    for i, n in enumerate([7, 4]):
        assert_close(got[i, :n].numpy(), want[i, :n], rtol=1e-4, atol=1e-5,
                     what=f"frames of {i}")


def _corrector_inputs(b=2, t=10, j=24, c=16, seed=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, j, c)).astype(np.float32)
    cp = (rng.normal(size=(b, t, 3)) * 0.5).astype(np.float32)
    return x, cp


@pytest.mark.parametrize("use_jwff,lengths", [
    (False, None), (False, [10, 6]), (True, [7, 10])],
    ids=["pwff-full", "pwff-ragged", "jwff-ragged"])
def test_feat_corrector_matches(use_jwff, lengths):
    x, cp = _corrector_inputs()
    seq = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    fc = jg.FeatCorrector(num_joints=24, feat_dim=16, h_size=64, num_heads=4,
                          use_jwff=use_jwff)
    params = flax_init(fc, 7, jnp.asarray(x), jnp.asarray(cp), seq)
    corr_w, avg_w, phase_w = fc.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(cp), seq_lengths=seq)
    port = port_module(pg.FeatCorrector(24, 16, h_size=64, num_heads=4,
                                        use_jwff=use_jwff), params)
    corr_g, avg_g, phase_g = run(port, x, cp, lengths)
    assert_close(avg_g.numpy(), avg_w, rtol=1e-4, atol=1e-5, what="pred_avg")
    for i, n in enumerate(lengths or [10, 10]):
        assert_close(phase_g[i, :n].numpy(), np.asarray(phase_w)[i, :n],
                     rtol=1e-4, atol=1e-5, what=f"pred_phase {i}")
        assert_close(corr_g[i, :n].numpy(), np.asarray(corr_w)[i, :n],
                     rtol=1e-4, atol=1e-5, what=f"corrected {i}")


def test_camera_reparam_matches():
    rng = np.random.default_rng(8)
    cam = (rng.normal(size=(6, 3)) * 0.1 + [0.9, 0, 0]).astype(np.float32)
    bbox = (np.abs(rng.normal(size=(6, 4))) * 100 + 100).astype(np.float32)
    cimg = np.full((6, 2), 160.0, np.float32)
    want = np.asarray(jg.camera_reparam(*map(jnp.asarray, (cam, bbox, cimg))))
    got = pg.camera_reparam(*map(torch.from_numpy, (cam, bbox, cimg)))
    assert_close(got.numpy(), want, rtol=1e-6, atol=1e-6, what="cparams")


@pytest.mark.parametrize("use_jwff", [False, True], ids=["pwff", "jwff"])
def test_converter_maps_every_leaf_once(use_jwff):
    """Every gaitlab leaf of a FeatCorrector lands in exactly one key of the
    port's state_dict, and the port's keys are exactly its module's."""
    x, cp = _corrector_inputs(b=1, t=4, c=8)
    fc = jg.FeatCorrector(feat_dim=8, h_size=16, num_heads=4,
                          use_jwff=use_jwff)
    params = flax_init(fc, 0, jnp.asarray(x), jnp.asarray(cp))
    sd, sources = gait_state_dict_from_flax(params)
    leaves = [tuple(str(p.key) for p in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(params)[0]]
    used = [leaf for srcs in sources.values() for leaf in srcs]
    assert sorted(used) == sorted(leaves)  # each leaf once, none left out
    port = pg.FeatCorrector(feat_dim=8, h_size=16, num_heads=4,
                            use_jwff=use_jwff)
    own = port.state_dict()
    assert set(sd) == set(own)
    for k, v in own.items():
        assert sd[k].shape == v.shape, k
    # GRU: the hidden biases of the r and z gates are zero (Flax has none)
    h = 300
    for k in (k for k in sd if k.startswith("featnet.rnn.bias_hh")):
        assert torch.count_nonzero(sd[k][:2 * h]) == 0


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def gait_pair(seed: int = 0, **overrides):
    """(gaitlab GRNetCore with the gait branch, its variables, the port's
    GRNet on the CPU with the same weights). The trunk's weights come from
    test_torch_models.tiny_pair, with the camera MLP scaled to the
    magnitudes of a trained model (so that camera_reparam does not divide
    by a scale near 0); the corrector's from a Flax init with random
    biases and scales."""
    cfg = {**GAIT, **overrides}
    module = JaxGRNetCore(**TINY, **cfg)
    _, trunk, _ = tiny_pair(seed)
    trunk = jax.tree_util.tree_map(np.asarray, trunk)
    cam = trunk["params"]["head"]["cam_mlp"]
    cam["kernel"] = cam["kernel"] * 0.02
    cam["bias"] = np.array([0.9, 0.0, 0.0], np.float32)
    x, cp = _corrector_inputs(b=1, t=4, c=TINY["num_features_pare"])
    fc = jg.FeatCorrector(feat_dim=TINY["num_features_pare"],
                          num_layers=module.featcorr_num_layers,
                          h_size=module.featcorr_h_size,
                          num_heads=module.featcorr_num_heads,
                          use_jwff=module.featcorr_use_jwff)
    trunk["params"]["pfeat_corrector"] = flax_init(
        fc, seed + 11, jnp.asarray(x), jnp.asarray(cp))
    port = PtGRNet.create(device="cpu", **TINY, **cfg)
    port.module.load_state_dict(state_dict_from_flax(trunk), strict=True)
    return module, trunk, port


_JAX_GAIT = {}


def jax_gait_forward(module, variables, crops, bbox, cimg, n_valid=None):
    """gaitlab's gait trunk + vp_regress in float32 on NHWC crops with
    synthetic SMPL (the runner's call, n_valid included)."""
    if module not in _JAX_GAIT:
        smpl = jax_smpl.synthetic_smpl_params()
        _JAX_GAIT[module] = jax.jit(
            lambda v, x, bb, ci, nv: jax_vp_regress(smpl, module.apply(
                v, x, bbox=bb, cimg=ci, n_valid=nv))[0])
    with jax.default_matmul_precision("float32"):
        out = _JAX_GAIT[module](variables, crops, bbox, cimg,
                                None if n_valid is None else np.int32(n_valid))
    return {k: np.asarray(v) for k, v in out.items()}


def gait_inputs(n: int, seed: int = 9):
    rng = np.random.default_rng(seed)
    crops = rng.normal(size=(n, 64, 64, 3)).astype(np.float32)
    bbox = np.stack([rng.uniform(100, 200, n), rng.uniform(80, 160, n),
                     rng.uniform(120, 180, n), rng.uniform(120, 180, n)],
                    1).astype(np.float32)
    cimg = np.tile(np.float32([160.0, 120.0]), (n, 1))
    return crops, bbox, cimg


@pytest.fixture(scope="module")
def pair():
    return gait_pair()


@pytest.mark.parametrize("n_valid", [None, 4], ids=["all", "padded"])
def test_grnet_gait_forward_matches(pair, n_valid):
    module, variables, port = pair
    crops, bbox, cimg = gait_inputs(6)
    want = jax_gait_forward(module, variables, crops, bbox, cimg, n_valid)
    got = {k: v.numpy() for k, v in port.forward(
        torch.from_numpy(crops), bbox=bbox, cimg=cimg, n_valid=n_valid)[0]
        .items()}
    assert set(got) == set(want)
    assert got["pred_avg"].shape == (1, 3)
    assert got["pred_phase"].shape == (1, 6, 4)
    assert got["pred_cparam"].shape == (6, 3)
    n = 6 if n_valid is None else n_valid
    assert_close(got["pred_avg"], want["pred_avg"], what="pred_avg")
    assert_close(got["pred_cparam"], want["pred_cparam"], what="pred_cparam")
    assert_close(got["pred_phase"][:, :n], want["pred_phase"][:, :n],
                 what="pred_phase")
    assert_outputs_close({k: v[:, :n] for k, v in got.items()
                          if k in ("theta", "verts", "kp_2d", "kp_3d",
                                   "rotmat")},
                         {k: v[:, :n] for k, v in want.items()})
