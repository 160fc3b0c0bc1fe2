"""gaitlab_torch's network against gaitlab's: HRNet backbone, PARE head,
GRNet.forward, and the weight bridge between the two packages.

Both packages run the small topology of tests/test_pipeline_parallel.py on
the CPU in float32 (gaitlab under jax.default_matmul_precision("float32")).
gaitlab's variables come from its own init with random, non-trivial BN
statistics and affine terms, and reach the port through
gaitlab_torch.weights.convert.state_dict_from_flax.

Tolerances: the two packages sum the same float32 products in different
orders (XLA:CPU against oneDNN convolutions), so outputs agree to a few
float32 ulps of their magnitude, scaled by the depth of the net. Each
comparison is `max|a - b| <= atol + rtol * max|b|`.

The helpers here (`tiny_pair`, `jax_forward`, `port_from_jax`) are shared
by the other test_torch_* files.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaitlab.body import smpl as jax_smpl
from gaitlab.core import geometry as jax_geometry
from gaitlab.nn.grnet import GRNetCore as JaxGRNetCore
from gaitlab.nn.grnet import vp_regress as jax_vp_regress
from gaitlab.weights import torch_import as jax_torch_import
from gaitlab_torch.body import smpl as pt_smpl
from gaitlab_torch.core import geometry as pt_geometry
from gaitlab_torch.nn.grnet import GRNet as PtGRNet
from gaitlab_torch.weights.convert import state_dict_from_flax
from gaitlab_torch.weights.torch_import import load_grnet_ckpt

TINY = dict(backbone_width=8, num_input_features=120,
            num_features_pare=32, num_features_smpl=16,
            backbone_modules=(1, 1, 1), backbone_blocks=1)
OUT_KEYS = ("theta", "verts", "kp_2d", "kp_3d", "rotmat")


def assert_close(got, want, rtol=1e-4, atol=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.all(np.isfinite(got)) and np.all(np.isfinite(want)), what
    err = np.abs(got - want).max() if got.size else 0.0
    limit = atol + rtol * (np.abs(want).max() if want.size else 0.0)
    assert err <= limit, f"{what}: max abs err {err:.3e} > {limit:.3e}"


def _randomise_stats(variables, seed: int):
    """Non-trivial BN running stats and affine terms (fresh init has mean 0,
    var 1, scale 1, bias 0, which would hide a swapped or dropped leaf)."""
    rng = np.random.default_rng(seed)

    def params(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "bias":
            return (rng.normal(size=x.shape) * 0.1).astype(np.float32)
        return x

    def stats(path, x):
        name = path[-1].key
        if name == "mean":
            return (rng.normal(size=x.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)

    return {
        "params": jax.tree_util.tree_map_with_path(params,
                                                   variables["params"]),
        "batch_stats": jax.tree_util.tree_map_with_path(
            stats, variables["batch_stats"]),
    }


def tiny_pair(seed: int = 0, **overrides):
    """(gaitlab GRNetCore, its variables as numpy, the port's GRNet on the
    CPU with the same weights). The weights are the port's random init
    read into gaitlab's variable tree by gaitlab's own importer (cheaper
    than a traced flax init), with random BN statistics and affine terms
    set on the gaitlab side; the port then takes them back through
    state_dict_from_flax. Synthetic SMPL on both sides."""
    cfg = {**TINY, **overrides}
    module = JaxGRNetCore(**cfg)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      dict(shapes))
    init = PtGRNet.create(device="cpu", seed=seed, **cfg).module.state_dict()
    variables, missing, _ = jax_torch_import.import_grnet_ckpt(
        init, template, strict=True)
    assert missing == []
    variables = _randomise_stats(variables, seed + 1)
    return module, variables, port_from_jax(variables, **overrides)


def port_from_jax(variables, **overrides) -> PtGRNet:
    model = PtGRNet.create(device="cpu", **{**TINY, **overrides})
    model.module.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


_JAX_FORWARDS = {}


def jax_forward(module):
    """Jitted gaitlab trunk + vp_regress in float32 on NHWC crops with
    synthetic SMPL: the first element of GRNet.forward's output."""
    if module not in _JAX_FORWARDS:
        smpl = jax_smpl.synthetic_smpl_params()
        _JAX_FORWARDS[module] = jax.jit(
            lambda v, x: jax_vp_regress(smpl, module.apply(v, x))[0])
    fn = _JAX_FORWARDS[module]

    def run(variables, x):
        with jax.default_matmul_precision("float32"):
            return {k: np.asarray(v) for k, v in fn(variables, x).items()}

    return run


def assert_outputs_close(got: dict, want: dict, rtol=1e-4, atol=2e-5):
    """GRNet output dicts. `pose` (theta[..., 3:75]) is compared through
    the rotation matrices it encodes: the axis-angle of a rotation near pi,
    and the branch rotmat_to_quat picks when m22 is within rounding of its
    threshold, may differ between packages for the same rotation."""
    for k in OUT_KEYS:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if k == "theta":
            assert_close(g[..., :3], w[..., :3], rtol, atol, "theta cam")
            assert_close(g[..., 75:], w[..., 75:], rtol, atol, "theta betas")

            def rot(a):
                aa = np.asarray(a[..., 3:75], np.float32).reshape(-1, 3)
                return np.asarray(jax_geometry.axis_angle_to_rotmat(
                    jnp.asarray(aa)))

            assert_close(rot(g), rot(w), rtol, atol, "theta pose")
        else:
            assert_close(g, w, rtol, atol, k)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.fixture(scope="module")
def crops():
    rng = np.random.default_rng(3)
    return rng.normal(size=(3, 64, 64, 3)).astype(np.float32)


def test_state_dict_from_flax_fills_every_key(pair):
    _, variables, model = pair
    sd = state_dict_from_flax(variables)
    own = model.module.state_dict()
    assert set(sd) == set(own)
    for k, v in own.items():
        assert sd[k].shape == v.shape, k
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    n_bn = len(jax.tree_util.tree_leaves(variables["batch_stats"])) // 2
    assert len(sd) == n_leaves + n_bn  # + num_batches_tracked per BN


def test_backbone_matches(pair, crops):
    module, variables, model = pair
    feats = jax.jit(lambda v, x: module.apply(
        v, x, method=lambda m, x: m.backbone(x, train=False)))
    with jax.default_matmul_precision("float32"):
        want = np.asarray(feats(variables, crops))
    with torch.no_grad():
        got = model.module.backbone(
            torch.from_numpy(crops).permute(0, 3, 1, 2).contiguous())
    assert got.shape == (3, 15 * TINY["backbone_width"], 16, 16)
    assert_close(got.permute(0, 2, 3, 1).numpy(), want, what="backbone")


def test_head_matches(pair):
    module, variables, model = pair
    rng = np.random.default_rng(4)
    feats = np.maximum(rng.normal(size=(2, 16, 16, 120)), 0).astype(np.float32)
    head = jax.jit(lambda v, x: module.apply(
        v, x, method=lambda m, x: m.head(x)))
    with jax.default_matmul_precision("float32"):
        want = {k: np.asarray(v) for k, v in head(variables, feats).items()}
    with torch.no_grad():
        got = model.module.head(
            torch.from_numpy(feats).permute(0, 3, 1, 2).contiguous())
    assert_close(got["pred_segm_mask"].permute(0, 2, 3, 1).numpy(),
                 want["pred_segm_mask"], what="pred_segm_mask")
    for k in ("point_local_feat", "cam_shape_feats", "pred_rot6d",
              "pred_rotmat", "pred_shape", "pred_cam"):
        assert_close(got[k].numpy(), want[k], what=k)


@pytest.mark.parametrize("layout", ["nhwc", "nchw", "bt_nchw"])
def test_grnet_forward_matches(pair, crops, layout):
    module, variables, model = pair
    want = jax_forward(module)(variables, crops)
    x = torch.from_numpy(crops)
    if layout == "nchw":
        x = x.permute(0, 3, 1, 2)
    elif layout == "bt_nchw":
        x = x.permute(0, 3, 1, 2)[None]
    got = {k: v.numpy() for k, v in model.forward(x)[0].items()}
    assert set(got) == set(OUT_KEYS)
    assert got["verts"].shape == (1, 3, 6890, 3)
    assert got["kp_3d"].shape == (1, 3, 29, 3)
    assert_outputs_close(got, want)


def test_vp_regress_with_j_regressor(pair):
    """The H36M J_regressor branch of vp_regress (17 rows -> 14 joints)."""
    from gaitlab_torch.nn.grnet import vp_regress as pt_vp_regress

    rng = np.random.default_rng(5)
    n = 2
    aa = (rng.normal(size=(n * 24, 3)) * 0.4).astype(np.float32)
    rot = np.asarray(jax_geometry.axis_angle_to_rotmat(jnp.asarray(aa))
                     ).reshape(n, 24, 3, 3)
    patt = {"pred_pose": rot,
            "pred_shape": (rng.normal(size=(n, 10)) * 0.5).astype(np.float32),
            "pred_cam": np.array([[0.9, 0.1, -0.1], [1.1, 0.0, 0.2]],
                                 np.float32)}
    jr = rng.random(size=(17, 6890)).astype(np.float32) ** 8
    jr /= jr.sum(1, keepdims=True)
    smpl = jax_smpl.synthetic_smpl_params()
    want = jax.jit(lambda p, j: jax_vp_regress(smpl, p, J_regressor=j)[0])(
        patt, jr)
    got = pt_vp_regress(pt_smpl.synthetic_smpl_params(),
                        {k: torch.from_numpy(v) for k, v in patt.items()},
                        J_regressor=torch.from_numpy(jr))[0]
    assert got["kp_3d"].shape == (1, n, 14, 3)
    assert_outputs_close({k: v.numpy() for k, v in got.items()},
                         {k: np.asarray(v) for k, v in want.items()})


def test_port_checkpoint_loads_in_gaitlab(pair, crops):
    """A reference-keyed checkpoint written from the port's state_dict
    loads through gaitlab's own importer with no missing leaf, and both
    packages then compute the same outputs from it."""
    module, variables, _ = pair
    # weights the gaitlab side has never seen: another seed's model
    _, other, port = tiny_pair(seed=7)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "grnet.pth")
        torch.save({"gen_state_dict": port.module.state_dict()}, path)
        state = jax_torch_import.load_torch_file(path)
        loaded, missing, unused = jax_torch_import.import_grnet_ckpt(
            state["gen_state_dict"], variables, strict=True)
    assert missing == []
    # gaitlab's importer reports keys as tokens split at '.' and '_'
    assert all(k[-3:] == ("num", "batches", "tracked") for k in unused)
    want = jax_forward(module)(loaded, crops)
    got = {k: v.numpy() for k, v in port.forward(torch.from_numpy(crops))[0]
           .items()}
    assert_outputs_close(got, want)


def test_flax_torch_flax_is_identity(pair):
    _, variables, _ = pair
    sd = state_dict_from_flax(variables)
    back, missing, _ = jax_torch_import.import_grnet_ckpt(
        sd, variables, strict=True)
    assert missing == []
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_load_grnet_ckpt_round_trip(pair):
    _, _, model = pair
    fresh = PtGRNet.create(device="cpu", seed=3, **TINY)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "grnet.pth")
        torch.save({"gen_state_dict": model.module.state_dict(),
                    "performance": 1.0}, path)
        missing, unused, state = load_grnet_ckpt(fresh.module, path)
    assert missing == [] and unused == []
    assert state["performance"] == 1.0
    for k, v in model.module.state_dict().items():
        assert torch.equal(fresh.module.state_dict()[k], v), k


def test_rotmat_is_a_rotation(pair, crops):
    """rotmat from the port's head is a rotation (orthonormal, det 1)."""
    _, _, model = pair
    rot = model.forward(torch.from_numpy(crops))[0]["rotmat"].reshape(-1, 3, 3)
    eye = torch.eye(3).expand_as(rot)
    assert torch.allclose(rot @ rot.transpose(1, 2), eye, atol=1e-5)
    assert torch.allclose(torch.linalg.det(rot), torch.ones(len(rot)),
                          atol=1e-5)
    aa = pt_geometry.rotmat_to_axis_angle(rot)
    assert torch.allclose(pt_geometry.axis_angle_to_rotmat(aa), rot,
                          atol=1e-4)


def test_gait_branch_is_not_ported():
    """The gait branch is ported: it builds on the CPU with the TINY
    knobs, and its forward matches gaitlab's on the same weights
    (tests/test_torch_gait.py holds it module by module)."""
    from test_torch_gait import gait_inputs, gait_pair, jax_gait_forward

    module, variables, port = gait_pair(seed=2)
    assert port.module.use_gait_feat and hasattr(port.module,
                                                 "pfeat_corrector")
    crops, bbox, cimg = gait_inputs(3, seed=4)
    want = jax_gait_forward(module, variables, crops, bbox, cimg)
    got = {k: v.numpy() for k, v in port.forward(
        torch.from_numpy(crops), bbox=bbox, cimg=cimg)[0].items()}
    assert_outputs_close(got, want)
    for k in ("pred_avg", "pred_phase", "pred_cparam"):
        assert_close(got[k], want[k], what=k)


def test_gaitlab_grnet_create_agrees_on_topology():
    """The port's GRNetCore takes gaitlab's topology knobs with the same
    defaults (full width: HRNet-W32, 480 -> 128/64 head; the corrector at
    MODEL.FEAT_CORR's defaults)."""
    import inspect

    from gaitlab_torch.nn.grnet import GRNetCore as PtCore

    pt = inspect.signature(PtCore.__init__).parameters
    for name in ("num_joints", "num_input_features", "num_features_pare",
                 "num_features_smpl", "backbone_width", "backbone_modules",
                 "backbone_blocks", "use_gait_feat", "featcorr_avg_dim",
                 "featcorr_estim_phase", "featcorr_num_layers",
                 "featcorr_h_size", "featcorr_num_heads",
                 "featcorr_use_jwff"):
        assert pt[name].default == getattr(JaxGRNetCore, name), name
