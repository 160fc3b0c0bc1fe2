"""gaitlab_torch's HRNet variants against gaitlab's: space-to-depth
packing, the s2d stem, bf16 activation storage, region casts, stop_after,
the four heads, and the weight converter for each; BN calibration of a
packed model; the study's variant modes; and three names outside the
backbone (YoloTinyDetector, max_pool_3x3_s2, create_train_state).

Both packages run on the CPU in float32 (gaitlab under
jax.default_matmul_precision("float32")) on gaitlab's small topology
(width 8, modules (1, 1, 1), one block, 64-pixel crops; width 8 is the
highest-resolution branch, so pack_low_channel=8 packs it). Weights go
from the port's init into gaitlab's variable tree by gaitlab's importer,
BN statistics are randomised there, and they come back through
weights.convert. Tolerances, each `max|a - b| <= atol + rtol * max|b|`
unless said otherwise:
  * space_to_depth / depth_to_space, packed_conv3x3_kernel: equal;
  * a packed block: atol 2e-5; the packed backbone: atol 5e-5 (gaitlab's
    own tests' bounds for the same products summed in another order);
  * the s2d stem conv: atol 1e-5; the s2d backbone: gaitlab's rtol 1e-3,
    atol 5e-3 (elementwise, its test's bound through the conv stack);
  * act_store: 1e-3 x max(1, max|out|): both round the same float32
    values to bf16, and where the two packages' float32 sums straddle a
    rounding boundary one element moves by a bf16 step;
  * cast_after (the stem's output cast to bf16): the same bound, for the
    same reason;
  * stop_after, the heads: rtol 1e-4, atol 2e-5, the float32 path's;
  * GRNet's outputs with each GRNetCore knob: test_torch_models'
    assert_outputs_close (rtol 1e-4, atol 2e-5).
"""

import copy
import dataclasses
import functools
import importlib.util
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaitlab import training as jax_training
from gaitlab.body import smpl as jax_smpl
from gaitlab.nn import hrnet as jax_hrnet
from gaitlab.nn import layers as jax_layers
from gaitlab.nn import resnet as jax_resnet
from gaitlab.nn.grnet import GRNetCore as JaxGRNetCore
from gaitlab.nn.grnet import vp_regress as jax_vp_regress
from gaitlab.pipeline import detect as jax_detect
from gaitlab.weights.torch_import import flax_tree_from_torch
from gaitlab_torch import training as pt_training
from gaitlab_torch.nn import hrnet as pt_hrnet
from gaitlab_torch.nn import layers as pt_layers
from gaitlab_torch.nn import resnet as pt_resnet
from gaitlab_torch.nn.grnet import GRNet as PtGRNet
from gaitlab_torch.nn.grnet import GRNetCore
from gaitlab_torch.pipeline import detect as pt_detect
from gaitlab_torch.pipeline.runner import GRNetRunner
from gaitlab_torch.weights.convert import state_dict_from_flax
from test_torch_models import (TINY, _randomise_stats, assert_close,
                               assert_outputs_close, port_from_jax,
                               tiny_pair)

W, IMG = TINY["backbone_width"], 64
DEPTH = dict(modules=TINY["backbone_modules"], blocks=TINY["backbone_blocks"])
L1ACT16 = dict(backbone_act_store=(("layer1", "bfloat16"),),
               backbone_region_precision=(("layer1", "w2x"),))
# GRNetCore's variant knobs, gaitlab's field names in both packages
KNOBS = {"pack": dict(pack_low_channel=W), "s2d": dict(stem_s2d=True),
         "l1act16": L1ACT16,
         "cast_after": dict(backbone_cast_after=(("stem", "bfloat16"),))}
BF16_BOUND = 1e-3  # x max(1, max|out|): see the module docstring


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def bf16_close(got, want, what):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    limit = BF16_BOUND * max(1.0, np.abs(want).max())
    assert err <= limit, f"{what}: max abs err {err:.3e} > {limit:.3e}"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The small shapes here gain nothing from torch's intra-op threads,
    and beside other test workers on the same cores those threads mostly
    wait for each other; the setting is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.fixture(scope="module")
def crops():
    return np.random.default_rng(3).normal(
        size=(2, IMG, IMG, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_space_to_depth_is_gaitlabs(rng):
    x = rng.normal(size=(2, 8, 12, 5)).astype(np.float32)
    want = np.asarray(jax_layers.space_to_depth(jnp.asarray(x)))
    got = pt_layers.space_to_depth(nchw(x))
    assert got.shape == (2, 20, 4, 6)
    np.testing.assert_array_equal(nhwc(got), want)
    np.testing.assert_array_equal(
        nhwc(pt_layers.depth_to_space(got)), x)
    np.testing.assert_array_equal(
        nhwc(pt_layers.depth_to_space(nchw(want))),
        np.asarray(jax_layers.depth_to_space(jnp.asarray(want))))
    with pytest.raises(ValueError):
        pt_layers.space_to_depth(torch.zeros(1, 2, 5, 4))


def test_packed_conv3x3_kernel_is_gaitlabs(rng):
    k = rng.normal(size=(3, 3, 5, 7)).astype(np.float32)  # HWIO
    want = np.asarray(jax_layers.packed_conv3x3_kernel(jnp.asarray(k)))
    got = pt_layers.packed_conv3x3_kernel(
        torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
    assert got.shape == (28, 20, 3, 3)
    np.testing.assert_array_equal(got.numpy().transpose(2, 3, 1, 0), want)


def _block_pair(planes=4):
    """A gaitlab BasicBlock's variables (the port's init through gaitlab's
    importer, BN terms randomised), and the port's BasicBlock holding
    them."""
    block = pt_hrnet.BasicBlock(planes, planes).eval()
    shapes = jax.eval_shape(jax_hrnet.BasicBlock(planes).init,
                            jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 8, 8, planes),
                                                 jnp.float32))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      dict(shapes))
    variables, missing, _ = flax_tree_from_torch(block.state_dict(),
                                                 template)
    assert missing == []
    variables = _randomise_stats(variables, 5)
    block.load_state_dict(state_dict_from_flax(variables), strict=True)
    return variables, block


def test_packed_basic_block_matches_gaitlab(rng):
    planes = 4
    variables, block = _block_pair(planes)
    x = rng.normal(size=(2, 8, 12, planes)).astype(np.float32)
    xp = jax_layers.space_to_depth(jnp.asarray(x))
    with jax.default_matmul_precision("float32"):
        want = jax.jit(jax_layers.PackedBasicBlock(planes).apply)(
            variables, xp)
    with torch.no_grad():
        got = pt_layers.packed_basic_block(block, nchw(np.asarray(xp)))
        plain = block(nchw(x))
    assert_close(nhwc(got), np.asarray(want), rtol=0, atol=2e-5,
                 what="packed block")
    assert_close(nhwc(pt_layers.depth_to_space(got)), nhwc(plain), rtol=0,
                 atol=2e-5, what="packed against the standard block")
    with pytest.raises(ValueError):
        pt_layers.packed_basic_block(pt_hrnet.BasicBlock(4, 8), nchw(x))


def test_stem_conv_s2d_matches_gaitlab(rng):
    k = rng.normal(size=(3, 3, 3, 8)).astype(np.float32)
    x = rng.normal(size=(2, 20, 28, 3)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = jax.jit(jax_hrnet.StemConvS2D(8).apply)(
            {"params": {"kernel": k}}, x)
    weight = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    got = pt_hrnet.stem_conv_s2d(nchw(x), weight)
    assert got.shape == (2, 8, 10, 14)
    assert_close(nhwc(got), np.asarray(want), rtol=0, atol=1e-5,
                 what="s2d stem")
    plain = torch.nn.functional.conv2d(nchw(x), weight, None, 2, 1)
    assert_close(nhwc(got), nhwc(plain), rtol=0, atol=1e-5,
                 what="s2d stem against the strided conv")


def test_bf16_store_is_gaitlabs_on_finite_values(rng):
    x = np.concatenate([
        rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, 4096),
        # halfway cases: ties to even both ways
        np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 0.0, -0.0,
                  3.3895e38, 1e-40])]).astype(np.float32)
    want = np.asarray(jax_layers.bf16_store(jnp.asarray(x)), np.float32)
    got = pt_layers.bf16_store(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the port keeps a NaN a NaN (gaitlab's integer rounding may not)
    nan = torch.tensor([float("nan")]).view(torch.int32) | 0x7FFF
    assert torch.isnan(pt_layers.bf16_store(nan.view(torch.float32))).all()


@pytest.mark.parametrize("kind", ["nearest", "up", "down"])
def test_upsampling_matches_gaitlab(rng, kind):
    x = rng.normal(size=(2, 7, 5, 3)).astype(np.float32)
    if kind == "nearest":
        want = jax.jit(lambda a: jax_layers.upsample_nearest(a, 4))(x)
        got = pt_layers.upsample_nearest(nchw(x), 4)
    else:
        size = (13, 9) if kind == "up" else (3, 2)
        want = jax.jit(lambda a: jax_layers.upsample_bilinear_align_corners(
            a, *size))(x)
        got = pt_layers.upsample_bilinear_align_corners(nchw(x), *size)
    assert_close(nhwc(got), np.asarray(want), rtol=0, atol=1e-6, what=kind)


def test_w2x_conv_on_a_bf16_activation_is_gaitlabs(rng):
    """A Conv2d at w2x on a bf16-stored input and float32 weights returns
    float32, gaitlab's conv_w2x bf16 path: x.k_hi + x.k_lo."""
    x = rng.normal(size=(2, 9, 9, 6)).astype(np.float32)
    k = rng.normal(size=(3, 3, 6, 5)).astype(np.float32)
    want = jax.jit(lambda a, b: jax_layers.conv_w2x(
        jax_layers.bf16_store(a), b))(x, k)
    conv = pt_layers.conv(6, 5, 3)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
        with pt_layers.conv_mode("w2x"):
            got = conv(pt_layers.bf16_store(nchw(x)))
    assert got.dtype == torch.float32
    assert_close(nhwc(got), np.asarray(want), rtol=1e-6, atol=0,
                 what="w2x on bf16")


# ---------------------------------------------------------------------------
# the backbone's variants, alone and through GRNet
# ---------------------------------------------------------------------------

_VP = {}


def jax_outputs(module, variables, x):
    """gaitlab's backbone features and GRNet outputs: the trunk jitted per
    module, SMPL's regression jitted once."""
    if "fn" not in _VP:
        smpl = jax_smpl.synthetic_smpl_params()
        _VP["fn"] = jax.jit(lambda p: jax_vp_regress(smpl, p)[0])

    def trunk(v, x):
        feats = module.apply(v, x, method=lambda m, x: m.backbone(x))
        patt = module.apply(v, feats, method=lambda m, f: m.head(f))
        return feats, patt

    with jax.default_matmul_precision("float32"):
        feats, patt = jax.jit(trunk)(variables, x)
        out = _VP["fn"](patt)
    return np.asarray(feats), {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_grnet_with_each_knob_matches_gaitlab(pair, crops, knob):
    _, variables, plain = pair
    kw = KNOBS[knob]
    want_f, want = jax_outputs(JaxGRNetCore(**TINY, **kw), variables, crops)
    model = port_from_jax(variables, **kw)
    cfg = model.module.backbone.cfg
    assert (cfg.pack_low_channel, cfg.stem_s2d, cfg.act_store,
            cfg.cast_after) == (kw.get("pack_low_channel", 0),
                                kw.get("stem_s2d", False),
                                kw.get("backbone_act_store", ()),
                                kw.get("backbone_cast_after", ()))
    boundaries = []
    hooks = [b.register_forward_pre_hook(
        lambda m, a: boundaries.append(a[0].dtype))
        for b in model.module.backbone.layer1]
    with torch.no_grad():
        got_f = model.module.backbone(nchw(crops))
        plain_f = plain.module.backbone(nchw(crops))
    for h in hooks:
        h.remove()
    if knob == "pack":
        assert_close(nhwc(got_f), want_f, rtol=0, atol=5e-5, what=knob)
    elif knob == "s2d":
        np.testing.assert_allclose(nhwc(got_f), want_f, rtol=1e-3, atol=5e-3)
    else:
        bf16_close(nhwc(got_f), want_f, knob)
        # bf16 was really stored: the output is not the float32 model's
        assert not torch.allclose(got_f, plain_f, rtol=0, atol=1e-6)
    if knob == "l1act16":
        # the entry to each of layer1's four blocks, and after the last
        assert boundaries == [torch.bfloat16] * 4
        l1 = copy.copy(model.module.backbone)
        l1.stop_after = "layer1"
        with torch.no_grad():
            assert l1(nchw(crops)).dtype == torch.bfloat16
    got = {k: v.numpy() for k, v in model.forward(
        torch.from_numpy(crops))[0].items()}
    assert_outputs_close(got, want)


def test_packed_convs_take_a_regions_precision_not_its_split(pair,
                                                             monkeypatch):
    """gaitlab's packed convolutions call conv_general_dilated under the
    region's matmul precision, and a w2x/a2x region sets none: a packed
    branch runs at the region's float32/high/default and, under w2x or
    a2x, at the backbone's."""
    _, variables, _ = pair
    model = port_from_jax(variables, pack_low_channel=W)
    seen = []
    conv_at = pt_layers.conv_at

    def spy(x, weight, padding, mode):
        seen.append(mode)
        return conv_at(x, weight, padding, mode)

    monkeypatch.setattr(pt_layers, "conv_at", spy)
    core = model.module.with_precision(
        "high", region_precision=(("stage2", "w2x"), ("stage3", "default"),
                                  ("stage4", "float32")))
    with torch.no_grad():
        core.backbone(torch.zeros(1, 3, IMG, IMG))
    # one module a stage, one packed block of two convolutions
    assert seen == ["high"] * 2 + ["default"] * 2 + ["float32"] * 2


@pytest.mark.parametrize("stop", pt_hrnet.REGIONS[:-1])
def test_stop_after_matches_gaitlab(pair, crops, stop):
    _, variables, model = pair
    net = jax_hrnet.PoseHighResolutionNet(jax_hrnet.HRNetCfg.w(W, **DEPTH),
                                          stop_after=stop)
    sub = {c: variables[c]["backbone"] for c in variables}
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jax.jit(net.apply)(sub, crops))
    port = pt_hrnet.PoseHighResolutionNet(model.module.backbone.cfg,
                                          stop_after=stop).eval()
    port.load_state_dict(model.module.backbone.state_dict(), strict=True)
    with torch.no_grad():
        got = port(nchw(crops))
    assert_close(nhwc(got), want, what=f"stop_after={stop}")
    with pytest.raises(ValueError):
        pt_hrnet.PoseHighResolutionNet(port.cfg, stop_after="heads")


@functools.lru_cache(maxsize=None)
def _backbone_pair(width, downsample, use_conv, seed=0):
    """gaitlab's bare backbone with the given head, its variables (the
    port's init through gaitlab's importer, BN terms randomised), and the
    port's backbone loaded back through state_dict_from_flax."""
    cfg = dict(downsample=downsample, use_conv=use_conv, **DEPTH)
    net = jax_hrnet.PoseHighResolutionNet(jax_hrnet.HRNetCfg.w(width, **cfg))
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, IMG, IMG, 3),
                                                 jnp.float32))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      dict(shapes))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        port = pt_hrnet.PoseHighResolutionNet(
            pt_hrnet.HRNetCfg.w(width, **cfg)).eval()
    variables, missing, _ = flax_tree_from_torch(port.state_dict(), template)
    assert missing == []
    variables = _randomise_stats(variables, seed + 1)
    sd = state_dict_from_flax(variables)
    own = port.state_dict()
    assert set(sd) == set(own)
    assert all(sd[k].shape == v.shape for k, v in own.items())
    port.load_state_dict(sd, strict=True)
    return net, variables, port


@pytest.mark.parametrize("width,downsample,use_conv", [
    (W, False, True), (W, True, True), (W, False, False), (W, True, False),
    (48, False, True)])
def test_converter_fills_every_key(width, downsample, use_conv):
    """state_dict_from_flax fills every key of the port's backbone for
    each head (downsample_stage_k_i is the module downsample_stage_k, index
    i) and for W48, whose factory gives gaitlab's channel counts."""
    _, _, port = _backbone_pair(width, downsample, use_conv)
    keys = set(port.state_dict())
    head = ("upsample_stage_" if use_conv and not downsample
            else "downsample_stage_" if use_conv else None)
    assert any(k.startswith(head) for k in keys) if head else not any(
        "sample_stage" in k for k in keys)
    if head == "downsample_stage_":
        assert "downsample_stage_1.6.weight" in keys  # three reps
    full_width = 48 if width == 48 else 32
    with torch.device("meta"):  # keys and shapes only
        full = (pt_hrnet.hrnet_w48 if width == 48 else pt_hrnet.hrnet_w32)(
            downsample, use_conv)
    assert full.cfg.stage4.num_channels == tuple(full_width * m
                                                 for m in (1, 2, 4, 8))
    assert set(full.state_dict()) >= keys


@pytest.mark.parametrize("downsample,use_conv", [
    (True, True), (False, False), (True, False)])
def test_other_heads_match_gaitlab(crops, downsample, use_conv):
    net, variables, port = _backbone_pair(W, downsample, use_conv)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jax.jit(net.apply)(variables, crops))
    with torch.no_grad():
        got = port(nchw(crops))
    side = IMG // 32 if downsample else IMG // 4
    assert got.shape == (2, 15 * W, side, side)
    assert_close(nhwc(got), want, what=f"head {downsample, use_conv}")
    # a region's precision reaches only the upsampling head (gaitlab's)
    view = copy.copy(port)
    view.precision = "high"
    view.cfg = dataclasses.replace(port.cfg,
                                   region_precision=(("heads", "float32"),))
    assert view.region_mode("heads") == "high"


# ---------------------------------------------------------------------------
# weights, calibration, views
# ---------------------------------------------------------------------------

def test_state_dict_keys_stay_under_every_knob():
    keys = set(GRNetCore(**TINY).state_dict())
    for kw in KNOBS.values():
        core = GRNetCore(**TINY, **kw)
        assert set(core.state_dict()) == keys
        assert set(core.with_precision("high").state_dict()) == keys


def test_calibrating_a_packed_model_equals_the_plain_one():
    images = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, 3, IMG, IMG)).astype(np.float32))
    stats = []
    for kw in ({}, dict(pack_low_channel=W, stem_s2d=True)):
        core = PtGRNet.create(device="cpu", seed=2, **TINY, **kw).module
        pt_training.calibrate_backbone_bn(core, images)
        stats.append({k: v for k, v in core.state_dict().items()
                      if "running" in k})
    assert stats[0].keys() == stats[1].keys()
    for k, v in stats[0].items():
        assert torch.equal(v, stats[1][k]), k


def test_views_copies_and_replicas_keep_the_knobs():
    kw = dict(pack_low_channel=W, stem_s2d=True,
              backbone_cast_after=(("stage2", "float32"),), **L1ACT16)
    model = PtGRNet.create(device="cpu", **TINY, **kw)
    cfg = model.module.backbone.cfg
    variant = ("pack_low_channel", "stem_s2d", "cast_after", "act_store")

    def same(core):
        return all(getattr(core.backbone.cfg, f) == getattr(cfg, f)
                   for f in variant)

    assert same(model.module.with_precision("high", "default",
                                            (("heads", "w2x"),)))
    runner = GRNetRunner(model, buckets=(2,), crop_size=IMG,
                         precision="high", trunk_dtype="bfloat16")
    assert same(runner._live()["core"])
    dp = GRNetRunner(model, buckets=(2,), crop_size=IMG, parallel="dp")
    assert all(same(m) for m in dp._live()["dp"][0].modules)
    view = model.module.with_backbone(pack_low_channel=0)
    assert view.backbone.cfg.pack_low_channel == 0 and same(model.module)
    assert view.backbone.conv1.weight is model.module.backbone.conv1.weight
    with pytest.raises(ValueError):
        model.module.with_backbone(width=16)
    with pytest.raises(ValueError):
        model.module.with_backbone(act_store=(("stage2", "bfloat16"),))


def _study():
    path = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                    "scripts", "torch_precision_study.py")
    spec = importlib.util.spec_from_file_location("torch_precision_study",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode", ["bf16trunk+f32stem", "high+l1act16",
                                  "float32+s2d", "high+pack",
                                  "default+pack+s2d"])
def test_study_modes_parse(mode):
    study = _study()
    s = study.parse_mode(mode)
    if mode == "bf16trunk+f32stem":
        assert (s["trunk_dtype"], s["f32_stem"], s["precision"],
                s["region_precision"], s["cast_after"]) == (
            "bfloat16", True, "default", (("stem", "high"),),
            (("stem", "bfloat16"),))
        model = PtGRNet.create(device="cpu", **TINY)
        core = study.at_mode(model, mode).module
        bb = core.backbone
        assert {getattr(bb, n).weight.dtype for n in study.STEM} == {
            torch.float32}
        assert bb.layer1[0].conv1.weight.dtype == torch.bfloat16
        assert bb.conv1.weight is not model.module.backbone.conv1.weight
        with torch.no_grad():
            feats = core.backbone(torch.zeros(1, 3, IMG, IMG))
        assert feats.dtype == torch.bfloat16
        return
    assert s["act_store"] == ((("layer1", "bfloat16"),)
                              if "l1act16" in mode else ())
    assert ("layer1", "w2x") in s["region_precision"] or "l1act16" not in mode
    assert s["stem_s2d"] == ("s2d" in mode)
    assert s["pack_low_channel"] == (study.PACK if "pack" in mode else 0)
    assert s["precision"] == mode.split("+")[0]


# ---------------------------------------------------------------------------
# names outside the backbone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["YoloTinyDetector", "max_pool_3x3_s2",
                                  "create_train_state"])
def test_other_names_match_gaitlab(rng, name):
    if name == "YoloTinyDetector":
        assert jax_detect.YoloTinyDetector is jax_detect.YoloDetector
        assert pt_detect.YoloTinyDetector is pt_detect.YoloDetector
    elif name == "max_pool_3x3_s2":
        x = rng.normal(size=(2, 9, 12, 3)).astype(np.float32)
        want = np.asarray(jax_resnet.max_pool_3x3_s2(jnp.asarray(x)))
        got = pt_resnet.max_pool_3x3_s2(nchw(x))
        np.testing.assert_array_equal(nhwc(got), want)
    else:
        core = PtGRNet.create(device="cpu", **TINY).module
        opt = pt_training.make_optimizer(
            pt_training.trainable_parameters(core), lr=1e-3)
        state = pt_training.create_train_state(core, opt)
        params = {"w": jnp.ones((2, 3))}
        want = jax_training.create_train_state(params, optax.adam(1e-3))
        assert state.step == int(want.step) == 0
        assert state.module is core
        assert (state.optimizer, state.scheduler) == opt
        assert state.optimizer.param_groups[0]["lr"] == 1e-3
