"""gaitlab_torch's precision modes against gaitlab's (the mirror of
tests/test_precision_modes.py): the runner's resolution rules, the
pass-split convolutions, the tiny runner under each mode, the TF32 gate,
and kernel B1's plain version on bf16 inputs.

On the CPU there is no TF32: every mode computes in float32 in both
packages, except the bf16 casts of trunk_dtype, and the masks and sums of
the split products run as they do on the card. Tolerances, each
`max|a - b| <= atol + rtol * max|b|`:
  * "float32", "default": rtol 1e-4, atol 2e-5, as for the float32
    path (test_torch_models);
  * "high": gaitlab's XLA:CPU computes "high" convolutions in float32
    (only its "heads" region runs the w2x masks), while the port runs the
    three-pass split everywhere, which drops the x_lo.k_lo and the
    residual of x_lo terms, about 2^-16 of each product; through the net
    that moves the outputs by about 1e-4 of their magnitude: rtol 1e-3;
  * trunk_dtype="bfloat16": both trunks round weights and activations to
    bf16 (8 significant bits), but at other places, so they differ by
    about as much as each differs from float32: RMS within 0.02 of the
    float32 output's RMS and the largest within 0.03 of its largest, with
    the measured distances and the op-by-op dtype check in the test's
    docstring.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from gaitlab.body import smpl as jax_smpl
from gaitlab.nn import layers as jax_layers
from gaitlab.nn.grnet import GRNet as JaxGRNet
from gaitlab.nn.grnet import GRNetCore as JaxGRNetCore
from gaitlab.pipeline.runner import GRNetRunner as JaxRunner
from gaitlab_torch import device as pt_device
from gaitlab_torch.nn import layers as pt_layers
from gaitlab_torch.nn import grnet as pt_grnet
from gaitlab_torch.nn.grnet import GRNet as PtGRNet
from gaitlab_torch.ops import keypoint_attention as pt_ka
from gaitlab_torch.pipeline.runner import GRNetRunner as PtRunner
from test_torch_models import TINY, assert_close, tiny_pair
from torch_threads import torch_threads  # noqa: F401

CROP = 64
PER_FRAME = ("theta", "verts", "kp_2d", "kp_3d")


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------

OVERRIDES = [
    {},
    {"head_precision": "default"},
    {"backbone_region_precision": (("stage4", "w2x"), ("stem", "float32")),
     "backbone_resize_precision": "high"},
]


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_resolution_matches_gaitlab(overrides):
    jax_model = JaxGRNet(module=JaxGRNetCore(**TINY, **overrides),
                         variables=None, smpl=None)
    port = PtGRNet.create(device="cpu", **TINY, **overrides)
    for precision in ("float32", "high", "default"):
        for head in ("auto", None, "float32", "default"):
            kw = dict(buckets=(4,), crop_size=CROP, precision=precision,
                      head_precision=head)
            want, got = JaxRunner(jax_model, **kw), PtRunner(port, **kw)
            rules = ("resolved_head_precision", "resolved_region_precision",
                     "resolved_resize_precision")
            assert [getattr(got, r)() for r in rules] == [
                getattr(want, r)() for r in rules], kw
            wm, gm = want._resolved_module(), got._resolved_module()
            assert (gm.head_precision,
                    tuple(gm.backbone_region_precision),
                    gm.backbone_resize_precision) == (
                wm.head_precision, tuple(wm.backbone_region_precision),
                wm.backbone_resize_precision), kw
            # and what the segments run: the head at the resolved mode or
            # the global one, each region at its entry or the global one
            modes = dict(gm.segments())
            assert modes["head"] == (got.resolved_head_precision()
                                     or precision)
            regions = dict(got.resolved_region_precision())
            assert modes["heads"] == regions.get("heads", precision)
            assert modes["stem"] == regions.get("stem", precision)


def test_inherit_clears_module_override():
    port = PtGRNet.create(device="cpu", **TINY, head_precision="default")
    assert port.module.head_precision == "default"
    assert dict(port.module.segments())["head"] == "default"
    parity = PtRunner(port, buckets=(4,), crop_size=CROP,
                      precision="float32")
    assert parity.resolved_head_precision() is None
    view = parity._resolved_module()
    assert view.head_precision is None
    assert dict(view.segments())["head"] == "float32"
    # the view shares the model's tensors; the model keeps its override
    assert view.head.keypoint_final_layer.weight is \
        port.module.head.keypoint_final_layer.weight
    assert port.module.head.precision == "default"
    prod = PtRunner(port, buckets=(4,), crop_size=CROP, precision="high")
    assert prod._resolved_module().head_precision == "default"
    forced = PtRunner(port, buckets=(4,), crop_size=CROP,
                      precision="float32", head_precision="high")
    assert dict(forced._resolved_module().segments())["head"] == "high"
    for bad in (dict(precision="bf16"), dict(head_precision="w2x"),
                dict(trunk_dtype="float16")):
        with pytest.raises(ValueError):
            PtRunner(port, buckets=(4,), crop_size=CROP, **bad)


def test_only_bf16_outputs_are_cast_before_smpl():
    """vp_regress casts a bf16 trunk's outputs to float32 and leaves
    float64 (the trainer's float64 checks) as it is."""
    port = PtGRNet.create(device="cpu", **TINY)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 3, CROP, CROP)))
    core, smpl = port.module.double(), port.smpl.to(torch.float64)
    with torch.no_grad():
        out = pt_grnet.vp_regress(smpl, core(x))[0]
    assert out["kp_3d"].dtype == torch.float64
    bf16 = PtRunner(port, buckets=(2,), crop_size=CROP,
                    trunk_dtype="bfloat16")
    assert bf16.forward_crops(x.float().permute(0, 2, 3, 1))[
        "kp_3d"].dtype == np.float32


# ---------------------------------------------------------------------------
# the split products
# ---------------------------------------------------------------------------

def test_bf16_hi_is_gaitlabs_bit_for_bit(rng):
    f32 = np.finfo(np.float32)
    edge = np.array([0.0, -0.0, 1.0, -1.0, f32.max, -f32.max, f32.tiny,
                     -f32.tiny, f32.tiny / 8, f32.eps, 1 + f32.eps,
                     65504.0, 3.0e-39, np.pi, -np.e], np.float32)
    x = np.concatenate([edge, rng.normal(size=4096).astype(np.float32),
                        (rng.normal(size=4096) * 1e30).astype(np.float32),
                        (rng.normal(size=4096) * 1e-30).astype(np.float32)])
    want = np.asarray(jax_layers._bf16_hi(jnp.asarray(x)))
    got = pt_layers.bf16_hi(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # and through a non-contiguous view, as the convs' weights may be
    t = torch.from_numpy(x[:4096].reshape(64, 64)).t()
    np.testing.assert_array_equal(
        pt_layers.bf16_hi(t).numpy().view(np.int32),
        np.asarray(jax_layers._bf16_hi(jnp.asarray(t.numpy()))).view(
            np.int32))


def _jax_conv(x, k, stride, padding):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (stride, stride),
        ((padding, padding), (padding, padding)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST))


@pytest.mark.parametrize("stride", [1, 2])
def test_split_convs_match_gaitlab(rng, stride):
    x = rng.normal(size=(2, 9, 9, 6)).astype(np.float32)
    k = rng.normal(size=(3, 3, 6, 4)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    kt = torch.from_numpy(k).permute(3, 2, 0, 1)

    def port(fn):
        return fn(xt, kt, stride, 1).permute(0, 2, 3, 1).numpy()

    # the layers read the mode when called, and keep nn.Conv2d's names
    conv = pt_layers.conv(6, 4, 3, stride)
    with torch.no_grad():
        conv.weight.copy_(kt)
    assert list(conv.state_dict()) == ["weight"]

    def layer(mode):
        with pt_layers.conv_mode(mode), torch.no_grad():
            return conv(xt).permute(0, 2, 3, 1).numpy()

    for name in ("conv_w2x", "conv_a2x"):
        want = np.asarray(getattr(jax_layers, name)(
            jnp.asarray(x), jnp.asarray(k), stride=stride, padding=1))
        assert_close(port(getattr(pt_layers, name)), want, 1e-6, 1e-6, name)
        np.testing.assert_array_equal(layer(name[-3:]),
                                      port(getattr(pt_layers, name)))
    # "high": gaitlab's bf16_3x as three products of its masked parts
    hi = jax_layers._bf16_hi
    x_hi, k_hi = np.asarray(hi(x)), np.asarray(hi(k))
    x_lo, k_lo = np.asarray(hi(x - x_hi)), np.asarray(hi(k - k_hi))
    want = sum(_jax_conv(a, b, stride, 1) for a, b in
               ((x_hi, k_hi), (x_hi, k_lo), (x_lo, k_hi)))
    assert_close(layer("high"), want, 1e-6, 1e-6, "high")
    # each carries about 16 bits of the plain product
    plain = _jax_conv(x, k, stride, 1)
    for mode in ("high", "w2x", "a2x"):
        assert_close(layer(mode), plain, 3e-4, 1e-4, mode)
    with pytest.raises(ValueError, match="mode"):
        pt_layers.conv_mode("bf16")


# ---------------------------------------------------------------------------
# the tiny runner under each mode, against gaitlab's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    module, variables, port = tiny_pair(seed=3)
    jax_model = JaxGRNet(module=module, variables=variables,
                         smpl=jax_smpl.synthetic_smpl_params())
    crops = np.random.default_rng(7).normal(
        size=(3, CROP, CROP, 3)).astype(np.float32)
    return jax_model, port, crops


def _runs(pair, precision, **kw):
    jax_model, port, crops = pair
    args = dict(buckets=(4,), crop_size=CROP, precision=precision, **kw)
    want = JaxRunner(jax_model, **args).forward_crops(jnp.asarray(crops))
    got = PtRunner(port, **args).forward_crops(torch.from_numpy(crops))
    return got, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("precision", ["float32", "default"])
def test_runner_matches_gaitlab_in_float32_modes(pair, precision):
    got, want = _runs(pair, precision)
    for k in PER_FRAME:
        assert_close(got[k], want[k], rtol=1e-4, atol=2e-5, what=k)


def test_runner_matches_gaitlab_at_high(pair):
    got, want = _runs(pair, "high")
    for k in PER_FRAME:
        assert_close(got[k], want[k], rtol=1e-3, atol=2e-5, what=k)


def test_runner_matches_gaitlab_with_a_bf16_trunk(pair):
    """Two bf16 trunks cannot agree to much better than bf16's own
    rounding: each conv and BN rounds its outputs to 8 significant bits,
    and where the two packages' sums round differently the difference
    spreads through the net. gaitlab's trunk on XLA:CPU also rounds at
    fewer places (XLA keeps float32 between the bf16 ops it fuses), so on
    this tiny model and these crops (seed 3) the distances, as RMS over
    the RMS of the port's float32 output, are: port bf16 vs gaitlab bf16
    0.0143 (kp_3d) and 0.0137 (verts); port bf16 vs port float32 0.0187
    and 0.0183; gaitlab bf16 vs gaitlab float32 0.0068 and 0.0065 (seeds
    4 and 5: 0.0225/0.0235 and 0.0092/0.0092 port vs gaitlab, the port's
    bf16 error 1.4-2.8 times gaitlab's); the largest distance over the
    largest float32 output, port vs gaitlab, 0.0197 and 0.0187. So the
    comparison with gaitlab bounds the size of the bf16 error (RMS within
    0.02, largest within 0.03, the port's error between 1 and 4 times
    gaitlab's), and which tensors are bf16 is checked op by op: every
    conv, BN and linear of the trunk on bf16 operands, kernel B1 on bf16
    inputs with float32 outputs, and SMPL in float32."""
    got, want = _runs(pair, "high", trunk_dtype="bfloat16")
    got32, want32 = _runs(pair, "float32")

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))

    for k in ("kp_3d", "verts"):
        assert got[k].dtype == np.float32 and np.isfinite(got[k]).all()
        assert rms(got[k] - want[k]) <= 0.02 * rms(got32[k]), k
        assert (np.abs(got[k] - want[k]).max()
                <= 0.03 * np.abs(got32[k]).max()), k
        ours, theirs = rms(got[k] - got32[k]), rms(want[k] - want32[k])
        assert theirs <= ours <= 4 * theirs, (k, ours, theirs)

    # the dtypes each op of one bucket's forward sees, on this thread
    runner = PtRunner(pair[1], buckets=(4,), crop_size=CROP,
                      precision="high", trunk_dtype="bfloat16")
    runner._live()  # the bf16 copy of the weights, made before the trace
    seen = {}

    def dtypes(tree):
        return tuple(sorted({str(t.dtype) for t in pytree.tree_leaves(tree)
                             if isinstance(t, torch.Tensor)
                             and t.is_floating_point()}))

    class Trace(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            seen.setdefault(str(func), set()).add(
                (dtypes((args, kwargs)), dtypes(out)))
            return out

    with Trace(), torch.no_grad():
        runner._forward_bucket(torch.from_numpy(pair[2]))
    bf16, f32 = ("torch.bfloat16",), ("torch.float32",)
    for op in ("aten.conv2d.default", "aten.batch_norm.default",
               "aten.linear.default"):
        assert seen[op] == {(bf16, bf16)}, op
    assert seen["gaitlab.keypoint_attention_fused.default"] == {(bf16, f32)}
    # SMPL: blend shapes and the joint regression's matmuls
    assert seen["gaitlab.blendshapes.default"] == {(f32, f32)}
    assert seen["aten.matmul.default"] == {(f32, f32)}


# ---------------------------------------------------------------------------
# the TF32 gate
# ---------------------------------------------------------------------------

def test_gate_shares_a_setting_and_queues_the_other():
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    events = []
    lock = threading.Lock()
    inside_a = threading.Event()
    release_a = threading.Event()

    def log(what):
        with lock:
            events.append(what)

    def hold(name, tf32, started=None, release=None):
        with pt_device.math_mode(tf32):
            log((name, "in", torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32))
            if started is not None:
                started.set()
            if release is not None:
                release.wait(5)
            log((name, "out"))

    a = threading.Thread(target=hold, args=("a", True, inside_a, release_a))
    a.start()
    inside_a.wait(5)
    # same setting: enters beside a at once
    b = threading.Thread(target=hold, args=("b", True))
    b.start()
    b.join(5)
    # the other setting: waits for a; a later "on" queues behind it
    c = threading.Thread(target=hold, args=("c", False))
    c.start()
    time.sleep(0.1)
    d = threading.Thread(target=hold, args=("d", True))
    d.start()
    time.sleep(0.1)
    assert ("c", "out") not in events and ("d", "out") not in events
    release_a.set()
    for t in (a, c, d):
        t.join(5)
    order = [e[0] for e in events if e[1] == "in"]
    assert order == ["a", "b", "c", "d"]
    ins = {e[0]: e[2:] for e in events if e[1] == "in"}
    assert ins == {"a": (True, True), "b": (True, True),
                   "c": (False, False), "d": (True, True)}
    assert events.index(("a", "out")) < events.index(("c", "in", False,
                                                      False))
    # the switches are back; a thread may re-enter its own setting, not
    # the other one
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == flags
    with pt_device.math_mode(False):
        with pt_device.float32_math():
            assert pt_device.held_math_mode() is False
        with pytest.raises(RuntimeError, match="TF32"):
            with pt_device.math_mode(True):
                pass
    assert pt_device.held_math_mode() is None


def test_segments_switch_the_gate_and_smpl_runs_with_tf32_off(pair,
                                                              monkeypatch):
    """Under "high" every trunk segment holds TF32 on, the SMPL regression
    holds it off; the splits run where the modes say."""
    _, port, crops = pair
    seen = []
    real_conv = pt_layers.Conv2d.forward
    from gaitlab_torch.body import smpl as pt_smpl

    real_lbs = pt_smpl.lbs

    def conv(self, x):
        seen.append(("conv", pt_device.held_math_mode(),
                     pt_layers._CONV_MODE.get()))
        return real_conv(self, x)

    def lbs(*a, **kw):
        seen.append(("smpl", pt_device.held_math_mode(), None))
        return real_lbs(*a, **kw)

    monkeypatch.setattr(pt_layers.Conv2d, "forward", conv)
    monkeypatch.setattr(pt_smpl, "lbs", lbs)
    PtRunner(port, buckets=(4,), crop_size=CROP, precision="high") \
        .forward_crops(torch.from_numpy(crops))
    convs = {(held, mode) for kind, held, mode in seen if kind == "conv"}
    assert convs == {(True, "high"), (True, "w2x"), (True, "default")}
    assert {held for kind, held, _ in seen if kind == "smpl"} == {False}
    seen.clear()
    PtRunner(port, buckets=(4,), crop_size=CROP).forward_crops(
        torch.from_numpy(crops))
    assert {(held, mode) for _, held, mode in seen} == {
        (False, "float32"), (False, None)}


# ---------------------------------------------------------------------------
# kernel B1 on bf16 inputs
# ---------------------------------------------------------------------------

def test_keypoint_attention_plain_on_bf16_is_the_upcast(rng):
    b, h, w = 2, 7, 9
    args = [torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(
        np.float32)).to(torch.bfloat16) for c in (16, 8, 24)]
    got = pt_ka.keypoint_attention_fused(*args)
    want = pt_ka.keypoint_attention_plain(*(a.float() for a in args))
    for g, wt in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), wt.numpy())
    # the NCHW views the head passes, and the backward in the inputs' dtype
    nchw = [a.permute(0, 3, 1, 2).contiguous().requires_grad_()
            for a in args]
    out = pt_ka.keypoint_attention_fused(
        *(a.permute(0, 2, 3, 1) for a in nchw))
    (out[0].sum() + 2 * out[1].sum()).backward()
    assert [a.grad.dtype for a in nchw] == [torch.bfloat16] * 3
