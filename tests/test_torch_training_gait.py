"""gaitlab_torch.training's gait trainer, data and BN calibration
against gaitlab.

The gait corrector is small (4 joints, 8 channels, h_size 16) with random
parameters carried over by gait_state_dict_from_flax; the GRNet trunk is
test_torch_models' TINY one at 64-pixel crops. Tolerances, each
`max|a - b| <= atol + rtol * max|b|`:
- gait metrics and gradients: rtol 1e-5 / 1e-4 (float32 sums of a GRU and
  an attention block in two libraries' orders), parameters after three
  SGD steps rtol 1e-4 of the distance moved;
- trunk features: rtol 1e-4, atol 1e-5 (the trunk's convolutions);
- synthetic data: equal (the same numpy and cv2 code);
- BN statistics: rtol 1e-4, atol 1e-5 (gaitlab recovers them from one
  momentum-0.9 update, losing a few ulps of the old value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaitlab import training as jt
from gaitlab.body import smpl as jax_smpl
from gaitlab.nn import gait as jg
from gaitlab.nn.grnet import GRNet as JaxGRNet
from gaitlab_torch import training as pt
from gaitlab_torch.nn import gait as pg
from gaitlab_torch.weights.convert import state_dict_from_flax
from test_torch_gait import flax_init, port_module
from test_torch_models import assert_close, port_from_jax, tiny_pair
from test_torch_training import LR, MOMENTUM, grads_close


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def gait_pair_fc(stop: bool):
    """gaitlab's FeatCorrector (4 joints, 8 channels, h_size 16) with
    random parameters, the port's with the same, and a synthetic batch."""
    batch = jt.synthetic_gait_batch(2, t=6, j=4, c=8, seed=1)
    batch = {k: np.asarray(v) for k, v in batch.items()}
    fc = jg.FeatCorrector(num_joints=4, feat_dim=8, h_size=16, num_heads=2,
                          stop_gaitfeat_grad=stop)
    params = flax_init(fc, 3, batch["features"], batch["cparams"])
    port = port_module(pg.FeatCorrector(
        4, 8, h_size=16, num_heads=2, stop_gaitfeat_grad=stop), params)
    return fc, params, port, batch


def gait_sd(params) -> dict:
    return port_module(pg.FeatCorrector(4, 8, h_size=16, num_heads=2),
                       jax.tree_util.tree_map(np.asarray, params)
                       ).state_dict()


def test_gait_step_matches_gaitlab():
    """Three SGD steps of the gait trainer (stop_gaitfeat_grad=False, as
    gaitlab's CLI builds it): the metrics before each, and the parameters
    after them, as the distance moved."""
    fc, params, port, batch = gait_pair_fc(stop=False)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    tx = optax.sgd(LR * 50, momentum=MOMENTUM)
    step = jax.jit(jt.make_gait_train_step(fc, tx))
    state = jt.create_train_state({"params": params}, tx)
    opt, _ = pt.make_optimizer(port.parameters(), lr=LR * 50, kind="sgd",
                               momentum=MOMENTUM)
    pstep = pt.make_gait_train_step(port, opt)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(3):
        state, want = step(state, batch)
        got = pstep(tb)
        for k in want:
            assert_close(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                         atol=1e-7, what=f"step {i} {k}")
    want = gait_sd(state.params["params"])
    for k, v in port.state_dict().items():
        assert_close((v - start[k]).numpy(), (want[k] - start[k]).numpy(),
                     rtol=1e-4, atol=1e-7, what=k)


@pytest.mark.parametrize("stop", [True, False])
def test_gait_estimates_get_corrector_gradients(stop):
    """With stop_gaitfeat_grad=False the reconstruction loss reaches the
    gait encoder through the gait token, as in gaitlab; with it set, the
    encoder gets none from it."""
    fc, params, port, batch = gait_pair_fc(stop)

    def recon(p):
        corrected, _, _ = fc.apply({"params": p}, batch["features"],
                                   batch["cparams"])
        return jnp.mean((corrected - batch["clean_features"]) ** 2)

    want = jax.jit(jax.grad(recon))(params)
    want = {k[len("featnet."):]: v.numpy() for k, v in gait_sd(want).items()
            if k.startswith("featnet.")}
    corrected, _, _ = port(torch.from_numpy(batch["features"]),
                           torch.from_numpy(batch["cparams"]))
    torch.mean((corrected - torch.from_numpy(batch["clean_features"])) ** 2
               ).backward()
    got = {n: p.grad for n, p in port.featnet.named_parameters()}
    if stop:
        assert all(g is None for g in got.values())
        assert not any(np.any(v) for v in want.values())
    else:
        assert all(g is not None for g in got.values())
        assert any(np.any(v) for v in want.values())
        grads_close({k: g.numpy() for k, g in got.items()}, want, "featnet")


# ---------------------------------------------------------------------------
# data and BN calibration
# ---------------------------------------------------------------------------

def test_synthetic_data_equals_gaitlab():
    want = jt.synthetic_gait_batch(3, t=5, j=4, c=6, seed=2)
    got = pt.synthetic_gait_batch(3, t=5, j=4, c=6, seed=2)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for g, w in zip(pt.synthetic_walker_clip(6, seed=3, phase0=0.4),
                    jt.synthetic_walker_clip(6, seed=3, phase0=0.4)):
        np.testing.assert_array_equal(g, w)


def test_synthetic_batch_contract():
    b = pt.synthetic_batch(2, img=32, seed=1, device="cpu")
    assert b["images"].shape == (2, 3, 32, 32)
    assert b["kp_2d"].shape == (2, 29, 3) and b["kp_3d"].shape == (2, 29, 4)
    assert torch.equal(b["pose"][0, 5], torch.eye(3))
    assert torch.equal(b["images"], pt.synthetic_batch(
        2, img=32, seed=1, device="cpu")["images"])


def test_trunk_gait_batch_matches(pair):
    module, variables, port = pair
    model = JaxGRNet(module=module, variables=variables,
                     smpl=jax_smpl.synthetic_smpl_params())
    with jax.default_matmul_precision("float32"):
        want = jt.trunk_gait_batch(model, b=2, t=4, img=64, seed=3)
    got = pt.trunk_gait_batch(port, b=2, t=4, img=64, seed=3)
    for k in ("gait_avg", "gait_phase"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6)
    for k in ("features", "clean_features", "cparams"):
        assert_close(got[k], np.asarray(want[k]), rtol=1e-4, atol=1e-5,
                     what=k)


@pytest.fixture(scope="module")
def calibrated(pair):
    """gaitlab's calibrate_backbone_bn, then its calibrate_all_bn, on four
    random crops: their bodies (one train-mode apply with batch_stats
    mutable, then gaitlab's _extrapolate_bn_stats) with the apply under
    jax.jit, which eager Flax takes about 30 s for here."""
    module, variables, _ = pair
    crops = np.random.default_rng(6).normal(
        size=(4, 64, 64, 3)).astype(np.float32)
    backbone = jax.jit(lambda v, x: module.apply(
        v, x, train=True, mutable=["batch_stats"],
        method=lambda m, im, train: m.backbone(im, train=train))[1])
    whole = module.clone(head_train_bn=True)
    everything = jax.jit(lambda v, x: whole.apply(
        v, x, train=True, mutable=["batch_stats"])[1])
    out = {"crops": crops}
    with jax.default_matmul_precision("float32"):
        v = {**variables, "batch_stats": jt._extrapolate_bn_stats(
            backbone(variables, crops)["batch_stats"],
            variables["batch_stats"])}
        out["backbone"] = state_dict_from_flax(v)
        v = {**v, "batch_stats": jt._extrapolate_bn_stats(
            everything(v, crops)["batch_stats"], v["batch_stats"])}
        out["all"] = state_dict_from_flax(v)
    return out


@pytest.mark.parametrize("which", ["backbone", "all"])
def test_bn_calibration_matches(pair, calibrated, which):
    """calibrate_backbone_bn (and then calibrate_all_bn) against gaitlab's:
    every BN statistic, which must have changed where gaitlab's did (the
    backbone's, and with "all" the head's over the calibrated backbone)."""
    _, variables, _ = pair
    before = state_dict_from_flax(variables)
    want = calibrated[which]
    core = port_from_jax(variables).module
    x = torch.from_numpy(calibrated["crops"]).permute(0, 3, 1, 2).contiguous()
    pt.calibrate_backbone_bn(core, x)
    if which == "all":
        pt.calibrate_all_bn(core, x)
    got = core.state_dict()
    stats = [k for k in got if k.endswith(("running_mean", "running_var"))]
    for k in stats:
        assert_close(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                     what=k)
        changed = not np.allclose(want[k].numpy(), before[k].numpy())
        assert changed == (which == "all" or k.startswith("backbone.")), k
