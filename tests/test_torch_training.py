"""gaitlab_torch.training's GRNet step and the kernel ops' backwards
against gaitlab (test_torch_training_gait.py: the gait trainer, data and
BN calibration).

Both packages run the small trunk of test_torch_models (TINY, 64-pixel
crops, synthetic SMPL) on the CPU in float32, with the same weights
(state_dict_from_flax / gait_state_dict_from_flax) and one numpy batch.

Tolerances, each `max|a - b| <= atol + rtol * max|b|`:
- losses and gradients: rtol 1e-4 per tensor, with an atol of 1e-6 of the
  largest gradient of the model (a gradient that is 0 in exact arithmetic
  comes out as rounding noise in both packages): the same float32 sums of
  ~30 convolutions and SMPL taken in two libraries' orders;
- parameters after three SGD steps: rtol 1e-4 of the distance moved;
- the ops against autograd through their plain versions: 1e-5 (float32,
  the same sums), gradcheck in float64 at its defaults;
- learning rates against optax: rtol 1e-6 (optax computes in float32);
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaitlab import training as jt
from gaitlab.body import smpl as jax_smpl
from gaitlab.nn.layers import keypoint_attention as jax_pool
from gaitlab_torch import training as pt
from gaitlab_torch.ops import blendshapes as b2
from gaitlab_torch.ops import keypoint_attention as b1
from gaitlab_torch.weights.convert import state_dict_from_flax
from test_torch_models import assert_close, port_from_jax, tiny_pair
from torch_threads import torch_threads  # noqa: F401

LR = 1e-3
MOMENTUM = 0.9
N = 3


def numpy_batch(n: int = N, img: int = 64, seed: int = 0) -> dict:
    """gaitlab's batch contract (NHWC images), partial confidences and one
    sample without SMPL labels."""
    rng = np.random.default_rng(seed)
    rot = np.linalg.qr(rng.normal(size=(n, 24, 3, 3)))[0]
    return {
        "images": rng.normal(size=(n, img, img, 3)).astype(np.float32),
        "kp_2d": np.concatenate([rng.normal(size=(n, 29, 2)),
                                 rng.uniform(0, 1, (n, 29, 1))],
                                -1).astype(np.float32),
        "kp_3d": np.concatenate([rng.normal(size=(n, 29, 3)),
                                 rng.uniform(0, 1, (n, 29, 1))],
                                -1).astype(np.float32),
        "pose": rot.astype(np.float32),
        "betas": (rng.normal(size=(n, 10)) * 0.03).astype(np.float32),
        "has_smpl": (np.arange(n) != 1).astype(np.float32),
    }


def port_batch(batch: dict) -> dict:
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["images"] = out["images"].permute(0, 3, 1, 2).contiguous()
    return out


def grads_close(got: dict, want: dict, what: str):
    floor = 1e-6 * max(np.abs(w).max() for w in want.values())
    assert set(got) == set(want), what
    for k in want:
        assert_close(got[k], want[k], rtol=1e-4, atol=floor, what=f"{what} {k}")


# ---------------------------------------------------------------------------
# the kernel ops' backwards
# ---------------------------------------------------------------------------

def b1_inputs(dtype, b=2, h=3, w=4, c1=5, c2=3, j=24, seed=0):
    """The head's layout: NCHW tensors as NHWC views, the heatmaps' first
    (background) channel sliced off."""
    g = torch.Generator().manual_seed(seed)
    f = torch.randn(b, c1, h, w, generator=g, dtype=dtype)
    c = torch.randn(b, c2, h, w, generator=g, dtype=dtype)
    hm = torch.randn(b, j + 1, h, w, generator=g, dtype=dtype) * 2
    return [t.requires_grad_() for t in (f, c, hm)]


def b1_views(f, c, hm):
    return (f.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1),
            hm[:, 1:].permute(0, 2, 3, 1))


def b2_inputs(dtype, b=3, v=7, s=4, p=5, seed=1):
    g = torch.Generator().manual_seed(seed)
    shapes = ((v, 3), (v, 3, s), (p, v * 3), (b, s), (b, p))
    return [torch.randn(*sh, generator=g, dtype=dtype).requires_grad_()
            for sh in shapes]


def test_keypoint_attention_gradcheck():
    # the CPU path takes any part count: 4 parts keep gradcheck short
    ins = b1_inputs(torch.float64, h=2, w=3, j=4)
    assert torch.autograd.gradcheck(
        lambda *a: b1.keypoint_attention_fused(*b1_views(*a)), ins)


def test_blendshapes_gradcheck():
    assert torch.autograd.gradcheck(b2.blendshapes, b2_inputs(torch.float64))


@pytest.mark.parametrize("op", ["keypoint_attention", "blendshapes"])
def test_backward_matches_autograd_of_plain(op):
    if op == "keypoint_attention":
        ins = b1_inputs(torch.float32, b=3, h=8, w=8, c1=16, c2=8)
        fused = lambda *a: b1.keypoint_attention_fused(*b1_views(*a))
        plain = lambda *a: b1.keypoint_attention_plain(*b1_views(*a))
        counter = b1.keypoint_attention_fused
    else:
        ins = b2_inputs(torch.float32, b=4, v=50, s=10, p=23)
        fused, plain = b2.blendshapes, b2.blendshapes_plain
        counter = b2.blendshapes
    outs = fused(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator().manual_seed(5)
    cot = [torch.randn(o.shape, generator=g) for o in outs]
    before = counter.backwards
    got = torch.autograd.grad(outs, ins, cot)
    assert counter.backwards == before + 1
    refs = plain(*ins)
    refs = refs if isinstance(refs, tuple) else (refs,)
    want = torch.autograd.grad(refs, ins, cot)
    for i, (a, b) in enumerate(zip(got, want)):
        assert_close(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6,
                     what=f"{op} d_input{i}")


def test_blendshapes_backward_skips_the_directions():
    vt, sd, pd, be, pf = b2_inputs(torch.float32)
    sd.requires_grad_(False)
    pd.requires_grad_(False)
    out = b2.blendshapes(vt, sd, pd, be, pf)
    out.sum().backward()
    assert sd.grad is None and pd.grad is None
    assert be.grad is not None and pf.grad is not None and vt.grad is not None


def test_keypoint_attention_backward_matches_jax_grad():
    """d(features), d(cam) and d(logits) against jax.grad of gaitlab's XLA
    pooling (the path gaitlab trains through) under one cotangent."""
    f, c, hm = b1_inputs(torch.float32, b=2, h=8, w=8, c1=16, c2=8)
    g = torch.Generator().manual_seed(7)
    w1, w2 = torch.randn(2, 24, 16, generator=g), torch.randn(2, 24, 8,
                                                             generator=g)
    o1, o2 = b1.keypoint_attention_fused(*b1_views(f, c, hm))
    ((o1 * w1).sum() + (o2 * w2).sum()).backward()

    def loss(fn, cn, hn):
        return (jnp.sum(jax_pool(fn, hn) * w1.numpy())
                + jnp.sum(jax_pool(cn, hn) * w2.numpy()))

    nhwc = [t.detach().permute(0, 2, 3, 1).numpy() for t in (f, c, hm)]
    with jax.default_matmul_precision("float32"):
        want = jax.grad(loss, argnums=(0, 1, 2))(nhwc[0], nhwc[1],
                                                 nhwc[2][..., 1:])
    for name, t, w in (("features", f, want[0]), ("cam", c, want[1])):
        assert_close(t.grad.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                     rtol=1e-5, atol=1e-6, what=name)
    got_hm = hm.grad.permute(0, 2, 3, 1).numpy()
    assert np.all(got_hm[..., 0] == 0)  # the dropped background channel
    assert_close(got_hm[..., 1:], np.asarray(want[2]), rtol=1e-5, atol=1e-6,
                 what="logits")


# ---------------------------------------------------------------------------
# losses and optimizers
# ---------------------------------------------------------------------------

def test_losses_match():
    rng = np.random.default_rng(2)
    b = numpy_batch(seed=3)
    outputs = {"kp_2d": rng.normal(size=(1, N, 29, 2)),
               "kp_3d": rng.normal(size=(1, N, 29, 3)),
               "rotmat": rng.normal(size=(1, N, 24, 3, 3)),
               "theta": rng.normal(size=(1, N, 85))}
    outputs = {k: v.astype(np.float32) for k, v in outputs.items()}
    w = pt.LossWeights(kp_2d=3.0, kp_3d=2.0, pose=5.0, shape=7.0)
    _, want = jt.grnet_loss(outputs, b, jt.LossWeights(*w))
    _, got = pt.grnet_loss({k: torch.from_numpy(v) for k, v in
                            outputs.items()}, port_batch(b), w)
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                     atol=0, what=k)

    pa, pp = rng.normal(size=(2, 3)), rng.normal(size=(2, 5, 4))
    ga, gp = rng.normal(size=(2, 3)), rng.normal(size=(2, 5, 4))
    args = [x.astype(np.float32) for x in (pa, pp, ga, gp)]
    want_t, want_m = jt.gait_loss(*args, w_avg=0.5, w_phase=2.0)
    got_t, got_m = pt.gait_loss(*map(torch.from_numpy, args), w_avg=0.5,
                                w_phase=2.0)
    assert_close(got_t.numpy(), np.asarray(want_t), rtol=1e-6, atol=0)
    for k in want_m:
        assert_close(got_m[k].numpy(), np.asarray(want_m[k]), rtol=1e-6,
                     atol=0, what=k)


OPTIMIZERS = [(kind, sched) for kind in ("adam", "adamw", "sgd")
              for sched in (None, "cosine", "step")]


@pytest.mark.parametrize("kind,schedule", OPTIMIZERS)
def test_optimizer_matches_optax(kind, schedule):
    """The learning rate of every update and the parameters after each,
    over total_steps + 2 updates of a fixed quadratic, against optax."""
    total, warmup = 10, (3 if schedule == "cosine" else 0)
    kw = dict(lr=0.1, kind=kind, schedule=schedule, total_steps=total,
              warmup_steps=warmup, weight_decay=0.05, momentum=0.8)
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(5,)).astype(np.float32)
    a = rng.normal(size=(5,)).astype(np.float32)

    def grad(p):  # of sum(a * p + p**4 / 4), as the torch side below
        return a + p ** 3

    tx = jt.make_optimizer(**kw)
    jp, state = jnp.asarray(p0), None
    state = tx.init(jp)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = pt.make_optimizer([param], **kw)
    lr_s = (optax.warmup_cosine_decay_schedule(0.0, 0.1, max(warmup, 1), total)
            if schedule == "cosine" else optax.piecewise_constant_schedule(
                0.1, {int(total * 0.6): 0.1, int(total * 0.8): 0.1})
            if schedule == "step" else (lambda count: 0.1))
    for count in range(total + 2):
        assert_close(opt.param_groups[0]["lr"], float(lr_s(count)), rtol=1e-6,
                     atol=1e-9, what=f"lr at update {count}")
        updates, state = tx.update(grad(jp), state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        param.grad = torch.from_numpy(a) + param.detach() ** 3
        opt.step()
        sched.step()
        assert_close(param.detach().numpy(), np.asarray(jp), rtol=1e-5,
                     atol=1e-6, what=f"params after update {count}")


def test_cosine_schedule_starts_at_zero():
    f = pt.lr_factor("cosine", 10)
    assert [round(f(c), 3) for c in range(4)] == [0.0, 1.0, 0.970, 0.883]
    with pytest.raises(ValueError, match="unknown schedule"):
        pt.lr_factor("linear", 10)


# ---------------------------------------------------------------------------
# the GRNet train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def recording():
    """An optax transformation that passes updates on and keeps the last
    ones in its state: the gradients of gaitlab's own step."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@pytest.fixture(scope="module")
def jax_run(pair):
    """Three steps of gaitlab's make_train_step on one numpy batch (one
    compile), with SGD on params and batch_stats left alone: the losses,
    the parameters after, and the gradients of the first step with
    respect to the whole variable tree, as gaitlab's step takes them."""
    module, variables, _ = pair
    smpl = jax_smpl.synthetic_smpl_params()
    b = numpy_batch()
    tx = optax.chain(recording(), optax.multi_transform(
        {"p": optax.sgd(LR, momentum=MOMENTUM), "bs": optax.set_to_zero()},
        {"params": "p", "batch_stats": "bs"}))
    out = {"batch": b, "losses": []}
    with jax.default_matmul_precision("float32"):
        step = jax.jit(jt.make_train_step(module, smpl, tx))
        state = jt.create_train_state(variables, tx)
        for i in range(3):
            state, m = step(state, b)
            out["losses"].append(float(m["loss"]))
            if i == 0:
                out["metrics"], out["grads"] = m, state.opt_state[0]
        out["after"] = state.params
    return jax.tree_util.tree_map(np.asarray, out)


def port_model(variables):
    model = port_from_jax(variables)
    return model.module, model.smpl


def test_head_gradients_match_jax_grad(pair, jax_run):
    _, variables, _ = pair
    core, smpl = port_model(variables)
    opt, _ = pt.make_optimizer(pt.trainable_parameters(core), lr=LR)
    got_m = pt.make_train_step(core, smpl, opt)(port_batch(jax_run["batch"]))
    for k, v in jax_run["metrics"].items():
        assert_close(got_m[k].numpy(), v, rtol=1e-5, atol=0, what=k)
    want = state_dict_from_flax(jax_run["grads"])
    got = {}
    for name, p in core.named_parameters():
        if name.startswith("backbone."):
            assert p.grad is None, name  # frozen: no autograd at all
        else:
            got[name] = p.grad.numpy()
    grads_close(got, {k: want[k].numpy() for k in got}, "grad")


def test_three_steps_match_gaitlab(pair, jax_run):
    """The loss before each of three SGD steps, and every parameter after
    them, against gaitlab's make_train_step (batch_stats masked). SGD's
    update is linear in the gradient, so rounding noise stays noise (Adam's
    first step turns a gradient at the noise floor into a step of size
    lr; test_optimizer_matches_optax holds Adam to optax)."""
    _, variables, _ = pair
    core, smpl = port_model(variables)
    start = {k: v.clone() for k, v in core.state_dict().items()}
    opt, sched = pt.make_optimizer(pt.trainable_parameters(core), lr=LR,
                                   kind="sgd", momentum=MOMENTUM)
    step = pt.make_train_step(core, smpl, opt, scheduler=sched)
    batch = port_batch(jax_run["batch"])
    losses = [float(step(batch)["loss"]) for _ in range(3)]
    assert_close(np.array(losses), np.array(jax_run["losses"]), rtol=1e-5,
                 atol=0, what="losses")
    want = state_dict_from_flax(jax_run["after"])
    floor = 1e-6 * max(np.abs(g).max() for g in jax.tree_util.tree_leaves(
        jax_run["grads"]["params"])) * LR
    for name, p in core.named_parameters():
        got, w0 = p.detach().numpy(), start[name].numpy()
        if name.startswith("backbone."):
            assert np.array_equal(got, w0), name
            continue
        assert_close(got - w0, want[name].numpy() - w0, rtol=1e-4,
                     atol=3 * floor, what=name)
    assert not torch.equal(core.head.pose_mlp.weight, start["head.pose_mlp.weight"])


def test_bn_buffers_stay_put_where_gaitlab_moves_them(pair, jax_run):
    """A fault of gaitlab's trainer: its step differentiates the whole
    variable tree, batch_stats included, so with the trainer's plain
    optax.adam the head's BN running statistics move by about lr (the
    backbone's stay, behind stop_gradient). The port's step leaves every
    BN buffer bit-equal, also when the core was left in train mode."""
    _, variables, _ = pair
    grads = jax_run["grads"]
    # Adam is elementwise: its step on the head's statistics alone
    head, head_g = variables["batch_stats"]["head"], grads["batch_stats"]["head"]
    tx = optax.adam(LR)
    updates, _ = tx.update(head_g, tx.init(head), head)
    after = optax.apply_updates(head, updates)
    for name in ("keypoint_deconv_layers_1", "keypoint_deconv_layers_4",
                 "smpl_deconv_layers_1", "smpl_deconv_layers_4"):
        for stat in ("mean", "var"):
            moved = np.abs(np.asarray(after[name][stat])
                           - head[name][stat]).max()
            assert moved == pytest.approx(LR, rel=0.01), (name, stat)
    assert not any(np.any(g) for g in jax.tree_util.tree_leaves(
        grads["batch_stats"]["backbone"]))

    core, smpl = port_model(variables)
    buffers = {k: v.clone() for k, v in core.named_buffers()}
    opt, sched = pt.make_optimizer(pt.trainable_parameters(core), lr=LR)
    step = pt.make_train_step(core, smpl, opt, scheduler=sched)
    core.train()  # the step applies the core in eval mode all the same
    for _ in range(2):
        step(port_batch(jax_run["batch"]))
    for k, v in core.named_buffers():
        assert torch.equal(v, buffers[k]), k


def test_frozen_backbone_gets_no_grad_and_same_outputs(pair):
    _, variables, _ = pair
    core, _ = port_model(variables)
    x = port_batch(numpy_batch())["images"]
    with torch.no_grad():
        ref = core(x)
    out = core(x)
    for k in ref:
        assert torch.equal(out[k].detach(), ref[k]), k
    out["pred_shape"].sum().backward()
    assert all(p.grad is None for p in core.backbone.parameters())
    assert core.head.shape_mlp.weight.grad is not None
    core.train()
    assert not core.backbone.training and core.head.training
    unfrozen, _ = port_model(variables)
    unfrozen.freeze_backbone = False
    unfrozen(x)["pred_shape"].sum().backward()
    assert all(p.grad is not None for p in unfrozen.backbone.parameters())


def test_train_state_round_trip(pair, tmp_path):
    _, variables, _ = pair
    core, smpl = port_model(variables)
    opt, sched = pt.make_optimizer(pt.trainable_parameters(core), lr=LR,
                                   schedule="cosine", total_steps=5)
    step = pt.make_train_step(core, smpl, opt, scheduler=sched)
    batch = port_batch(numpy_batch(n=2))
    state = pt.TrainState(core, opt, sched)
    step(batch)
    state.step = 1
    state.save(str(tmp_path / "ckpt.pt"))
    want = float(step(batch)["loss"])

    core2, smpl2 = port_model(variables)
    opt2, sched2 = pt.make_optimizer(pt.trainable_parameters(core2), lr=LR,
                                     schedule="cosine", total_steps=5)
    state2 = pt.TrainState(core2, opt2, sched2)
    state2.load(str(tmp_path / "ckpt.pt"))
    assert state2.step == 1 and sched2.last_epoch == 1
    assert opt2.param_groups[0]["lr"] == pytest.approx(LR)  # cosine at 1
    got = float(pt.make_train_step(core2, smpl2, opt2, scheduler=sched2)(
        batch)["loss"])
    assert got == want


# ---------------------------------------------------------------------------
# the gait trainer
# ---------------------------------------------------------------------------
