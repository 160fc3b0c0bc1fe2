"""gaitlab_torch.training.make_dp_train_step against gaitlab's
`--use_mesh` step (make_train_step jitted with its batch split over the
"data" axis of make_mesh(2) on the fake CPU mesh) and against the port's
one-device step, on a batch whose has_smpl is mixed.

Both packages run test_torch_models' TINY trunk at 64-pixel crops, on the
CPU in float32, with the same weights, three SGD steps (batch_stats held
still on gaitlab's side, as test_torch_training.py does). The port's
replicas are two entries of one device list that names the CPU twice.

Tolerances, each `max|a - b| <= atol + rtol * max|b|`:
- against gaitlab: as test_torch_training.py, losses rtol 1e-5, and
  every parameter's distance moved rtol 1e-4 with an atol of 3e-6 of the
  largest first-step gradient times the learning rate;
- against the port's one-device step: losses rtol 1e-6 (one library),
  distance moved rtol 1e-4: the replicas' gradients are summed in parts,
  in another order, and the gradients of the head's first convolutions
  pass through the softmax pooling's backward, whose subtraction cancels
  in float32 (test_torch_training.py), which turns that order into about
  3e-5 of their size;
- backbone parameters, BN buffers and the replicas' copies: bit-equal.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from gaitlab import training as jt
from gaitlab.body import smpl as jax_smpl
from gaitlab.parallel import make_mesh, param_shardings
from gaitlab_torch import training as pt
from gaitlab_torch.ops import blendshapes as b2
from gaitlab_torch.ops import keypoint_attention as b1
from gaitlab_torch.weights.convert import state_dict_from_flax
from test_torch_models import assert_close, port_from_jax, tiny_pair
from test_torch_training import numpy_batch, port_batch
from torch_threads import torch_threads  # noqa: F401

LR = 1e-3
MOMENTUM = 0.9
N = 4
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=7)


@pytest.fixture(scope="module")
def batch():
    b = numpy_batch(n=N, seed=11)
    assert 0 < b["has_smpl"].sum() < N  # mixed
    return b


@pytest.fixture(scope="module")
def jax_mesh_run(pair, batch):
    """Three SGD steps of gaitlab's step as `cli/train.py --use_mesh`
    compiles it on a mesh of 2 devices."""
    module, variables, _ = pair
    tx = optax.multi_transform(
        {"p": optax.sgd(LR, momentum=MOMENTUM), "bs": optax.set_to_zero()},
        {"params": "p", "batch_stats": "bs"})
    mesh = make_mesh(2)
    state = jt.create_train_state(variables, tx)
    state_sh = jt.TrainState(params=param_shardings(state.params, mesh),
                             opt_state=param_shardings(state.opt_state, mesh),
                             step=NamedSharding(mesh, P()))
    step = jax.jit(jt.make_train_step(module, jax_smpl.synthetic_smpl_params(),
                                      tx),
                   in_shardings=(state_sh, NamedSharding(mesh, P("data"))),
                   out_shardings=(state_sh, NamedSharding(mesh, P())))
    state = jax.device_put(state, state_sh)
    losses, grad_max = [], 0.0
    with jax.default_matmul_precision("float32"):
        for _ in range(3):
            before = jax.tree_util.tree_map(np.asarray, state.params)
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            if not grad_max:  # SGD's first step is -lr * gradient
                grad_max = max(np.abs(np.asarray(a) - b).max() for a, b in zip(
                    jax.tree_util.tree_leaves(state.params["params"]),
                    jax.tree_util.tree_leaves(before["params"]))) / LR
    return {"losses": losses, "grad_max": grad_max,
            "after": jax.tree_util.tree_map(np.asarray, state.params)}


def run_port(variables, batch, devices):
    """Three SGD steps of the port's step (data-parallel over `devices`
    when there are several): losses, the core and its state before."""
    model = port_from_jax(variables)
    core, smpl = model.module, model.smpl
    start = {k: v.clone() for k, v in core.state_dict().items()}
    opt, sched = pt.make_optimizer(pt.trainable_parameters(core), lr=LR,
                                   kind="sgd", momentum=MOMENTUM)
    if len(devices) > 1:
        step = pt.make_dp_train_step(core, smpl, opt, devices,
                                     scheduler=sched)
    else:
        step = pt.make_train_step(core, smpl, opt, scheduler=sched)
    b = port_batch(batch)
    counts = (b1.keypoint_attention_fused.backwards, b2.blendshapes.backwards)
    losses = [float(step(b)["loss"]) for _ in range(3)]
    counts = (b1.keypoint_attention_fused.backwards - counts[0],
              b2.blendshapes.backwards - counts[1])
    return losses, core, start, counts, step


def test_dp_step_matches_gaitlabs_mesh_step(pair, batch, jax_mesh_run):
    _, variables, _ = pair
    losses, core, start, counts, _ = run_port(variables, batch, [CPU] * 2)
    # both ops' backwards ran in each replica, every step
    assert counts == (6, 6)
    assert_close(np.array(losses), np.array(jax_mesh_run["losses"]),
                 rtol=1e-5, atol=0, what="losses")
    want = state_dict_from_flax(jax_mesh_run["after"])
    floor = 1e-6 * jax_mesh_run["grad_max"] * LR
    for name, p in core.named_parameters():
        got, w0 = p.detach().numpy(), start[name].numpy()
        if name.startswith("backbone."):
            assert np.array_equal(got, w0), name
            continue
        assert_close(got - w0, want[name].numpy() - w0, rtol=1e-4,
                     atol=3 * floor, what=name)
    for name, buf in core.named_buffers():
        assert torch.equal(buf, start[name]), name


def test_dp_step_matches_the_one_device_step(pair, batch):
    """Two and four replicas against one device: the loss is the whole
    batch's, gathered on the first device."""
    _, variables, _ = pair
    losses1, core1, start, _, _ = run_port(variables, batch, [CPU])
    for k in (2, 4):
        losses, core, _, _, step = run_port(variables, batch, [CPU] * k)
        assert_close(np.array(losses), np.array(losses1), rtol=1e-6, atol=0,
                     what=f"losses over {k}")
        for (name, p), p1 in zip(core.named_parameters(),
                                 core1.parameters()):
            assert_close(p.detach() - start[name], p1.detach() - start[name],
                         rtol=1e-4, atol=1e-12, what=f"{name} over {k}")
    # the replicas hold the trained parameters and buffers, bit for bit
    first, *others = step.replicas.modules
    assert first is core
    for replica in others:
        for (name, p), q in zip(first.state_dict().items(),
                                replica.state_dict().values()):
            assert torch.equal(p, q), name



def test_dp_step_refuses_a_core_off_its_first_device(pair):
    _, variables, _ = pair
    model = port_from_jax(variables)
    opt, _ = pt.make_optimizer(pt.trainable_parameters(model.module))
    with pytest.raises(ValueError, match="devices\\[0\\]"):
        pt.make_dp_train_step(model.module, model.smpl, opt,
                              [torch.device("meta"), CPU])
    step = pt.make_dp_train_step(model.module, model.smpl, opt, [CPU] * 3)
    with pytest.raises(ValueError, match="split evenly"):
        step(port_batch(numpy_batch(n=4)))
