"""gaitlab_torch.parallel against gaitlab.parallel on the CPU: the mesh,
the model-axis placement rule (param_shardings, shard_params), replicas,
and data-parallel inference through GRNetRunner, with and without the gait
branch (test_torch_parallel_pipeline.py: the 2-stage pipeline, the
entry points and the data-parallel train step).

gaitlab runs on the 8-device fake CPU mesh of tests/conftest.py, the port
on a device list that names the CPU k times (a list may repeat a
device). Models are test_torch_models' TINY trunk at 64-pixel crops.

Tolerances, each `max|a - b| <= atol + rtol * max|b|`:
- specs, shards and replicas: exact (placement moves bytes, no math);
- the port's data-parallel runner against gaitlab's on its mesh: rtol
  1e-4, atol 2e-5, as test_torch_pipeline.py holds the one-device
  runners (the same float32 sums in two libraries' orders);
- the port's data-parallel runner against its own one-device runner:
  rtol 1e-5, atol 1e-6 (the same library; a replica's convolutions see
  fewer rows, which may change the order of a sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaitlab.body import smpl as jax_smpl
from gaitlab.core import geometry as jax_geometry
from gaitlab.nn.grnet import GRNet as JaxGRNet
from gaitlab.parallel import mesh as jax_mesh
from gaitlab.pipeline import runner as jax_runner
from gaitlab_torch import device as pt_device
from gaitlab_torch.body import smpl as pt_smpl
from gaitlab_torch.parallel import mesh as pt_mesh
from gaitlab_torch.parallel import replicas as pt_replicas
from gaitlab_torch.pipeline import runner as pt_runner
from gaitlab_torch.weights.convert import _LEAF, torch_module_path
from test_torch_gait import gait_pair
from test_torch_models import assert_close, tiny_pair

CPU = torch.device("cpu")
TOKEN_MAJOR = ("head.shape_mlp.weight", "head.cam_mlp.weight")


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=4)


def flax_leaves(tree, path=()):
    """(path, leaf) of a nested mapping of arrays."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flax_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def torch_key(path) -> str:
    """The state_dict key of a gaitlab variable path (coll, *mods, leaf)."""
    *mods, leaf = path[1:]
    return f"{torch_module_path(mods)}.{_LEAF[leaf]}"


def torch_layout(flax_array, key: str, shape) -> np.ndarray:
    """A Flax-layout array in torch's layout through the axis map."""
    axes = pt_mesh.flax_axes(key, len(shape))
    perm = [a for a in axes if a is not None]
    return np.transpose(np.asarray(flax_array), perm).reshape(shape)


def port_spec(flax_spec, key: str, ndim: int) -> tuple:
    """gaitlab's spec of a Flax leaf mapped onto the torch tensor's dims."""
    if not tuple(flax_spec):
        return ()
    return tuple(None if a is None else tuple(flax_spec)[a]
                 for a in pt_mesh.flax_axes(key, ndim))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,model", [(8, 1), (8, 2), (4, 4), (6, 3), (2, 1)])
def test_make_mesh_matches_gaitlab(n, model):
    want = jax_mesh.make_mesh(n, model=model)
    got = pt_mesh.make_mesh(n, model=model, devices=[CPU] * 8)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape
    assert got.data_devices == [CPU] * want.devices.shape[0]
    assert pt_mesh.data_sharding(got, 3, axis=1).spec == tuple(
        jax_mesh.data_sharding(want, 3, axis=1).spec)
    assert pt_mesh.replicated(got).spec == tuple(
        jax_mesh.replicated(want).spec)


def test_make_mesh_errors_and_defaults(monkeypatch):
    for n, model in ((6, 4), (9, 1)):
        with pytest.raises(ValueError):
            jax_mesh.make_mesh(n, model=model)
        with pytest.raises(ValueError):
            pt_mesh.make_mesh(n, model=model, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="not divisible"):
        pt_mesh.make_mesh(6, model=4, devices=[CPU] * 8)
    if not torch.cuda.is_available():
        # every visible card, and without one it raises: never the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt_mesh.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt_mesh.devices_for("cuda")
    assert pt_mesh.devices_for("cpu") == [CPU]
    monkeypatch.setattr(pt_mesh, "default_devices", lambda: [CPU] * 4)
    assert pt_mesh.make_mesh(model=2).shape == {"data": 2, "model": 2}


# ---------------------------------------------------------------------------
# the model axis: placement of parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,min_elems", [(2, 1 << 14), (2, 256),
                                             (4, 256)])
def test_param_shardings_pick_gaitlabs_dim(pair, model, min_elems):
    """Leaf for leaf on the small GRNetCore: the port's spec is gaitlab's
    on the same logical dim, through the axis map, and the axis map takes
    each Flax leaf to the converted tensor."""
    _, variables, port = pair
    state = port.module.state_dict()
    want = jax_mesh.param_shardings(variables, jax_mesh.make_mesh(8, model),
                                    min_elems=min_elems)
    got = pt_mesh.param_shardings(state, pt_mesh.make_mesh(
        8, model, devices=[CPU] * 8), min_elems=min_elems)
    leaves = dict(flax_leaves(variables))
    split = 0
    for path, sharding in flax_leaves(want):
        key = torch_key(path)
        t = state[key]
        if key not in TOKEN_MAJOR:  # token-major rows reordered in place
            np.testing.assert_array_equal(
                torch_layout(leaves[path], key, t.shape), t.numpy(), key)
        assert got[key].spec == port_spec(sharding.spec, key, t.dim()), key
        split += bool(got[key].spec)
    assert split > 0  # some leaf is split at every setting
    # num_batches_tracked has no gaitlab leaf: replicated
    assert all(got[k].spec == () for k in state
               if k.endswith("num_batches_tracked"))


def test_param_shardings_of_smpl():
    want = jax_mesh.param_shardings(jax_smpl.synthetic_smpl_params(),
                                    jax_mesh.make_mesh(8, 2))
    got = pt_mesh.param_shardings(pt_smpl.synthetic_smpl_params(),
                                  pt_mesh.make_mesh(8, 2, devices=[CPU] * 8))
    assert got._fields == want._fields
    for name, w, g in zip(want._fields, want, got):
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.spec == tuple(w.spec), name
    assert any(g.spec for g in got if g is not None)


def test_shard_params_match_gaitlabs_shards(pair):
    """Every device's shard of every leaf, in mesh order, equals gaitlab's
    addressable shard through the axis map; the shards reassemble
    bit-exactly. Likewise SMPL's fields."""
    _, variables, port = pair
    state = port.module.state_dict()
    jm = jax_mesh.make_mesh(8, 2)
    pm = pt_mesh.make_mesh(8, 2, devices=[CPU] * 8)
    want = jax_mesh.shard_params(variables, jm, min_elems=256)
    got = pt_mesh.shard_params(state, pm, min_elems=256)
    order = list(jm.devices.flat)
    for path, arr in flax_leaves(want):
        key = torch_key(path)
        shards = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        placed = got[key]
        assert len(placed.shards) == len(order)
        for dev, shard in zip(order, placed.shards):
            assert shard.device == CPU
            if key not in TOKEN_MAJOR:
                np.testing.assert_array_equal(
                    shard.numpy(), torch_layout(shards[dev], key,
                                                shard.shape), key)
        assert torch.equal(placed.full(), state[key]), key
    smpl = pt_smpl.synthetic_smpl_params()
    jsmpl = jax_mesh.shard_params(jax_smpl.synthetic_smpl_params(), jm)
    for name, p, j in zip(smpl._fields, pt_mesh.shard_params(smpl, pm),
                          jsmpl):
        if p is None:
            continue
        shards = {s.device: np.asarray(s.data) for s in j.addressable_shards}
        for dev, shard in zip(order, p.shards):
            np.testing.assert_array_equal(shard.numpy(), shards[dev], name)
        np.testing.assert_array_equal(p.full().numpy(),
                                      np.asarray(getattr(smpl, name)), name)


# ---------------------------------------------------------------------------
# replicas
# ---------------------------------------------------------------------------

def test_replicas_scatter_apply_gather():
    lin = torch.nn.Linear(3, 2)
    reps = pt_replicas.Replicas(lin, [CPU] * 3)
    assert reps.modules[0] is lin and reps.streams == [None] * 3
    for m in reps.modules[1:]:
        assert m is not lin
        assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                     lin.parameters()))
    x = torch.arange(18.0).reshape(6, 3)
    parts = pt_replicas.scatter(x, reps.devices)
    assert [p.tolist() for p in parts] == [x[:2].tolist(), x[2:4].tolist(),
                                          x[4:].tolist()]
    seen = []

    def fn(module, xs):
        seen.append((torch.is_grad_enabled(),
                     torch.is_inference_mode_enabled(),
                     torch.backends.cudnn.allow_tf32,
                     pt_device.held_math_mode()))
        return {"y": module(xs)}

    with torch.inference_mode(), pt_device.float32_math():
        out = pt_replicas.gather(reps.apply(fn, [(p,) for p in parts]), CPU)
    assert torch.equal(out["y"], lin(x).detach())
    # each thread took the caller's modes and its turn at the TF32 gate
    # (off); outside one, a thread holds none and sets its own
    assert seen == [(False, True, False, False)] * 3
    seen.clear()
    reps.apply(fn, [(p,) for p in parts])
    assert [s[3] for s in seen] == [None] * 3
    with pytest.raises(ValueError, match="split evenly"):
        pt_replicas.scatter(torch.zeros(4, 1), reps.devices)

    def fail(module, xs):  # the second replica's error reaches the caller
        if xs[0, 0] == 6:
            raise KeyError("replica 1")
        return module(xs)

    with pytest.raises(KeyError, match="replica 1"):
        reps.apply(fail, [(p,) for p in parts])


# ---------------------------------------------------------------------------
# data-parallel inference
# ---------------------------------------------------------------------------

def _frames(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (n, 96, 128, 3)).astype(np.uint8)
    bboxes = np.stack([rng.uniform(55, 75, n), rng.uniform(40, 56, n),
                       rng.uniform(60, 80, n), np.full(n, 70.0)],
                      1).astype(np.float32)
    bboxes[:, 3] = bboxes[:, 2]
    return frames, bboxes


def rot(aa):
    """pose through the rotations it encodes."""
    return np.asarray(jax_geometry.axis_angle_to_rotmat(
        jnp.asarray(np.asarray(aa, np.float32).reshape(-1, 3))))


def assert_tracks_close(got: dict, want: dict, rtol: float, atol: float):
    assert set(got) == set(want)
    for k in want:
        if k == "pose":
            assert_close(rot(got[k]), rot(want[k]), rtol, atol, k)
        else:
            assert_close(got[k], want[k], rtol, atol, k)


def test_dp_runner_matches_gaitlabs_mesh_runner(pair):
    """k = 4 replicas, a bucket (6) that 4 does not divide: both runners
    round it to 8; 11 frames make a forward at 8 and a tail of 3 padded
    to 8."""
    module, variables, port = pair
    jmodel = JaxGRNet(module=module, variables=variables,
                      smpl=jax_smpl.synthetic_smpl_params())
    frames, bboxes = _frames(11)
    kw = dict(crop_size=64, buckets=(6,), crop_on="host")
    jr = jax_runner.GRNetRunner(jmodel, precision="float32",
                                mesh=jax_mesh.make_mesh(4), **kw)
    pr = pt_runner.GRNetRunner(port, mesh=pt_mesh.make_mesh(
        devices=[CPU] * 4), **kw)
    assert pr.buckets == jr.buckets == (8,)
    reps = pr._dp[0]
    assert len(reps) == 4 and reps.modules[0] is port.module
    got = pr.run_track(frames, bboxes)
    assert_tracks_close(got, jr.run_track(frames, bboxes), 1e-4, 2e-5)
    single = pt_runner.GRNetRunner(port, **kw).run_track(frames, bboxes)
    assert_tracks_close(got, single, 1e-5, 1e-6)


def test_dp_runner_gait_branch_matches_gaitlab():
    """MAX-GRNet's small twin, 10 frames over k = 4 at bucket 8: a full
    forward and a tail of 2 padded to 8. The replicas run the per-frame
    part; the corrector runs on the gathered rows."""
    module, variables, port = gait_pair(seed=1)
    jmodel = JaxGRNet(module=module, variables=variables,
                      smpl=jax_smpl.synthetic_smpl_params())
    frames, bboxes = _frames(10, seed=3)
    kw = dict(crop_size=64, buckets=(8,), crop_on="host")
    got = pt_runner.GRNetRunner(port, parallel="dp", mesh=pt_mesh.make_mesh(
        devices=[CPU] * 4), **kw).run_track(frames, bboxes)
    want = jax_runner.GRNetRunner(
        jmodel, precision="float32", parallel="dp",
        mesh=jax_mesh.make_mesh(4), **kw).run_track(frames, bboxes)
    assert got["pred_avg"].shape == (3,) and got["pred_phase"].shape == (10, 4)
    assert_tracks_close(got, want, 1e-4, 2e-5)
    single = pt_runner.GRNetRunner(port, **kw).run_track(frames, bboxes)
    assert_tracks_close(got, single, 1e-5, 1e-6)


def test_runner_parallel_checks(pair):
    """gaitlab's ValueErrors, and "dp" without a mesh takes the model's
    devices: the CPU alone for a model on the CPU."""
    _, _, port = pair
    with pytest.raises(ValueError, match="parallel="):
        pt_runner.GRNetRunner(port, parallel="zz")
    with pytest.raises(ValueError, match="mesh"):
        pt_runner.GRNetRunner(port, parallel="pp", mesh=pt_mesh.make_mesh(
            devices=[CPU] * 2))
    _, _, gait = gait_pair()
    with pytest.raises(ValueError, match="gait"):
        pt_runner.GRNetRunner(gait, parallel="pp")
    r = pt_runner.GRNetRunner(port, parallel="dp", buckets=(5, 9))
    assert r.mesh.shape == {"data": 1, "model": 1} and r.buckets == (5, 9)
    r = pt_runner.GRNetRunner(port, mesh=pt_mesh.make_mesh(
        devices=[CPU] * 3), buckets=(5, 9))
    assert r.buckets == (6, 9)
