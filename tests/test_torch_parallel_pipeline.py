"""gaitlab_torch.parallel.pipeline against gaitlab.parallel.pipeline on the
CPU, the runner's "pp" and "dp" surfaces with ForwardStream, and the entry
points: `demo --cpu_only --parallel dp|pp` and `api.load_pipeline(mesh=)`.

The port runs on device lists that name the CPU k times (a stage, or a
replica, per entry); gaitlab on its 8-device fake CPU mesh
(tests/conftest.py). Models are test_torch_models' TINY trunk at
64-pixel crops. gaitlab's GRNetPipeline equals its unsharded forward
(tests/test_pipeline_parallel.py), so the port's pipeline is held to
gaitlab's jitted forward on the same crops, which spares the compiles of
gaitlab's two sharded stage programs per configuration; the group
arithmetic (default_microbatch) and the refusals are held to gaitlab's
GRNetPipeline itself.

Tolerances, each `max|a - b| <= atol + rtol * max|b|`:
- against gaitlab: rtol 1e-4, atol 2e-5 (test_torch_models.
  assert_outputs_close: the same float32 sums in two libraries' orders);
- the port's parallel paths against its own one-device paths: rtol 1e-5,
  atol 1e-6 (one library; a stage or replica sees fewer rows at a time,
  which may change the order of a sum);
- the pkl of `demo --parallel` against the demo's: the same.
"""

import os
import shutil

import jax
import joblib
import numpy as np
import pytest
import torch

from gaitlab.nn.grnet import GRNet as JaxGRNet
from gaitlab.parallel import pipeline as jax_pipeline
from gaitlab_torch import api as pt_api
from gaitlab_torch.cli import demo as pt_demo
from gaitlab_torch.parallel import mesh as pt_mesh
from gaitlab_torch.parallel import pipeline as pt_pipeline
from gaitlab_torch.pipeline import runner as pt_runner
from test_torch_demo import PKL_KEYS, _args, clip  # noqa: F401
from test_torch_gait import gait_pair
from test_torch_models import (assert_close, assert_outputs_close,
                               jax_forward, tiny_pair)
from test_torch_parallel import _frames, assert_tracks_close
from torch_threads import torch_threads  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=6)


@pytest.fixture(scope="module")
def crops():
    return np.random.default_rng(0).standard_normal(
        (9, 64, 64, 3)).astype(np.float32)


def test_split_state_dict_matches_split_variables(pair):
    _, variables, port = pair
    state = port.module.state_dict()
    s0, s1 = pt_pipeline.split_state_dict(state)
    v0, v1 = jax_pipeline.split_variables(variables)
    assert set(s0) | set(s1) == set(state) and not set(s0) & set(s1)
    assert all(k.startswith("backbone.") for k in s0) and s0 and s1
    assert set(v0["params"]) == {"backbone"}
    assert "backbone" not in v1["params"]
    # each stage's group holds only its own weights
    pipe = pt_pipeline.GRNetPipeline(port, devices=[CPU] * 2)
    held0 = pipe._stage0.replicas.modules[0].state_dict()
    held1 = pipe._stage1.replicas.modules[0].state_dict()
    assert {f"backbone.{k}" for k in held0} == set(s0)
    assert {f"head.{k}" for k in held1} == set(s1)


@pytest.mark.parametrize("n_stage0,microbatch", [(4, 4), (2, 6), (1, None)],
                         ids=["even", "uneven", "default_microbatch"])
def test_pipeline_matches_gaitlab(pair, crops, n_stage0, microbatch):
    """9 crops (a zero-padded tail microbatch) over 8 devices split 4+4
    and 2+6, and over 2 split 1+1 at the default microbatch."""
    module, variables, port = pair
    n_dev = 2 if microbatch is None else 8
    pipe = pt_pipeline.GRNetPipeline(port, devices=[CPU] * n_dev,
                                     n_stage0=n_stage0)
    got = pipe(crops, microbatch=microbatch)
    want = jax_forward(module)(variables, crops)
    assert set(got) == set(want)
    assert all(v.shape[:2] == (1, 9) for v in got.values())
    assert_outputs_close(got, want)
    own = {k: v.numpy() for k, v in port.forward(torch.from_numpy(crops))[0]
           .items()}
    assert_outputs_close(got, own, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("groups", [(3, 5), (4, 4), (2, 6), (1, 1)])
def test_default_microbatch_matches_gaitlab(pair, groups):
    module, variables, port = pair
    jmodel = JaxGRNet(module=module, variables=variables, smpl=None)
    n0, n1 = groups
    want = jax_pipeline.GRNetPipeline(jmodel, devices=jax.devices()[:n0 + n1],
                                      n_stage0=n0)
    got = pt_pipeline.GRNetPipeline(port, devices=[CPU] * (n0 + n1),
                                    n_stage0=n0)
    for n in (1, 5, 17, 200):
        assert got.default_microbatch(n) == want.default_microbatch(n), n


def test_pipeline_refuses_what_gaitlab_refuses(pair):
    module, variables, port = pair
    jmodel = JaxGRNet(module=module, variables=variables, smpl=None)
    jdev = jax.devices()
    cases = [
        (lambda: jax_pipeline.GRNetPipeline(jmodel, jdev[:8], 3)(
            np.zeros((4, 64, 64, 3), np.float32), microbatch=4),
         lambda: pt_pipeline.GRNetPipeline(port, [CPU] * 8, 3)(
            np.zeros((4, 64, 64, 3), np.float32), microbatch=4), "microbatch"),
        (lambda: jax_pipeline.GRNetPipeline(jmodel, jdev[:1]),
         lambda: pt_pipeline.GRNetPipeline(port, [CPU]), "devices"),
        (lambda: jax_pipeline.GRNetPipeline(jmodel, jdev[:4], 4),
         lambda: pt_pipeline.GRNetPipeline(port, [CPU] * 4, 4), "n_stage0"),
        (lambda: jax_pipeline.GRNetPipeline(jmodel, jdev[:8])(
            np.zeros((0, 64, 64, 3), np.float32)),
         lambda: pt_pipeline.GRNetPipeline(port, [CPU] * 8)(
            np.zeros((0, 64, 64, 3), np.float32)), "one frame"),
    ]
    for jax_call, port_call, match in cases:
        with pytest.raises(ValueError, match=match):
            jax_call()
        with pytest.raises(ValueError, match=match):
            port_call()
    gait_module, gait_vars, gait = gait_pair()
    with pytest.raises(ValueError, match="gait"):
        jax_pipeline.GRNetPipeline(JaxGRNet(module=gait_module,
                                            variables=gait_vars, smpl=None))
    with pytest.raises(ValueError, match="gait"):
        pt_pipeline.GRNetPipeline(gait, devices=[CPU] * 2)


def test_pipeline_stage_error_reaches_the_caller(pair, crops, monkeypatch):
    _, _, port = pair
    pipe = pt_pipeline.GRNetPipeline(port, devices=[CPU] * 2)

    def broken(*args, **kw):
        raise KeyError("stage 1 failed")

    monkeypatch.setattr(pt_pipeline, "vp_regress", broken)
    with pytest.raises(KeyError, match="stage 1 failed"):
        pipe(crops, microbatch=2)


def test_runner_pp_surface_matches_dp(pair, monkeypatch):
    """GRNetRunner(parallel="pp") on 3 devices (1+2) and parallel="dp" on
    3 replicas agree with the one-device runner end to end (run_track);
    ForwardStream in both modes gives what forward_crops gives, and pp
    keeps every chunk until finish()."""
    _, _, port = pair
    monkeypatch.setattr(pt_mesh, "devices_for", lambda device: [CPU] * 3)
    frames, bboxes = _frames(9, seed=5)
    kw = dict(crop_size=64, buckets=(4,), crop_on="host")
    base = pt_runner.GRNetRunner(port, **kw)
    pp = pt_runner.GRNetRunner(port, parallel="pp", pp_n_stage0=1, **kw)
    dp = pt_runner.GRNetRunner(port, parallel="dp", **kw)
    assert dp.mesh.shape == {"data": 3, "model": 1} and dp.buckets == (6,)
    want = base.run_track(frames, bboxes)
    assert {"pred_cam", "pose", "betas", "verts", "joints3d",
            "joints2d"} == set(want)
    for runner in (pp, dp):
        assert_tracks_close(runner.run_track(frames, bboxes), want, 1e-5,
                            1e-6)

    crops = base.crop_track(frames, bboxes)
    full = base.forward_crops(crops)
    for runner in (pp, dp):
        session = runner.open_stream()
        for s in range(0, 9, 2):
            session.feed(crops[s:s + 2])
        if runner is pp:
            assert session._buffered == 9 and not session._lengths
        out = session.finish()
        assert set(out) == set(full)
        for k in full:
            assert_close(out[k], full[k], 1e-5, 1e-6, k)
    pp.fetch = ("kp_3d",)
    assert set(pp.forward_crops(crops)) == {"kp_3d"}


@pytest.fixture(scope="module")
def parallel_clip(clip, tmp_path_factory):  # noqa: F811
    """test_torch_demo's clip under a name of its own: the demo extracts a
    clip's frames into a folder named after it, which the demo tests of
    another file, running at the same time, would share."""
    d = tmp_path_factory.mktemp("torch_parallel_demo")
    vid = str(d / "torch_parallel_walk.mp4")
    shutil.copy(clip[1], vid)
    return d, vid, clip[2]


def demo_pkl(parallel_clip, name, *extra):
    """The port's demo on the clip into the folder `name`: its pkl."""
    d, vid, trackfile = parallel_clip
    out = str(d / name)
    pt_demo.main(_args(pt_demo.build_parser(), vid, trackfile, out, *extra))
    return joblib.load(os.path.join(out, "torch_parallel_walk_mp4",
                                    "grnet.pkl"))


@pytest.fixture(scope="module")
def demo_plain(parallel_clip):
    """The demo tests' model and its demo without --parallel, run once for
    both cases."""
    port = tiny_pair(seed=5)[2]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pt_demo, "load_model", lambda args, cfg: port)
        mp.setenv("GAITLAB_BUCKETS", "16")
        return port, demo_pkl(parallel_clip, "plain")


@pytest.mark.parametrize("parallel", ["dp", "pp"])
def test_demo_parallel_on_the_cpu(parallel_clip, demo_plain, monkeypatch,
                                  parallel):
    """`demo --cpu_only --parallel dp|pp`: the mesh is the CPU alone, which
    --parallel dp runs on and --parallel pp refuses (gaitlab's ValueError:
    it needs two devices); over a list that names the CPU twice, both
    write the pkl of the demo without --parallel."""
    port, want = demo_plain
    monkeypatch.setattr(pt_demo, "load_model", lambda args, cfg: port)
    monkeypatch.setenv("GAITLAB_BUCKETS", "16")

    def run(name, *extra):
        return demo_pkl(parallel_clip, f"{parallel}_{name}", *extra)

    if parallel == "pp":
        with pytest.raises(ValueError, match="need >= 2 devices"):
            run("one", "--parallel", "pp")
    else:
        got = run("one", "--parallel", "dp")[0]
        for k in PKL_KEYS:
            np.testing.assert_array_equal(got[k], want[0][k], k)
    monkeypatch.setattr(pt_mesh, "devices_for", lambda device: [CPU] * 2)
    got = run("two", "--parallel", parallel)
    assert list(got) == list(want) == [0]
    np.testing.assert_array_equal(got[0]["frame_ids"], want[0]["frame_ids"])
    for k in ("pred_cam", "verts", "betas", "joints3d", "joints2d",
              "orig_cam"):
        assert_close(got[0][k], want[0][k], 1e-5, 1e-6, k)


def test_load_pipeline_takes_a_mesh():
    mesh = pt_mesh.make_mesh(devices=[CPU] * 2)
    model, runner = pt_api.load_pipeline(device="cpu", mesh=mesh)
    assert runner.mesh is mesh and runner._dp[0].modules[0] is model.module
    assert len(runner._dp[0]) == 2 and runner.parallel is None
