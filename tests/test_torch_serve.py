"""gaitlab_torch.serve (torch.export artifacts) and cli/serve.py, against
the port's live forward and gaitlab's bucket forward.

The mirror of tests/test_serve.py at 64-pixel crops with the shrunk trunk
(test_torch_models.TINY) and bucket (4,), on the CPU
(`platforms=("cpu",)`, `device="cpu"`); the gait branch's artifacts and
the masked BiGRU are in test_torch_serve_gait.py. The programs are
exported on the CPU and hold both kernels as custom-op nodes, which run
their plain versions here.

Tolerances: a loaded program against the live forward that it was
exported from runs the same ops on the same inputs, 1e-5; against gaitlab
on the same weights (converted with state_dict_from_flax) and crops,
test_torch_models.assert_outputs_close (rtol 1e-4, atol 2e-5).
"""

import json
import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaitlab.body import smpl as jax_smpl
from gaitlab.nn.grnet import GRNet as JaxGRNet
from gaitlab.pipeline.runner import GRNetRunner as JaxRunner
from gaitlab_torch import serve
from gaitlab_torch.pipeline.runner import GRNetRunner
from test_torch_models import assert_close, assert_outputs_close, tiny_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = 64
PER_FRAME = ("theta", "verts", "kp_2d", "kp_3d")
OPS = {"gaitlab.keypoint_attention_fused.default",
       "gaitlab.blendshapes.default"}


def u8_crops(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (n, CROP, CROP, 3)).astype(np.uint8)


def edge_pad(x: np.ndarray, b: int) -> np.ndarray:
    return np.concatenate([x, np.repeat(x[-1:], b - len(x), 0)])


def track(n: int, seed: int = 5):
    """n frames of 96x128 and a box on each."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (n, 96, 128, 3)).astype(np.uint8)
    return frames, np.tile(np.array([64.0, 48.0, 60.0, 60.0], np.float32),
                           (n, 1))


def outputs_close(got: dict, want: dict, n: int):
    """assert_outputs_close on the per-frame outputs of n frames (the
    bucket programs return no rotmat)."""
    assert_outputs_close(
        {**{k: np.asarray(got[k])[:n] for k in PER_FRAME},
         "rotmat": np.zeros(1)},
        {**{k: np.asarray(want[k])[:n] for k in PER_FRAME},
         "rotmat": np.zeros(1)})


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    module, variables, port = tiny_pair(seed=4)
    runner = GRNetRunner(port, buckets=(4,), crop_size=CROP)
    art_dir = str(tmp_path_factory.mktemp("torch_serve") / "artifacts")
    manifest = serve.save_artifacts(runner, art_dir, platforms=("cpu",))
    jax_model = JaxGRNet(module=module, variables=variables,
                         smpl=jax_smpl.synthetic_smpl_params())
    return {"runner": runner, "art_dir": art_dir, "manifest": manifest,
            "port": port, "jax_model": jax_model,
            "loaded": serve.load_artifacts(art_dir, device="cpu")}


def test_manifest_and_files(served):
    m, art = served["manifest"], served["art_dir"]
    assert m["format"] == "torch.export"
    assert m["manifest_version"] == serve.MANIFEST_VERSION == 2
    assert m["torch_version"] == torch.__version__
    assert m["platforms"] == ["cpu"] and m["buckets"] == [4]
    assert m["raw_uint8"] and m["crop_size"] == CROP and not m["gait"]
    assert m["precision"] == "float32" and m["joint_mode"] == "spin2"
    # the modes the program runs, resolved: float32 throughout, one
    # program with TF32 off
    assert (m["head_precision"], m["trunk_dtype"]) == (None, None)
    assert (m["region_precision"], m["tf32"]) == ([], [False])
    assert m["files"] == {"4": {"cpu": ["forward_b4.cpu.pt2"]}}
    assert m["weights"] == "weights.npz"
    with open(os.path.join(art, "manifest.json")) as f:
        assert json.load(f) == m
    assert sorted(os.listdir(art)) == ["forward_b4.cpu.pt2", "manifest.json",
                                       "weights.npz"]


def test_graph_holds_both_ops_and_no_weights(served):
    ep = torch.export.load(os.path.join(served["art_dir"],
                                        "forward_b4.cpu.pt2"))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert {t: targets.count(t) for t in OPS} == dict.fromkeys(OPS, 1)
    assert ep.state_dict == {} and list(ep.parameters()) == []
    # the weights arrive as inputs: one placeholder per state_dict key
    n_state = len(served["port"].module.state_dict())
    assert len([n for n in ep.graph.nodes if n.op == "placeholder"]) > n_state


def test_padded_dispatch_matches_live(served):
    runner = served["runner"]
    crops = u8_crops(3, seed=1)
    loaded = served["loaded"]
    got = loaded.call(None, None, crops)
    assert set(got) == set(PER_FRAME) and got["kp_3d"].shape[0] == 3

    model = runner.model
    with torch.inference_mode():
        want = runner._forward(4, True)(
            model.module.state_dict(), model.smpl,
            torch.from_numpy(edge_pad(crops, 4)))
    for k in PER_FRAME:
        assert_close(got[k], want[k][:3].numpy(), rtol=1e-5, atol=1e-5,
                     what=k)
    with pytest.raises(ValueError, match="exceeds the largest"):
        loaded.call(None, None, u8_crops(9))


def test_artifact_matches_gaitlab_bucket_forward(served):
    crops = u8_crops(3, seed=2)
    got = served["loaded"].call(None, None, crops)
    jax_runner = JaxRunner(served["jax_model"], buckets=(4,),
                           precision="float32", crop_size=CROP)
    want = jax_runner._forward(4, True)(
        jax_runner._trunk_variables(), jax_runner._smpl_params(),
        jnp.asarray(edge_pad(crops, 4)))
    outputs_close(got, want, 3)


_RELOAD_SCRIPT = """
import sys
import numpy as np

from gaitlab_torch import serve  # the artifact loader only: no nn/ code

art_dir, blob = sys.argv[1], np.load(sys.argv[2])
out = serve.load_artifacts(art_dir, device="cpu").call(None, None,
                                                       blob["crops"])
for k in ("theta", "verts", "kp_2d", "kp_3d"):
    np.testing.assert_allclose(out[k], blob[k], rtol=1e-5, atol=1e-5,
                               err_msg=k)
track = serve.load_runner(art_dir, device="cpu").run_track(
    blob["frames"], blob["bboxes"])
for k in ("verts", "joints3d", "pose"):
    np.testing.assert_allclose(track[k], blob["track_" + k], rtol=1e-5,
                               atol=1e-5, err_msg=k)
loaded = sorted(m for m in sys.modules if m.startswith(
    ("gaitlab_torch.nn", "gaitlab.", "jax", "flax")) or m == "gaitlab")
assert not loaded, loaded
print("RELOAD_OK", sorted(out))
"""


def test_fresh_interpreter_reload(served, tmp_path):
    """A process that imports only gaitlab_torch.serve serves from the
    directory, through load_artifacts and through load_runner, without
    loading the model code."""
    crops = u8_crops(4, seed=4)
    want = served["loaded"].call(None, None, crops)
    frames, bboxes = track(5)
    live = GRNetRunner(served["port"], buckets=(4,), crop_size=CROP,
                       crop_on="host").run_track(frames, bboxes)
    blob = str(tmp_path / "blob.npz")
    np.savez(blob, crops=crops, frames=frames, bboxes=bboxes, **want,
             **{"track_" + k: live[k] for k in ("verts", "joints3d", "pose")})
    r = subprocess.run([sys.executable, "-c", _RELOAD_SCRIPT,
                        served["art_dir"], blob], capture_output=True,
                       text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "RELOAD_OK" in r.stdout


def test_export_for_an_absent_card_raises(served, tmp_path):
    """The default platforms include the card's: without one, export
    raises instead of leaving that program out."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.save_artifacts(served["runner"], str(tmp_path / "art"))
    assert not (tmp_path / "art" / "manifest.json").exists()


def test_weights_roundtrip(served, tmp_path):
    state, smpl = serve.load_weights(served["art_dir"])
    port = served["port"]
    want = port.module.state_dict()
    assert list(state) == list(want)
    for k, v in want.items():
        assert state[k].dtype == v.dtype, k
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)
    for name, w in port.smpl._asdict().items():
        np.testing.assert_array_equal(np.asarray(getattr(smpl, name)),
                                      np.asarray(w), err_msg=name)
    assert isinstance(smpl.faces, np.ndarray)
    # absent SMPL fields come back as None
    bare = type(port)(port.module, port.smpl._replace(
        J_regressor_extra=None, faces=None), port.device)
    serve.save_weights(str(tmp_path), bare)
    _, smpl = serve.load_weights(str(tmp_path))
    assert smpl.J_regressor_extra is None and smpl.faces is None
    torch.testing.assert_close(smpl.posedirs, port.smpl.posedirs, rtol=0,
                               atol=0)


def test_load_runner_matches_live(served, monkeypatch):
    def no_export(*a, **kw):
        raise AssertionError("load_runner retraced the model")

    monkeypatch.setattr(torch.export, "export", no_export)
    srunner = serve.load_runner(served["art_dir"], device="cpu")
    assert tuple(srunner.buckets) == (4,)
    assert srunner.crop_size == CROP and srunner.crop_on == "host"
    frames, bboxes = track(7)
    got = srunner.run_track(frames, bboxes)
    direct = GRNetRunner(served["port"], buckets=(4,), crop_size=CROP,
                         crop_on="host").run_track(frames, bboxes)
    assert set(got) == set(direct)
    for k in direct:
        assert_close(got[k], direct[k], rtol=1e-5, atol=1e-5, what=k)

    # a wrong dispatch mode or bucket fails loudly, never retraces
    with pytest.raises(ValueError, match="raw_uint8"):
        srunner._forward(4, False)
    with pytest.raises(ValueError, match="bucket"):
        srunner._forward(16, True)
    with pytest.raises(ValueError, match="raw_uint8"):
        serve.load_runner(served["art_dir"], device="cpu",
                          crop_on="device").run_track(frames, bboxes)


def test_reads_a_manifest_written_before_the_precision_modes(served,
                                                            tmp_path):
    """An artifact directory exported before the manifest had a version
    (one float32 program per bucket and platform, its file name a string,
    "head_precision" and "trunk_dtype" written as "float32", no TF32 list
    and no region modes) loads as float32 with TF32 off, through
    load_artifacts and load_runner; a version this module does not know
    asks for a new export."""
    import shutil

    old = tmp_path / "old"
    shutil.copytree(served["art_dir"], old)
    m = dict(served["manifest"])
    for key in ("manifest_version", "tf32", "region_precision",
                "resize_precision"):
        del m[key]
    m.update(head_precision="float32", trunk_dtype="float32",
             files={b: {p: f[0] for p, f in files.items()}
                    for b, files in m["files"].items()})
    (old / "manifest.json").write_text(json.dumps(m))

    loaded = serve.load_artifacts(str(old), device="cpu")
    man = loaded.manifest
    assert man["files"] == {"4": {"cpu": ["forward_b4.cpu.pt2"]}}
    assert (man["tf32"], man["region_precision"], man["trunk_dtype"],
            man["head_precision"]) == ([False], [], None, None)
    crops = u8_crops(3, seed=1)
    got, want = loaded.call(None, None, crops), served["loaded"].call(
        None, None, crops)
    for k in PER_FRAME:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    srunner = serve.load_runner(str(old), device="cpu")
    assert (srunner.precision, srunner.resolved_head_precision(),
            srunner.trunk_dtype) == ("float32", None, None)
    frames, bboxes = track(5)
    got = srunner.run_track(frames, bboxes)
    want = serve.load_runner(served["art_dir"], device="cpu").run_track(
        frames, bboxes)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    m.update(manifest_version=3)
    (old / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ValueError, match="export the artifacts again"):
        serve.load_artifacts(str(old), device="cpu")


def test_serve_cli_e2e_matches_demo_onepass(tmp_path, monkeypatch, capsys):
    """export -> run on a synthetic walking clip: a demo-schema pkl with the
    persons, frames, boxes and joints of `demo --onepass --cpu_only` on the
    same weights (the small trunk's seed-0 init) and buckets."""
    from test_pipeline_e2e import make_synthetic_video

    from gaitlab_torch.cli import demo
    from gaitlab_torch.cli.serve import SMALL_TRUNK, main_cli
    from gaitlab_torch.nn.grnet import GRNet

    art = str(tmp_path / "art")
    assert main_cli(["export", "--artifacts", art, "--crop_size", str(CROP),
                     "--platforms", "cpu", "--buckets", "32"],
                    device="cpu") == 0
    assert (tmp_path / "art" / "manifest.json").exists()
    assert (tmp_path / "art" / "weights.npz").exists()

    vid = str(tmp_path / "walk.mp4")
    make_synthetic_video(vid, n=40)
    assert main_cli(["run", "--artifacts", art, "--vid_file", vid,
                     "--output_folder", str(tmp_path / "out")],
                    device="cpu") == 0
    assert "pinned programs" in capsys.readouterr().out
    with open(tmp_path / "out" / "walk_serve_output.pkl", "rb") as f:
        results = pickle.load(f)  # a plain pickle
    assert len(results) >= 1
    for person in results.values():
        for key in ("pred_cam", "orig_cam", "verts", "pose", "betas",
                    "joints3d", "joints2d", "bboxes", "frame_ids"):
            assert key in person, key
        assert person["pose"].shape[1] == 72
        assert len(person["frame_ids"]) >= 25  # MIN_NUM_FRAMES gate

    monkeypatch.setattr(demo, "load_model", lambda args, cfg: GRNet.create(
        device="cpu", **SMALL_TRUNK))
    monkeypatch.setattr(demo, "_runner_kwargs", lambda args: {
        "buckets": (32,), "crop_size": CROP})
    want = demo.main(demo.build_parser().parse_args(
        ["--vid_file", vid, "--detector", "median_bg", "--onepass",
         "--save_vid", "--cpu_only", "--output_folder",
         str(tmp_path / "demo")]))
    # SORT numbers tracks across runs of one process: match by frames
    def persons(res):
        return sorted(res.values(), key=lambda p: tuple(p["frame_ids"]))

    assert len(results) == len(want)
    for got, ref in zip(persons(results), persons(want)):
        for k in ("frame_ids", "bboxes"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        for k in ("joints3d", "joints2d", "verts", "pred_cam"):
            assert_close(got[k], ref[k], rtol=1e-5, atol=1e-5, what=k)
