"""gaitlab_torch.cli.demo --tracking_path against gaitlab's demo at pkl
level, and the port's package-level guarantees: it imports neither JAX
nor gaitlab, and its entry points never drop to the CPU on their own.

Both demos get the same small model (tests/test_torch_models.tiny_pair)
through `load_model`, run the float32 path on the CPU on one synthetic
clip, and write their pkl files; every key of every person is compared.
Tolerance as in test_torch_models.py (`pose` through its rotations).
"""

import os
import subprocess
import sys

import cv2
import joblib
import numpy as np
import pytest
import torch

from gaitlab.body import smpl as jax_smpl
from gaitlab.cli import demo as jax_demo
from gaitlab.nn.grnet import GRNet as JaxGRNet
from gaitlab_torch.cli import batch_generation as pt_bg
from gaitlab_torch.cli import demo as pt_demo
from gaitlab_torch.device import resolve_device
from gaitlab_torch.nn.grnet import GRNet as PtGRNet
from gaitlab_torch.pipeline import medoids as pt_medoids
from gaitlab_torch.pipeline import openpose as pt_openpose
from gaitlab_torch.pipeline.runner import GRNetRunner as PtRunner
from test_torch_models import assert_close, tiny_pair
from torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 30
PKL_KEYS = ("pred_cam", "orig_cam", "verts", "pose", "betas", "joints3d",
            "joints2d", "bboxes", "frame_ids")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 320x240 clip of N_FRAMES frames and its tracklets: person 0 on
    every frame, person 1 on 20 frames (dropped: fewer than
    MIN_NUM_FRAMES)."""
    d = tmp_path_factory.mktemp("torch_demo")
    vid = str(d / "torch_demo_walk.mp4")
    rng = np.random.default_rng(0)
    bg = rng.integers(40, 70, size=(240, 320, 3)).astype(np.uint8)
    writer = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 20.0,
                             (320, 240))
    for i in range(N_FRAMES):
        frame = bg.copy()
        cv2.rectangle(frame, (40 + 3 * i, 40), (90 + 3 * i, 200),
                      (210, 190, 180), -1)
        writer.write(frame)
    writer.release()
    fr = np.arange(N_FRAMES)
    tracks = {
        0: {"frames": fr, "bbox": np.stack(
            [65 + 3.0 * fr, np.full(N_FRAMES, 120.0),
             np.full(N_FRAMES, 170.0), np.full(N_FRAMES, 170.0)], 1)},
        1: {"frames": fr[:20], "bbox": np.tile([250.0, 120, 90, 90], (20, 1))},
    }
    trackfile = str(d / "tracks.pkl")
    joblib.dump(tracks, trackfile)
    return d, vid, trackfile


@pytest.fixture(scope="module")
def models():
    """gaitlab's demo model and the port's, with the same weights."""
    module, variables, port = tiny_pair(seed=5)
    return JaxGRNet(module=module, variables=variables,
                    smpl=jax_smpl.synthetic_smpl_params()), port


@pytest.fixture(scope="module")
def port6():
    """The port's model of the tests that run the port's demo alone."""
    return tiny_pair(seed=6)[2]


def _args(parser, vid, trackfile, out, *extra):
    return parser.parse_args(
        ["--vid_file", vid, "--tracking_path", trackfile, "--output_folder",
         out, "--save_vid", "--cpu_only", "--precision", "float32", *extra])


@pytest.mark.parametrize("joint_type", ["spin", "common"])
def test_demo_pkl_matches_gaitlab(clip, models, monkeypatch, joint_type):
    d, vid, trackfile = clip
    jax_model, port = models
    monkeypatch.setattr(jax_demo, "load_model", lambda args, cfg: jax_model)
    monkeypatch.setattr(pt_demo, "load_model", lambda args, cfg: port)
    # 30 frames: one forward at bucket 16, then 14 frames padded to 16
    monkeypatch.setenv("GAITLAB_BUCKETS", "16")
    extra = ("--joint_type", joint_type)
    out_pt, out_jax = str(d / f"pt_{joint_type}"), str(d / f"jax_{joint_type}")
    pt_demo.main(_args(pt_demo.build_parser(), vid, trackfile, out_pt, *extra))
    jax_demo.main(_args(jax_demo.build_parser(), vid, trackfile, out_jax,
                        *extra))
    got = joblib.load(os.path.join(out_pt, "torch_demo_walk_mp4", "grnet.pkl"))
    want = joblib.load(os.path.join(out_jax, "torch_demo_walk_mp4",
                                    "grnet.pkl"))
    assert list(got) == list(want) == [0]
    g, w = got[0], want[0]
    assert set(g) == set(w) == set(PKL_KEYS)
    assert g["verts"].shape == (N_FRAMES, 6890, 3)
    assert g["joints3d"].shape == ((N_FRAMES, 29, 3) if joint_type == "spin"
                                   else w["joints3d"].shape)
    np.testing.assert_array_equal(g["frame_ids"], w["frame_ids"])
    np.testing.assert_array_equal(g["bboxes"], w["bboxes"])
    for k in ("pred_cam", "betas", "verts", "joints3d"):
        assert_close(g[k], w[k], rtol=1e-4, atol=2e-5, what=k)
    # pixel coordinates: the same relative error on values of ~hundreds
    for k in ("orig_cam", "joints2d"):
        assert_close(g[k], w[k], rtol=1e-4, atol=1e-3, what=k)
    from gaitlab.core import geometry as jg

    def rot(aa):
        return np.asarray(jg.axis_angle_to_rotmat(aa.reshape(-1, 3)))

    assert_close(rot(g["pose"]), rot(w["pose"]), rtol=1e-4, atol=2e-5,
                 what="pose")


def test_demo_names_repeat_pkls_like_gaitlab(clip, port6, monkeypatch):
    d, vid, trackfile = clip
    monkeypatch.setattr(pt_demo, "load_model", lambda args, cfg: port6)
    monkeypatch.setenv("GAITLAB_BUCKETS", "32")
    out = str(d / "repeat")
    for _ in range(2):
        res = pt_demo.main(_args(pt_demo.build_parser(), vid, trackfile, out))
    assert sorted(os.listdir(os.path.join(out, "torch_demo_walk_mp4"))) == [
        "grnet.pkl", "grnet1.pkl"]
    assert list(res) == [0] and set(res[0]) == set(PKL_KEYS)


def test_parsers_have_the_same_flags():
    def flags(parser):
        return {a.dest: (a.default, tuple(a.choices or ()))
                for a in parser._actions if a.dest != "help"}

    port = flags(pt_demo.build_parser())
    # the port's one flag of its own: the model, gaitlab's by default
    assert port.pop("arch") == ("grnet", ("grnet", "hmr2"))
    assert port == flags(jax_demo.build_parser())


class _FirstTrack(Exception):
    """Ends a demo run after its runner's first track."""


@pytest.mark.parametrize("flags", [
    # the paths that once raised as not ported: the precision modes now
    # reach the runner and run (each run stops after the first track)
    ["--precision", "high"],
    ["--save_vid", "--precision", "high"],
    ["--save_vid", "--precision", "default"],
    ["--mesh_render", "--precision", "default"],
    ["--parallel", "dp", "--precision", "high"]])
def test_unported_paths_raise(clip, port6, monkeypatch, flags):
    d, vid, trackfile = clip
    monkeypatch.setattr(pt_demo, "load_model", lambda args, cfg: port6)
    monkeypatch.setenv("GAITLAB_BUCKETS", "32")
    seen = []
    real = PtRunner.run_track

    def run_track(self, *a, **kw):
        out = real(self, *a, **kw)
        seen.append((self.precision, self.resolved_head_precision(),
                     self.parallel, out["joints3d"]))
        raise _FirstTrack

    monkeypatch.setattr(PtRunner, "run_track", run_track)
    argv = ["--vid_file", vid, "--tracking_path", trackfile,
            "--output_folder", str(d / "modes"), "--cpu_only", *flags]
    with pytest.raises(_FirstTrack):
        pt_demo.main(pt_demo.build_parser().parse_args(argv))
    precision = flags[flags.index("--precision") + 1]
    (got, head, parallel, joints3d), = seen
    assert (got, parallel) == (precision, "dp" if "--parallel" in flags
                               else None)
    assert head == ("default" if precision == "high" else None)
    assert joints3d.shape == (N_FRAMES, 29, 3)
    assert np.isfinite(joints3d).all()


def test_entry_points_never_fall_back_to_the_cpu(clip):
    """Without a card, the default device raises unless the CPU is asked
    for (this box has no CUDA)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    _, vid, trackfile = clip
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PtGRNet.create(backbone_width=8, backbone_modules=(1, 1, 1),
                       backbone_blocks=1)
    args = pt_demo.build_parser().parse_args(
        ["--vid_file", vid, "--tracking_path", trackfile, "--save_vid",
         "--output_folder", str(clip[0] / "nocuda")])
    with pytest.raises(RuntimeError, match="--cpu_only"):
        pt_demo.main(args)
    # batch_generation, the OpenPose ingestion and the medoid, before they
    # read anything
    bg_args = pt_bg.build_parser().parse_args(
        ["--vid_folder", str(clip[0]), "--bbox_path", trackfile,
         "--outpath", str(clip[0] / "nocuda_db.json")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt_bg.main(bg_args)
    assert not list(clip[0].glob("nocuda_db*"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt_openpose.load_openpose_anno(str(clip[0]), "unused.json",
                                       "unused_bad.json")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt_medoids.medoid_1(np.zeros((3, 3), np.float32))
    # the chip smoke test refuses to run and prints no result
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_port_imports_neither_jax_nor_gaitlab():
    """Every gaitlab_torch module, every scripts/torch_*.py and
    chip_smoke.py import with JAX blocked, and leave no gaitlab,
    bench_e2e, jax or flax module behind. A subprocess: the test process
    has imported all of them already (tests/conftest.py imports jax)."""
    code = r"""
import glob, importlib, os, pkgutil, sys
for name in ("jax", "jaxlib", "flax"):
    sys.modules[name] = None  # any import of them raises
import gaitlab_torch
names = [m.name for m in pkgutil.walk_packages(gaitlab_torch.__path__,
                                               "gaitlab_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, "scripts")  # the scripts import their siblings
scripts = sorted(os.path.basename(p)[:-3]
                 for p in glob.glob("scripts/torch_*.py"))
for name in scripts:
    importlib.import_module(name)
import chip_smoke
loaded = [m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] in ("gaitlab", "jax", "jaxlib", "flax", "bench_e2e"))]
assert not loaded, loaded
# nothing is compiled or prepared for compiling at import
assert "torch.utils.cpp_extension" not in sys.modules
print(" ".join(names + scripts))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 30
    assert {f"gaitlab_torch.{m}" for m in (
        "core.filters", "nn.yolo", "pipeline.detect", "pipeline.fetch",
        "pipeline.smoothing", "pipeline.tracks", "pipeline.video",
        "nn.gait", "pipeline.stream", "gait.features", "gait.classify",
        "api", "pipeline.loader", "render.raster", "render.raster_torch",
        "render.vis", "render.overlay", "render.export", "render.fbx",
        "cli.fbx_output", "utils", "cli.batch_generation", "pipeline.medoids",
        "pipeline.openpose", "pipeline.boxes", "pipeline.datasets",
        "pipeline.data", "weights.torch_import", "serve", "cli.serve",
        "weights.cache", "nn.resnet", "nn.spin", "eval", "training",
        "cli.train", "parallel", "parallel.mesh", "parallel.replicas",
        "parallel.pipeline")} <= names
    assert {f"torch_{s}" for s in (
        "prepare_data", "latency_bench", "serve_bench", "mfu_trace",
        "mfu_report", "render_bench", "onepass_util", "gait_robustness",
        "precision_study", "stage_timing", "pack_bench", "stem_s2d_bench",
        "kernel_study")} <= names


def test_ops_import_no_model_code():
    """Loading the kernels' op registrations (what a serving process does
    before it loads a program) pulls in no gaitlab_torch.nn module."""
    code = r"""
import sys
import gaitlab_torch.ops.blendshapes, gaitlab_torch.ops.keypoint_attention
import torch
assert hasattr(torch.ops.gaitlab, "blendshapes")
assert hasattr(torch.ops.gaitlab, "keypoint_attention_fused")
loaded = [m for m in sys.modules if m.startswith("gaitlab_torch.nn")]
assert not loaded, loaded
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
