"""A configuration names its architecture, and everything the harness
needs from a model comes from that architecture's module: a toy
architecture defined only here (benchmark/tests/toy) runs a cell through
harness.runner.Run untraced and traced, checked by its own reference,
with no entry in BENCHMARK.json and no edit to the harness."""

import ast
import copy
import glob
import os.path as osp
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import spec
from benchmark.harness.runner import Run
from benchmark.tests.tiny import TINY_LIMIT, tiny_traffic
from benchmark.tests.toy import arch as toy_arch

SEED = 2 ** 33 + 29
TOY_CELL = "toy_vit.clinic_tracks"
GRNET_ONLY = {"hrnet_roofline", "hr_head_roofline", "b1_roofline"}


def toy_cfg(arch: str | None = "toy") -> dict:
    grnet = spec.load_json("configs", "grnet_w32")
    cfg = {"name": "toy_vit", "model": {"width": 32, "patch": 16, "mlp": 64},
           "smpl": grnet["smpl"], "crop_size": 64, "precision": "float32",
           "runner": dict(grnet["runner"], buckets=[4, 8, 16]),
           "calibration_frames": 8, "init": {},
           "stage_hooks": [
               {"module": "patch_embed", "when": "pre", "stage": "embed"},
               {"module": "norm1", "when": "pre", "stage": "blocks"},
               {"module": "head", "when": "pre", "stage": "head"}],
           "rows_module": "",
           "limits": {f"{k}_gap": TINY_LIMIT for k in (
               "verts", "joints3d", "joints2d", "betas", "pred_cam",
               "pose")}}
    if arch is not None:
        cfg["arch"] = arch
    return cfg


def toy_cell(monkeypatch, cfg: dict) -> spec.Cell:
    """The toy cell through spec.Cell: the manifest with one more
    workload, its configuration served in place of a file, the toy's
    module registered as benchmark.arch.toy."""
    man = copy.deepcopy(spec.manifest())
    man["workloads"].append({"name": TOY_CELL, "config": "toy_vit",
                             "traffic": "clinic_tracks", "chips": 1})
    traffic = tiny_traffic("clinic_tracks")

    def load(kind, name):
        assert (kind, name) in {("configs", "toy_vit"),
                                ("traffic", "clinic_tracks")}
        return copy.deepcopy(cfg if kind == "configs" else traffic)

    monkeypatch.setattr(spec, "load_json", load)
    monkeypatch.setitem(sys.modules, "benchmark.arch.toy", toy_arch)
    return spec.Cell(TOY_CELL, man)


@pytest.mark.parametrize("traced", [False, True])
def test_toy_architecture_runs_and_is_correct(monkeypatch, traced):
    cell = toy_cell(monkeypatch, toy_cfg())
    assert cell.arch is toy_arch
    assert not GRNET_ONLY & {m["name"] for m in cell.per_layer}
    res = Run(cell, SEED, "cpu").execute(1.0, traced, 0.0)
    assert res["correct"], res["check"]
    assert set(res["check"]) == set(cell.cfg["limits"])
    assert all(0 <= v["value"] < TINY_LIMIT for v in res["check"].values())
    names = set(res["metrics"])
    assert not names & GRNET_ONLY
    if traced:
        # the runner's spans and the trunk's row counter need no card
        assert {"rows_per_frame", "crop_ms_per_frame",
                "stream_wait_ms_per_frame", "readback_ms_per_frame"} <= names
    else:
        assert names == {m["name"] for m in cell.end_to_end}


def test_broken_toy_is_not_correct(monkeypatch):
    """The toy's program with one weight moved after the build: its
    outputs leave its reference's."""
    build = toy_arch.build

    def broken(cfg, sd, smpl, device, precision):
        model, runner = build(cfg, sd, smpl, device, precision)
        with torch.no_grad():
            model.module.head.bias[-3] += 0.2
        return model, runner

    monkeypatch.setattr(toy_arch, "build", broken)
    res = Run(toy_cell(monkeypatch, toy_cfg()), SEED, "cpu").execute(
        1.0, False, 0.0)
    assert not res["correct"], res["check"]


def test_toy_counts_match_flop_counter():
    """The toy's trunk count equals FlopCounterMode's count of its
    program's forward (the convolution and the linear layers)."""
    cfg = toy_cfg()
    trunk = toy_arch.ToyTrunk(**toy_arch._trunk_kwargs(cfg)).eval()
    counts = toy_arch.counts(cfg, trunk.state_dict())
    with FlopCounterMode(display=False) as fcm, torch.inference_mode():
        trunk(torch.randn(3, 3, 64, 64))
    assert 3 * counts.trunk == fcm.get_total_flops()
    assert counts.forward_flops(3) > 3 * counts.trunk


@pytest.mark.parametrize("arch,names", [
    (None, "benchmark/configs/toy_vit.json"),
    ("nosuch", "benchmark/arch/nosuch.py")])
def test_missing_architecture_exits_naming_the_file(monkeypatch, arch, names):
    with pytest.raises(SystemExit) as e:
        toy_cell(monkeypatch, toy_cfg(arch))
    assert names in str(e.value)


HARNESS = [osp.join(spec.BENCH_DIR, "run.py")] + sorted(
    glob.glob(osp.join(spec.BENCH_DIR, "harness", "*.py")))
# the program's GRNet and its runner, and the benchmark's files that are
# GRNet's (arch/grnet.py names them)
GRNET_MODULES = {"gaitlab_torch.nn.grnet", "gaitlab_torch.pipeline.runner",
                 "benchmark.reference.model", "benchmark.reference.track",
                 "benchmark.counts.flops"}


def _imports(path: str) -> set:
    """Every module that a file's import statements name, with each
    `from a import b` also as a.b (relative imports resolved)."""
    pkg = ("benchmark.harness" if osp.basename(osp.dirname(path)) == "harness"
           else "benchmark")
    out = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = pkg.split(".")[:len(pkg.split(".")) - node.level + 1]
                base = ".".join(parts + ([base] if base else []))
            out.add(base)
            out |= {f"{base}.{a.name}" for a in node.names}
    return out


@pytest.mark.parametrize("path", HARNESS, ids=osp.basename)
def test_shared_harness_names_no_architecture(path):
    assert not _imports(path) & GRNET_MODULES
    assert "GRNet" not in open(path).read()

