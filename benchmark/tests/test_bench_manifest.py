"""BENCHMARK.json against the benchmark's rules, and the files it names."""

import json
import os.path as osp
import re

import pytest

from benchmark.harness import spec

MAN = spec.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def metrics():
    return MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert isinstance(MAN["run_seconds"], int)


def test_command_and_paths():
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert osp.isdir(osp.join(spec.ROOT, p))
    assert len(MAN["command"]) <= 32
    for word in MAN["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MAN["paths"])


@pytest.mark.parametrize("entry", metrics() + MAN["configs"]
                         + MAN["workloads"], ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


def test_unique_names():
    for group in (metrics(), MAN["configs"], MAN["workloads"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert cfg["file"].startswith("benchmark/configs/")
    with open(osp.join(spec.ROOT, cfg["file"])) as f:
        data = json.load(f)
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert len(cfg["reduced"]) <= 16
    assert any(w["config"] == cfg["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cells(cell):
    assert cell["chips"] in (1, 4)
    assert cell["config"] in {c["name"] for c in MAN["configs"]}
    assert osp.isfile(osp.join(spec.BENCH_DIR, "traffic",
                               cell["traffic"] + ".json"))
    c = spec.Cell(cell["name"], MAN)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


def test_cell_pairs_once():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", MAN["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "workloads"}


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer(metric):
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert set(metric) <= {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert callable(spec.reader(metric["name"]))
    moves = {m["name"]: m for m in MAN["end_to_end"]}[metric["moves"]]
    for cell in MAN["workloads"]:
        c = spec.Cell(cell["name"], MAN)
        if c.reports(metric):
            assert c.reports(moves), (metric["name"], cell["name"])
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_check_limits_named():
    """Every configuration's limits name numbers the check computes, and
    always the mesh, the 3D joints, the pose, the shape, the camera and,
    with the gait branch, its two outputs."""
    for cfg in MAN["configs"]:
        data = spec.load_json("configs", cfg["name"])
        can = {"verts_gap", "joints3d_gap", "joints2d_gap", "betas_gap",
               "pred_cam_gap", "pose_gap"}
        must = can - {"joints2d_gap"}
        if data["model"].get("use_gait_feat"):
            can |= {"pred_avg_gap", "pred_phase_gap"}
            must |= {"pred_avg_gap", "pred_phase_gap"}
        assert must <= set(data["limits"]) <= can


def test_judge_compares_the_named_numbers():
    from benchmark.harness.check import judge

    ok, table = judge({"a_gap": 0.1, "b_gap": 5.0}, {"a_gap": 0.2})
    assert ok and list(table) == ["a_gap"]
    assert not judge({"a_gap": 0.3}, {"a_gap": 0.2})[0]
    ok, table = judge({}, {"a_gap": 0.2})
    assert not ok and table["a_gap"]["value"] == float("inf")


def test_check_budget():
    """A full check of 24 cells fits its 43200 s."""
    runs = 2 + 14 * 24
    total = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_size():
    assert osp.getsize(osp.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024
