"""The HMR 2.0 cell's files (configs/hmr2_vith.json, arch/hmr2.py,
reference/hmr2.py, counts/hmr2.py, metrics/vit_roofline.py,
metrics/decoder_ms_per_frame.py) on the CPU at a tiny size: a ViT of
width 64, 2 blocks, 4 heads; a 2-layer decoder of width 32; 64-px crops.
The harness runs the cell untraced and traced through the architecture's
module and checks it against its own reference; a model moved after the
build is not correct; the counts equal FlopCounterMode's count of the
reference."""

import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.arch import hmr2 as arch
from benchmark.counts.hmr2 import StepCounts, grid
from benchmark.harness import inputs, spec
from benchmark.harness.runner import Ctx, Run
from benchmark.reference import hmr2 as reference
from benchmark.tests.tiny import TINY_LIMIT, tiny_traffic

SEED = 2 ** 33 + 41
CELL = "hmr2_vith.clinic_tracks"
TINY_MODEL = dict(width=64, depth=2, heads=4, mlp=256, dec_width=32,
                  dec_depth=2, dec_heads=4, dec_head_dim=8, dec_mlp=32)
NEW = {"vit_roofline", "decoder_ms_per_frame"}


def tiny_cfg() -> dict:
    cfg = spec.load_json("configs", "hmr2_vith")
    cfg["model"].update(TINY_MODEL)
    cfg["crop_size"] = 64
    cfg["runner"].update(buckets=[4, 8, 16], ref_block=8)
    n = 12 + 1  # tokens of a 64-px crop's 48 columns, and the class slot
    cfg["init"]["backbone.pos_embed"] = {"gain": 0.02 * (n * 64) ** 0.5}
    cfg["limits"] = {k: TINY_LIMIT for k in cfg["limits"]}
    return cfg


def tiny_cell() -> types.SimpleNamespace:
    man = spec.manifest()
    entry = {w["name"]: w for w in man["workloads"]}[CELL]
    cfg = tiny_cfg()
    reports = spec.Cell.reports

    def of(metrics):
        return [m for m in metrics
                if reports(types.SimpleNamespace(name=CELL), m)]

    return types.SimpleNamespace(
        name=CELL, cfg=cfg, arch=spec.load_arch(entry["config"], cfg),
        traffic=tiny_traffic(entry["traffic"]), chips=1,
        end_to_end=of(man["end_to_end"]), per_layer=of(man["per_layer"]))


def test_the_manifest_names_the_cell_and_its_metrics():
    cell = spec.Cell(CELL)
    assert cell.arch is arch and cell.chips == 1
    assert cell.cfg["reduced"] == [] and cell.cfg["crop_size"] == 256
    names = {m["name"] for m in cell.per_layer}
    assert NEW <= names
    assert not names & {"hrnet_roofline", "hr_head_roofline", "b1_roofline",
                        "gait_ms_per_frame"}
    for other in ("grnet_w32.clinic_tracks", "maxgrnet_w32.clinic_tracks"):
        assert not NEW & {m["name"] for m in spec.Cell(other).per_layer}


@pytest.mark.parametrize("traced", [False, True])
def test_tiny_run_is_correct(traced):
    cell = tiny_cell()
    res = Run(cell, SEED, "cpu").execute(1.0, traced, 0.0)
    assert res["correct"], res["check"]
    assert set(res["check"]) == set(cell.cfg["limits"])
    assert all(0 <= v["value"] < TINY_LIMIT for v in res["check"].values())
    names = set(res["metrics"])
    if traced:
        # the hooks' row count and the program's spans need no card; the
        # device-time readers give nothing on the CPU
        assert {"rows_per_frame", "crop_ms_per_frame",
                "stream_wait_ms_per_frame", "readback_ms_per_frame"} <= names
        assert not names & NEW
    else:
        assert names == {m["name"] for m in cell.end_to_end}


def test_moved_weight_is_not_correct(monkeypatch):
    """The program with one regressor bias moved after the build: its
    outputs leave the reference's."""
    build = arch.build

    def broken(cfg, sd, smpl, device, precision):
        model, runner = build(cfg, sd, smpl, device, precision)
        with torch.no_grad():
            model.module.smpl_head.deccam.bias[0] += 0.05
        return model, runner

    monkeypatch.setattr(arch, "build", broken)
    res = Run(tiny_cell(), SEED, "cpu").execute(1.0, False, 0.0)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("rows", [1, 3])
def test_counts_match_flop_counter(rows):
    """counts/hmr2.py's trunk FLOPs (ViT and decoder) equal, within 1%,
    FlopCounterMode's count of the reference's trunk; the ViT's part is
    all but the decoder's."""
    cfg = tiny_cfg()
    sd = inputs.make_weights(arch.skeleton(cfg), SEED, "cpu", cfg["init"])
    counts = arch.counts(cfg, sd)
    x = torch.randn(rows, 3, 64, 64)
    with FlopCounterMode(display=False) as fcm, torch.no_grad():
        reference.trunk(sd, cfg, x)
    want = fcm.get_total_flops()
    assert abs(rows * counts.trunk_flops() - want) <= 0.01 * want
    assert counts.vit(rows)[0] == rows * (counts.trunk_flops()
                                          - counts.decoder)
    assert counts.forward_flops(rows) > rows * counts.trunk_flops()


def test_published_counts():
    """At the published sizes: 192 tokens, about 242 GFLOP a frame in the
    ViT's linear layers and patch embedding, 6 in its attention, 3 in the
    decoder; 630.9 M ViT weights read once a forward."""
    cfg = spec.load_json("configs", "hmr2_vith")
    c = StepCounts(cfg, arch.skeleton(cfg).state_dict())
    assert grid(cfg) == (16, 12) and c.tokens == 192
    assert c.vit_linear == pytest.approx(241.96e9, rel=1e-3)
    assert c.vit_attention == pytest.approx(6.04e9, rel=1e-3)
    assert c.decoder == pytest.approx(3.09e9, rel=1e-2)
    assert c.vit_weights == 4 * 630_912_000


def test_ctx_reads_the_new_metrics_from_stage_times():
    """The two readers on a stand-in trace: the ViT's bound over the
    patch-embed and vit-blocks stage time, the decoder's stage time per
    real frame."""
    from benchmark.metrics import decoder_ms_per_frame, vit_roofline

    cfg = spec.load_json("configs", "hmr2_vith")
    counts = StepCounts(cfg, arch.skeleton(cfg).state_dict())
    hooks = types.SimpleNamespace(rows=[32, 64], real=[30, 50])
    win = types.SimpleNamespace(frames=[30, 50])
    tv = types.SimpleNamespace(stage_s={"patch-embed": 0.1,
                                        "vit-blocks": 1.9, "decoder": 0.04})
    ctx = Ctx(cfg, tv, hooks, win, counts, "stand-in")
    bound = sum(max(f / 495e12, b / 3.35e12)
                for f, b in (counts.vit(32), counts.vit(64)))
    assert vit_roofline.read(ctx) == pytest.approx(100 * bound / 2.0)
    assert decoder_ms_per_frame.read(ctx) == pytest.approx(1e3 * 0.04 / 80)
    empty = Ctx(cfg, None, hooks, win, counts, "stand-in")
    assert vit_roofline.read(empty) is None
    assert decoder_ms_per_frame.read(empty) is None
