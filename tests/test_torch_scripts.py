"""The port's scripts (scripts/torch_*.py) against gaitlab's scripts on
the CPU, with numpy-seeded inputs.

What runs here is what a CPU can show: the data-layout checker's report
and exit code, the latency bench's model step against gaitlab's
`GRNetCore.apply` + `vp_regress`, the MFU trace's FLOP counts against
torch's own FlopCounterMode, the MFU report's arithmetic on a hand-built
Chrome trace, the render bench's mesh, the one-pass clip, the gait
study's corruptions and metrics against gaitlab's, the envelope of its
committed card run, and that every card script refuses to run without
CUDA unless it is asked for the CPU. Times, rates and device shares come
only from the card (chip_smoke.py phase 17 and the scripts' full runs).

Tolerances are stated where they are used: the model step's kp_3d and
theta within 1e-4 (the same float32 products summed in other orders,
XLA:CPU against ATen, through ~30 convolutions of the shrunk trunk and
SMPL); the FLOP count within 1% of FlopCounterMode's (what the hooks
leave out is the few 3x3 products of SMPL's kinematic chain).
"""

import importlib.util
import json
import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaitlab.nn import gait as jg
from gaitlab_torch.nn import gait as pg
from gaitlab_torch.nn.grnet import GRNet as PtGRNet
from test_torch_gait import flax_init, port_module
from test_torch_models import TINY, jax_forward, tiny_pair

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SCRIPTS = osp.join(REPO, "scripts")
if SCRIPTS not in sys.path:  # the port's scripts import their siblings
    sys.path.insert(0, SCRIPTS)


def load(name: str):
    """scripts/<name>.py as a module of its own (gaitlab's scripts under a
    prefixed name, so that none shadows another)."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", osp.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ prepare_data

@pytest.mark.parametrize("case", ["empty", "partial", "mirror"])
def test_prepare_data_matches_gaitlab(case, tmp_path, monkeypatch, capsys):
    """The same tree through both checkers: nothing anywhere; two files in
    place, two in the mirror (nested, as resolve_asset searches
    recursively), the rest missing; everything in the mirror. The same
    report, the same files copied, the same exit code."""
    from gaitlab.pipeline import fetch as jax_fetch
    from gaitlab_torch.pipeline import fetch as pt_fetch

    mods = {"gaitlab": load("prepare_data"),
            "port": load("torch_prepare_data")}
    assert mods["port"].EXPECTED == mods["gaitlab"].EXPECTED
    rels = [rel for rel, _ in mods["port"].EXPECTED]
    present = {"empty": [], "partial": rels[:2], "mirror": []}[case]
    mirrored = {"empty": [], "partial": rels[2:4], "mirror": rels}[case]
    mirror = tmp_path / "mirror"
    for rel in mirrored:
        f = mirror / "nested" / osp.basename(rel)
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(f"mirror {rel}")
    mirror.mkdir(exist_ok=True)
    for fetch in (jax_fetch, pt_fetch):
        monkeypatch.setattr(fetch, "ASSET_DIR", str(mirror))
    results = {}
    for name, mod in mods.items():
        root = tmp_path / name
        for rel in present:
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            (root / rel).write_text(f"present {rel}")
        root.mkdir(exist_ok=True)
        monkeypatch.setattr(sys, "argv", [name, "--root", str(root)])
        try:
            rc = mod.main() or 0
        except SystemExit as e:
            rc = e.code
        files = sorted((str(p.relative_to(root)), p.read_text())
                       for p in root.rglob("*") if p.is_file())
        results[name] = (rc, capsys.readouterr().out, files)
    assert results["port"] == results["gaitlab"]
    assert results["port"][0] == (0 if case == "mirror" else 1)
    assert len(results["port"][2]) == len(present) + len(mirrored)


# ----------------------------------------------------------- latency_bench

@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.mark.parametrize("b", [1, 2])
def test_latency_step_matches_gaitlab(pair, b):
    """The bench's step (the trunk at "float32", then vp_regress, at
    exactly b rows) against gaitlab's GRNetCore.apply + vp_regress under
    jax.default_matmul_precision("float32"): kp_3d and theta within 1e-4.
    theta's pose (axis-angle) is compared through the rotations it
    encodes: near pi the two packages may pick either branch for one
    rotation (test_torch_models.assert_outputs_close)."""
    from gaitlab.core import geometry as jax_geometry

    latency = load("torch_latency_bench")
    module, variables, model = pair
    x = np.random.default_rng(5 + b).normal(size=(b, 64, 64, 3)).astype(
        np.float32)
    kp, theta = latency.step(latency.at_mode(model, "float32"),
                             torch.from_numpy(x))
    want = jax_forward(module)(variables, x)
    assert kp.shape == want["kp_3d"].shape == (1, b, 29, 3)
    assert np.abs(kp.numpy() - want["kp_3d"]).max() <= 1e-4
    got, ref = theta.numpy(), want["theta"]
    assert got.shape == ref.shape == (1, b, 85)
    for sl in (slice(0, 3), slice(75, 85)):
        assert np.abs(got[..., sl] - ref[..., sl]).max() <= 1e-4

    def rot(a):
        return np.asarray(jax_geometry.axis_angle_to_rotmat(
            jnp.asarray(a[..., 3:75].reshape(-1, 3))))

    assert np.abs(rot(got) - rot(ref)).max() <= 1e-4


# ------------------------------------------------------------- mfu trace

def test_mfu_flops_match_flop_counter():
    """The hooks' per-stage FLOPs, summed without the kernels' analytic
    counts, against torch.utils.flop_counter.FlopCounterMode's count of
    the same forward (which sees B1 and B2 as custom ops and counts none
    of their work): within 1%. Every stage of gaitlab's report is met, and
    only pare-head and smpl hold kernel work."""
    from torch.utils.flop_counter import FlopCounterMode

    trace = load("torch_mfu_trace")
    model = PtGRNet.create(device="cpu", **TINY)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 64, 64, 3)).astype(np.float32))
    hooks = trace.StageHooks(model.module)
    try:
        with hooks.kernels_counted():
            model.forward(x)
        hooks.switch(None)
    finally:
        hooks.remove()
    counts = dict(hooks.counts)
    assert set(counts) == set(load("torch_mfu_report").STAGES)
    assert {k for k, c in counts.items() if c["kernel_flops"]} == {
        "pare-head", "smpl"}
    assert all(c["flops"] > 0 and c["bytes"] > 0 for c in counts.values())
    ours = sum(c["flops"] - c["kernel_flops"] for c in counts.values())
    with FlopCounterMode(display=False) as fc:
        model.forward(x)
    want = fc.get_total_flops()
    assert abs(ours - want) <= 0.01 * want, (ours, want)
    # and the counted pass left no hook behind
    assert not any(m._forward_pre_hooks or m._forward_hooks
                   for m in model.module.modules())


def _fixture_trace():
    """Two iterations on one host thread (pid 1, tid 1) and one stream
    (pid 0, tid 7): a stem kernel (40 us), B1's split kernel in pare-head
    (10 us) and B2 in smpl (5 us, whose launch is known only through its
    ac2g flow) each iteration, and one memcpy (10 us) launched outside
    every stage range, inside a 1000 us `mfu/window`."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "mfu/window",
           "pid": 1, "tid": 1, "ts": 0.0, "dur": 1000.0}]
    corr = 0

    def launch(ts, name, dur, kts, via_flow=False, cat="kernel"):
        nonlocal corr
        corr += 1
        if via_flow:
            ev.append({"ph": "s", "cat": "ac2g", "name": "ac2g", "id": corr,
                       "pid": 1, "tid": 1, "ts": ts})
        else:
            ev.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
                       "ts": ts, "dur": 2.0, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
                   "ts": kts, "dur": dur, "args": {"correlation": corr}})

    for base in (0.0, 500.0):
        for stage, lo, hi in (("stem", 10, 100), ("pare-head", 100, 200),
                              ("smpl", 200, 300)):
            ev.append({"ph": "X", "cat": "user_annotation",
                       "name": f"stage/{stage}", "pid": 1, "tid": 1,
                       "ts": base + lo, "dur": float(hi - lo)})
        launch(base + 20, "sm90_xmma_fprop_implicit_gemm", 40.0, base + 30)
        launch(base + 150, "attention_split_kernel(Tensors, float*)", 10.0,
               base + 160)
        launch(base + 250, "blendshapes_kernel(float const*)", 5.0,
               base + 260, via_flow=True)
    launch(900.0, "Memcpy DtoH (Device -> Pinned)", 10.0, 950.0,
           cat="gpu_memcpy")
    return {"traceEvents": ev}


def test_mfu_report_on_a_fixture():
    """Exact per-stage ms, shares, mfu_pct and bounds of the fixture."""
    rep_mod = load("torch_mfu_report")
    fp32, tf32 = rep_mod.H100_FP32_FLOP_PER_S, rep_mod.H100_TF32_FLOP_PER_S
    sidecar = {"iters": 2, "mode": "float32", "batch": 4, "stages": {
        "stem": {"flops": 1.34e9, "bytes": 0.0, "kernel_flops": 0.0,
                 "peak_flop_per_s": fp32},
        "pare-head": {"flops": 0.99e9, "bytes": 16.75e6,
                      "kernel_flops": 1e6, "peak_flop_per_s": tf32},
        "smpl": {"flops": 67e6, "bytes": 6.7e6, "kernel_flops": 1e6,
                 "peak_flop_per_s": fp32}}}
    rep = rep_mod.report(_fixture_trace(), sidecar)
    approx = pytest.approx
    st = rep["stages"]
    # device us: stem 80, pare-head 20, smpl 10, other 10 over 2 iters
    assert rep["total_device_ms_per_iter"] == approx(0.06)
    assert rep["window_ms_per_iter"] == approx(0.5)
    assert rep["busy_pct"] == approx(12.0)
    want = {"stem": (0.04, 200 / 3, 50.0, "flops", 0.02),
            "pare-head": (0.01, 50 / 3, 20.0, "bytes", 0.005),
            "smpl": (0.005, 25 / 3, 20.0, "bytes", 0.002),
            "other": (0.005, 25 / 3, 0.0, "flops", 0.0)}
    for name, (ms, share, mfu, by, bound_ms) in want.items():
        s = st[name]
        assert s["ms_per_iter"] == approx(ms), name
        assert s["share_pct"] == approx(share), name
        assert s["mfu_pct"] == approx(mfu), name
        assert s["bound_by"] == by and s["bound_ms"] == approx(bound_ms), name
    assert {k: st[k]["ms_per_iter"] for k in ("layer1", "transition",
                                              "stages2-4", "hr-head")} == {
        "layer1": 0.0, "transition": 0.0, "stages2-4": 0.0, "hr-head": 0.0}
    assert sum(s["share_pct"] for s in st.values()) == approx(100.0)
    # (0.02 + 0.002 + 0.001) ms of ideal time over 0.06 ms
    assert rep["mfu_pct"] == approx(100 * 0.023 / 0.06)
    # B2's 10 us and the memcpy's tie: the order they were met in stays
    assert [k["stage"] for k in rep["top_kernels"]] == [
        "stem", "pare-head", "smpl", "other"]
    assert {v["kernel"] for v in rep["port_kernels"].values()} == {"B1", "B2"}
    empty = {"traceEvents": [e for e in _fixture_trace()["traceEvents"]
                             if e["pid"] == 1]}
    with pytest.raises(rep_mod.NoDeviceTime):
        rep_mod.report(empty, sidecar)


# ------------------------------------------------- render, one-pass clip

def test_render_sphere_is_gaitlabs():
    gaitlab_bench, port = load("render_bench"), load("torch_render_bench")
    for got, want in zip(port.sphere_mesh(), gaitlab_bench.sphere_mesh()):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (port.H, port.W, port.REPS) == (gaitlab_bench.H, gaitlab_bench.W,
                                            gaitlab_bench.REPS)


def test_onepass_clip_is_bench_e2es(tmp_path):
    """make_clip writes the same bytes as bench_e2e.make_clip."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import bench_e2e

    port = load("torch_onepass_util")
    assert (port.N_FRAMES, port.W, port.H, port.CROP_BYTES) == (
        bench_e2e.N_FRAMES, bench_e2e.W, bench_e2e.H, bench_e2e.CROP_BYTES)
    port.make_clip(str(tmp_path / "port.mp4"), 3)
    bench_e2e.make_clip(str(tmp_path / "gaitlab.mp4"), 3)
    got = (tmp_path / "port.mp4").read_bytes()
    assert len(got) > 1000
    assert got == (tmp_path / "gaitlab.mp4").read_bytes()


# --------------------------------------------------------- gait robustness

def _synthetic(seed: int):
    from gaitlab import training as jt

    port = load("torch_gait_robustness")
    b = jt.synthetic_gait_batch(16, t=port.T, j=port.J, c=port.C, seed=seed)
    return port, {k: np.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("kind,level,seed", [
    ("dropout", 0.2, 7), ("dropout", 0.4, 7), ("jitter", 0.2, 8)])
def test_gait_corruptions_are_gaitlabs(kind, level, seed):
    port, batch = _synthetic(1000)
    gaitlab_study = load("gait_robustness")
    fn = f"corrupt_{kind}"
    got = getattr(port, fn)(batch["features"], level,
                            np.random.default_rng(seed))
    want = getattr(gaitlab_study, fn)(batch["features"], level,
                                      np.random.default_rng(seed))
    assert np.array_equal(got, want)


def _gaitlab_metrics(module, params, feats, cparams, batch,
                     seq_lengths=None):
    """gaitlab's gait_robustness.py metrics (its main's closure)."""
    kw = {} if seq_lengths is None else {"seq_lengths": jnp.asarray(
        seq_lengths)}
    _, pred_avg, pred_phase = jax.jit(module.apply)(
        params, jnp.asarray(feats, jnp.float32), jnp.asarray(cparams), **kw)
    pp, gp = np.asarray(pred_phase), np.asarray(batch["gait_phase"])
    if seq_lengths is not None:
        tt = int(seq_lengths.max())
        pp, gp = pp[:, :tt], gp[:, :tt]

    def nrm(v):
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-9)

    cos = 0.5 * ((nrm(pp[..., :2]) * nrm(gp[..., :2])).sum(-1)
                 + (nrm(pp[..., 2:]) * nrm(gp[..., 2:])).sum(-1))
    return (float(1.0 - cos.mean()), float(np.abs(
        np.asarray(pred_avg)[:, 0] - np.asarray(batch["gait_avg"])[:, 0]
    ).mean()))


@pytest.mark.parametrize("cell", ["clean", "dropout_0.2", "truncate_16"])
def test_gait_metrics_match_gaitlab(cell):
    """The study's metrics of the port's untrained corrector, on weights
    from gait_state_dict_from_flax, against gaitlab's on the same
    corrector: within 1e-4 (a GRU and an attention block in float32,
    summed in other orders)."""
    port, batch = _synthetic(1000 if cell != "truncate_16" else 1002)
    fc = jg.FeatCorrector(num_joints=port.J, feat_dim=port.C, h_size=32,
                          num_heads=2, stop_gaitfeat_grad=False)
    params = flax_init(fc, 3, batch["features"], batch["cparams"])
    module = port_module(pg.FeatCorrector(
        port.J, port.C, h_size=32, num_heads=2, stop_gaitfeat_grad=False),
        params)
    feats, lengths = batch["features"], None
    if cell == "dropout_0.2":
        feats = port.corrupt_dropout(feats, 0.2, np.random.default_rng(7))
    elif cell == "truncate_16":
        feats = feats.copy()
        feats[:, 16:] = 0.0
        lengths = np.full((16,), 16, np.int32)
    got = port.metrics(module, feats, batch["cparams"], batch, lengths)
    want = _gaitlab_metrics(fc, {"params": params}, feats, batch["cparams"],
                            batch, lengths)
    assert np.abs(np.subtract(got, want)).max() <= 1e-4, (got, want)
    assert 0.05 < got[0] < 1.95  # an untrained corrector: not degenerate


def test_gait_robustness_artifact():
    """gaitlab's assertions of test_gait_training.py::
    test_robustness_artifact on the port's committed card run,
    docs/TORCH_GAIT_ROBUSTNESS.json: every cell has the trained corrector
    beating the untrained one by half the phase error, dropout degrades
    gracefully, and the transfer cells generalise but cost something."""
    with open(osp.join(REPO, "docs", "TORCH_GAIT_ROBUSTNESS.json")) as f:
        study = json.load(f)
    assert study["card"] and study["setup"]["train_steps"] == 600
    rows = study["results"]
    assert {r["corruption"] for r in rows} == {"dropout", "bbox_jitter",
                                               "truncate"}
    for r in rows:
        assert r["trained_beats_untrained"], r
        assert r["phase_err_trained"] < 0.5 * r["phase_err_untrained"], r
    drop = {r["level"]: r["phase_err_trained"] for r in rows
            if r["corruption"] == "dropout"}
    assert drop[0.4] < 0.5, "40% dropout should still be usable"
    assert drop[0.0] < drop[0.4], "corruption-free must be the best case"
    tr = {r["cell"]: r for r in study["transfer"]["results"]}
    assert set(tr) == {"in_regime_holdout", "shifted_freq_band",
                       "shifted_freq_cam_noise"}
    for r in tr.values():
        assert r["trained_beats_untrained"], r
        assert r["phase_err_trained"] < 0.5 * r["phase_err_untrained"], r
    assert tr["shifted_freq_band"]["phase_err_trained"] > \
        tr["in_regime_holdout"]["phase_err_trained"]
    assert tr["shifted_freq_band"]["phase_err_trained"] < 0.3


# ----------------------------------------------------- no CUDA, no fallback

CARD_SCRIPTS = {
    "torch_latency_bench": ["--batches", "1"],
    "torch_serve_bench": ["--batch", "2"],
    "torch_mfu_trace": ["--batch", "2", "--iters", "1"],
    "torch_render_bench": ["--reps", "1"],
    "torch_onepass_util": ["--frames", "3"],
    "torch_gait_robustness": ["--steps", "1"],
}


@pytest.mark.parametrize("name", sorted(CARD_SCRIPTS))
def test_card_scripts_raise_without_cuda(name, tmp_path):
    """Without CUDA a card script raises before it writes anything; it
    never falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    out = tmp_path / "out.json"
    argv = CARD_SCRIPTS[name] + ["--out", str(out)]
    if name == "torch_onepass_util":
        argv += ["--clip_dir", str(tmp_path)]
    if name == "torch_mfu_trace":
        argv += ["--trace_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load(name).main(argv)
    assert not out.exists() and not list(tmp_path.iterdir())


def test_gait_robustness_runs_on_the_cpu_when_asked(tmp_path):
    """--device cpu runs the study on the CPU (two steps here) and writes
    its document without a card line; the rows have every cell."""
    out = tmp_path / "g.json"
    assert load("torch_gait_robustness").main(
        ["--device", "cpu", "--steps", "2", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["card"] is None and doc["device"] == "cpu"
    assert len(doc["results"]) == 10 and len(doc["transfer"]["results"]) == 3
