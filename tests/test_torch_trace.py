"""gaitlab_torch's tracing (utils.span, utils.SPAN_LOG) on the CPU.

Outside a profiler a span records nothing and enters no record_function.
Under one, a track through GRNetRunner.run_track leaves its span tree:
runner/track, a runner/crop per chunk, stream/forward on the
ForwardStream's worker with the track's id, model/<segment> for each of
the trunk's segments (the gait branch's too) and model/regress inside it,
stream/wait and stream/readback on the caller's thread; the counts agree
with a forward pre-hook's rows and the track's frames. A full log counts
what it drops; profile_trace keeps the spans of threads started inside
it; a program exported under a profiler holds no profiler op.

The model is the shrunk trunk of test_torch_models.TINY at 64-pixel crops
(the serve tests' size), built here without gaitlab.
"""

import glob
import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gaitlab_torch import serve, utils
from gaitlab_torch.nn.grnet import GRNet
from gaitlab_torch.pipeline.runner import GRNetRunner
from test_torch_models import TINY
from torch_threads import torch_threads  # noqa: F401

CROP = 64
N = 11  # frames of a track: forwards of 8 and 3 (bucket 4) real frames


def runner(gait: bool = False, **kw) -> GRNetRunner:
    extra = dict(use_gait_feat=True, featcorr_h_size=64) if gait else {}
    model = GRNet.create(device="cpu", seed=3, **TINY, **extra)
    return GRNetRunner(model, buckets=(4, 8), crop_size=CROP,
                       ingest_chunk=3, crop_on="host", **kw)


def track(n: int = N):
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 255, (n, 96, 128, 3)).astype(np.uint8)
    return frames, np.tile(np.array([64.0, 48.0, 60.0, 60.0], np.float32),
                           (n, 1))


def profiled():
    return profile(activities=[ProfilerActivity.CPU],
                   **utils._all_threads_config())


@pytest.fixture(autouse=True)
def empty_log():
    utils.SPAN_LOG.clear()
    yield
    utils.SPAN_LOG.clear()


def test_no_span_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: entered.append(a) or real(*a, **k))
    r = runner()
    r.run_track(*track())
    assert entered == []
    assert utils.SPAN_LOG.snapshot() == ([], 0)
    sp = utils.span("runner/track", frames=3)
    assert sp is utils.span("model/stem") and not sp


@pytest.mark.parametrize("gait", [False, True])
def test_span_tree_of_a_track(gait):
    r = runner(gait)
    core = r._live()["core"]
    seen_rows = []
    hook = core.register_forward_pre_hook(
        lambda m, args: seen_rows.append(int(args[0].shape[0])))
    try:
        with profiled():
            r.run_track(*track())
            r.run_track(*track(5))
    finally:
        hook.remove()
    records, dropped = utils.SPAN_LOG.snapshot()
    assert dropped == 0
    assert not [x for x in records
                if x.name.startswith(utils.RESERVED_PREFIXES)]
    tracks = [x for x in records if x.name == "runner/track"]
    assert [x.counts["frames"] for x in tracks] == [N, 5]
    assert len({x.parent for x in tracks}) == 2
    rec = [x for x in records if x.parent == tracks[0].parent]
    by = {}
    for x in rec:
        by.setdefault(x.name, []).append(x)
    caller = tracks[0].thread
    crops = by["runner/crop"]
    assert [x.counts["frames"] for x in crops] == [3, 3, 3, 2]
    forwards = sorted(by["stream/forward"], key=lambda x: x.t0)
    assert [(x.counts["rows"], x.counts["frames"]) for x in forwards] == \
        [(8, 8), (4, 3)]
    assert [x.counts["rows"] for x in forwards] == seen_rows[:2]
    assert sum(x.counts["frames"] for x in forwards) == N
    worker = {x.thread for x in forwards}
    assert len(worker) == 1 and caller not in worker
    segments = ["model/" + n for n, _ in core.segments()] + ["model/regress"]
    if gait:
        assert {"model/frame_head", "model/corrector",
                "model/predict"} <= set(segments)
    for f in forwards:
        inside = sorted((x for x in rec if x.name.startswith("model/")
                         and f.t0 <= x.t0 and x.t1 <= f.t1),
                        key=lambda x: x.t0)
        assert [x.name for x in inside] == segments
        assert {x.thread for x in inside} == worker
    assert by["stream/wait"] and len(by["stream/readback"]) == 1
    for name in ("runner/crop", "stream/wait", "stream/readback"):
        assert {x.thread for x in by[name]} == {caller}
    t = tracks[0]
    assert all(t.t0 <= x.t0 and x.t1 <= t.t1 for x in rec)


def test_counts_go_to_the_innermost_span():
    with profiled():
        with utils.span("runner/track", parent=7) as outer:
            with utils.span("stream/readback", d2h_bytes=2) as inner:
                utils.count(h2d_bytes=5)
                inner.add(d2h_bytes=3)
            utils.count(h2d_bytes=1)
            assert utils.span_parent() == 7
        utils.count(h2d_bytes=100)  # no span open: nowhere
    assert utils.span_parent() is None
    got = {x.name: (x.parent, x.counts)
           for x in utils.SPAN_LOG.snapshot()[0]}
    assert got == {"runner/track": (7, {"h2d_bytes": 1}),
                   "stream/readback": (7, {"d2h_bytes": 5, "h2d_bytes": 5})}
    assert outer and inner


def test_a_full_log_counts_what_it_drops(monkeypatch):
    small = utils.SpanLog(maxlen=3)
    monkeypatch.setattr(utils, "SPAN_LOG", small)
    with profiled():
        for i in range(5):
            with utils.span("x/y", i=i):
                pass
    records, dropped = small.snapshot()
    assert dropped == 2
    assert [x.counts["i"] for x in records] == [2, 3, 4]
    small.clear()
    assert small.snapshot() == ([], 0)


@pytest.mark.parametrize("name", ["stage/stem", "host/crop", "bench/window"])
def test_the_benchmarks_prefixes_are_refused(name):
    with profiled():
        with pytest.raises(ValueError):
            utils.span(name)


def test_stage_timer_stages_are_spans():
    timer = utils.StageTimer()
    with timer.stage("decode"):
        pass
    assert utils.SPAN_LOG.snapshot()[0] == []
    with profiled():
        with timer.stage("model"):
            pass
    assert [x.name for x in utils.SPAN_LOG.snapshot()[0]] == ["demo/model"]
    assert set(timer.stages) == {"decode", "model"}


def _annotations(logdir):
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def test_profile_trace_records_a_thread_started_inside(tmp_path):
    logdir = str(tmp_path / "trace")

    def work():
        with utils.span("runner/crop", frames=1):
            torch.ones(8).sum()

    with utils.profile_trace(logdir):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    names = [e["name"] for e in _annotations(logdir)]
    assert "runner/crop" in names


def test_worker_spans_are_in_the_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    r = runner()
    with utils.profile_trace(logdir):
        r.run_track(*track())
    ann = _annotations(logdir)
    tid = {e["name"]: e["tid"] for e in ann}
    assert {"runner/track", "stream/forward", "model/stem",
            "model/regress"} <= set(tid)
    assert tid["stream/forward"] == tid["model/stem"] != tid["runner/track"]


def test_an_export_under_a_profiler_holds_no_profiler_op():
    r = GRNetRunner(GRNet.create(device="cpu", seed=4, **TINY), buckets=(4,),
                    crop_size=CROP)
    with profiled():
        programs = serve.export_forward(r, 4, platforms=("cpu",))
    targets = [str(n.target) for _, ep in programs["cpu"]
               for n in ep.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t]
    assert not [x for x in utils.SPAN_LOG.snapshot()[0]
                if x.name.startswith("model/")]


def test_demo_main_traces_the_whole_run(tmp_path, monkeypatch):
    """demo.main, for the command line and every other caller, runs in
    $GAITLAB_PROFILE's trace, which holds the demo's StageTimer stages."""
    from gaitlab_torch.cli import demo

    def run(args):
        with utils.StageTimer().stage("tracking"):
            torch.ones(8).sum()
        return args

    logdir = str(tmp_path / "trace")
    monkeypatch.setenv("GAITLAB_PROFILE", logdir)
    monkeypatch.setattr(demo, "_run", run)
    assert demo.main("args") == "args"
    assert "demo/tracking" in [e["name"] for e in _annotations(logdir)]
