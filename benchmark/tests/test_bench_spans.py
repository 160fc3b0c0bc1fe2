"""The readers of the program's spans (harness/spans.py and the metrics
crop_ms_per_frame, crop_idle_pct, stream_wait_ms_per_frame,
readback_ms_per_frame, kernels_per_forward) on a synthetic span log and
trace, in the shape the port and torch.profiler write them; then the
tiny traced run on the CPU, which reports the three host metrics, and a
run whose counts disagree, which stops."""

import types

import pytest

from benchmark.harness import spans, spec
from benchmark.harness.runner import Run
from benchmark.harness.trace import TraceView
from benchmark.tests.tiny import tiny_cell
from gaitlab_torch import utils

MAIN, WORKER = 1, 2
SEED = 2 ** 33 + 29
# the trace's clock (us) runs 5,000 us ahead of the spans' (s); each
# host/track span opens 3 us before its runner/track span and closes 3 us
# after it
SHIFT, LEAD = 5000.0, 3.0


def R(name, t0, t1, parent, thread=MAIN, **counts):
    return utils.SpanRecord(name, thread, t0 * 1e-6, t1 * 1e-6, parent,
                            counts)


def records():
    """Two tracks of 10 and 6 frames: crops of 5+5 and 6 frames, one
    forward each (rows 16 and 8), a wait and a read-back."""
    out = []
    for k, (t, n, rows) in enumerate(((100, 10, 16), (600, 6, 8))):
        out.append(R("runner/track", t, t + 400, k, frames=n))
        if n == 10:
            out += [R("runner/crop", t + 10, t + 60, k, frames=5,
                      h2d_bytes=500),
                    R("runner/crop", t + 60, t + 110, k, frames=5,
                      h2d_bytes=500)]
        else:
            out.append(R("runner/crop", t + 10, t + 110, k, frames=6,
                         h2d_bytes=600))
        out += [R("stream/wait", t + 120, t + 300, k),
                R("stream/forward", t + 125, t + 290, k, WORKER, rows=rows,
                  frames=n),
                R("model/stem", t + 130, t + 200, k, WORKER),
                R("stream/readback", t + 300, t + 320, k, d2h_bytes=100 * n)]
    return out


def X(cat, name, tid, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "pid": 9, "tid": tid,
            "ts": ts, "dur": dur, "args": {}}


def trace():
    """The window 0-1000 on the spans' clock; kernels busy 150-250 and
    640-700 (inside the second track's crop, 610-710) and 800-900."""
    ev = [X("user_annotation", "bench/window", MAIN, SHIFT, 1000)]
    for t in (100, 600):
        ev.append(X("user_annotation", "host/track", MAIN,
                    SHIFT + t - LEAD, 400 + 2 * LEAD))
    for ts, dur in ((150, 100), (640, 60), (800, 100)):
        ev.append(X("kernel", "k", 7, SHIFT + ts, dur))
    ev.append(X("gpu_memcpy", "copy", 7, SHIFT + 900, 10))
    return TraceView(ev)


def ctx(monkeypatch, recs=None, dropped=0, rows=(16, 8), frames=(10, 6),
        tv=True):
    log = utils.SpanLog()
    for r in records() if recs is None else recs:
        log.append(r)
    log.dropped = dropped
    monkeypatch.setattr(utils, "SPAN_LOG", log)
    lines = []
    return types.SimpleNamespace(
        window=types.SimpleNamespace(t0=0.0, t1=1e-3, frames=list(frames)),
        hooks=types.SimpleNamespace(rows=list(rows)),
        trace=trace() if tv else None, log=lines.append, lines=lines)


def read(name, c):
    return spec.reader(name)(c)


def test_host_metrics(monkeypatch):
    c = ctx(monkeypatch)
    assert read("crop_ms_per_frame", c) == pytest.approx(1e3 * 200e-6 / 16)
    assert read("stream_wait_ms_per_frame", c) == \
        pytest.approx(1e3 * 360e-6 / 16)
    assert read("readback_ms_per_frame", c) == pytest.approx(1e3 * 40e-6 / 16)
    assert c.lines == ["[readback_ms_per_frame] d2h 100.0 B/frame, h2d "
                       "100.0 B/frame over 16 frames"]


def test_crop_idle_places_spans_by_the_host_track_spans(monkeypatch):
    """Crops 110-210 (busy 150-210) and 610-710 (busy 640-700), placed by
    the host spans that open and close LEAD us around each track: idle 40
    + 40 of 1000 us."""
    c = ctx(monkeypatch)
    assert read("crop_idle_pct", c) == pytest.approx(100 * 80 / 1000)


def test_placement_takes_the_median_offset_of_the_tracks(monkeypatch):
    """A third track whose host span opens 300 us early moves nothing."""
    recs = records() + [R("runner/track", 900, 950, 2, frames=1)]
    c = ctx(monkeypatch)
    c.trace._spans.append((SHIFT + 600, SHIFT + 953, "host/track"))
    c.trace._spans.sort()
    got = spans.ProgramSpans(recs)
    assert got.placed("runner/crop", c.trace) == pytest.approx(
        [(SHIFT + 110, SHIFT + 160), (SHIFT + 160, SHIFT + 210),
         (SHIFT + 610, SHIFT + 710)])


def test_kernels_per_forward_counts_kernels_only(monkeypatch):
    assert read("kernels_per_forward", ctx(monkeypatch)) == 1.5


def test_without_a_card_the_device_readers_give_none(monkeypatch):
    c = ctx(monkeypatch, tv=False)
    assert read("crop_idle_pct", c) is None
    assert read("kernels_per_forward", c) is None
    assert read("crop_ms_per_frame", c) > 0


NAMES = ["crop_ms_per_frame", "crop_idle_pct", "stream_wait_ms_per_frame",
         "readback_ms_per_frame", "kernels_per_forward"]


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_spans_gives_none(monkeypatch, name):
    c = ctx(monkeypatch)
    monkeypatch.delattr(utils, "SPAN_LOG")
    assert read(name, c) is None


@pytest.mark.parametrize("fault", ["dropped", "rows", "forwards", "frames",
                                   "track", "owner", "crop"])
def test_counts_that_disagree_stop_the_run(monkeypatch, fault):
    recs = records()
    kw = {}
    if fault == "dropped":
        kw["dropped"] = 1
    elif fault == "rows":
        kw["rows"] = (16, 16)
    elif fault == "forwards":
        kw["rows"] = (16, 8, 8)
    elif fault == "frames":
        kw["frames"] = (10, 7)
    elif fault == "track":  # a track's span missing from the log
        recs = [r for r in recs if not (r.name == "runner/track"
                                        and r.parent == 1)]
    else:  # a forward or a crop credited to the other track
        i = next(i for i, r in enumerate(recs) if r.parent == 1 and r.name
                 == ("stream/forward" if fault == "owner" else "runner/crop"))
        recs[i] = recs[i]._replace(parent=0)
    c = ctx(monkeypatch, recs, **kw)
    for name in NAMES:
        with pytest.raises(RuntimeError):
            read(name, c)


def test_spans_outside_the_window_are_left_out(monkeypatch):
    late = [r._replace(t0=r.t0 + 2e-3, t1=r.t1 + 2e-3) for r in records()]
    c = ctx(monkeypatch, records() + late)
    assert read("crop_ms_per_frame", c) == pytest.approx(1e3 * 200e-6 / 16)


def test_placement_measures_each_offset_against_the_ranges(monkeypatch):
    """Every program span's own range lies SHIFT us after it, except the
    second track's crop, whose range opens 7 us late: each estimator finds
    SHIFT (the host/track ranges sit LEAD us around the tracks, the window
    range at the Window's start), the error shows the 7 us, and the idle
    share from the ranges themselves loses 7 us of idle."""
    from benchmark import placement

    c = ctx(monkeypatch)
    sp = spans.of(c)
    ranges = [X("user_annotation", "host/track", MAIN, SHIFT + t - LEAD,
                400 + 2 * LEAD) for t in (100, 600)]
    for r in sp.records:
        if r.name in placement.NAMES:
            late = 7.0 if r.name == "runner/crop" and r.t0 == 610e-6 else 0
            ranges.append(X("user_annotation", r.name, r.thread,
                            SHIFT + 1e6 * r.t0 + late,
                            1e6 * (r.t1 - r.t0) - late))
    got = placement.placement(sp, ranges, c.window.t0, c.trace)
    assert got["offsets_minus_own_us"] == pytest.approx(
        {"tracks": 0, "window": 0, "own": 0})
    crop = got["errors_us"]["runner/crop"]
    for k in ("reader", "tracks", "window", "own"):
        assert crop[k]["n"] == 6 and crop[k]["max"] == pytest.approx(7)
        assert crop[k]["median"] == pytest.approx(0)
    assert got["errors_us"]["stream/forward"]["own"]["max"] == \
        pytest.approx(0)
    assert got["crop_idle_pct"] == pytest.approx(
        {"reader": 8.0, "tracks": 8.0, "window": 8.0, "own": 8.0,
         "ranges": 7.3})
    assert got["drift_us"] == pytest.approx(0) and got["tracks"] == 2


def test_placement_stops_on_a_span_without_its_range(monkeypatch):
    from benchmark import placement

    c = ctx(monkeypatch)
    sp = spans.of(c)
    with pytest.raises(RuntimeError, match="runner/track"):
        placement.placement(sp, [], c.window.t0, c.trace)


def test_idle_us():
    busy = [[0, 10], [20, 30], [40, 50]]
    assert spans.idle_us(busy, 5, 45) == pytest.approx(20)
    assert spans.idle_us(busy, 10, 20) == pytest.approx(10)
    assert spans.idle_us(busy, 60, 70) == pytest.approx(10)
    assert spans.idle_us([], 1, 2) == pytest.approx(1)


def test_tiny_traced_run_reports_the_host_metrics():
    res = Run(tiny_cell(), SEED, "cpu").execute(1.0, True, 0.0)
    assert res["correct"], res["check"]
    got = res["metrics"]
    for name in ("crop_ms_per_frame", "stream_wait_ms_per_frame",
                 "readback_ms_per_frame"):
        assert got[name]["value"] > 0 and got[name]["unit"] == "ms/frame"
    assert not {"crop_idle_pct", "kernels_per_forward"} & set(got)


def test_tiny_traced_run_stops_on_a_lost_forward(monkeypatch):
    append = utils.SpanLog.append
    lost = []

    def lossy(self, record):
        if record.name == "stream/forward" and not lost:
            lost.append(record)
            return
        append(self, record)

    monkeypatch.setattr(utils.SpanLog, "append", lossy)
    with pytest.raises(RuntimeError):
        Run(tiny_cell(), SEED, "cpu").execute(1.0, True, 0.0)
    assert lost
