"""The reading of a trace (harness/trace.py) on a small synthetic one, in
the shape torch.profiler writes on the card: the window span and host
spans on the main thread, stage ranges and host ops on a worker thread,
every CUDA runtime call reported on one thread and tied to its op by
"External id", kernels tied to their launch by correlation id."""

import pytest

from benchmark.harness.trace import TraceView

MAIN, WORKER, CUPTI = 1, 2, 3


def X(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 9, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def events():
    ev = [X("user_annotation", "bench/window", MAIN, 0, 1000),
          X("user_annotation", "host/crop", MAIN, 0, 300),
          X("user_annotation", "stage/stem", WORKER, 300, 200),
          X("user_annotation", "stage/hr-head", WORKER, 500, 300)]
    # one op and launch in each stage; a kernel 100 us long after each
    for i, (ts, ext) in enumerate(((320, 11), (520, 12))):
        ev.append(X("cpu_op", "aten::conv", WORKER, ts, 5, **{
            "External id": ext}))
        ev.append(X("cuda_runtime", "cudaLaunchKernel", CUPTI, ts + 1, 2,
                    correlation=100 + i, **{"External id": ext}))
        ev.append(X("kernel", f"k{i}", 7, ts + 50, 100,
                    correlation=100 + i))
    return ev


def test_stage_time_follows_the_op_thread():
    tv = TraceView(events())
    assert tv.stage_s["stem"] == pytest.approx(100e-6)
    assert tv.stage_s["hr-head"] == pytest.approx(100e-6)
    assert "other" not in tv.stage_s


def test_busy_and_window():
    tv = TraceView(events())
    assert tv.window_s == pytest.approx(1000e-6)
    assert tv.busy_s == pytest.approx(200e-6)
    assert [n for n, _ in tv.device_ops()] == ["k0", "k1"]


def test_idle_gaps_are_named_at_their_middle():
    """Gaps 0-370 (middle in the crop), 470-570 (middle in hr-head's
    range) and 670-1000 (middle after every span)."""
    gaps = dict(TraceView(events()).idle_gaps())
    assert gaps == pytest.approx({"host/crop": 370e-6,
                                  "launching hr-head": 100e-6,
                                  "host: no span": 330e-6})


def test_no_window_span_raises():
    with pytest.raises(RuntimeError):
        TraceView([e for e in events() if e["name"] != "bench/window"])
