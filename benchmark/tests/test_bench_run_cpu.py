"""The harness's control flow on the CPU at a tiny size (tests/tiny.py),
with the kernels' plain CPU paths: a run passes the check, and each fault
of the timed path that an inference cell can have makes `correct` false.
run.py's measured path refuses a machine without a card; these tests
drive its pieces (harness.runner.Run) instead."""

import numpy as np
import pytest
import torch

from benchmark.harness import inputs, trace, window
from benchmark.harness.runner import Ctx, Run
from benchmark.tests.tiny import tiny_cell

SEED = 2 ** 33 + 17  # wider than 32 bits, as the driver's seeds are


@pytest.mark.parametrize("cell_name", ["grnet_w32.clinic_tracks",
                                       "maxgrnet_w32.clinic_tracks"])
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_run_is_correct(cell_name, traced):
    cell = tiny_cell(cell_name)
    res = Run(cell, SEED, "cpu").execute(1.0, traced, 0.0)
    assert res["correct"], res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "check"
    names = set(res["metrics"])
    if traced:
        assert "rows_per_frame" in names  # the hooks' count needs no card
        assert not names & {"step_mfu", "device_idle_pct"}  # no device time
    else:
        want = {m["name"] for m in cell.end_to_end}
        assert names == want
        assert all(v["value"] > 0 for v in res["metrics"].values())


def _fault(monkeypatch, kind):
    from gaitlab_torch.pipeline.runner import GRNetRunner

    orig = GRNetRunner._forward_bucket
    state = {}

    def broken(self, crops, bbox=None, cimg=None):
        m = crops.shape[0]
        if kind == "half_batch" and m > 1:
            # half of the rows left out, the rest copied over them
            h = (m + 1) // 2
            kw = {} if bbox is None else dict(bbox=bbox[:h], cimg=cimg[:h])
            out = orig(self, crops[:h], **kw)
            idx = torch.arange(m) % h
            return {k: v if k == "pred_avg" else v[idx]
                    for k, v in out.items()}
        out = orig(self, crops, bbox=bbox, cimg=cimg)
        if kind == "stale":
            # a forward that returns the first forward's state unchanged
            first = state.setdefault("first", out)
            idx = torch.arange(m) % first["verts"].shape[0]
            return {k: v if k == "pred_avg" else v[idx]
                    for k, v in first.items()}
        if kind == "altered":
            # one answer altered where it is produced
            out = dict(out)
            verts = out["verts"].clone()
            verts[0, 0, 0] += 0.05 * verts.abs().max()
            out["verts"] = verts
        return out

    monkeypatch.setattr(GRNetRunner, "_forward_bucket", broken)


@pytest.mark.parametrize("kind", ["half_batch", "stale", "altered"])
def test_faults_are_not_correct(monkeypatch, kind):
    _fault(monkeypatch, kind)
    res = Run(tiny_cell(length=(6, 20)), SEED, "cpu").execute(
        1.0, False, 0.0)
    assert not res["correct"], res["check"]


def test_forwards_are_recorded_as_the_runner_passes_them():
    """The traced run pairs each trunk forward's rows with the real frames
    the runner passed to that bucket's forward, whatever its splitting
    rule; counts that disagree stop the run instead of dropping metrics."""
    cell = tiny_cell(length=(6, 20))
    run = Run(cell, SEED, "cpu")
    run.setup()
    hooks = trace.StageHooks(run.runner._live()["core"], cell.cfg)
    trace.instrument(run.runner, hooks)
    win = window.run(run.runner, run.schedule, 0.5, lambda i: False, 16)
    hooks.remove()
    ctx = Ctx(cell.cfg, None, hooks, win, None, "cpu")
    fw = ctx.forwards()
    buckets = cell.cfg["runner"]["buckets"]
    assert sum(real for _, real in fw) == sum(win.frames)
    assert all(rows in buckets and real <= rows for rows, real in fw)
    hooks.real.pop()
    with pytest.raises(RuntimeError):
        ctx.forwards()


def test_same_lengths_for_every_seed():
    tr = tiny_cell().traffic
    pool = np.zeros((40, 8, 8, 3), np.uint8)
    decks = []
    for seed in (1, 2 ** 40 + 3):
        s = inputs.Schedule(tr, seed, pool, 4)
        decks.append(sorted(s.length(i) for i in range(8)))
    assert decks[0] == decks[1] == sorted(inputs.deck(tr["length"]) * 2)


def test_schedule_is_fixed_by_the_seed():
    tr = tiny_cell().traffic
    pool = np.zeros((40, 8, 8, 3), np.uint8)
    a = inputs.Schedule(tr, 9, pool, 4)
    b = inputs.Schedule(tr, 9, pool, 4)
    c = inputs.Schedule(tr, 10, pool, 4)
    assert all(np.array_equal(a[i].boxes, b[i].boxes) for i in range(5))
    assert not all(np.array_equal(a[i].boxes, c[i].boxes)
                   for i in range(5))


def test_track_chunks_are_views_of_the_pool():
    pool = np.arange(40 * 2 * 2 * 3, dtype=np.uint8).reshape(40, 2, 2, 3)
    t = inputs.Track(0, pool, 37, np.zeros((70, 4), np.float32), 32)
    chunks = list(t)
    assert [len(c) for c in chunks] == [32, 32, 6]
    assert all(c.base is pool or c.base is pool.base for c in chunks)
    assert len(t.frames()) == 70


def test_buckets_used():
    b = [32, 64, 128, 256, 450]
    assert inputs.buckets_used({"length": {"min": 25, "max": 90}}, b) == \
        [32, 64, 128]
    assert inputs.buckets_used({"length": {"min": 150, "max": 900}}, b) == b


def test_keep_set_is_seeded():
    a, b = window.keep_set(5, 0.3), window.keep_set(5, 0.3)
    assert [a(i) for i in range(50)] == [b(i) for i in range(50)]
    assert a(0)
