"""gaitlab_torch's utilities against gaitlab's: utils (create_logger,
AverageMeter, StageTimer.fps, profile_trace), config.merge_from_other_cfg
and weights/cache.py (file_hash, memo_tree, convert_cached), all on the
host. Exact equality throughout: the same arithmetic on the same inputs.
"""

import glob
import logging
import os

import numpy as np
import pytest
import torch

from gaitlab import config as jax_config
from gaitlab import utils as jax_utils
from gaitlab.weights import cache as jax_cache
from gaitlab_torch import config as pt_config
from gaitlab_torch import utils as pt_utils
from gaitlab_torch.weights import cache as pt_cache


def test_average_meter_matches():
    meters = pt_utils.AverageMeter(), jax_utils.AverageMeter()
    for val, n in ((1.5, 1), (2.0, 3), (-0.25, 2), (7.0, 0)):
        for m in meters:
            m.update(val, n)
        got, want = (vars(m) for m in meters)
        assert got == want
    for m in meters:
        m.reset()
    assert vars(meters[0]) == vars(meters[1]) == {
        "val": 0.0, "avg": 0.0, "sum": 0.0, "count": 0}


def test_stage_timer_fps_matches():
    timers = pt_utils.StageTimer(), jax_utils.StageTimer()
    for t in timers:
        t.stages.update({"model": 2.5, "idle": 0.0})
    for args in ((100, "model"), (7, "idle")):
        assert timers[0].fps(*args) == timers[1].fps(*args)
    assert timers[0].fps(100, "model") == 40.0
    assert timers[0].fps(7, "idle") == 0.0
    assert timers[0].fps(10) > 0.0  # over the timer's whole life


def test_create_logger_matches(tmp_path):
    root = logging.getLogger()
    before = list(root.handlers)
    try:
        loggers = [mod.create_logger(str(tmp_path / name), phase="eval")
                   for name, mod in (("pt", pt_utils), ("jax", jax_utils))]
        added = [h for h in root.handlers if h not in before]
    finally:
        for h in root.handlers[:]:
            if h not in before:
                root.removeHandler(h)
    assert loggers[0] is loggers[1] is root
    assert root.level == logging.INFO
    # one console handler each
    assert [type(h) for h in added] == [logging.StreamHandler] * 2
    assert (tmp_path / "pt").is_dir() and (tmp_path / "jax").is_dir()


def test_profile_trace_is_a_no_op_without_a_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("GAITLAB_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    with pt_utils.profile_trace():
        assert not torch.autograd.profiler._is_profiler_enabled
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("how", ["env", "arg"])
def test_profile_trace_writes_a_trace(tmp_path, monkeypatch, how):
    logdir = str(tmp_path / "trace")
    if how == "env":
        monkeypatch.setenv("GAITLAB_PROFILE", logdir)
    with pt_utils.profile_trace(None if how == "env" else logdir):
        assert torch.autograd.profiler._is_profiler_enabled
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    traces = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
    assert not torch.autograd.profiler._is_profiler_enabled


def _tree(node):
    return {k: _tree(v) if isinstance(v, dict) else v
            for k, v in node.items()}


def test_merge_from_other_cfg_matches():
    update = {"EXP_NAME": "merged", "DATASET": {"SEQLEN": 16},
              "MODEL": {"FEAT_CORR": {"H_SIZE": 64, "USE_JWFF": True}}}
    got, want = pt_config.get_cfg_defaults(), jax_config.get_cfg_defaults()
    got.merge_from_other_cfg(update)
    want.merge_from_other_cfg(update)
    merged, reference = _tree(got), _tree(want)
    assert merged["EXP_NAME"] == "merged" and merged["DATASET"]["SEQLEN"] == 16
    # the port's defaults differ from gaitlab's only in DEVICE
    assert merged.pop("DEVICE") == "cuda"
    reference.pop("DEVICE")
    assert merged == reference
    # another config node merges whole, and unknown keys are refused alike
    other = pt_config.get_cfg_defaults()
    other.merge_from_other_cfg(got)
    assert _tree(other) == _tree(got)
    for cfg in (pt_config.get_cfg_defaults(), jax_config.get_cfg_defaults()):
        with pytest.raises(KeyError, match="NOT_A_KEY"):
            cfg.merge_from_other_cfg({"NOT_A_KEY": 1})


def test_file_hash_matches(tmp_path):
    path = tmp_path / "ckpt.bin"
    path.write_bytes(np.random.default_rng(0).bytes(3 * (1 << 20) + 17))
    assert pt_cache.file_hash(str(path)) == jax_cache.file_hash(str(path))
    assert pt_cache.file_hash(str(path), chunk=4096) == \
        jax_cache.file_hash(str(path))


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"conv.weight": torch.randn(4, 3, 3, 3, generator=g),
            "bn.num_batches_tracked": torch.tensor(7),
            "nested": {"a": [torch.arange(5), torch.ones(2, 2)]}}


def _assert_same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert got.dtype == want.dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_memo_tree_round_trip(tmp_path):
    calls = []

    def build():
        calls.append(1)
        return _state()

    first = pt_cache.memo_tree("model-init-0", build, cache_dir=str(tmp_path))
    again = pt_cache.memo_tree("model-init-0", build, cache_dir=str(tmp_path))
    assert len(calls) == 1
    _assert_same(again, first)
    pt_cache.memo_tree("model-init-1", build, cache_dir=str(tmp_path))
    assert len(calls) == 2


def test_convert_cached_round_trip_and_corrupt_entry(tmp_path):
    src = tmp_path / "model.pth"
    src.write_bytes(b"a source checkpoint")
    calls = []

    def convert(path, like):
        calls.append(path)
        return _state(seed=len(like))

    cache_dir = str(tmp_path / "cache")
    first = pt_cache.convert_cached(str(src), [0, 0], convert,
                                    cache_dir=cache_dir)
    again = pt_cache.convert_cached(str(src), [0, 0], convert,
                                    cache_dir=cache_dir)
    assert calls == [str(src)]
    _assert_same(again, first)
    (entry,) = glob.glob(os.path.join(cache_dir, "model.pth.torch.*.pt"))
    assert entry.endswith(f".{pt_cache.file_hash(str(src))}.pt")
    with open(entry, "wb") as f:  # a corrupt entry is converted again
        f.write(b"not a torch file")
    third = pt_cache.convert_cached(str(src), [0, 0], convert,
                                    cache_dir=cache_dir)
    assert len(calls) == 2
    _assert_same(third, first)
    # a changed source is another entry
    src.write_bytes(b"another source checkpoint")
    pt_cache.convert_cached(str(src), [0, 0], convert, cache_dir=cache_dir)
    assert len(calls) == 3


def test_cache_write_failure_is_best_effort(tmp_path, capsys):
    blocker = tmp_path / "file"
    blocker.write_text("a file where the cache directory should be")
    tree = pt_cache.memo_tree("k", _state, cache_dir=str(blocker))
    _assert_same(tree, _state())
    assert "cache write failed" in capsys.readouterr().out
