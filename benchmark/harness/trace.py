"""The traced run: stage ranges and row counts put on the program by the
benchmark (forward hooks named in the configuration), host spans around
the calls into the runner, torch.profiler over the window, and the
reading of its trace.

Stage ranges follow scripts/torch_mfu_trace.py: a hook leaves the open
`record_function("stage/<name>")` range and enters the next, so a range
runs from its stage's first module to the next stage's; device work is
attributed to the range that held the host call that launched it
(correlation ids, as scripts/torch_mfu_report.py reads them). The ranges
are opened on the thread that runs the forward (the runner's
ForwardStream worker) and closed when each bucket's forward returns."""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench/window"


def resolve(root, path: str) -> list:
    """The modules at a dotted path under `root` ("" is root itself); a
    path ending in ".*" names each direct child of its parent."""
    if path.endswith(".*"):
        return list(resolve(root, path[:-2])[0].children())
    return [root.get_submodule(path) if path else root]


class StageHooks:
    """The configuration's stage markers and row counter on a trunk."""

    def __init__(self, core, cfg: dict):
        self.current, self._range = None, None
        self.rows: list = []  # rows of each forward of the trunk
        self.real: list = []  # real frames of each bucket's forward
        self._handles = []
        for mark in cfg["stage_hooks"]:
            for mod in resolve(core, mark["module"]):
                fn = functools.partial(self._hook, mark["stage"])
                self._handles.append(
                    mod.register_forward_pre_hook(fn) if mark["when"] == "pre"
                    else mod.register_forward_hook(fn))
        for mod in resolve(core, cfg["rows_module"]):
            self._handles.append(mod.register_forward_pre_hook(
                lambda m, args: self.rows.append(int(args[0].shape[0]))))

    def _hook(self, stage, *_):
        self.switch(stage)

    def switch(self, stage) -> None:
        if stage == self.current:
            return
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.current = stage
        if stage is not None:
            self._range = torch.profiler.record_function(f"stage/{stage}")
            self._range.__enter__()

    def remove(self) -> None:
        self.switch(None)
        for h in self._handles:
            h.remove()


def _spanned(fn, name: str):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


def instrument(runner, hooks: StageHooks) -> None:
    """Host spans around the calls into the runner's layers (the track,
    the host crop, the session's finish), the real frames of each bucket's
    forward as the runner passes them, and the end of the stage ranges
    when a bucket's forward returns; all on this runner object only."""
    runner.run_track = _spanned(runner.run_track, "host/track")
    runner._host_crop = _spanned(runner._host_crop, "host/crop")
    open_stream = runner.open_stream

    def open_spanned():
        session = open_stream()
        session.finish = _spanned(session.finish, "host/finish")
        return session

    runner.open_stream = open_spanned
    forward_bucket = runner._forward_bucket

    def bucket(crops, *args, **kwargs):
        hooks.real.append(int(crops.shape[0]))
        hooks.switch(None)
        try:
            return forward_bucket(crops, *args, **kwargs)
        finally:
            hooks.switch(None)

    runner._forward_bucket = bucket


def profiler(on_card: bool = True):
    """torch.profiler over the host (every thread) and the card."""
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    for opts in ({"profile_all_threads": True, "trace_only": True},
                 {"profile_all_threads": True}):
        try:
            kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
                **opts)
            break
        except TypeError:
            continue
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    return profile(activities=acts, **kw)


@contextlib.contextmanager
def window_span():
    with torch.profiler.record_function(WINDOW):
        yield
        torch.cuda.synchronize()


def events_of(prof) -> list:
    """The profile's Chrome-trace events (written to a temporary file in
    $TMPDIR, read back and deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceView:
    """What the metrics read from a trace: the window, the card's busy
    time, device time by stage range and by kernel name, idle gaps by
    what the host was doing."""

    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X"]
        win = [e for e in xs if e.get("cat") == "user_annotation"
               and e["name"] == WINDOW]
        if not win:
            raise RuntimeError("the trace has no window span")
        self.t0 = win[0]["ts"]
        self.t1 = win[0]["ts"] + win[0]["dur"]
        self.main_tid = (win[0]["pid"], win[0]["tid"])
        dev = [e for e in xs if e.get("cat") in DEVICE_CATS
               and e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]
        self.device = dev
        self.busy = _union([(max(e["ts"], self.t0),
                             min(e["ts"] + e["dur"], self.t1)) for e in dev])
        self.busy_s = sum(e - s for s, e in self.busy) / 1e6
        self.window_s = (self.t1 - self.t0) / 1e6
        self.kernel_s = collections.Counter()
        for e in dev:
            self.kernel_s[e["name"]] += e["dur"] / 1e6
        self.stage_s = self._by_stage(xs, dev)
        self._spans = sorted(
            (e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
            if (e["pid"], e["tid"]) == self.main_tid
            and e.get("cat") == "user_annotation"
            and e["name"].startswith("host/"))
        self._stages = sorted(
            (e["ts"], e["ts"] + e["dur"], "launching " + e["name"][6:])
            for e in xs if e.get("cat") == "user_annotation"
            and e["name"].startswith("stage/"))

    @staticmethod
    def _by_stage(xs: list, dev: list) -> dict:
        """Device seconds by the stage range that held each event's launch.
        A launch is found by correlation id; its thread is that of the
        host op that made it (the runtime event's "External id"), since
        CUPTI may report every runtime call on one thread."""
        ops = {(e.get("args") or {}).get("External id"): (e["pid"], e["tid"])
               for e in xs if e.get("cat") in ("cpu_op", "user_annotation")}
        launches = {}
        for e in xs:
            args = e.get("args") or {}
            corr = args.get("correlation")
            if e.get("cat") in ("cuda_runtime", "cuda_driver") \
                    and corr is not None:
                where = ops.get(args.get("External id"),
                                (e["pid"], e["tid"]))
                launches[corr] = where + (e["ts"],)
        ranges = collections.defaultdict(list)
        for e in xs:
            if e.get("cat") == "user_annotation" \
                    and e["name"].startswith("stage/"):
                ranges[(e["pid"], e["tid"])].append(
                    (e["ts"], e["ts"] + e["dur"], e["name"][6:]))
        for v in ranges.values():
            v.sort()
        starts = {k: [r[0] for r in v] for k, v in ranges.items()}
        out = collections.Counter()
        for e in dev:
            launch = launches.get((e.get("args") or {}).get("correlation"))
            stage = "other"
            if launch is not None:
                key = launch[:2]
                i = bisect.bisect_right(starts.get(key, []), launch[2]) - 1
                if i >= 0 and ranges[key][i][1] >= launch[2]:
                    stage = ranges[key][i][2]
            out[stage] += e["dur"] / 1e6
        return out

    def host_at(self, ts: float) -> str:
        """What the host was doing at ts: launching a stage (a stage range
        open on the thread that runs the forward), or else the innermost
        host/* span of the main thread."""
        for spans in (self._stages, self._spans):
            name = None
            i = bisect.bisect_right(spans, (ts, float("inf"), "")) - 1
            for s, e, n in spans[max(0, i - 64):i + 1]:
                if s <= ts <= e:
                    name = n
            if name is not None:
                return name
        return "host: no span"

    def idle_gaps(self) -> list:
        """[(what the host did, seconds)]: the card's idle time inside the
        window, each gap named by `host_at` its middle, summed by name,
        longest first."""
        gaps, prev = collections.Counter(), self.t0
        for s, e in self.busy + [[self.t1, self.t1]]:
            if s > prev:
                gaps[self.host_at((s + prev) / 2)] += (s - prev) / 1e6
            prev = max(prev, e)
        return gaps.most_common()

    def device_ops(self) -> list:
        return self.kernel_s.most_common()
