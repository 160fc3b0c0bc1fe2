"""Logging, meters, profiling, spans and per-stage wall-clock telemetry.

Counterpart of gaitlab/utils.py: `create_logger`, `AverageMeter`,
`StageTimer` (one structured report of the demo's stages in place of
scattered time brackets) and `profile_trace`, on torch.profiler here.
gaitlab's `enable_compile_cache` has no counterpart: the port compiles
nothing at run time but its CUDA kernels, which ops/_build.py caches by
source hash.

The port's tracing is `span`: a named range with counts, recorded only
while a torch.profiler session is active (`profile_trace`, an operator's
own profiler, a benchmark's traced run), both as a `record_function` range
in the profiler's trace, on the kernels' clock, and in `SPAN_LOG`, on the
clock of `time.perf_counter()`. Outside a profiler a span is one boolean
check and a shared null context.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import os.path as osp
import threading
import time
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


def create_logger(logdir: str, phase: str = "train") -> logging.Logger:
    """File+console logger (reference utils.py:138-151)."""
    os.makedirs(logdir, exist_ok=True)
    log_file = osp.join(logdir,
                        f"{time.strftime('%Y-%m-%d_%H-%M-%S')}_{phase}.log")
    logging.basicConfig(filename=log_file, format="%(asctime)-15s %(message)s")
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    console = logging.StreamHandler()
    logging.getLogger("").addHandler(console)
    return logger


class AverageMeter:
    """Running average (reference utils.py:154-168)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0


# prefixes a profiler's reader may give its own ranges around the port's
RESERVED_PREFIXES = ("stage/", "host/", "bench/")


class SpanRecord(NamedTuple):
    """One finished span: its thread's native id, its start and end on
    `time.perf_counter()`, the id of what it belongs to (a runner's track
    sequence number; None for none) and its counts."""

    name: str
    thread: int
    t0: float
    t1: float
    parent: object
    counts: dict


class SpanLog:
    """The spans finished while a profiler was active, oldest first. A full
    log drops its oldest record for each new one and counts it in
    `dropped`."""

    def __init__(self, maxlen: int = 1 << 16):
        self._records: collections.deque = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self.dropped = 0

    def append(self, record: SpanRecord) -> None:
        with self._lock:
            if len(self._records) == self._records.maxlen:
                self.dropped += 1
            self._records.append(record)

    def snapshot(self) -> tuple[list, int]:
        """(the records, the number dropped so far)."""
        with self._lock:
            return list(self._records), self.dropped

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.dropped = 0


SPAN_LOG = SpanLog()
_open = threading.local()  # .stack: this thread's open spans, innermost last


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class _Span:
    __slots__ = ("name", "parent", "counts", "_range", "_t0")

    def __init__(self, name: str, parent, counts: dict):
        if name.startswith(RESERVED_PREFIXES):
            raise ValueError(f"span {name!r}: the prefixes "
                             f"{RESERVED_PREFIXES} are not the port's")
        self.name, self.parent, self.counts = name, parent, counts

    def add(self, **counts) -> None:
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    # Each clock is read just before the profiler's op that stamps the
    # range: that op lets go of the GIL, and taking it back may wait for
    # another thread for milliseconds, which must not fall between the two
    # stamps of one edge.
    def __enter__(self) -> "_Span":
        stack = _stack()
        if self.parent is None and stack:
            self.parent = stack[-1].parent
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._t0 = time.perf_counter()
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        self._range.__exit__(*exc)
        _stack().remove(self)
        SPAN_LOG.append(SpanRecord(self.name, threading.get_native_id(),
                                   self._t0, t1, self.parent, self.counts))


class _NullSpan:
    def __bool__(self) -> bool:
        return False

    def add(self, **counts) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


def span(name: str, parent=None, **counts):
    """A context manager that records the enclosed work as `name` with
    `counts` (more may be added with `.add(**counts)` inside, or `count`)
    while a torch.profiler session is active: a `record_function` range
    and, on exit, a SpanRecord in SPAN_LOG. `parent` is the id of what the
    span belongs to; None takes that of this thread's innermost open span.
    Otherwise, and while torch.export or torch.compile traces (a program
    keeps no profiler op), it is a shared null context, which is falsy."""
    if not _autograd_profiler._is_profiler_enabled or \
            torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return _NULL_SPAN
    return _Span(name, parent, counts)


def count(**counts) -> None:
    """Add `counts` to this thread's innermost open span, if any."""
    if _autograd_profiler._is_profiler_enabled:
        stack = _stack()
        if stack:
            stack[-1].add(**counts)


def span_parent():
    """The id that this thread's innermost open span belongs to (None when
    no span is open): what a span started on a helper thread for this work
    passes as `parent`."""
    stack = getattr(_open, "stack", None)
    return stack[-1].parent if stack else None


class StageTimer:
    """Seconds spent per named stage, summed over repeats; each stage is
    also a span `demo/<stage>`."""

    def __init__(self):
        self.stages: dict[str, float] = {}
        self._t0 = time.time()

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.time()
        try:
            with span(f"demo/{name}"):
                yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.time() - t

    def total(self) -> float:
        return time.time() - self._t0

    def report(self) -> str:
        lines = [f"  {k}: {v:.2f}s" for k, v in self.stages.items()]
        return "\n".join(lines + [f"  total: {self.total():.2f}s"])

    def fps(self, num_frames: int, stage: Optional[str] = None) -> float:
        dt = self.stages.get(stage, self.total()) if stage else self.total()
        return num_frames / dt if dt > 0 else 0.0


def _all_threads_config() -> dict:
    """torch.profiler's keyword that records the ops of every thread (a
    ForwardStream's worker starts inside the session), where this PyTorch
    has it."""
    try:
        return {"experimental_config": torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)}
    except TypeError:
        return {}


@contextlib.contextmanager
def profile_trace(logdir: Optional[str] = None):
    """torch.profiler trace of the enclosed work on every thread (host, and
    the card's kernels when CUDA is there), written to `logdir` or
    $GAITLAB_PROFILE as a TensorBoard/Chrome trace file; a no-op when
    neither is set."""
    logdir = logdir or os.environ.get("GAITLAB_PROFILE")
    if not logdir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir),
                 **_all_threads_config()):
        yield
