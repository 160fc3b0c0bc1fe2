"""The program's own spans in a traced run: gaitlab_torch.utils.SPAN_LOG,
which the port fills while a profiler is active, on the host clock of the
window (time.perf_counter).

`of(ctx)` keeps the spans that started inside the traced window and holds
their counts to the harness's: the real frames of the window's tracks, one
`stream/forward` per trunk forward with the rows the trunk's pre-hook saw,
nothing dropped; and, by the track id each span carries, every track's
frames forwarded and cropped once. Counts that disagree stop the run, as Ctx.forwards() does.
A program without a span log (one that predates it) gives None, and the
metrics read from it are left out of the line."""

from __future__ import annotations

import bisect
import collections
import statistics


class ProgramSpans:
    """The window's program spans (utils.SpanRecord), oldest first."""

    def __init__(self, records: list):
        self.records = sorted(records, key=lambda r: r.t0)
        self.tracks = self.named("runner/track")
        self.forwards = self.named("stream/forward")
        self.frames = sum(r.counts["frames"] for r in self.tracks)

    def named(self, name: str) -> list:
        return [r for r in self.records if r.name == name]

    def seconds(self, name: str) -> float:
        return sum(r.t1 - r.t0 for r in self.named(name))

    def total(self, key: str) -> int:
        """The sum of a count over every span."""
        return sum(r.counts.get(key, 0) for r in self.records)

    def placed(self, name: str, tv) -> list:
        """[(start, end)] of the spans called `name` on the trace's time
        axis (us), moved by one offset between the two clocks: the median,
        over the window's tracks, of the mean of two differences between
        the harness's `host/track` span and the program's `runner/track`
        span of the same track (the k-th of each), their starts and their
        ends. The host span opens a little before and closes a little after
        the program's; either difference alone swings by tens of us from
        track to track, more than the clocks drift apart over a window."""
        anchors = [(s, e) for s, e, n in tv._spans
                   if n == "host/track" and tv.t0 <= s <= tv.t1]
        if len(anchors) != len(self.tracks) or not anchors:
            raise RuntimeError(f"{len(self.tracks)} program tracks against "
                               f"{len(anchors)} host/track spans")
        offset = statistics.median(
            (s + e - 1e6 * (r.t0 + r.t1)) / 2
            for r, (s, e) in zip(self.tracks, anchors))
        return [(1e6 * r.t0 + offset, 1e6 * r.t1 + offset)
                for r in self.named(name)]


def of(ctx):
    """The window's ProgramSpans, checked; None without a span log."""
    try:
        from gaitlab_torch.utils import SPAN_LOG
    except ImportError:
        return None
    records, dropped = SPAN_LOG.snapshot()
    w = ctx.window
    spans = ProgramSpans([r for r in records if w.t0 <= r.t0 <= w.t1])
    rows = [r.counts["rows"] for r in spans.forwards]
    real = sum(r.counts["frames"] for r in spans.forwards)
    want = sum(w.frames)
    if dropped or spans.frames != want or real != want \
            or rows != list(ctx.hooks.rows):
        raise RuntimeError(
            f"program spans: {dropped} dropped, {spans.frames} track frames "
            f"and {real} forward frames against {want} in the window's "
            f"tracks, {len(rows)} forwards against {len(ctx.hooks.rows)} "
            f"trunk forwards, rows equal: {rows == list(ctx.hooks.rows)}")
    per_track = {r.parent: r.counts["frames"] for r in spans.tracks}
    for name in ("stream/forward", "runner/crop"):
        got = collections.Counter()
        for r in spans.named(name):
            got[r.parent] += r.counts["frames"]
        if got != per_track:
            raise RuntimeError(f"program spans: {name} frames by track "
                               f"{dict(got)} against {per_track}")
    return spans


def idle_us(busy: list, start: float, end: float) -> float:
    """The time in [start, end] that the sorted disjoint [s, e] intervals
    of `busy` leave uncovered."""
    covered = 0.0
    i = max(0, bisect.bisect_right(busy, [start]) - 1)
    while i < len(busy) and busy[i][0] < end:
        s, e = busy[i]
        covered += max(0.0, min(e, end) - max(s, start))
        i += 1
    return (end - start) - covered
