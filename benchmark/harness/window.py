"""The measured window: one worker takes the schedule's tracks in turn,
each through the runner's `run_track` with every output fetched (a closed
loop, as the demo's run_tracks and a clinic's batch job run), until
`seconds` have passed; then it finishes the deck of track lengths it is
on, so that every window holds whole decks: the same work for every
seed, in another order."""

from __future__ import annotations

import time

import numpy as np


class Window:
    """What a window did: per track its frames and completion time (host
    clock), and the outputs of the tracks kept for the check."""

    def __init__(self):
        self.frames, self.done = [], []
        self.kept: dict = {}
        self.t0 = self.t1 = None

    @property
    def attempted(self) -> int:
        return len(self.frames)

    def frames_per_s(self) -> float:
        """Real frames of every completed track over the time from the
        window's start to the last completion."""
        return sum(self.frames) / (self.t1 - self.t0)


def keep_set(seed: int, share: float, n_max: int = 100000):
    """Which schedule indices keep their outputs for the check: a sample
    drawn from the seed with probability `share`, plus index 0."""
    rng = np.random.default_rng([seed % (1 << 63), 3])
    draws = rng.random(n_max)
    return lambda i: i == 0 or draws[i % n_max] < share


def warm_up(runner, make_track, buckets: list) -> None:
    """One track of each forward size the cell uses, cropped and fetched
    as in the window: every kernel, cuDNN plan and host buffer of those
    shapes is built before the window."""
    for b in buckets:
        track = make_track(b)
        runner.run_track(track, track.boxes)


def run(runner, schedule, seconds: float, keep, first_long: int
        ) -> Window:
    """The closed loop over `schedule` for `seconds` (whole decks). The
    outputs of tracks for which keep(i) holds, and of the first track
    longer than `first_long` frames, are kept."""
    per_deck = len(schedule.deck)
    w = Window()
    want_long = True
    w.t0 = time.perf_counter()
    i = 0
    while True:
        tr = schedule[i]
        out = runner.run_track(tr, tr.boxes)
        te = time.perf_counter()
        w.frames.append(len(tr))
        w.done.append(te)
        if keep(i) or (want_long and len(tr) > first_long):
            w.kept[i] = out
            want_long = want_long and len(tr) <= first_long
        i += 1
        if te - w.t0 >= seconds and i % per_deck == 0:
            break
    w.t1 = w.done[-1]
    return w
