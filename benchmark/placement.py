"""How far the program's spans land, on the trace's time axis, from their
own record_function ranges in the same trace.

One traced run of a cell, made as run.py makes it (`--trace 1`), that
keeps the trace's ranges. Each program span of the window (the port's
span log, on time.perf_counter()) is paired with the range of the same
name that it opened, the k-th of each in order of start, and both edges
of every pair are compared once the span is moved onto the trace's axis
by one offset. The offset is estimated four ways:

- `reader`: what spans.ProgramSpans.placed gives, which crop_idle_pct
  reads;
- `tracks`: the median over the window's tracks of the midpoint
  differences between the harness's `host/track` range and the program's
  `runner/track` span;
- `window`: the start of the trace's window range against the Window's
  own start;
- `own`: the median of the pairs' own start differences, which no reader
  can know: the floor that the spans' clock stamps allow.

It prints one JSON line, and writes it to --out: for each estimator and
span name the absolute error of the edges in us (n, median, p99, max),
crop_idle_pct as each estimator's placement gives it and as the ranges
themselves give it, and the drift, how far the `own` offset of the
window's last tenth of pairs lies from that of its first tenth.

    python3 benchmark/placement.py --workload grnet_w32.clinic_tracks \\
        --seed 123456789 --seconds 50 --out placement.json
"""

from __future__ import annotations

import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("runner/track", "runner/crop", "stream/wait", "stream/readback",
         "stream/forward")


def _stats(errors: list) -> dict:
    xs = sorted(abs(x) for x in errors)
    if len(xs) < 2:
        return {"n": len(xs), "max": xs[0] if xs else None}
    return {"n": len(xs), "median": statistics.median(xs),
            "p99": statistics.quantiles(xs, n=100)[98], "max": xs[-1]}


def _pairs(spans, ranges: list, name: str) -> list:
    """[(span, range)] of `name`, the k-th of each in order of start."""
    got = spans.named(name)
    own = sorted((e for e in ranges if e["name"] == name),
                 key=lambda e: e["ts"])
    if len(got) != len(own):
        raise RuntimeError(f"{name}: {len(got)} program spans against "
                           f"{len(own)} ranges in the trace")
    return list(zip(got, own))


def placement(spans, ranges: list, window_t0: float, tv) -> dict:
    """The errors, crop idle shares and drift described above, from the
    window's ProgramSpans, the trace's user_annotation ranges inside the
    window, the Window's start (s) and the TraceView."""
    from benchmark.harness.spans import idle_us

    pairs = {n: _pairs(spans, ranges, n) for n in NAMES}
    tracks = sorted((e for e in ranges if e["name"] == "host/track"),
                    key=lambda e: e["ts"])
    if len(tracks) != len(pairs["runner/track"]):
        raise RuntimeError(f"{len(tracks)} host/track ranges against "
                           f"{len(pairs['runner/track'])} tracks")
    every = sorted((p for v in pairs.values() for p in v),
                   key=lambda p: p[0].t0)
    own = [e["ts"] - 1e6 * r.t0 for r, e in every]
    tenth = max(1, len(own) // 10)
    offsets = {
        "tracks": statistics.median(
            e["ts"] + e["dur"] / 2 - 1e6 * (r.t0 + r.t1) / 2
            for (r, _), e in zip(pairs["runner/track"], tracks)),
        "window": tv.t0 - 1e6 * window_t0,
        "own": statistics.median(own)}
    out = {"errors_us": {}, "crop_idle_pct": {}}
    placed = {k: [(1e6 * r.t0 + d, 1e6 * r.t1 + d)
                  for r, _ in pairs["runner/crop"]]
              for k, d in offsets.items()}
    placed["reader"] = spans.placed("runner/crop", tv)
    for name in NAMES:
        rows = {}
        for k, d in offsets.items():
            rows[k] = _stats([x for r, e in pairs[name] for x in (
                1e6 * r.t0 + d - e["ts"],
                1e6 * r.t1 + d - e["ts"] - e["dur"])])
        out["errors_us"][name] = rows
    out["errors_us"]["runner/crop"]["reader"] = _stats(
        [x for (s, t), (_, e) in zip(placed["reader"], pairs["runner/crop"])
         for x in (s - e["ts"], t - e["ts"] - e["dur"])])
    placed["ranges"] = [(e["ts"], e["ts"] + e["dur"])
                        for _, e in pairs["runner/crop"]]
    for k, ivs in placed.items():
        out["crop_idle_pct"][k] = 100 * sum(
            idle_us(tv.busy, s, t) for s, t in ivs) / 1e6 / tv.window_s
    out["drift_us"] = statistics.median(own[-tenth:]) - \
        statistics.median(own[:tenth])
    out["offsets_minus_own_us"] = {k: d - offsets["own"]
                                   for k, d in offsets.items()}
    out["tracks"] = len(tracks)
    out["window_s"] = tv.window_s
    return out


def main(argv=None) -> int:
    import argparse

    sys.path.insert(0, ROOT)
    from benchmark import run
    from benchmark.harness import spans, trace

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    kept = {}
    events_of, of = trace.events_of, spans.of

    def keep_events(prof):
        events = events_of(prof)
        kept["ranges"] = [e for e in events if e.get("ph") == "X"
                          and e.get("cat") == "user_annotation"]
        return events

    def keep_spans(ctx):
        got = of(ctx)
        kept.setdefault("ctx", ctx)
        kept.setdefault("spans", got)
        return got

    trace.events_of, spans.of = keep_events, keep_spans
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc or kept.get("spans") is None or kept["ctx"].trace is None:
        print(f"[placement] no traced window with program spans (rc {rc})",
              file=sys.stderr)
        return rc or 1
    ctx = kept["ctx"]
    tv = ctx.trace
    ranges = [e for e in kept["ranges"] if tv.t0 <= e["ts"] <= tv.t1]
    res = placement(kept["spans"], ranges, ctx.window.t0, tv)
    res.update(workload=args.workload, seed=args.seed, card=ctx.card)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
