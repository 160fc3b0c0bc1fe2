"""Runner crop: the card's idle time inside the program's `runner/crop`
spans, as a share of the traced window. The spans are put on the trace's
time axis by their track's `host/track` span (spans.ProgramSpans.placed)."""

from benchmark.harness import spans


def read(ctx):
    tv = ctx.trace
    sp = spans.of(ctx) if tv is not None and tv.busy_s else None
    if sp is None:
        return None
    idle = sum(spans.idle_us(tv.busy, s, e)
               for s, e in sp.placed("runner/crop", tv))
    return 100 * idle / 1e6 / tv.window_s
