"""Model step: the kernels the card ran in the traced window (its device
trace's `kernel` events, those of the crops' normalisation included) per
forward of the program (its `stream/forward` spans)."""

from benchmark.harness import spans


def read(ctx):
    tv = ctx.trace
    sp = spans.of(ctx) if tv is not None else None
    if sp is None or not sp.forwards:
        return None
    n = sum(1 for e in tv.device if e.get("cat") == "kernel")
    if not n:
        return None
    ctx.log(f"[kernels_per_forward] {n} kernels, {len(sp.forwards)} forwards")
    return n / len(sp.forwards)
