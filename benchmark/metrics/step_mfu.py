"""Model step (the architecture's trunk + body/smpl.py): nominal FLOPs of
the real frames the traced window completed (the architecture's counts,
counts/flops.py for GRNet; padded rows do not count), over the seconds
in which the card ran an operation in that window (the trace's busy
time, not the host's clock, which the profiler slows) and the card's
peak for the configuration's precision (counts/peaks.py: TF32's 495
TFLOP/s for float32): the step's share of the peak while the card
works. The share against the FP32 units' 67 TFLOP/s is logged on an
earlier line, for continuity with the earlier stage tables."""

from benchmark.counts import peaks


def read(ctx):
    if ctx.trace is None or not ctx.trace.busy_s:
        return None
    flops = sum(ctx.counts.forward_flops(m) for _, m in ctx.forwards())
    secs = ctx.trace.busy_s
    rate = flops / secs
    ctx.log(f"[step_mfu] {flops:.6e} FLOP in {secs:.6f} busy s: "
            f"{100 * rate / peaks.FP32_FLOP_PER_S:.4f}% of 67 TFLOP/s (FP32), "
            f"{100 * rate / peaks.flop_peak(ctx.precision):.4f}% of "
            f"{peaks.flop_peak(ctx.precision) / 1e12:.0f} TFLOP/s")
    return 100 * rate / peaks.flop_peak(ctx.precision)
