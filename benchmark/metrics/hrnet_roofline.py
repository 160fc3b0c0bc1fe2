"""Backbone (nn/hrnet.py), stem to upsampling head: the least time of the
forwards' backbone work (counts/flops.py: direct-form FLOPs; images read
once, features written once, weights once per forward) over the device
time that the stage ranges stem, layer1, transition, stages2-4 and
hr-head hold."""

from benchmark.counts import peaks

STAGES = ("stem", "layer1", "transition", "stages2-4", "hr-head")


def read(ctx):
    fw = ctx.forwards() if ctx.trace is not None else None
    t = ctx.stage_s(*STAGES) if fw else 0.0
    if not t:
        return None
    bound = sum(peaks.bound_s(*ctx.counts.hrnet(rows), ctx.precision)
                for rows, _ in fw)
    ctx.log(f"[hrnet_roofline] bound {bound:.6f} s, device {t:.6f} s")
    return 100 * bound / t
