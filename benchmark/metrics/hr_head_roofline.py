"""Backbone's upsampling head (nn/hrnet.py `upsample_stage_*`, with the
concatenation): the least time of its work (its convolutions' direct-form
FLOPs; the four branches read once, the features written once, its
weights once per forward; the bilinear resizes count no FLOPs) over the
device time of the hr-head stage range."""

from benchmark.counts import peaks


def read(ctx):
    fw = ctx.forwards() if ctx.trace is not None else None
    t = ctx.stage_s("hr-head") if fw else 0.0
    if not t:
        return None
    bound = sum(peaks.bound_s(*ctx.counts.hr_head(rows), ctx.precision)
                for rows, _ in fw)
    ctx.log(f"[hr_head_roofline] bound {bound:.6f} s, device {t:.6f} s")
    return 100 * bound / t
