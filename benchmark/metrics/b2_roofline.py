"""SMPL (body/smpl.py + kernel B2, csrc/blendshapes.cu): the least time of
each call's blendshape sum (counts/smpl.py b2_work at the forward's
rows) over the profiler's time of B2's kernel, by name."""

from benchmark.counts import peaks

KERNELS = ("blendshapes_kernel",)


def read(ctx):
    fw = ctx.forwards() if ctx.trace is not None else None
    t = ctx.kernel_s(*KERNELS) if fw else 0.0
    if not t:
        return None
    bound = sum(peaks.bound_s(*ctx.counts.b2(rows), ctx.precision)
                for rows, _ in fw)
    ctx.log(f"[b2_roofline] bound {bound:.6f} s, kernels {t:.6f} s")
    return 100 * bound / t
