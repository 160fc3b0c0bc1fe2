"""Head (nn/pare_head.py + kernel B1, csrc/keypoint_attention.cu): the
least time of each call's pooling (counts/flops.py b1_work at the
forward's rows) over the profiler's time of B1's kernels, by name."""

from benchmark.counts import peaks

KERNELS = ("attention_split_kernel", "attention_merge_kernel")


def read(ctx):
    fw = ctx.forwards() if ctx.trace is not None else None
    t = ctx.kernel_s(*KERNELS) if fw else 0.0
    if not t:
        return None
    bound = sum(peaks.bound_s(*ctx.counts.b1(rows), ctx.precision)
                for rows, _ in fw)
    ctx.log(f"[b1_roofline] bound {bound:.6f} s, kernels {t:.6f} s")
    return 100 * bound / t
