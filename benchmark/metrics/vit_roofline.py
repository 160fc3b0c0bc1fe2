"""ViT trunk (gaitlab_torch nn/vit.py in nn/hmr2.py's HMR2Core): the least
time of the forwards' ViT work (counts/hmr2.py: direct-form FLOPs of the
patch embedding, the blocks' products and attention; the crops' columns
read once, the tokens written once, the ViT's weights once per forward)
over the device time that the stage ranges patch-embed and vit-blocks
hold."""

from benchmark.counts import peaks

STAGES = ("patch-embed", "vit-blocks")


def read(ctx):
    fw = ctx.forwards() if ctx.trace is not None else None
    t = ctx.stage_s(*STAGES) if fw else 0.0
    if not t:
        return None
    bound = sum(peaks.bound_s(*ctx.counts.vit(rows), ctx.precision)
                for rows, _ in fw)
    ctx.log(f"[vit_roofline] bound {bound:.6f} s, device {t:.6f} s")
    return 100 * bound / t
