"""Decoder head (gaitlab_torch nn/hmr2.py DecoderHead: six layers on one
token a row, cross-attending to the ViT's tokens, then the regressors):
device time of the decoder's stage range per real frame of the traced
window, in ms."""


def read(ctx):
    frames = sum(ctx.window.frames)
    t = ctx.stage_s("decoder") if ctx.trace is not None else 0.0
    if not t or not frames:
        return None
    return 1e3 * t / frames
