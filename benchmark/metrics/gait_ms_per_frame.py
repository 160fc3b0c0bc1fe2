"""Gait branch (nn/gait.py via GRNetCore.pfeat_corrector): device time of
the corrector's stage range per real frame of the traced window, in
ms."""


def read(ctx):
    frames = sum(ctx.window.frames)
    t = ctx.stage_s("corrector") if ctx.trace is not None else 0.0
    if not t or not frames:
        return None
    return 1e3 * t / frames
