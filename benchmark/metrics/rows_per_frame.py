"""Runner (pipeline/runner.py): rows the trunk ran, counted by a forward
pre-hook on the trunk, over the real frames of the traced window's
tracks. Padding to bucket sizes makes it exceed 1."""


def read(ctx):
    frames = sum(ctx.window.frames)
    if not ctx.hooks.rows or not frames:
        return None
    return sum(ctx.hooks.rows) / frames
