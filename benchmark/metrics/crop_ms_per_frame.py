"""Runner crop (pipeline/runner.py `_crop_stream`): the host time of the
program's `runner/crop` spans (the host warp or the device crop, the
upload and the normalisation of each chunk) per real frame of the traced
window, in ms."""

from benchmark.harness import spans


def read(ctx):
    sp = spans.of(ctx)
    if sp is None or not sp.frames:
        return None
    return 1e3 * sp.seconds("runner/crop") / sp.frames
