"""Forward stream (pipeline/runner.py `ForwardStream`): the time the caller
blocks on the session's worker (the program's `stream/wait` spans: a full
queue's put, the join in finish and close) per real frame of the traced
window, in ms."""

from benchmark.harness import spans


def read(ctx):
    sp = spans.of(ctx)
    if sp is None or not sp.frames:
        return None
    return 1e3 * sp.seconds("stream/wait") / sp.frames
