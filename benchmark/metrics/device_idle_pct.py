"""Device: the share of the traced window in which no kernel, copy or
memset runs on the card (the union of the trace's device events)."""


def read(ctx):
    tv = ctx.trace
    if tv is None or not tv.busy_s:
        return None
    return 100 * (1 - tv.busy_s / tv.window_s)
