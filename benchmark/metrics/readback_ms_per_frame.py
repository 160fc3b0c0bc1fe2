"""Forward stream (`ForwardStream.finish`): the host time of the program's
`stream/readback` spans (the copies to the host and the merge) per real
frame of the traced window, in ms. The bytes each frame copies to the host
and to the card (the spans' d2h_bytes and h2d_bytes) are logged beside."""

from benchmark.harness import spans


def read(ctx):
    sp = spans.of(ctx)
    if sp is None or not sp.frames:
        return None
    ctx.log(f"[readback_ms_per_frame] d2h "
            f"{sp.total('d2h_bytes') / sp.frames:.1f} B/frame, h2d "
            f"{sp.total('h2d_bytes') / sp.frames:.1f} B/frame over "
            f"{sp.frames} frames")
    return 1e3 * sp.seconds("stream/readback") / sp.frames
