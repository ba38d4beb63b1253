"""Renderer host: the wall of the ``render_batch`` spans less the part of
it in which a kernel or copy runs on the card, ms per frame returned."""


def read(traced):
    tl = traced.timeline
    wall = tl.span_seconds("render_batch")
    if wall <= 0 or traced.frames == 0:
        return None
    return (wall - tl.busy_seconds("render_batch")) * 1e3 / traced.frames
