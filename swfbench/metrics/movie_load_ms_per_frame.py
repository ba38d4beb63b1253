"""Movie front end: the benchmark span around ``load_movie_timeline``
(parse and stage build), ms per frame returned."""


def read(traced):
    s = traced.timeline.span_seconds("load_movie_timeline")
    if s <= 0 or traced.frames == 0:
        return None
    return s * 1e3 / traced.frames
