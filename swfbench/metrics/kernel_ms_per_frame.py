"""Device time of the kernels the run launches inside the calls, from the
profiler's device timeline, ms per frame returned."""


def read(traced):
    if traced.frames == 0 or not traced.timeline.device:
        return None
    return traced.timeline.device_seconds("kernel") * 1e3 / traced.frames
