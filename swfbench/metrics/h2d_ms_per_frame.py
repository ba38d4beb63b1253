"""Device time of the host-to-device copies inside the calls, from the
profiler's device timeline, ms per frame returned."""


def read(traced):
    if traced.frames == 0 or not traced.timeline.device:
        return None
    return traced.timeline.device_seconds("h2d") * 1e3 / traced.frames
