"""Share of the time inside the calls in which no kernel and no copy runs
on the card, %."""


def read(traced):
    tl = traced.timeline
    total = tl.call_seconds()
    if total <= 0 or not tl.device:
        return None
    return 100.0 * (1.0 - tl.busy_seconds() / total)
