"""Faults planted in what the timed path returns, for the tests and the
readings that show the check catches them.  Each maps a call's
(F, H, W, 4) u8 frames to what a broken renderer would have returned."""

from __future__ import annotations

import numpy as np


def unchanged(frames):
    """The state never advances: every frame is the first one."""
    return np.repeat(frames[:1], len(frames), axis=0)


def half_dropped(frames):
    """Half of the batch left out: the second half comes back empty."""
    out = frames.copy()
    out[len(out) // 2:] = 0
    return out


def one_altered(frames):
    """One answer altered where it is produced: the middle frame is its
    predecessor's (or, in a one-frame call, shifted by one column)."""
    out = frames.copy()
    k = len(out) // 2
    out[k] = out[k - 1] if k else np.roll(out[k], 1, axis=1)
    return out


FAULTS = {"unchanged": unchanged, "half_dropped": half_dropped,
          "one_altered": one_altered}
