"""The comparison that decides ``correct``: the u8 frames a timed call
returned against the plain reference's frames of the same content.

Both sides are taken to premultiplied alpha (``c * a / 255`` per colour
channel, alpha as it is), so a pixel's straight colour counts by how much
of it shows.  A pixel's gap is its largest channel difference in u8
levels.  The numbers, each the worst over the frames checked:

- ``over_share``: the share of a frame's pixels whose gap is over
  ``OVER_LEVELS`` (geometry that lands in the wrong place, a wrong paint,
  a frame missing or repeated);
- ``mean_gap``: a frame's mean gap (a colour or alpha that is off
  everywhere by a little);
- ``max_gap``: the largest gap of any pixel (one that is off by much);
- ``over<k>_share``, where the cell's limits name it: the share of a
  frame's pixels whose gap is over ``k`` levels (a paint, composite or
  quantize a little off on many pixels).

A cell's limits are in ``checks/<cell>.json``, set from the readings
recorded in PERF.md.  Every cell compares ``over_share`` and
``mean_gap``; a number the file gives no limit is reported beside them
and not compared (``max_gap`` where curves are drawn: antialiased pixels
on curves differ by the renderer's flattening tolerance, so it swings
from seed to seed).
"""

from __future__ import annotations

import json
import pathlib
import re

import torch

OVER_LEVELS = 8.0
COMPARED = ("over_share", "mean_gap")
NUMBERS = COMPARED + ("max_gap",)
HERE = pathlib.Path(__file__).resolve().parent


def limits(cell: str) -> dict:
    return json.loads((HERE / "checks" / f"{cell}.json").read_text())


def levels(lim: dict) -> tuple:
    """The ``k`` of every ``over<k>_share`` that ``lim`` names."""
    return tuple(sorted(int(m.group(1)) for m in (
        re.fullmatch(r"over(\d+)_share", k) for k in lim) if m))


def _premul(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    a = x[..., 3:]
    return torch.cat([x[..., :3] * a / 255.0, a], -1)


class Tally:
    """Worst readings over every frame compared."""

    def __init__(self, levels=()):
        """``levels``: the ``k`` of each ``over<k>_share`` to read."""
        self.levels = tuple(levels)
        self.values = {k: 0.0 for k in NUMBERS}
        self.values.update({f"over{k}_share": 0.0 for k in self.levels})
        self.frames = 0
        self.faults = []

    def add(self, got, want: torch.Tensor) -> None:
        """``got``: the program's (H, W, 4) u8 frame (array or tensor);
        ``want``: the reference's, a tensor on the device to compare on."""
        got = torch.as_tensor(got)
        if got.dtype != torch.uint8 or tuple(got.shape) != tuple(want.shape):
            self.faults.append(f"frame {self.frames}: {got.dtype} "
                               f"{tuple(got.shape)} for {tuple(want.shape)}")
            self.values = {k: float("inf") for k in self.values}
            self.frames += 1
            return
        gap = (_premul(got.to(want.device)) - _premul(want)).abs().amax(-1)
        self._worst("max_gap", gap.max())
        self._worst("over_share", (gap > OVER_LEVELS).float().mean())
        self._worst("mean_gap", gap.mean())
        for k in self.levels:
            self._worst(f"over{k}_share", (gap > k).float().mean())
        self.frames += 1

    def _worst(self, key: str, value) -> None:
        self.values[key] = max(self.values[key], float(value))

    def verdict(self, lim: dict):
        """(correct, {name: {"value", "limit"}}) -- each number against
        its limit, None where it is only reported."""
        ok = self.frames > 0 and not self.faults
        shown = {}
        for k in self.values:
            if k in lim:
                ok = ok and self.values[k] <= lim[k]
            shown[k] = {"value": self.values[k], "limit": lim.get(k)}
        ok = ok and set(lim) <= set(self.values)
        shown["frames"] = {"value": self.frames, "limit": None}
        return ok, shown
