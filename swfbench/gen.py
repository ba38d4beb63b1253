"""The one content generator: a configuration and a traffic mix, as read
from their JSON files, and a seed -> the content of each call.

Content is plain numbers (no type of the program under test): integer
twips, 16.16 matrix terms, 8.8 colour-transform multipliers, u16 morph
ratios and u8 colours, exactly as the SWF wire carries them, so the
writer (``swfwrite``), the entries' stage builder and the reference all
start from the same values.

A call is a ``Clip``: its frames, each the list of ``Instance`` s shown,
bottom to top.  ``Clip.chars`` lists the definitions in the order a movie
defines them.  Everything else is found by name, so a new kind of content
is added as files:

- the mix's ``content`` names its form, ``forms/<content>.py``, whose
  ``make(cfg, mix, rng, frames)`` draws a clip;
- a character (``chars/``) is an object that writes its own definition
  tag, builds its own port definition and instance, and gives the
  reference its outlines and the work count its terms;
- a fill (``fills/``) writes its own style, builds its own port fill, and
  paints itself for the reference.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import List, Optional, Tuple

import numpy as np

TWIPS = 20
FIXED_ONE = 65536


@dataclasses.dataclass
class Instance:
    """One character shown at ``depth``: SWF matrix (sx, sy, r0, r1 in
    1/65536, tx, ty in twips) or None, alpha-multiplier colour transform
    ((mult r, g, b, a in 1/256), (add r, g, b, a in 1/255)) or None, morph
    ratio in 1/65536 or None."""

    depth: int
    char: object
    matrix: Optional[Tuple[int, int, int, int, int, int]] = None
    cxform: Optional[tuple] = None
    ratio: Optional[int] = None


@dataclasses.dataclass
class Clip:
    width: int
    height: int
    background: Tuple[int, int, int, int]
    frame_rate: float
    chars: list
    frames: List[List[Instance]]


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def fixed(v: float) -> int:
    return int(round(v * FIXED_ONE))


def rotation(th: float, s: float, tx: float, ty: float):
    c, n = math.cos(th) * s, math.sin(th) * s
    return (fixed(c), fixed(c), fixed(n), fixed(-n),
            int(round(tx)), int(round(ty)))


def outline(rng, n: int, radius: int, star: bool, curved: float):
    """A closed n-gon (or star) about the origin, a share ``curved`` of
    its edges quadratic with the control pushed out by 12%."""
    pts = np.zeros((n, 2), np.int64)
    for i in range(n):
        th = 2 * math.pi * i / n
        r = radius * (0.55 if star and i % 2 else 1.0)
        pts[i] = (int(round(r * math.cos(th))), int(round(r * math.sin(th))))
    bent = rng.random(n) < curved
    ctrl = np.zeros((n, 2), np.int64)
    for i in range(n):
        x0, y0 = pts[i]
        x1, y1 = pts[(i + 1) % n]
        mx, my = (x0 + x1) // 2, (y0 + y1) // 2
        ctrl[i] = (mx + int(round(mx * 0.12)), my + int(round(my * 0.12)))
    return pts, ctrl, bent


def rgba(rng, lo: int, alo: int) -> Tuple[int, int, int, int]:
    c = rng.integers(lo, 256, 3)
    return (int(c[0]), int(c[1]), int(c[2]), int(rng.integers(alo, 256)))


def tracks(rng, n: int, tw: int, th: int, p: dict):
    """Per-depth start, velocity, spin and scale of a moving placement."""
    starts = rng.uniform(0.2, 0.8, (n, 2)) * (tw, th)
    vel = rng.uniform(-1, 1, (n, 2)) * p["velocity"] * (tw, th)
    spin = rng.uniform(-1, 1, n) * p["spin"]
    scale = rng.uniform(*p["scale"], n)

    def mat(i, f):
        x, y = starts[i] + vel[i] * f
        return rotation(float(spin[i] * f), float(scale[i]), x, y)

    return mat


def form(name: str):
    """The module ``forms/<name>.py``."""
    return importlib.import_module(f"swfbench.forms.{name}")


def make_clip(cfg: dict, mix: dict, seed: int, index: int,
              frames: Optional[int] = None) -> Clip:
    """The content of call ``index`` of a run seeded ``seed`` (a negative
    index gives the warm-up content, apart from every call's)."""
    rng = rng_for(seed, 0 if index >= 0 else 1, abs(index))
    return form(mix["content"]).make(cfg, mix, rng,
                                     frames or cfg["frames_per_call"])
