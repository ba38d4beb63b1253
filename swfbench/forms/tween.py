"""Motion tweens: ``shapes`` DefineShape3 (polygons and stars, some edges
quadratic; the last ``gradients`` with linear gradients) at one depth
each, moved every frame (rotation, scale, translation); with
``fade_top`` the top one fades through its colour transform."""

from __future__ import annotations

import math

from ..chars.shape import Shape
from ..fills.linear import Linear
from ..fills.solid import Solid
from ..gen import TWIPS, Clip, Instance, outline, rgba, rotation, tracks


def make(cfg: dict, p: dict, rng, frames: int) -> Clip:
    tw, th = cfg["width"] * TWIPS, cfg["height"] * TWIPS
    base = min(tw, th)
    n_shapes = p["shapes"]
    lo, hi = p["edges"]
    shapes = []
    for i in range(n_shapes):
        radius = int(base * rng.uniform(*p["radius_share"]))
        n = int(rng.integers(lo // 2, hi // 2 + 1)) * 2
        pts, ctrl, bent = outline(rng, n, radius, i % 2 == 1, p["curved"])
        if i < n_shapes - p["gradients"]:
            fill = Solid(rgba(rng, 30, p["alpha_min"]))
        else:
            s = radius * 2 / 32768
            fill = Linear(rotation(float(rng.uniform(0, math.pi)), s, 0, 0),
                          tuple((r, rgba(rng, 0, 255)) for r in (0, 128, 255)))
        shapes.append(Shape(i + 1, [pts], [ctrl], [bent], fill))
    mat = tracks(rng, n_shapes, tw, th, p)
    background = rgba(rng, 160, 255)

    def fade(f):   # alpha multiplier k / 256, exact on the wire
        k = 256 - int(round(200 * f / max(frames - 1, 1)))
        return ((256, 256, 256, k), (0, 0, 0, 0))

    top = n_shapes - 1 if p["fade_top"] else -1
    timeline = [[Instance(i + 1, s, mat(i, f),
                          fade(f) if i == top else None)
                 for i, s in enumerate(shapes)] for f in range(frames)]
    return Clip(cfg["width"], cfg["height"], background, cfg["frame_rate"],
                shapes, timeline)
