"""Frame-by-frame animation: ``shapes`` depths, each depth's character
replaced every frame by a new solid-filled shape (polygons and stars,
some edges quadratic), moved along its track."""

from __future__ import annotations

from ..chars.shape import Shape
from ..fills.solid import Solid
from ..gen import TWIPS, Clip, Instance, outline, rgba, tracks


def _solid_shape(rng, cid: int, base: int, p: dict) -> Shape:
    radius = int(base * rng.uniform(*p["radius_share"]))
    lo, hi = p["edges"]
    n = int(rng.integers(lo // 2, hi // 2 + 1)) * 2
    pts, ctrl, bent = outline(rng, n, radius, bool(rng.integers(0, 2)),
                              p["curved"])
    return Shape(cid, [pts], [ctrl], [bent],
                 Solid(rgba(rng, 30, p["alpha_min"])))


def make(cfg: dict, p: dict, rng, frames: int) -> Clip:
    tw, th = cfg["width"] * TWIPS, cfg["height"] * TWIPS
    base = min(tw, th)
    depths = p["shapes"]
    mat = tracks(rng, depths, tw, th, p)
    background = rgba(rng, 160, 255)
    chars, timeline = [], []
    for f in range(frames):
        row = []
        for i in range(depths):
            s = _solid_shape(rng, len(chars) + 1, base, p)
            chars.append(s)
            row.append(Instance(i + 1, s, mat(i, f)))
        timeline.append(row)
    return Clip(cfg["width"], cfg["height"], background, cfg["frame_rate"],
                chars, timeline)
