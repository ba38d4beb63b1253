"""Shape tweens: ``shapes`` DefineMorphShape2 (straight-edged start and
end outlines, solid colours that morph) at one depth each, their ratios
ramping 0 -> 65535 over the clip while the matrices move."""

from __future__ import annotations

import numpy as np

from ..chars.morph import Morph
from ..gen import TWIPS, Clip, Instance, rgba, tracks


def make(cfg: dict, p: dict, rng, frames: int) -> Clip:
    tw, th = cfg["width"] * TWIPS, cfg["height"] * TWIPS
    base = min(tw, th)
    lo, hi = p["edges"]
    morphs = []
    for i in range(p["shapes"]):
        n = int(rng.integers(lo // 2, hi // 2 + 1)) * 2
        r0 = base * rng.uniform(*p["radius_share"])
        r1 = base * rng.uniform(*p["radius_share"])
        turn, squash = rng.uniform(0, 1), rng.uniform(0.5, 1.0)
        k = np.arange(n)
        a0, a1 = 2 * np.pi * k / n, 2 * np.pi * (k + turn) / n
        pts0 = np.stack([np.round(r0 * np.cos(a0)),
                         np.round(r0 * np.sin(a0))], 1).astype(np.int64)
        pts1 = np.stack([np.round(r1 * np.cos(a1)),
                         np.round(r1 * squash * np.sin(a1))],
                        1).astype(np.int64)
        morphs.append(Morph(i + 1, pts0, pts1, rgba(rng, 30, p["alpha_min"]),
                            rgba(rng, 30, p["alpha_min"])))
    mat = tracks(rng, len(morphs), tw, th, p)
    background = rgba(rng, 160, 255)

    def ratio(f):   # u16 / 65536, exact on the wire
        return int(round(65535 * f / max(frames - 1, 1)))

    timeline = [[Instance(i + 1, m, mat(i, f), None, ratio(f))
                 for i, m in enumerate(morphs)] for f in range(frames)]
    return Clip(cfg["width"], cfg["height"], background, cfg["frame_rate"],
                morphs, timeline)
