"""Synthetic benchmark scenes (the reference benchmark's generator)."""

from __future__ import annotations

import numpy as np


def build_scene_edges(frames, layers, height, width, shapes_per_layer=16,
                      seed=7):
    """Random multi-shape layered scenes: per (frame, layer) an edge table
    of ``shapes_per_layer`` random star-convex octagons, plus (F, L, 4)
    straight RGBA colors."""
    rng = np.random.default_rng(seed)
    tables = []
    colors = np.zeros((frames, layers, 4), np.float32)
    radius = max(8.0, min(height, width) / 10.0)
    for i in range(frames):
        per_frame = []
        for j in range(layers):
            segs = []
            for _ in range(shapes_per_layer):
                cx = rng.uniform(0, width)
                cy = rng.uniform(0, height)
                ang = np.sort(rng.uniform(0, 2 * np.pi, 8))
                r = rng.uniform(0.4, 1.0, 8) * radius
                pts = np.stack(
                    [cx + r * np.cos(ang), cy + r * np.sin(ang)], 1
                ).astype(np.float32)
                closed = np.concatenate([pts, pts[:1]])
                segs.append(np.concatenate([closed[:-1], closed[1:]], axis=1))
            per_frame.append(np.concatenate(segs))
            colors[i, j] = rng.uniform(0.1, 1.0, size=4)
        tables.append(per_frame)
    return tables, colors
