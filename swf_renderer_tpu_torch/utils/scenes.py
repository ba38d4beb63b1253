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


def anim_scene(h: int, w: int, frames: int, seed: int = 9):
    """The animation benchmark scene: 3 layers x 12 random blobs
    (local-space edge tables, 10 edges each) + a full-turn rotation track
    about the frame center -> (tables, colors, (F, 6) f32 matrices)."""
    rng = np.random.default_rng(seed)
    tables, colors = [], []
    for _ in range(3):
        segs = []
        for _ in range(12):
            cx = rng.uniform(100, w - 100)
            cy = rng.uniform(60, h - 60)
            ang = np.sort(rng.uniform(0, 2 * np.pi, 10))
            r = rng.uniform(15, 60, 10)
            pts = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)],
                           1).astype(np.float32)
            closed = np.concatenate([pts, pts[:1]])
            segs.append(np.concatenate([closed[:-1], closed[1:]], axis=1))
        tables.append(np.concatenate(segs))
        colors.append(rng.uniform(0.2, 1.0, 4))

    mats = []
    for i in range(frames):
        th = 2 * np.pi * i / frames
        a, b = np.cos(th), np.sin(th)
        cx, cy = w / 2.0, h / 2.0
        mats.append((a, b, -b, a, cx - a * cx + b * cy,
                     cy - b * cx - a * cy))
    return tables, colors, np.asarray(mats, np.float32)


def random_blobs(rng, layers, height, width, blobs=4):
    """[layers] local-space edge tables of ``blobs`` random star-convex
    nonagons each; some overhang the frame on every side."""
    tables = []
    for _ in range(layers):
        segs = []
        for _ in range(blobs):
            cx = rng.uniform(-10, width + 10)
            cy = rng.uniform(-10, height + 10)
            ang = np.sort(rng.uniform(0, 2 * np.pi, 9))
            r = rng.uniform(6, 0.3 * min(height, width), 9)
            pts = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)],
                           1).astype(np.float32)
            closed = np.concatenate([pts, pts[:1]])
            segs.append(np.concatenate([closed[:-1], closed[1:]], axis=1))
        tables.append(np.concatenate(segs))
    return tables


def random_tracks(rng, frames, layers, height, width):
    """Per-layer rotate + scale + shear + translate tracks about the frame
    centre -> (F, L, 6) f32 device affines."""
    th = rng.uniform(0, 2 * np.pi, (frames, layers))
    sc = rng.uniform(0.6, 1.5, (frames, layers))
    a, b = sc * np.cos(th), sc * np.sin(th)
    c = -b + rng.uniform(-0.2, 0.2, (frames, layers))
    cx, cy = width / 2.0, height / 2.0
    e = cx - a * cx - c * cy + rng.uniform(-8, 8, (frames, layers))
    f = cy - b * cx - a * cy + rng.uniform(-8, 8, (frames, layers))
    return np.stack([a, b, c, a, e, f], -1).astype(np.float32)


def polygon_edges(points) -> np.ndarray:
    """A closed polygon's (N, 4) f32 edge table."""
    pts = np.asarray(points, np.float32)
    return np.concatenate([pts, np.roll(pts, -1, axis=0)], axis=1)


def closed_edge_planes(rng, planes, n, e_pad, height, width):
    """(planes, 4, e_pad) f32 edge tables of closed paths for the coverage
    kernels: an axis-aligned rectangle (horizontal and vertical edges), a
    sliver with an edge of |dy| under 1e-9, a triangle whose long edges
    cross the whole frame unsplit, then random star-convex octagons (some
    partly off the frame) up to about ``n`` edges; the rest all-zero
    padding."""
    t = np.zeros((planes, 4, e_pad), np.float32)
    r = max(4.0, min(height, width) / 4)
    for p in range(planes):
        x, y = rng.uniform(0, width - 8), rng.uniform(0, height - 6)
        paths = [
            polygon_edges([(x, y), (x + 7.5, y), (x + 7.5, y + 5.25),
                           (x, y + 5.25)]),
            polygon_edges([(x + 1, y + 2), (x + 21, y + 2 + 2e-10),
                           (x + 9, y + 4.5)]),
            polygon_edges([(width * 0.3, -25.0), (width * 0.7, height + 25.0),
                           (width * 0.1, height * 0.5)]),
        ]
        while sum(len(q) for q in paths) + 8 <= n:
            c = rng.uniform([-r, -r], [width + r, height + r])
            ang = np.sort(rng.uniform(0, 2 * np.pi, 8))
            rad = rng.uniform(0.3, 1.0, 8) * r
            paths.append(polygon_edges(np.stack(
                [c[0] + rad * np.cos(ang), c[1] + rad * np.sin(ang)], 1)))
        e = np.concatenate(paths)[:e_pad]
        t[p, :, :len(e)] = e.T
    return t
