"""Morph shape lowering: paired (start, end) edge tables for on-device lerp.

The reference interpolates path commands on the CPU per ratio
(reference canvas-renderer.ts:207-266).  Here we exploit linearity instead:
a quadratic Bezier evaluated at parameter t is linear in its control points,
and morphing lerps control points — so flattening the start and end curves
at the SAME uniform t-grid yields polylines whose pointwise lerp is exactly
the flattening of the lerped curve.  That lets a whole batch of ratio steps
rasterize on device from one pair of edge tables:

    edges(ratio) = (1 - ratio) * edges_start + ratio * edges_end

Only fills are lowered this way; morph strokes (whose outline geometry is
not linear in the ratio) go through the host path per ratio.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from . import ir
from .geometry import Affine, quad_subdivisions


def _pair_subpaths(
    commands: Sequence[ir.MorphCommand],
    transform: Affine,
    tolerance: float = 0.1,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Replay morph commands into two parallel device-space polyline sets
    (identical topology; curves flattened on a shared t-grid)."""
    start_subs: List[np.ndarray] = []
    end_subs: List[np.ndarray] = []
    cur_s: List[np.ndarray] = []
    cur_e: List[np.ndarray] = []
    pos_s = np.zeros(2)
    pos_e = np.zeros(2)

    def tp(x, y):
        return transform.apply(np.array([x, y], dtype=np.float64))

    def flush():
        nonlocal cur_s, cur_e
        if len(cur_s) >= 2:
            start_subs.append(np.asarray(cur_s))
            end_subs.append(np.asarray(cur_e))
        cur_s, cur_e = [], []

    for cmd in commands:
        if isinstance(cmd, ir.MorphMoveTo):
            flush()
            pos_s = tp(cmd.x[0], cmd.y[0])
            pos_e = tp(cmd.x[1], cmd.y[1])
            cur_s, cur_e = [pos_s], [pos_e]
        elif isinstance(cmd, ir.MorphLineTo):
            if not cur_s:
                cur_s, cur_e = [pos_s], [pos_e]
            pos_s = tp(cmd.end_x[0], cmd.end_y[0])
            pos_e = tp(cmd.end_x[1], cmd.end_y[1])
            cur_s.append(pos_s)
            cur_e.append(pos_e)
        elif isinstance(cmd, ir.MorphCurveTo):
            if not cur_s:
                cur_s, cur_e = [pos_s], [pos_e]
            ctrl_s = tp(cmd.control_x[0], cmd.control_y[0])
            ctrl_e = tp(cmd.control_x[1], cmd.control_y[1])
            end_s = tp(cmd.end_x[0], cmd.end_y[0])
            end_e = tp(cmd.end_x[1], cmd.end_y[1])
            # Shared subdivision count: fine enough for both endpoints (the
            # deviation bound |p0 - 2c + p1| is convex in the lerp, so the
            # max of the two endpoints bounds every ratio).
            n = max(
                quad_subdivisions(pos_s, ctrl_s, end_s, tolerance,
                                  pow2=True),
                quad_subdivisions(pos_e, ctrl_e, end_e, tolerance,
                                  pow2=True),
            )
            t = (np.arange(1, n + 1, dtype=np.float64) / n)[:, None]
            omt = 1.0 - t
            pts_s = omt * omt * pos_s + 2 * omt * t * ctrl_s + t * t * end_s
            pts_e = omt * omt * pos_e + 2 * omt * t * ctrl_e + t * t * end_e
            cur_s.extend(pts_s)
            cur_e.extend(pts_e)
            pos_s, pos_e = pts_s[-1], pts_e[-1]
        else:
            raise ValueError(f"UnexpectedMorphCommand: {cmd!r}")
    flush()
    return start_subs, end_subs


def _subpaths_to_paired_fill_edges(
    start_subs: Sequence[np.ndarray], end_subs: Sequence[np.ndarray]
) -> Tuple[np.ndarray, np.ndarray]:
    rows_s, rows_e = [], []
    for ps, pe in zip(start_subs, end_subs):
        rows_s.append(np.concatenate([ps[:-1], ps[1:]], axis=1))
        rows_e.append(np.concatenate([pe[:-1], pe[1:]], axis=1))
        # Implicit fill closing: close BOTH shapes (topology must match, so
        # close even if one of them happens to be already closed).
        rows_s.append(np.concatenate([ps[-1], ps[0]])[None, :])
        rows_e.append(np.concatenate([pe[-1], pe[0]])[None, :])
    if not rows_s:
        z = np.zeros((0, 4), dtype=np.float32)
        return z, z.copy()
    return (
        np.concatenate(rows_s, axis=0).astype(np.float32),
        np.concatenate(rows_e, axis=0).astype(np.float32),
    )


def morph_fill_edge_pairs(
    morph_shape: ir.MorphShape,
    transform: Affine,
    tolerance: float = 0.1,
):
    """Lower every filled morph path to (start_edges, end_edges, start_color,
    end_color) tuples in device space."""
    out = []
    for path in morph_shape.paths:
        if path.fill is None:
            continue
        subs_s, subs_e = _pair_subpaths(path.commands, transform, tolerance)
        es, ee = _subpaths_to_paired_fill_edges(subs_s, subs_e)
        if es.shape[0] == 0:
            continue
        out.append((es, ee, path.fill.start_color, path.fill.end_color))
    return out
