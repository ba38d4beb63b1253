"""The least work a call's frames need, counted from the content alone,
and the roofline bound it gives on a card of the peaks table.

Bytes: every content number read once (outline points and curve controls
as f32 pairs, paints, per-frame matrices, colour transforms and ratios)
and every output byte written once (F x H x W x 4 u8).

Operations (f32), the counts of the renderer's flat-block and sweep
kernels rewritten against the content:

- per edge and frame: 3, plus 16 for the instance matrix, plus 12 for a
  morph's lerp;
- per edge and pixel row it spans inside the frame: 22 (the row span);
- per pixel a layer covers at all: 2 (prefix and carry) + 2 (nonzero rule)
  + 11 (composite), and for a linear gradient 13 + 24 per stop gap;
- per pixel: 21 (quantize and pack), and 37 more where the stage has an
  opaque background (composite under it and quantize again).

Curves count as their chord, and covered pixels come from the
reference's geometry, so the count is what any renderer of these frames
has to do, never more.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from .gen import Clip

HERE = pathlib.Path(__file__).resolve().parent


def peaks(device_name: str):
    """(bytes/s, f32 operations/s) of the named card, or None."""
    row = json.loads((HERE / "peaks.json").read_text()).get(device_name)
    return None if row is None else (row["bytes_per_s"],
                                     row["f32_ops_per_s"])


def _rows(y0, y1, height: int) -> int:
    lo = np.clip(np.floor(np.minimum(y0, y1)), 0, height)
    hi = np.clip(np.ceil(np.maximum(y0, y1)), 0, height)
    return int((hi - lo).sum())


def clip_work(clip: Clip, covered) -> tuple:
    """(bytes, operations) of all ``clip``'s frames; ``covered[f][l]`` is
    the number of pixels layer ``l`` of frame ``f`` covers.  Each
    character gives its own terms (``work(inst)``: definition bytes,
    anchors, operations it adds to each edge, fill)."""
    h, w = clip.height, clip.width
    nbytes = len(clip.frames) * h * w * 4
    ops = len(clip.frames) * h * w * (21 + (37 if clip.background[3] else 0))
    seen = set()
    for f, row in enumerate(clip.frames):
        for layer, inst in enumerate(row):
            ch = inst.char
            def_bytes, polys, edge_ops, fill = ch.work(inst)
            if id(ch) not in seen:
                seen.add(id(ch))
                nbytes += def_bytes
            nbytes += ((24 if inst.matrix is not None else 0)
                       + (32 if inst.cxform is not None else 0)
                       + (4 if inst.ratio is not None else 0))
            per_edge = 3 + (16 if inst.matrix is not None else 0) + edge_ops
            m = inst.matrix or (65536, 65536, 0, 0, 0, 0)
            for p in polys:
                p = np.asarray(p, np.float64)
                q = np.roll(p, -1, axis=0)
                y0 = (m[2] / 65536 * p[:, 0] + m[1] / 65536 * p[:, 1]
                      + m[5]) / 20
                y1 = (m[2] / 65536 * q[:, 0] + m[1] / 65536 * q[:, 1]
                      + m[5]) / 20
                ops += per_edge * len(p) + 22 * _rows(y0, y1, h)
            ops += covered[f][layer] * (15 + fill.ops())
    return nbytes, ops


def bound_seconds(nbytes: float, ops: float, peak) -> float:
    return max(nbytes / peak[0], ops / peak[1])
