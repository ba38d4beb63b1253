"""Scanline cell-accumulation rasterization: O(perimeter + pixels).

Port of ``swf_renderer_tpu/ops/scanline.py``.  Every edge is split (on
the host) at integer x and y crossings so each sub-segment lies in one
pixel cell; a sub-segment in cell (r, c) contributes its trapezoid
``area`` to its own pixel and ``cover`` = dy to every pixel right of it.
On the device ``area`` scatters into an (H, W) plane and ``cover`` into
column c + 1 of an (H, W + 1) plane, and

    winding_integral = area_plane + cumsum_x(cover_plane)[:, :W],

the analytic winding integral per pixel; the fill rule maps it to
coverage.  The point-sampled variant (Flash's quality-high 4x4
antialiasing) scatters crossing signs on the 4x subsample grid instead.

The reference computes the device half with XLA scatters and ``cumsum``
(no Pallas kernel), so PyTorch operations serve here too.  The scatters
accumulate through ``index_put_(accumulate=True)``: on the CPU it adds
the updates in their order; on CUDA it sorts them (stably) and adds each
target's updates in that same order, so two calls give the same bytes,
unlike ``index_add_``'s float atomics.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .coverage import FILL_RULE_NONZERO, apply_fill_rule


# ---------------------------------------------------------------------------
# Host: edge -> cell list
# ---------------------------------------------------------------------------


def _no_cells():
    z = np.zeros(0)
    return z.astype(np.int32), z.astype(np.int32), z.astype(np.float64), z


def edges_to_cells(
    edges: np.ndarray, height: int, width: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Split edges into pixel-cell crossings -> (rows, cols, area, cover)
    int32/int32/f64/f64, one entry per cell crossing.  x is clamped into
    [0, W] after splitting (left-of-viewport geometry still contributes
    cover), y spans are clipped to [0, H]."""
    edges = np.asarray(edges, dtype=np.float64)
    if edges.shape[0] == 0:
        return _no_cells()
    if not np.isfinite(edges).all():
        raise ValueError("non-finite edge coordinates")

    x0, y0, x1, y1 = edges[:, 0], edges[:, 1], edges[:, 2], edges[:, 3]
    keep = y0 != y1   # horizontal edges contribute nothing
    x0, y0, x1, y1 = x0[keep], y0[keep], x1[keep], y1[keep]
    if x0.size == 0:
        return _no_cells()

    # Clip y spans to the viewport (x at the clip by interpolation).
    t_lo = np.clip((0.0 - y0) / (y1 - y0), 0.0, 1.0)
    t_hi = np.clip((height - y0) / (y1 - y0), 0.0, 1.0)
    ta = np.minimum(t_lo, t_hi)
    tb = np.maximum(t_lo, t_hi)
    nx0 = x0 + (x1 - x0) * ta
    ny0 = y0 + (y1 - y0) * ta
    nx1 = x0 + (x1 - x0) * tb
    ny1 = y0 + (y1 - y0) * tb
    keep = ny0 != ny1
    x0, y0, x1, y1 = nx0[keep], ny0[keep], nx1[keep], ny1[keep]
    if x0.size == 0:
        return _no_cells()

    rows_out, cols_out, area_out, cover_out = [], [], [], []
    for ex0, ey0, ex1, ey1 in zip(x0, y0, x1, y1):
        # Split at every integer y crossing and at integer x crossings
        # inside [0, W] (clamping before splitting would bend the line).
        ts = [0.0, 1.0]
        dy = ey1 - ey0
        dx = ex1 - ex0
        ylo, yhi = sorted((ey0, ey1))
        for yc in range(int(np.floor(ylo)) + 1, int(np.ceil(yhi))):
            ts.append((yc - ey0) / dy)
        if dx != 0.0:
            xlo, xhi = sorted((ex0, ex1))
            xc_start = max(0, int(np.floor(xlo)) + 1)
            xc_stop = min(width, int(np.ceil(xhi)) - 1)
            for xc in range(xc_start, xc_stop + 1):
                if xlo < xc < xhi:
                    ts.append((xc - ex0) / dx)
        ts = np.unique(np.clip(np.asarray(ts), 0.0, 1.0))
        sx = ex0 + dx * ts
        sy = ey0 + dy * ts
        for i in range(len(ts) - 1):
            ax, ay, bx, by = sx[i], sy[i], sx[i + 1], sy[i + 1]
            sub_dy = by - ay
            if sub_dy == 0.0:
                continue
            # A sub-piece lies in one cell column or wholly outside
            # [0, W]; its clamped midpoint maps left-of-viewport pieces to
            # full coverage of column 0, right-of-viewport ones to zero
            # area in column W - 1.
            mx = min(max(0.5 * (ax + bx), 0.0), float(width))
            my = 0.5 * (ay + by)
            r = min(max(int(np.floor(my)), 0), height - 1)
            c = min(max(int(np.floor(mx)), 0), width - 1)
            rows_out.append(r)
            cols_out.append(c)
            area_out.append(sub_dy * (c + 1.0 - mx))
            cover_out.append(sub_dy)

    return (np.asarray(rows_out, dtype=np.int32),
            np.asarray(cols_out, dtype=np.int32),
            np.asarray(area_out, dtype=np.float64),
            np.asarray(cover_out, dtype=np.float64))


def edges_to_point_cells(edges: np.ndarray, height: int, width: int,
                         ss: int = 4):
    """Cell deltas for POINT-SAMPLED winding on an ss x ss subsample grid
    (the Flash player's quality "high"): for each edge and subsample row
    (line y = R + 0.5 on the ss-scaled grid, half-open [ymin, ymax)), the
    crossing column is ``floor(x + 0.5)``.  Returns (rows, cols, delta)
    for an (ss*H, ss*W + 1) delta plane whose x-cumsum is the integer
    winding at every subsample."""
    edges = np.asarray(edges, dtype=np.float64) * ss
    out_r, out_c, out_d = [], [], []
    sh, sw = height * ss, width * ss
    for x0, y0, x1, y1 in edges:
        if y0 == y1:
            continue
        sign = 1.0 if y1 > y0 else -1.0
        ylo, yhi = min(y0, y1), max(y0, y1)
        r_start = max(0, int(np.ceil(ylo - 0.5)))
        r_stop = min(sh - 1, int(np.floor(yhi - 0.5 - 1e-12)))
        if (yhi - 0.5) == np.floor(yhi - 0.5):  # half-open upper bound
            r_stop = min(r_stop, int(yhi - 0.5) - 1)
        for r in range(r_start, r_stop + 1):
            yline = r + 0.5
            if not (ylo <= yline < yhi):
                continue
            t = (yline - y0) / (y1 - y0)
            x = x0 + t * (x1 - x0)
            c = min(max(int(np.floor(x + 0.5)), 0), sw)
            out_r.append(r)
            out_c.append(c)
            out_d.append(sign)
    return (np.asarray(out_r, dtype=np.int32),
            np.asarray(out_c, dtype=np.int32),
            np.asarray(out_d, dtype=np.float64))


def pack_cells(cell_lists, pad_multiple: int = 512, sort: bool = True):
    """Pad per-draw cell lists to a common length -> (rows, cols, area,
    cover), each (P, N); padding entries carry zero area and cover.  With
    ``sort`` each draw's cells are ordered row-major (stable), which fixes
    the order in which a pixel's cells add up."""
    count = max(1, max(r.shape[0] for r, _, _, _ in cell_lists))
    n = ((count + pad_multiple - 1) // pad_multiple) * pad_multiple
    p = len(cell_lists)
    rows = np.zeros((p, n), np.int32)
    cols = np.zeros((p, n), np.int32)
    area = np.zeros((p, n), np.float32)
    cover = np.zeros((p, n), np.float32)
    for i, (r, c, a, v) in enumerate(cell_lists):
        k = r.shape[0]
        if sort and k:
            order = np.lexsort((c, r))
            r, c, a, v = r[order], c[order], a[order], v[order]
        rows[i, :k] = r
        cols[i, :k] = c
        area[i, :k] = a
        cover[i, :k] = v
    return rows, cols, area, cover


def lower_draws_to_cells(draw_edge_tables, height, width,
                         pad_multiple: int = 512):
    """List of (E_i, 4) edge tables -> packed cell arrays."""
    cells = [edges_to_cells(e, height, width) for e in draw_edge_tables]
    return pack_cells(cells, pad_multiple)


# ---------------------------------------------------------------------------
# Device: scatter + prefix sum
# ---------------------------------------------------------------------------


def _on(x, device, dtype):
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device,
                                                          dtype=dtype)


def scatter_add(size: int, idx, vals) -> torch.Tensor:
    """A flat f32 plane of ``size`` zeros with ``vals`` added at ``idx``
    (duplicates accumulate in update order, on either device)."""
    plane = torch.zeros(size, dtype=torch.float32, device=vals.device)
    plane.index_put_((idx.reshape(-1),), vals.reshape(-1), accumulate=True)
    return plane


def _rules_for(fill_rule, planes: int):
    if isinstance(fill_rule, tuple):
        return fill_rule
    return (fill_rule,) * planes


def coverage_scanline(rows, cols, area, cover, height: int, width: int,
                      fill_rule=FILL_RULE_NONZERO, device=None):
    """Cell lists (P, N) -> (P, H, W) coverage via scatter-add + cumsum.
    ``fill_rule``: one rule, or a tuple of one per plane.  Runs on the
    inputs' device (tensors) or ``device`` (numpy: the card unless the
    caller asks for the CPU)."""
    device = rows.device if torch.is_tensor(rows) else resolve_device(device)
    rows = _on(rows, device, torch.int64)
    cols = _on(cols, device, torch.int64)
    area = _on(area, device, torch.float32)
    cover = _on(cover, device, torch.float32)
    p = rows.shape[0]
    stride = width + 1
    base = torch.arange(p, device=device)[:, None] * (height * stride)
    flat = base + rows * stride + cols
    size = p * height * stride
    area_plane = scatter_add(size, flat, area).view(p, height, stride)
    cover_plane = scatter_add(size, flat + 1, cover).view(p, height, stride)
    acc = (area_plane + torch.cumsum(cover_plane, dim=2))[:, :, :width]
    rules = _rules_for(fill_rule, p)
    if len(set(rules)) == 1:
        return apply_fill_rule(acc, rules[0])
    return torch.stack([apply_fill_rule(acc[i], rules[i]) for i in range(p)])


def coverage_scanline_points(rows, cols, delta, height: int, width: int,
                             fill_rule=FILL_RULE_NONZERO, ss: int = 4,
                             device=None):
    """Point-sampled (Flash quality-high) coverage from point cells (P, N)
    on the ss-scaled grid: scatter + cumsum -> binary inside test per
    subsample -> box average.  -> (P, H, W)."""
    device = rows.device if torch.is_tensor(rows) else resolve_device(device)
    rows = _on(rows, device, torch.int64)
    cols = _on(cols, device, torch.int64)
    delta = _on(delta, device, torch.float32)
    p = rows.shape[0]
    sh, sw = height * ss, width * ss
    stride = sw + 1
    base = torch.arange(p, device=device)[:, None] * (sh * stride)
    plane = scatter_add(p * sh * stride, base + rows * stride + cols,
                        delta).view(p, sh, stride)
    winding = torch.cumsum(plane, dim=2)[:, :, :sw]

    def inside(w, rule):
        if rule == FILL_RULE_NONZERO:
            return (torch.abs(w) >= 0.5).to(torch.float32)
        return (torch.remainder(torch.abs(torch.round(w)), 2.0)
                == 1.0).to(torch.float32)

    rules = _rules_for(fill_rule, p)
    if len(set(rules)) == 1:
        hit = inside(winding, rules[0])
    else:
        hit = torch.stack([inside(winding[i], rules[i]) for i in range(p)])
    return hit.view(p, height, ss, width, ss).mean(dim=(2, 4))


def render_scanline_batch(rows, cols, area, cover, colors, height: int,
                          width: int, fill_rule=FILL_RULE_NONZERO,
                          device=None) -> np.ndarray:
    """Batched frames from cell lists (F, L, N) and colours (F, L, 4):
    coverage -> composite -> u8, one frame at a time (peak memory is one
    frame's L planes).  Returns (F, H, W, 4) uint8."""
    from .composite import composite_solid_layers, premul_to_straight_u8

    device = rows.device if torch.is_tensor(rows) else resolve_device(device)
    colors = _on(colors, device, torch.float32)
    out = []
    for f in range(rows.shape[0]):
        cov = coverage_scanline(rows[f], cols[f], area[f], cover[f], height,
                                width, fill_rule, device=device)
        out.append(premul_to_straight_u8(
            composite_solid_layers(cov, colors[f])))
    return np.stack(out)
