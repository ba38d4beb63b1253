"""Exact area coverage of straight-edged paths, in plain PyTorch.

Every edge is cut where it crosses a whole pixel row or column, so each
piece lies in one pixel cell.  A piece of height ``dy`` whose mean x is
``xm`` in cell ``(py, px)`` leaves ``dy * (px + 1 - xm)`` of area in its
own cell and ``dy`` in every cell to its right: the first is added at
``px`` and the rest at ``px + 1`` of a per-row buffer, and a prefix sum
along the row gives the integral of the winding number over each pixel.
The nonzero rule maps it to coverage, ``min(|winding integral|, 1)``.
Pieces left of the frame put their whole ``dy`` in column 0; pieces right
of it or above or below it add nothing inside the frame.

All arithmetic is in the dtype of the edges, on their device.
"""

from __future__ import annotations

import torch


def _crossings(lo, hi, limit: int, e, sel):
    """Whole numbers k in [max(ceil(lo), 0), min(floor(hi), limit)] of
    each selected edge -> (values, edge index of each)."""
    k_lo = torch.clamp(torch.ceil(lo), 0, limit)
    k_hi = torch.clamp(torch.floor(hi), 0, limit)
    n = torch.clamp(k_hi - k_lo + 1, min=0).to(torch.int64) * sel
    idx = torch.repeat_interleave(e, n)
    start = torch.cumsum(n, 0) - n
    step = torch.arange(idx.numel(), device=e.device) - start[idx]
    return k_lo[idx] + step.to(lo.dtype), idx


def coverage(edges: torch.Tensor, layer_of: torch.Tensor, layers: int,
             height: int, width: int) -> torch.Tensor:
    """(E, 4) edges (x0, y0, x1, y1) in pixels, (E,) layer of each ->
    (layers, height, width) nonzero-rule coverage."""
    dev, dt = edges.device, edges.dtype
    buf = torch.zeros(layers * height * (width + 1), dtype=dt, device=dev)
    x0, y0, x1, y1 = edges.unbind(1)
    keep = ((y0 != y1) & (torch.maximum(y0, y1) > 0)
            & (torch.minimum(y0, y1) < height))
    if keep.any():
        x0, y0, x1, y1 = x0[keep], y0[keep], x1[keep], y1[keep]
        lay = layer_of[keep]
        dx, dy = x1 - x0, y1 - y0
        e = torch.arange(x0.numel(), device=dev)
        ky, ey = _crossings(torch.minimum(y0, y1), torch.maximum(y0, y1),
                            height, e, torch.ones_like(e))
        kx, ex = _crossings(torch.minimum(x0, x1), torch.maximum(x0, x1),
                            width, e, (dx != 0).to(torch.int64))
        one = torch.ones_like(x0)
        t = torch.cat([torch.zeros_like(x0), one,
                       (ky - y0[ey]) / dy[ey],
                       (kx - x0[ex]) / torch.where(dx != 0, dx, one)[ex]])
        t = torch.clamp(t, 0.0, 1.0)
        owner = torch.cat([e, e, ey, ex])
        order = torch.sort(t, stable=True)[1]
        order = order[torch.sort(owner[order], stable=True)[1]]
        t, owner = t[order], owner[order]
        same = owner[1:] == owner[:-1]
        ta, tb, k = t[:-1][same], t[1:][same], owner[:-1][same]
        xa, xb = x0[k] + ta * dx[k], x0[k] + tb * dx[k]
        ya, yb = y0[k] + ta * dy[k], y0[k] + tb * dy[k]
        h = yb - ya
        xm, ym = (xa + xb) * 0.5, (ya + yb) * 0.5
        py = torch.floor(ym)
        px = torch.floor(xm)
        ok = (py >= 0) & (py < height) & (px < width) & (h != 0)
        left = px < 0
        nxt = torch.where(left, torch.zeros_like(xm), xm - px)
        col = torch.clamp(px, min=0).to(torch.int64)
        base = ((lay[k] * height + py.to(torch.int64)) * (width + 1) + col)
        base, h, nxt = base[ok], h[ok], nxt[ok]
        buf.index_add_(0, base, h * (1.0 - nxt))
        buf.index_add_(0, base + 1, h * nxt)
    acc = torch.cumsum(buf.view(layers, height, width + 1), -1)[..., :width]
    return torch.clamp(torch.abs(acc), max=1.0)
