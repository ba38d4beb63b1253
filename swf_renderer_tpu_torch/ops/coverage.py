"""Analytic-coverage rasterization: edge tables -> per-pixel coverage.

Port of ``swf_renderer_tpu/ops/coverage.py``.  For every pixel cell and
every line segment the signed area of the part of the cell right of the
segment (restricted to the segment's y-span) is accumulated; summed over
a closed path that is the integral of the winding number over the pixel,
and the fill rule maps it to coverage.  Edge tables are ``(B, 4, E)``
f32 (rows x0, y0, x1, y1) in pixels; all-zero edges are padding and
contribute exactly 0.

Two kernels compute it, with DIFFERENT arithmetic, each beside its plain
PyTorch version (the CPU route, and the yardstick on the card):

* ``coverage_banded`` (B9, ``csrc/coverage.cu``): edges sorted by ymin;
  each 16-row band walks the window ``[lo, hi)`` of edges that can reach
  it, accumulating ``edge_contribution`` edge by edge.  E <= 2048.
* ``coverage_tiled`` (B10): edges sorted by ymin in 128-edge blocks with
  (ymin, ymax) bounds; a 16x128 tile skips blocks that miss its rows and
  sums each block in the slope form of the reference's production body
  (four edges a trip, merged pairwise), then adds the block's partial to
  its running sum.

``coverage`` dispatches like the reference: B9 while the padded edge
count is at most ``SMEM_EDGE_CAP``, else B10; on a CUDA tensor it
launches the kernel, on a CPU tensor it runs that kernel's plain version.

A third formulation, ``coverage_grouped`` (B11), has no route of the
renderer, as in the reference (which calls it only from a benchmark
tool): the tiled kernel's 128-edge blocks, walked by 8-row strips in
8-edge groups with reciprocals in place of the divisions.
``coverage_plain`` is the reference's XLA formulation (one scan over the
edges in table order).  ``coverage_numpy`` is the reference's f64 numpy
oracle, one edge at a time: a yardstick for tests and the chip check,
on no render route.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.numerics import floor_mod, true_div

FILL_RULE_NONZERO = 0
FILL_RULE_EVENODD = 1

TILE_H = 16
TILE_W = 128
EDGE_BLOCK = 128          # edges per block of the tiled and grouped kernels
STRIP_H = 8               # pixel rows per strip of the grouped kernel
GROUP = 8                 # edges summed together by the grouped kernel
MAX_EDGE_EXTENT = 64.0    # px; geometry.split_edges_y's default bound
SMEM_EDGE_CAP = 2048      # most edges the banded kernel takes
PAD_KEY = 3.0e38          # sort key of a padding (all-zero) edge


def _h01(x):
    """Antiderivative of clamp(x, 0, 1): 0 | x^2/2 | x - 1/2."""
    return torch.where(x <= 0.0, torch.zeros_like(x),
                       torch.where(x >= 1.0, x - 0.5, 0.5 * x * x))


def edge_row_span(x0, y0, x1, y1, py):
    """The part of one edge inside pixel row ``py`` (broadcasting over all
    tensor arguments): (dy, xmn, xmx) — its signed y-extent clipped to the
    row (0 for horizontal edges and rows it misses) and the x-range it
    covers there.  Every step is one IEEE f32 operation, in the
    reference's order (``edge_contribution``, first half)."""
    sy0 = y0 - py
    sy1 = y1 - py
    cy0 = torch.clamp(sy0, 0.0, 1.0)
    cy1 = torch.clamp(sy1, 0.0, 1.0)
    dy = cy1 - cy0

    dyd = sy1 - sy0
    safe_dyd = torch.where(torch.abs(dyd) < 1e-9, torch.ones_like(dyd), dyd)
    t0 = (cy0 - sy0) / safe_dyd
    t1 = (cy1 - sy0) / safe_dyd

    dx_seg = x1 - x0
    xa = x0 + t0 * dx_seg  # absolute x at the clipped y window
    xb = x0 + t1 * dx_seg
    return dy, torch.minimum(xa, xb), torch.maximum(xa, xb)


def span_ramp(dy, xmn, xmx, px):
    """Area of pixel cell ``px`` to the right of a row span: dy * (1 - the
    mean over the span of clamp(edge_x - px, 0, 1))
    (``edge_contribution``, second half)."""
    span = xmx - xmn
    safe_span = torch.where(span < 1e-9, torch.ones_like(span), span)
    rel_mn = xmn - px
    rel_mx = xmx - px
    mean_clamped = torch.where(
        span < 1e-9,
        torch.clamp(0.5 * (rel_mn + rel_mx), 0.0, 1.0),
        (_h01(rel_mx) - _h01(rel_mn)) / safe_span,
    )
    return dy * (1.0 - mean_clamped)


def edge_contribution(x0, y0, x1, y1, px, py):
    """Signed pixel-area contribution of one edge: the area of the pixel
    row-slab to the right of the edge.  ``px``/``py`` are the pixel cell
    origins."""
    return span_ramp(*edge_row_span(x0, y0, x1, y1, py), px)


def apply_fill_rule(acc, fill_rule: int):
    """Winding integral -> coverage: nonzero ``min(|acc|, 1)``, even-odd
    the triangle wave ``1 - |mod(acc, 2) - 1|`` (floored modulo)."""
    if fill_rule == FILL_RULE_NONZERO:
        return torch.clamp(torch.abs(acc), max=1.0)
    if fill_rule == FILL_RULE_EVENODD:
        return 1.0 - torch.abs(floor_mod(acc, 2.0) - 1.0)
    raise ValueError(f"unknown fill rule {fill_rule}")


def normalize_fill_rule(fill_rule, layers: int):
    """One rule for every layer (int) or one PER LAYER (sequence — SWF
    mixes even-odd and DefineShape4 nonzero shapes in one scene).
    Returns the int form when uniform."""
    if isinstance(fill_rule, (tuple, list)):
        fill_rule = tuple(fill_rule)
        if len(fill_rule) != layers:
            raise ValueError(f"fill_rule tuple has {len(fill_rule)} "
                             f"entries for {layers} layers")
        if len(set(fill_rule)) == 1:
            return fill_rule[0]
    return fill_rule


def layer_rules(fill_rule, layers: int):
    """Normalized fill rule -> length-``layers`` per-layer rule tuple."""
    return (fill_rule if isinstance(fill_rule, tuple)
            else (fill_rule,) * layers)


# ---------------------------------------------------------------------------
# The reference's XLA formulation
# ---------------------------------------------------------------------------


def coverage_plain(edges_t, height: int, width: int,
                   fill_rule: int = FILL_RULE_NONZERO) -> torch.Tensor:
    """``coverage_xla``: (B, 4, E) -> (B, H, W), one pass over the edges in
    table order, each edge's contribution added to the whole plane."""
    edges_t = _edges_tensor(edges_t, None)
    b, _, num_edges = edges_t.shape
    dev = edges_t.device
    py = torch.arange(height, dtype=torch.float32, device=dev)[None, :, None]
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, None, :]
    acc = torch.zeros((b, height, width), dtype=torch.float32, device=dev)
    for i in range(num_edges):
        x0, y0, x1, y1 = (edges_t[:, k, i, None, None] for k in range(4))
        acc = acc + edge_contribution(x0, y0, x1, y1, px, py)
    return apply_fill_rule(acc, fill_rule)


# ---------------------------------------------------------------------------
# Host steps shared by the kernels: the sort, the band windows, the bounds
# ---------------------------------------------------------------------------


def _edges_tensor(edges_t, device) -> torch.Tensor:
    """(B, 4, E) or (4, E) edges as a contiguous f32 tensor on ``device``:
    a tensor's own device when ``device`` is None; for numpy input the
    card unless the caller asks for the CPU."""
    if not torch.is_tensor(edges_t):
        edges_t = torch.from_numpy(np.ascontiguousarray(edges_t, np.float32))
        device = resolve_device(device)
    if device is not None:
        edges_t = edges_t.to(device)
    edges_t = edges_t.to(torch.float32)
    if edges_t.ndim == 2:
        edges_t = edges_t[None]
    if edges_t.ndim != 3 or edges_t.shape[1] != 4 or edges_t.shape[2] < 1:
        raise ValueError(f"edges must be (B, 4, E), got {tuple(edges_t.shape)}")
    return edges_t.contiguous()


def sort_edges(edges_t: torch.Tensor):
    """Sort each plane's edges by ymin with a STABLE sort; padding edges
    (all zero) take the key 3e38 and go last.  Ties keep table order, so
    the kernels sum in the reference's order.  Returns (sorted edges
    (B, 4, E), sorted keys (B, E), sorted padding mask (B, E))."""
    y0, y1 = edges_t[:, 1], edges_t[:, 3]
    is_pad = (edges_t == 0.0).all(dim=1)
    key = torch.where(is_pad, torch.full_like(y0, PAD_KEY),
                      torch.minimum(y0, y1))
    key_sorted, order = torch.sort(key, dim=-1, stable=True)
    edges_sorted = torch.gather(edges_t, 2, order[:, None, :].expand(
        -1, 4, -1)).contiguous()
    return edges_sorted, key_sorted.contiguous(), torch.gather(is_pad, 1,
                                                                order)


def band_ranges(edges_t: torch.Tensor, key_sorted: torch.Tensor,
                height: int) -> torch.Tensor:
    """The banded kernel's window of sorted edges per 16-row band:
    ``lo = searchsorted(ymin, band_y0 - max_ext)``, ``hi =
    searchsorted(ymin, band_y0 + 16)`` (side left), with ``max_ext`` the
    plane's largest edge y-extent, so the windows are exact for any input
    and tight for edges split to ``MAX_EDGE_EXTENT``.  -> (B, TY, 2) int32."""
    b = edges_t.shape[0]
    max_ext = torch.abs(edges_t[:, 3] - edges_t[:, 1]).amax(dim=-1)
    ty_count = -(-height // TILE_H)
    band_y0 = torch.arange(ty_count, dtype=torch.float32,
                           device=edges_t.device) * TILE_H
    lo = torch.searchsorted(key_sorted, band_y0[None, :] - max_ext[:, None])
    hi = torch.searchsorted(key_sorted,
                            (band_y0 + TILE_H)[None, :].expand(b, -1)
                            .contiguous())
    return torch.stack([lo, hi], dim=-1).to(torch.int32).contiguous()


def block_bounds(edges_sorted: torch.Tensor, key_sorted: torch.Tensor,
                 pad_sorted: torch.Tensor) -> torch.Tensor:
    """(ymin, ymax) of each 128-edge block of the sorted table (padding
    edges count as +3e38 / -3e38) -> (B, NB, 2) f32."""
    b, _, e = edges_sorted.shape
    ymax = torch.maximum(edges_sorted[:, 1], edges_sorted[:, 3])
    ymax = torch.where(pad_sorted, torch.full_like(ymax, -PAD_KEY), ymax)
    nb = e // EDGE_BLOCK
    return torch.stack(
        [key_sorted.view(b, nb, EDGE_BLOCK).amin(dim=-1),
         ymax.view(b, nb, EDGE_BLOCK).amax(dim=-1)], dim=-1).contiguous()


def split_pad_tables(tables, multiple: int = 128) -> np.ndarray:
    """(E_i, 4) edge tables -> one (N, 4, E) f32 batch for the coverage
    kernels: each table split to |dy| <= ``MAX_EDGE_EXTENT``
    (``geometry.split_edges_y``, tight band windows), transposed and
    zero-padded to a common multiple of ``multiple`` edges."""
    from ..models.geometry import split_edges_y

    split = [split_edges_y(t) for t in tables]
    padded = max(multiple, -(-max(s.shape[0] for s in split) // multiple)
                 * multiple)
    out = np.zeros((len(split), 4, padded), np.float32)
    for i, s in enumerate(split):
        out[i, :, :s.shape[0]] = s.T
    return out


# ---------------------------------------------------------------------------
# B9: banded coverage
# ---------------------------------------------------------------------------

# Elements of one intermediate plane of the plain versions: bounds their
# temporaries on 1080p batches.
_PLAIN_CHUNK = 1 << 24


def banded_plain(edges_sorted: torch.Tensor, ranges: torch.Tensor,
                 height: int, width: int,
                 fill_rule: int = FILL_RULE_NONZERO) -> torch.Tensor:
    """Plain PyTorch version of the banded kernel: every pixel of band
    ``ty`` adds ``edge_contribution`` of the sorted edges ``lo..hi-1`` of
    its band, one edge after the other, then the fill rule.  -> (B, H, W)."""
    b, _, num_edges = edges_sorted.shape
    dev = edges_sorted.device
    ty_count = ranges.shape[1]
    py = (torch.arange(ty_count, dtype=torch.float32, device=dev)[:, None]
          * TILE_H + torch.arange(TILE_H, dtype=torch.float32,
                                  device=dev)[None, :])[None, :, :, None]
    px = torch.arange(width, dtype=torch.float32, device=dev)
    out = torch.empty((b, ty_count * TILE_H, width), dtype=torch.float32,
                      device=dev)
    step = max(1, _PLAIN_CHUNK // (ty_count * TILE_H * width))
    for b0 in range(0, b, step):
        b1 = min(b, b0 + step)
        lo = ranges[b0:b1, :, 0].long()
        count = (ranges[b0:b1, :, 1].long() - lo).clamp(min=0)
        acc = torch.zeros((b1 - b0, ty_count, TILE_H, width),
                          dtype=torch.float32, device=dev)
        for k in range(int(count.max().item()) if count.numel() else 0):
            idx = (lo + k).clamp(max=num_edges - 1)
            x0, y0, x1, y1 = (
                torch.gather(edges_sorted[b0:b1, c], 1, idx)[..., None, None]
                for c in range(4))
            contrib = edge_contribution(x0, y0, x1, y1, px, py)
            acc = torch.where((k < count)[..., None, None], acc + contrib,
                              acc)
        out[b0:b1] = apply_fill_rule(acc, fill_rule).view(
            b1 - b0, ty_count * TILE_H, width)
    return out[:, :height]


def _launch_coverage(kind: str, edges_sorted, table, height, width,
                     fill_rule):
    """Launch ``swf_coverage_banded`` / ``_tiled`` / ``_grouped``
    (csrc/coverage.cu) on the tensors' card.  Raises if the library does
    not build or the launch is refused."""
    from . import cuda_lib

    b, _, num_edges = edges_sorted.shape
    if b > 65535 or -(-height // TILE_H) > 65535:
        raise ValueError(f"{b} planes of {height} rows exceed the grid")
    out = torch.empty((b, height, width), dtype=torch.float32,
                      device=edges_sorted.device)
    fn = getattr(cuda_lib.load("swfcoverage"), f"swf_coverage_{kind}")
    err = fn(edges_sorted.data_ptr(), table.data_ptr(), out.data_ptr(), b,
             num_edges, height, width, int(fill_rule),
             torch.cuda.current_stream(edges_sorted.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kind} coverage kernel launch failed: CUDA "
                           f"error {err}")
    return out


def _check_rule(fill_rule):
    if fill_rule not in (FILL_RULE_NONZERO, FILL_RULE_EVENODD):
        raise ValueError(f"unknown fill rule {fill_rule}")


def coverage_banded(edges_t, height: int, width: int,
                    fill_rule: int = FILL_RULE_NONZERO,
                    device=None) -> torch.Tensor:
    """Banded coverage: (B, 4, E) edges, E <= ``SMEM_EDGE_CAP``, ->
    (B, H, W) f32 coverage on the edges' device (a tensor's own, else
    ``device``: the card unless the caller asks for the CPU).

    Kernel: replaces ``_banded_kernel`` (swf_renderer_tpu/ops/
    coverage.py:559).  One block per (plane, 16-row band) and one or
    more of its 128-column tiles stages the y-only terms of each (window
    edge, row) whose clipped dy is nonzero in shared memory; each thread
    owns four columns of two rows and adds those edges' contributions one
    by one, in window order.  On the CPU ``banded_plain`` runs instead."""
    edges_t = _edges_tensor(edges_t, device)
    _check_rule(fill_rule)
    if edges_t.shape[-1] > SMEM_EDGE_CAP:
        raise ValueError(
            f"banded kernel supports at most {SMEM_EDGE_CAP} edges, got "
            f"{edges_t.shape[-1]}; use coverage_tiled instead")
    edges_sorted, key_sorted, _ = sort_edges(edges_t)
    ranges = band_ranges(edges_t, key_sorted, height)
    if edges_t.device.type == "cpu":
        return banded_plain(edges_sorted, ranges, height, width, fill_rule)
    if edges_t.device.type != "cuda":
        raise ValueError(f"unsupported device {edges_t.device}")
    out = _launch_coverage("banded", edges_sorted, ranges, height, width,
                           fill_rule)
    coverage_banded.launches += 1
    return out


coverage_banded.launches = 0


# ---------------------------------------------------------------------------
# B10: tiled coverage over 128-edge blocks
# ---------------------------------------------------------------------------


def slope_contribution(x0, y0, y1, slope, px, py):
    """The tiled kernel's per-edge body: ``edge_contribution`` in slope
    form — x at the clipped row window measured from the segment start
    through the edge's scalar slope, and the ramp multiplied by
    ``1 / max(span, 1e-9)``."""
    sy0 = y0 - py
    sy1 = y1 - py
    cy0 = torch.clamp(sy0, 0.0, 1.0)
    cy1 = torch.clamp(sy1, 0.0, 1.0)
    dy = cy1 - cy0
    xa = x0 + (cy0 - sy0) * slope
    xb = x0 + (cy1 - sy0) * slope
    xmn = torch.minimum(xa, xb)
    xmx = torch.maximum(xa, xb)
    span = xmx - xmn
    inv_span = true_div(1.0, torch.clamp(span, min=1e-9))
    rel_mn = xmn - px
    rel_mx = xmx - px
    ramp = (_h01(rel_mx) - _h01(rel_mn)) * inv_span
    mean = torch.where(span < 1e-9,
                       torch.clamp(0.5 * (rel_mn + rel_mx), 0.0, 1.0), ramp)
    return dy * (1.0 - mean)


def edge_slopes(edges_sorted: torch.Tensor) -> torch.Tensor:
    """(x1 - x0) / (y1 - y0) per edge, 0 where |y1 - y0| < 1e-9."""
    dyd = edges_sorted[:, 3] - edges_sorted[:, 1]
    slope = true_div(edges_sorted[:, 2] - edges_sorted[:, 0], dyd)
    return torch.where(torch.abs(dyd) < 1e-9, torch.zeros_like(dyd), slope)


def tiled_plain(edges_sorted: torch.Tensor, bounds: torch.Tensor,
                height: int, width: int,
                fill_rule: int = FILL_RULE_NONZERO) -> torch.Tensor:
    """Plain PyTorch version of the tiled kernel: for every 128-edge block
    whose bounds reach a 16-row tile, the block's partial sum (32 trips of
    four edges, merged ``(p0 + p1) + (p2 + p3)``) is added to the tile's
    running sum; then the fill rule.  -> (B, H, W)."""
    b, _, num_edges = edges_sorted.shape
    dev = edges_sorted.device
    nb = num_edges // EDGE_BLOCK
    ty_count = -(-height // TILE_H)
    slope = edge_slopes(edges_sorted)
    tile_y0 = torch.arange(ty_count, dtype=torch.float32,
                           device=dev) * TILE_H
    hit = ((bounds[..., 1, None] > tile_y0) &
           (bounds[..., 0, None] < tile_y0 + TILE_H)).cpu()   # (B, NB, TY)
    px = torch.arange(width, dtype=torch.float32, device=dev)
    acc = torch.zeros((b, ty_count * TILE_H, width), dtype=torch.float32,
                      device=dev)
    rows_step = max(TILE_H, _PLAIN_CHUNK // (EDGE_BLOCK * width))
    for p in range(b):
        for j in range(nb):
            tys = hit[p, j].nonzero()
            if tys.numel() == 0:
                continue
            r_lo = int(tys.min()) * TILE_H
            r_hi = (int(tys.max()) + 1) * TILE_H
            sl = slice(j * EDGE_BLOCK, (j + 1) * EDGE_BLOCK)
            x0, y0, y1 = (edges_sorted[p, c, sl, None, None]
                          for c in (0, 1, 3))
            sp = slope[p, sl, None, None]
            for r0 in range(r_lo, r_hi, rows_step):
                r1 = min(r_hi, r0 + rows_step)
                py = torch.arange(r0, r1, dtype=torch.float32,
                                  device=dev)[:, None]
                part = slope_contribution(x0, y0, y1, sp, px, py)
                trips = (part[0::4] + part[1::4]) + (part[2::4] + part[3::4])
                blk = torch.zeros((r1 - r0, width), dtype=torch.float32,
                                  device=dev)
                for i in range(EDGE_BLOCK // 4):
                    blk = blk + trips[i]
                acc[p, r0:r1] = acc[p, r0:r1] + blk
    return apply_fill_rule(acc[:, :height], fill_rule)


def coverage_tiled(edges_t, height: int, width: int,
                   fill_rule: int = FILL_RULE_NONZERO,
                   device=None) -> torch.Tensor:
    """Tiled coverage: (B, 4, E) edges, E a multiple of 128, -> (B, H, W)
    f32 coverage on the edges' device (as ``coverage_banded``).

    Kernel: replaces ``_coverage_kernel`` (swf_renderer_tpu/ops/
    coverage.py:169) in its production (``scalar_loop``) body.  One block
    per (plane, 16-row tile, 128-column tile) walks the 128-edge blocks,
    skips those whose bounds miss its rows, stages each hit block's
    y-only terms per (edge, row) in shared memory and sums it four edges
    a trip, walking only the trips with an edge whose clipped dy is
    nonzero.  On the CPU ``tiled_plain`` runs instead."""
    edges_t = _edges_tensor(edges_t, device)
    _check_rule(fill_rule)
    if edges_t.shape[-1] % EDGE_BLOCK:
        raise ValueError(f"edge count {edges_t.shape[-1]} is not a multiple "
                         f"of {EDGE_BLOCK}")
    edges_sorted, key_sorted, pad_sorted = sort_edges(edges_t)
    bounds = block_bounds(edges_sorted, key_sorted, pad_sorted)
    if edges_t.device.type == "cpu":
        return tiled_plain(edges_sorted, bounds, height, width, fill_rule)
    if edges_t.device.type != "cuda":
        raise ValueError(f"unsupported device {edges_t.device}")
    out = _launch_coverage("tiled", edges_sorted, bounds, height, width,
                           fill_rule)
    coverage_tiled.launches += 1
    return out


coverage_tiled.launches = 0


# ---------------------------------------------------------------------------
# B11: grouped coverage over 128-edge blocks, 8-row strips, 8-edge groups
# ---------------------------------------------------------------------------


def grouped_row_terms(edges, py):
    """The grouped kernel's per-(edge, row) terms: (dy, xmn, xmx,
    inv_span) of edges (..., 4 rows of coordinates along dim 0 as x0,
    y0, x1, y1) in pixel row ``py``, through the reciprocals the
    reference multiplies by (``coverage.py:440-466``): ``inv_dyd = 1 /
    safe_dyd``, then ``t = (cy - sy0) * inv_dyd``; ``inv_span = 1 /
    (span < 1e-9 ? 1 : span)``."""
    x0, y0, x1, y1 = edges
    dyd = y1 - y0
    safe_dyd = torch.where(torch.abs(dyd) < 1e-9, torch.ones_like(dyd), dyd)
    inv_dyd = true_div(1.0, safe_dyd)
    dx_seg = x1 - x0
    sy0 = y0 - py
    sy1 = y1 - py
    cy0 = torch.clamp(sy0, 0.0, 1.0)
    cy1 = torch.clamp(sy1, 0.0, 1.0)
    dy = cy1 - cy0
    t0 = (cy0 - sy0) * inv_dyd
    t1 = (cy1 - sy0) * inv_dyd
    xa = x0 + t0 * dx_seg
    xb = x0 + t1 * dx_seg
    xmn = torch.minimum(xa, xb)
    xmx = torch.maximum(xa, xb)
    span = xmx - xmn
    inv_span = true_div(1.0, torch.where(span < 1e-9, torch.ones_like(span),
                                         span))
    return dy, xmn, xmx, span, inv_span


def grouped_contribution(dy, xmn, xmx, span, inv_span, px):
    """The grouped kernel's per-pixel body: ``dy * (1 - mean)`` with the
    mean of the clamped ramp times ``inv_span``."""
    rel_mn = xmn - px
    rel_mx = xmx - px
    mean = torch.where(span < 1e-9,
                       torch.clamp(0.5 * (rel_mn + rel_mx), 0.0, 1.0),
                       (_h01(rel_mx) - _h01(rel_mn)) * inv_span)
    return dy * (1.0 - mean)


def grouped_plain(edges_sorted: torch.Tensor, bounds: torch.Tensor,
                  height: int, width: int,
                  fill_rule: int = FILL_RULE_NONZERO) -> torch.Tensor:
    """Plain PyTorch version of the grouped kernel: for every 128-edge
    block whose bounds reach an 8-row strip, the block's partial (16
    groups of 8 edges, each group summed ``((c0 + c1) + (c2 + c3)) + ((c4
    + c5) + (c6 + c7))`` and added to the partial in turn) is added to the
    strip's running sum; then the fill rule.  -> (B, H, W)."""
    b, _, num_edges = edges_sorted.shape
    dev = edges_sorted.device
    nb = num_edges // EDGE_BLOCK
    ty_count = -(-height // STRIP_H)
    strip_y0 = torch.arange(ty_count, dtype=torch.float32,
                            device=dev) * STRIP_H
    hit = ((bounds[..., 1, None] > strip_y0) &
           (bounds[..., 0, None] < strip_y0 + STRIP_H)).cpu()  # (B, NB, TY)
    px = torch.arange(width, dtype=torch.float32, device=dev)
    acc = torch.zeros((b, ty_count * STRIP_H, width), dtype=torch.float32,
                      device=dev)
    rows_step = max(STRIP_H, _PLAIN_CHUNK // (EDGE_BLOCK * width)
                    // STRIP_H * STRIP_H)
    for p in range(b):
        for j in range(nb):
            tys = hit[p, j].nonzero()
            if tys.numel() == 0:
                continue
            r_lo = int(tys.min()) * STRIP_H
            r_hi = (int(tys.max()) + 1) * STRIP_H
            edges = edges_sorted[p, :, j * EDGE_BLOCK:(j + 1) * EDGE_BLOCK,
                                 None, None]              # (4, 128, 1, 1)
            for r0 in range(r_lo, r_hi, rows_step):
                r1 = min(r_hi, r0 + rows_step)
                py = torch.arange(r0, r1, dtype=torch.float32,
                                  device=dev)[:, None]
                c = grouped_contribution(*grouped_row_terms(edges, py), px)
                c = c.view(EDGE_BLOCK // GROUP, GROUP, r1 - r0, width)
                groups = (((c[:, 0] + c[:, 1]) + (c[:, 2] + c[:, 3]))
                          + ((c[:, 4] + c[:, 5]) + (c[:, 6] + c[:, 7])))
                blk = torch.zeros((r1 - r0, width), dtype=torch.float32,
                                  device=dev)
                for g in range(EDGE_BLOCK // GROUP):
                    blk = blk + groups[g]
                acc[p, r0:r1] = acc[p, r0:r1] + blk
    return apply_fill_rule(acc[:, :height], fill_rule)


def coverage_grouped(edges_t, height: int, width: int,
                     fill_rule: int = FILL_RULE_NONZERO,
                     device=None) -> torch.Tensor:
    """Grouped coverage: (B, 4, E) edges, E a multiple of 128, -> (B, H,
    W) f32 coverage on the edges' device (as ``coverage_banded``).

    Kernel: replaces ``_grouped_kernel`` (swf_renderer_tpu/ops/
    coverage.py:404, wrapper ``coverage_grouped`` :486).  Edges sorted by
    ymin in 128-edge blocks with (ymin, ymax) bounds, as for the tiled
    kernel; one block of 256 threads per (plane, two 8-row strips,
    128-column tile) walks the blocks that reach either strip, stages
    each block's per-(edge, row) terms where the edge crosses the row
    (computed once, not once a column), and each thread sums 4 columns of
    2 rows over the 8-edge groups that hold a crossing edge, in the
    reference's merge order, then applies the fill rule.  On the CPU
    ``grouped_plain`` runs instead."""
    edges_t = _edges_tensor(edges_t, device)
    _check_rule(fill_rule)
    if edges_t.shape[-1] % EDGE_BLOCK:
        raise ValueError(f"edge count {edges_t.shape[-1]} is not a multiple "
                         f"of {EDGE_BLOCK}")
    edges_sorted, key_sorted, pad_sorted = sort_edges(edges_t)
    bounds = block_bounds(edges_sorted, key_sorted, pad_sorted)
    if edges_t.device.type == "cpu":
        return grouped_plain(edges_sorted, bounds, height, width, fill_rule)
    if edges_t.device.type != "cuda":
        raise ValueError(f"unsupported device {edges_t.device}")
    out = _launch_coverage("grouped", edges_sorted, bounds, height, width,
                           fill_rule)
    coverage_grouped.launches += 1
    return out


coverage_grouped.launches = 0


def coverage(edges_t, height: int, width: int,
             fill_rule: int = FILL_RULE_NONZERO,
             device=None) -> torch.Tensor:
    """Dispatch as the reference does: the banded kernel when the padded
    table fits ``SMEM_EDGE_CAP`` edges (callers pre-split edges to
    ``MAX_EDGE_EXTENT``: see ``split_pad_tables``), else the tiled
    kernel."""
    if edges_t.shape[-1] <= SMEM_EDGE_CAP:
        return coverage_banded(edges_t, height, width, fill_rule, device)
    return coverage_tiled(edges_t, height, width, fill_rule, device)


# ---------------------------------------------------------------------------
# NumPy oracle (tests and the chip check only)
# ---------------------------------------------------------------------------


def coverage_numpy(edges: np.ndarray, height: int, width: int,
                   fill_rule: int = FILL_RULE_NONZERO) -> np.ndarray:
    """Direct NumPy port of the math, one edge at a time, in f64.
    (E, 4) -> (H, W)."""
    py = np.arange(height, dtype=np.float64)[:, None]
    px = np.arange(width, dtype=np.float64)[None, :]
    acc = np.zeros((height, width), dtype=np.float64)

    def h01(x):
        return np.where(x <= 0.0, 0.0, np.where(x >= 1.0, x - 0.5, 0.5 * x * x))

    for x0, y0, x1, y1 in np.asarray(edges, dtype=np.float64):
        sy0, sy1 = y0 - py, y1 - py
        cy0, cy1 = np.clip(sy0, 0, 1), np.clip(sy1, 0, 1)
        dy = cy1 - cy0
        dyd = sy1 - sy0
        safe = np.where(np.abs(dyd) < 1e-9, 1.0, dyd)
        t0, t1 = (cy0 - sy0) / safe, (cy1 - sy0) / safe
        sx0 = x0 - px
        xa = sx0 + t0 * (x1 - x0)
        xb = sx0 + t1 * (x1 - x0)
        xmn, xmx = np.minimum(xa, xb), np.maximum(xa, xb)
        span = xmx - xmn
        safe_span = np.where(span < 1e-9, 1.0, span)
        mean = np.where(
            span < 1e-9,
            np.clip(0.5 * (xmn + xmx), 0, 1),
            (h01(xmx) - h01(xmn)) / safe_span,
        )
        acc += dy * (1.0 - mean)

    if fill_rule == FILL_RULE_NONZERO:
        return np.minimum(np.abs(acc), 1.0)
    m = np.mod(acc, 2.0)
    return 1.0 - np.abs(m - 1.0)
