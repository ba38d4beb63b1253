"""On-device TRANSFORM-animation rasterizer: host work independent of the
frame count.

Port of ``swf_renderer_tpu/ops/transform.py``.  Re-rendering a cached
shape under a new matrix should cost one replay, not a new lowering:

* **Host, once per animation** (``affine_pieces``): split each
  local-space edge at uniform t so the piece's |dy| AFTER transform is
  <= 1 for EVERY frame matrix.  Uniform-t subdivision commutes with affine
  maps, so piece p of the transformed edge equals the transform of piece
  p.
* **Device, per frame** (one CUDA kernel launch for all frames,
  ``csrc/sweep.cu``): apply the frame's affine to the piece tables,
  evaluate each piece's exact analytic coverage ramp over the <= 2 rows
  it touches, sum the ramps per pixel, then the shared fill-rule /
  composite / premultiplied-u8 tail.

``render_affine_sweep`` and ``render_morph_affine_sweep`` launch the
kernel for tensors on the card and take the plain version only for
tensors on the CPU; their ``launches`` attributes count kernel launches.
Frames come out as (F, H, W) packed little-endian RGBA held in int32
(view with ``ops.morph.morph_frames_to_u8``).

Three tilings compute the same frames byte for byte (every pixel sums
the same 32.32 fixed-point ramps):

* the column tiling (default): a CUDA block per 128-column tile;
* ``row_grid=True``: a block per band of rows across the full width,
  carrying each row's winding from one 256-column chunk to the next
  (``row_launches``; ``wchunk`` is checked as the reference's knob, but
  the chunk cannot change a frame, so one width is compiled);
* ``**plan_compact_sweep(...)`` (``compact_counts``, ``wblock``,
  ``blocks_per_step``): ``compact_pre`` gathers, per (frame, column bin,
  layer), the pieces that cross the bin and the fixed-point prefix of
  those wholly left of it, and the kernel walks only those
  (``compact_launches``; plain version ``sweep_compact_plain``).

``x_shift=`` (the column tiling only, as in the reference) renders the
columns of a tile shard: frame column c is column c + x_shift of the
global pixel grid, where the pieces and gradient matrices stay.  The
column kernel takes it as its origin (0 for a whole frame) and gives a
shard the words of those columns of the unsharded frame, at any origin
and shard width (``parallel/mesh.py``'s tile-sharded sweeps).

Not taken over from the reference: its other tiling knobs (``e_chunk``,
``prefix_cheap``, ``prefilter``, ``chunk_list``, ``skip_empty``,
``x_split``) and the sublane copies of the piece tables (``subxy``) are
formulations for that machine's memories and matrix unit, not part of
the function.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..utils.device import resolve_device
from .coverage import (
    FILL_RULE_NONZERO, edge_row_span, layer_rules, normalize_fill_rule,
    span_ramp,
)
from .flatblock import (
    _P_C0, _P_DC, _P_INV, KPAINT_COLOR, KPAINT_FIELD, KPAINT_FOCAL,
    KPAINT_LINEAR, MAX_KERNEL_LAYERS, KernelPaint, _composite_pack,
    _device_tables, _fill_cov, _grad_ramp_plain, _grad_t_plain, paint_tables,
)

_GRADIENT_KINDS = (KPAINT_LINEAR, KPAINT_FOCAL)
SWEEP_CHUNK = 16    # gathered slots per row-bounds chunk of the
                    # compacted sweep (csrc kFineChunk)
FINE_CHUNK = 16     # pieces per row-bounds chunk of the others (kFineChunk)
LANE = 128          # the reference's lane width (frame heights pad to it)
ROW_CHUNKS = (128, 256)   # wchunk values taken (the kernel runs 256)
MAX_BIN_W = 256     # widest column bin of the compacted tiling


# ---------------------------------------------------------------------------
# Host half: piece tables (numpy, byte-equal to the reference's)
# ---------------------------------------------------------------------------


def _per_layer_mats(matrices, n_layers: int):
    """(F, 6) or per-layer (F, L, 6) matrix tracks -> [L] of (F, 6) f64."""
    mats = np.asarray(matrices, np.float64)
    if mats.ndim == 2 and mats.shape[1] == 6:
        return [mats] * n_layers
    if mats.ndim == 3 and mats.shape[2] == 6:
        if mats.shape[1] != n_layers:
            raise ValueError(
                f"per-layer matrices {mats.shape} vs {n_layers} layers")
        return [mats[:, i] for i in range(mats.shape[1])]
    raise ValueError(f"matrices must be (F, 6) or (F, L, 6),"
                     f" got {mats.shape}")


def _split_uniform(rows, counts):
    """Split each (x0, y0, x1, y1) row into ``counts[i]`` uniform-t pieces
    (f64) -> (sum counts, 4)."""
    ps = []
    for row, k in zip(rows, counts):
        t = np.linspace(0.0, 1.0, k + 1)
        xs = row[0] + t * (row[2] - row[0])
        ys = row[1] + t * (row[3] - row[1])
        ps.append(np.stack([xs[:-1], ys[:-1], xs[1:], ys[1:]], 1))
    return np.concatenate(ps) if ps else np.zeros((0, 4))


def _pad_tables(split, e_multiple: int):
    """[layers] of (n, 4) f64 piece lists -> (L, 4, 1, EP) f32, zero
    padded to a multiple of ``e_multiple``."""
    e_max = max(1, max(s.shape[0] for s in split))
    ep = max(e_multiple, -(-e_max // e_multiple) * e_multiple)
    tab = np.zeros((len(split), 4, 1, ep), np.float32)
    for i, ps in enumerate(split):
        tab[i, :, 0, :ps.shape[0]] = ps.T.astype(np.float32)
    return tab


def affine_pieces(edge_tables, colors, matrices, e_multiple: int = 128,
                  split_margin: float = 1.0, min_splits=None,
                  return_splits: bool = False):
    """Split LOCAL-space edge tables into pieces row-bounded under every
    frame matrix.

    ``edge_tables``: [layers] of (E, 4) f32 local-space edges (one per
    draw/layer, shared by all frames).  ``colors``: [layers] straight RGBA.
    ``matrices``: (F, 6) device affines (a, b, c, d, e, f):
    x' = a x + c y + e,  y' = b x + d y + f — or (F, L, 6) PER-LAYER
    affines (each layer animates under its own matrix track).

    ``split_margin`` scales the per-edge |dy'| bound before the ceil
    (headroom so matrices up to margin-times as magnifying still validate
    against a cached table); ``min_splits``: optional [layers] of (E,) int
    floors; ``return_splits``: also return the per-edge split counts.

    Returns (tab, colors_arr[, splits]): tab (L, 4, 1, EP) f32 — x0, y0,
    x1, y1 local coordinates — and colors_arr (L, 4) f32.  Padding pieces
    are all-zero; they transform to degenerate points (dy' = 0) and
    contribute nothing for any matrix."""
    per_layer = _per_layer_mats(matrices, len(edge_tables))

    split = []
    splits_out = []
    for li, (edges, lm) in enumerate(zip(edge_tables, per_layer)):
        b = lm[:, 1][:, None]
        d = lm[:, 3][:, None]
        e = np.asarray(edges, np.float64)
        dx = (e[:, 2] - e[:, 0])[None, :]
        dy = (e[:, 3] - e[:, 1])[None, :]
        dyp = np.abs(b * dx + d * dy).max(axis=0)  # worst |dy'| per edge
        n = np.maximum(1, np.ceil(dyp * split_margin)).astype(int)
        if min_splits is not None and min_splits[li] is not None:
            n = np.maximum(n, np.asarray(min_splits[li], int))
        splits_out.append(n)
        split.append(_split_uniform(e, n))

    tab = _pad_tables(split, e_multiple)
    colors_arr = np.zeros((len(split), 4), np.float32)
    for i, color in enumerate(colors):
        colors_arr[i] = color
    if return_splits:
        return tab, colors_arr, splits_out
    return tab, colors_arr


def morph_affine_pieces(pairs, matrices, e_multiple: int = 128):
    """Split matched LOCAL-space morph edge-pair tables into pieces
    row-bounded under EVERY (frame matrix, ratio) combination.

    ``pairs``: list of (edges_start (E, 4), edges_end (E, 4), color_start,
    color_end) per draw (models.morph_geometry.morph_fill_edge_pairs with
    a local-space ctm).  |dy'(r, M)| is linear in r, so the bound is the
    max over the ratio ENDPOINTS and all frame matrices; uniform-t
    subdivision commutes with both the ratio lerp and the affine.

    Returns (tab_s, tab_e, colors_s, colors_e), each table shaped like
    affine_pieces output.  ``matrices`` may be (F, 6) or (F, L, 6)."""
    per_layer = _per_layer_mats(matrices, len(pairs))

    split_s, split_e = [], []
    for (es, ee, _cs, _ce), lm in zip(pairs, per_layer):
        b = lm[:, 1][:, None]
        d = lm[:, 3][:, None]
        es = np.asarray(es, np.float64)
        ee = np.asarray(ee, np.float64)
        dyp = np.zeros(es.shape[0])
        for tbl in (es, ee):  # ratio endpoints bound the linear lerp
            dx = (tbl[:, 2] - tbl[:, 0])[None, :]
            dy = (tbl[:, 3] - tbl[:, 1])[None, :]
            dyp = np.maximum(dyp, np.abs(b * dx + d * dy).max(axis=0))
        n = np.maximum(1, np.ceil(dyp)).astype(int)
        split_s.append(_split_uniform(es, n))
        split_e.append(_split_uniform(ee, n))

    tab_s = _pad_tables(split_s, e_multiple)
    tab_e = _pad_tables(split_e, e_multiple)
    colors_s = np.zeros((len(pairs), 4), np.float32)
    colors_e = np.zeros((len(pairs), 4), np.float32)
    for i, (_es, _ee, cs, ce) in enumerate(pairs):
        colors_s[i], colors_e[i] = cs, ce
    return tab_s, tab_e, colors_s, colors_e


def layer_piece_counts(tab, multiple: int = 256) -> tuple:
    """Per-layer REAL piece counts from a padded (L, 4, 1, EP) table
    (host numpy): index of the last piece with any nonzero coordinate,
    +1, rounded UP to ``multiple``.  Trailing degenerate pieces count as
    padding — they transform to points (dy' = 0) and contribute nothing.
    Pass as ``layer_counts`` to the sweep entries so layers far below the
    padded EP (the MAX over layers) skip their padding."""
    t = np.asarray(tab)
    nz = np.any(t != 0.0, axis=(1, 2))  # (L, EP)
    counts = []
    for lyr in range(t.shape[0]):
        idx = np.nonzero(nz[lyr])[0]
        n = int(idx[-1]) + 1 if idx.size else 0
        counts.append(-(-n // multiple) * multiple)
    return tuple(counts)


def _auto_bps(layers: int, hp: int, e_chunk: int, n_blocks: int) -> int:
    """The reference's column blocks per grid step for its frame and
    layer count (``transform.py:1261``): 4, 3 or 2 when they divide the
    block count of a short, shallow frame, else 1.  Here: the column bins
    one CUDA block of the compacted tiling walks in turn."""
    if layers <= 4 and hp <= 1280 and e_chunk <= 256 and n_blocks >= 4:
        cands = (4, 3, 2) if hp <= 640 else (3, 2)
        for b in cands:
            if n_blocks % b == 0:
                return b
    return 1


def _wblock_for(width: int, hp: int, lists: bool = True) -> int:
    """The reference's column-block width (``transform.py:1283``): 256
    for short frames, 128 for tall ones, halved towards 64 until there
    are 8 blocks (while the half stays a multiple of 8); tall frames with
    the chunk-list walk (``lists``) take 64 outright."""
    wp = -(-width // 8) * 8
    wb = min(wp, 256 if hp <= 640 else 128)
    while wb > 64 and wp // wb < 8 and (wb // 2) % 8 == 0:
        wb //= 2
    if lists and hp > 640 and wp // 64 >= 8:
        wb = min(wb, 64)
    return wb


def plan_compact_sweep(matrices, tab, height, width, e_chunk: int = 256,
                       wblock: int = None, blocks_per_step: int = None):
    """Host plan of the compacted sweep (numpy f64, the reference's
    ``plan_compact_sweep`` value for value): per layer, the most pieces
    that cross one column block in any frame, with an epsilon wide enough
    that the device's exact f32 test never finds more, rounded up to
    ``e_chunk``.  -> {"compact_counts", "wblock", "blocks_per_step"} to
    pass to ``render_affine_sweep``, or None when there is a single
    column block or nothing crosses."""
    t = np.asarray(tab, np.float64)  # (L, 4, 1, EP)
    layers = t.shape[0]
    per_layer = _per_layer_mats(matrices, layers)
    hp = -(-height // LANE) * LANE
    wp8 = -(-width // 8) * 8
    wblock = wblock or _wblock_for(width, hp, lists=False)
    bps = blocks_per_step or _auto_bps(
        layers, hp, e_chunk, -(-wp8 // wblock))
    wp = -(-wp8 // (wblock * bps)) * (wblock * bps)
    nb = wp // wblock
    if nb < 2:
        return None
    lo = (np.arange(nb, dtype=np.float64) * wblock)[:, None, None]
    s_pads = []
    for lyr in range(layers):
        lm = per_layer[lyr]  # (F, 6) f64
        x0l, y0l, x1l, y1l = t[lyr, :, 0]  # (EP,)
        a, b, c, d, e, f = (lm[:, k:k + 1] for k in range(6))
        x0 = a * x0l + c * y0l + e  # (F, EP)
        y0 = b * x0l + d * y0l + f
        x1 = a * x1l + c * y1l + e
        y1 = b * x1l + d * y1l + f
        pxmn = np.minimum(x0, x1)
        pxmx = np.maximum(x0, x1)
        # f32-vs-f64 transform divergence is ~|x| * 2^-22 worst case
        # across the 4-op chain; 1e-2 + 1e-5|x| is orders wider.
        eps = 1e-2 + 1e-5 * np.maximum(np.abs(pxmn), np.abs(pxmx))
        live = y0 != y1
        crossing = (live[None] & (pxmx[None] + eps[None] > lo)
                    & (pxmn[None] - 1.0 - eps[None] < lo + wblock))
        n = int(crossing.sum(axis=-1).max()) if crossing.size else 0
        s_pads.append(-(-n // e_chunk) * e_chunk if n else 0)
    if not any(s_pads):
        return None
    return {"compact_counts": tuple(s_pads), "wblock": wblock,
            "blocks_per_step": bps}


# ---------------------------------------------------------------------------
# Host half: paints
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SweepFieldSpec:
    """One sweep layer whose paint bakes to per-frame field planes."""

    layer: int
    paint: object        # ops.style.Paint (bitmap or linear-RGB gradient)
    invs: np.ndarray     # (F, 6) composed device->paint inverses


def sweep_paints(paints, matrices, allow_fields: bool = False):
    """Per-layer style Paints + per-frame device affines ->
    (KernelPaint tuple, (F, L, 6) grad_mats or None) for
    render_affine_sweep.

    Solid layers read per-layer/per-frame colors; sRGB LINEAR/FOCAL
    gradient layers evaluate in-kernel with a per-frame composed matrix:
    the gradient coordinate of device point p in frame f is
    ``paint.inv_matrix(M_f^{-1}(p))`` (SWF gradients move WITH the shape).

    ``allow_fields=False``: raises ValueError for paints the kernel can't
    evaluate in-line (bitmaps, linear-RGB gradients) and for singular
    frame matrices.  ``allow_fields=True``: those layers become
    ``KernelPaint.field(slot)`` entries and the return gains a third
    element — a list of ``SweepFieldSpec(layer, paint, invs)`` to feed
    ``bake_sweep_fields``."""
    from ..models.geometry import Affine
    from . import style as style_ops

    per_layer = _per_layer_mats(matrices, len(paints))
    f_count = per_layer[0].shape[0]
    kps = []
    gm = np.zeros((f_count, len(paints), 6), np.float32)
    any_grad = False
    field_specs = []

    def composed_invs(p, li):
        inv = Affine(*p.inv_matrix)
        out = np.zeros((f_count, 6), np.float32)
        for f in range(f_count):
            frame_inv = Affine(*per_layer[li][f]).inverse()
            out[f] = inv.then(frame_inv).as_tuple()
        return out

    for li, p in enumerate(paints):
        if p.kind == style_ops.PAINT_SOLID:
            kps.append(KernelPaint.color())
            continue
        if (p.kind not in (style_ops.PAINT_LINEAR, style_ops.PAINT_FOCAL)
                or p.color_space == "linear-rgb"):
            if not allow_fields:
                raise ValueError(
                    "sweep paints must be solid or sRGB linear/focal "
                    f"gradients, got kind {p.kind}/{p.color_space}")
            kps.append(KernelPaint.field(len(field_specs)))
            field_specs.append(
                SweepFieldSpec(li, p, composed_invs(p, li)))
            continue
        any_grad = True
        kind = (KPAINT_LINEAR if p.kind == style_ops.PAINT_LINEAR
                else KPAINT_FOCAL)
        kps.append(KernelPaint.gradient(
            kind, (), p.stop_ratios, p.stop_colors,
            focal=p.focal_point, spread=p.spread))
        gm[:, li] = composed_invs(p, li)
    if allow_fields:
        return tuple(kps), (gm if any_grad else None), field_specs
    return tuple(kps), (gm if any_grad else None)


def bake_sweep_fields(field_specs, height: int, width: int,
                      stop_tracks=None, frame_chunk: int = 8,
                      device=None) -> torch.Tensor:
    """SweepFieldSpecs -> (NF, F, H, W, 4) f32 straight-RGBA field planes
    on ``device`` (the card unless the caller asks for the CPU): the SAME
    sampling math as the per-frame styled path, so host work does not
    grow with the frame count.

    Bitmap specs bake their axis-aligned frames through the separable
    weights ``style.paint_field`` uses for them and every other frame
    through the texfield kernel (``ops.texfield.bitmap_field_planes``, one
    launch for all such frames); a mixed track (a rotation through 0)
    bakes both and interleaves them along the frame axis.  Gradient specs
    evaluate ``style.paint_field_traced`` ``frame_chunk`` frames at a
    time.

    ``stop_tracks``: optional [NF] list of (F, K, 4) per-frame stop-color
    overrides (linear-RGB gradient fades); None entries keep static stops.
    A spec whose composed inverse repeats across frames bakes each UNIQUE
    matrix once and broadcasts (byte-equal rows give byte-equal planes)."""
    from . import style as style_ops
    from .texfield import bitmap_field_planes

    device = resolve_device(device)
    outs = []
    for si, spec in enumerate(field_specs):
        track = None if stop_tracks is None else stop_tracks[si]
        p = spec.paint
        invs_np = np.asarray(spec.invs, np.float32)
        if track is None and invs_np.shape[0] > 1:
            uniq, inv_idx = np.unique(invs_np, axis=0, return_inverse=True)
            if uniq.shape[0] < invs_np.shape[0]:
                sub = bake_sweep_fields(
                    [SweepFieldSpec(spec.layer, p, uniq)], height, width,
                    frame_chunk=frame_chunk, device=device)[0]
                outs.append(sub.index_select(0, torch.as_tensor(
                    inv_idx.reshape(-1), device=device)))
                continue
        n_frames = invs_np.shape[0]
        if p.kind == style_ops.PAINT_BITMAP:
            sep = style_ops.separable_frames_mask(p, invs_np)
            if sep.all():
                outs.append(style_ops.separable_field_stack(
                    p, invs_np, height, width, device=device))
                continue
            rest = np.nonzero(~sep)[0]
            sampled = bitmap_field_planes(
                p.image, invs_np[rest], height, width,
                supersample=max(1, int(p.supersample)),
                repeating=p.repeating, smoothed=p.smoothed,
                edge_mode=p.edge_mode, device=device)
            if not sep.any():
                outs.append(sampled)
                continue
            out = torch.empty((n_frames, height, width, 4),
                              dtype=torch.float32, device=device)
            out[torch.as_tensor(rest, device=device)] = sampled
            idx = np.nonzero(sep)[0]
            out[torch.as_tensor(idx, device=device)] = (
                style_ops.separable_field_stack(p, invs_np[idx], height,
                                                width, device=device))
            outs.append(out)
            continue
        invs = torch.as_tensor(invs_np, device=device)
        stops = (None if track is None else torch.as_tensor(
            np.asarray(track, np.float32), device=device))
        out = torch.empty((n_frames, height, width, 4), dtype=torch.float32,
                          device=device)
        for f0 in range(0, n_frames, frame_chunk):
            sl = slice(f0, f0 + frame_chunk)
            out[sl] = style_ops.paint_field_traced(
                p, invs[sl], height, width,
                stop_colors=None if stops is None else stops[sl])
        outs.append(out)
    return outs[0][None] if len(outs) == 1 else torch.stack(outs, dim=0)


# ---------------------------------------------------------------------------
# Device half: the compacted sweep's pre-pass (plain torch on the device)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompactTables:
    """What ``compact_pre`` gathers for the compacted sweep kernel."""

    tab: torch.Tensor       # (F, NB, L, 4, cap) f32 device-space pieces
    counts: torch.Tensor    # (F, NB, L) int32 pieces gathered per bin
    crossing: torch.Tensor  # (F, NB, L) int32 pieces crossing the bin
    bounds: torch.Tensor    # (F, NB, L, cap / 16, 2) f32 chunk row bounds
    prefix: torch.Tensor    # (F, L, NB, H) int64 32.32 dy of left pieces
    bin_w: int

    @property
    def cap(self) -> int:
        return self.tab.shape[-1]


def _to_fixed(v):
    """f32 -> 32.32 fixed point, half to even (the kernels' to_fixed)."""
    return torch.round(v.double() * 2.0 ** 32).long()


def compact_pre(matrices, tab, compact_counts, wblock: int, height: int,
                width: int) -> CompactTables:
    """The compacted sweep's pre-pass (counterpart of the reference's
    XLA ``_compact_pre``, ``transform.py:287``), in plain PyTorch on the
    tensors' device.

    Per frame the pieces go to device pixels in the sweep kernel's own
    operation order (op by op, no multiply-add contracts), so they are
    bit for bit what the column kernel transforms.  Per column bin b of
    ``wblock`` columns, [lo, lo + wblock) with lo = b * wblock:

    * a live piece (y0 != y1) is LEFT of the bin when its extent ends at
      or before lo (``pxmx <= lo``, the reference's test) and so do its
      row spans ``xmn``/``xmx`` of the rows it touches (the kernel's own
      values: x0 + t * dx may round an ulp past max(x0, x1));
    * it is RIGHT of the bin when ``pxmn - 1 >= lo + wblock`` and its row
      spans start there too; every other live piece CROSSES the bin;
    * crossing pieces fill the bin's slots of ``compact_counts[l]`` in
      table order; slots past the capacity are dropped (the plan's
      capacities cover the crossing counts, ``crossing`` reports them);
    * the prefix plane holds, per (frame, layer, bin, row), the 32.32
      fixed-point sum of dy of the left pieces' rows: what those pieces
      add at every column of the bin in the column kernel.

    The reference gathers through a one-hot matrix product split into 3
    bf16 parts and keeps the prefix in f32 (its matrix unit); here the
    gather indexes and the prefix stays in the sweep's fixed point, so
    the compacted frames equal the column kernel's."""
    dev = tab.device
    frames, layers, ep = matrices.shape[0], tab.shape[0], tab.shape[-1]
    if len(compact_counts) != layers:
        raise ValueError(
            f"{len(compact_counts)} compact_counts for {layers} layers")
    nb = -(-width // wblock)
    cap = max(SWEEP_CHUNK,
              -(-max(int(c) for c in compact_counts) // SWEEP_CHUNK)
              * SWEEP_CHUNK)
    m3 = (matrices if matrices.ndim == 3
          else matrices[:, None, :].expand(frames, layers, 6))
    x0l, y0l, x1l, y1l = (tab[:, ch, 0] for ch in range(4))   # (L, EP)
    a, b, c, d, e, g = (m3[..., k, None] for k in range(6))   # (F, L, 1)
    x0 = a * x0l + c * y0l + e                                # (F, L, EP)
    y0 = b * x0l + d * y0l + g
    x1 = a * x1l + c * y1l + e
    y1 = b * x1l + d * y1l + g

    inf = torch.full_like(x0, float("inf"))
    span_mx, span_mn = -inf, inf
    rows = []
    rowbase = torch.floor(torch.minimum(y0, y1))
    for k in (0.0, 1.0):
        py = rowbase + k
        dy, xmn, xmx = edge_row_span(x0, y0, x1, y1, py)
        hit = dy != 0.0
        span_mx = torch.where(hit, torch.maximum(span_mx, xmx), span_mx)
        span_mn = torch.where(hit, torch.minimum(span_mn, xmn), span_mn)
        rows.append((dy, py))
    pxmn = torch.minimum(x0, x1)
    pxmx = torch.maximum(x0, x1)
    live = y0 != y1
    lo = torch.arange(nb, dtype=torch.float32, device=dev) * float(wblock)
    hi = lo + float(wblock)
    # Left of bins first_left.., right of bins ..first_cross - 1.
    first_left = torch.searchsorted(
        lo, torch.maximum(pxmx, span_mx).contiguous(), side="left")
    first_cross = torch.searchsorted(
        hi, torch.minimum(pxmn - 1.0, span_mn).contiguous(), side="right")

    pre = torch.zeros((frames, layers, nb, height), dtype=torch.int64,
                      device=dev)
    fl = (torch.arange(frames, device=dev)[:, None, None] * layers
          + torch.arange(layers, device=dev)[None, :, None])
    for dy, py in rows:
        ok = live & (first_left < nb) & (dy != 0.0) & (py >= 0.0) & (
            py < float(height))
        flat = (fl * nb + first_left) * height + torch.clamp(
            py, 0.0, height - 1.0).long()
        pre.view(-1).index_add_(0, flat[ok], _to_fixed(dy)[ok])
    prefix = torch.cumsum(pre, dim=2)

    ctab = torch.zeros((frames, nb, layers, 4, cap), dtype=torch.float32,
                       device=dev)
    crossing = torch.zeros((frames, nb, layers), dtype=torch.int32,
                           device=dev)
    caps = torch.tensor([int(c) for c in compact_counts], dtype=torch.int32,
                        device=dev)
    coords = torch.stack([x0, y0, x1, y1], dim=2)   # (F, L, 4, EP)
    bins = torch.arange(nb, device=dev)[:, None]
    step = max(1, (1 << 25) // max(1, layers * nb * ep))
    for f0 in range(0, frames, step):
        sl = slice(f0, f0 + step)
        cross = (live[sl, :, None, :] & (bins >= first_cross[sl, :, None, :])
                 & (bins < first_left[sl, :, None, :]))    # (f, L, NB, EP)
        pos = torch.cumsum(cross, dim=-1, dtype=torch.int32) - 1
        crossing[sl] = cross.sum(dim=-1, dtype=torch.int32).permute(0, 2, 1)
        keep = cross & (pos < caps[None, :, None, None])
        fi, li, bi, pi = keep.nonzero(as_tuple=True)
        slot = pos[fi, li, bi, pi].long()
        fi = fi + f0
        vals = coords[fi, li, :, pi]                        # (K, 4)
        base = ((fi * nb + bi) * layers + li) * 4
        flat_tab = ctab.view(-1)
        for ch in range(4):
            flat_tab[(base + ch) * cap + slot] = vals[:, ch]
    counts = torch.minimum(crossing, caps)

    # Row bounds of each 16-slot chunk of gathered pieces (the walk's skip).
    rb = torch.floor(torch.minimum(ctab[:, :, :, 1], ctab[:, :, :, 3]))
    filled = (torch.arange(cap, device=dev) < counts[..., None])
    shape = (frames, nb, layers, cap // SWEEP_CHUNK, SWEEP_CHUNK)
    bounds = torch.stack([
        torch.where(filled, rb, torch.full_like(rb, 3.0e38)).view(shape)
        .amin(dim=-1),
        torch.where(filled, rb, torch.full_like(rb, -3.0e38)).view(shape)
        .amax(dim=-1)], dim=-1).contiguous()
    return CompactTables(ctab, counts.contiguous(), crossing, bounds,
                         prefix.contiguous(), int(wblock))


# ---------------------------------------------------------------------------
# Device half: the plain versions
# ---------------------------------------------------------------------------


def _frame_paint_rows(pflt_t, paints, grad_mats, stop_colors, f: int):
    """This frame's paint records: the per-layer table with the frame's
    composed gradient matrix and, with per-frame stops, its first stop and
    colour steps (f32 differences) written in — what the kernel does in
    shared memory."""
    rows = pflt_t.clone()
    for lyr, p in enumerate(paints):
        if p.kind not in _GRADIENT_KINDS:
            continue
        rows[lyr, _P_INV:_P_INV + 6] = grad_mats[f, lyr]
        if stop_colors is not None:
            k = len(p.stop_ratios)
            sc = stop_colors[f, lyr, :k]
            rows[lyr, _P_C0:_P_C0 + 4] = sc[0]
            rows[lyr, _P_DC:_P_DC + 4 * (k - 1)] = (sc[1:] - sc[:-1]
                                                    ).reshape(-1)
    return rows


def _shift_origin(x_shift):
    """The tile-shard origin ``x_shift`` (None, a number, or a one-element
    array or tensor) -> None or a whole column as an int: the port places
    shards on whole columns, where the grid's f32 sums are exact."""
    if x_shift is None:
        return None
    v = (x_shift.reshape(-1) if torch.is_tensor(x_shift)
         else np.asarray(x_shift, np.float64).reshape(-1))
    if v.shape[0] != 1:
        raise ValueError(f"x_shift: one origin, got {v.shape[0]} values")
    v = float(v[0])
    if not v.is_integer() or abs(v) >= 2 ** 24:
        raise ValueError(f"x_shift={v}: the origin is a whole column "
                         "below 2^24")
    return int(v)


def _grid(width: int, x_shift, device):
    """(1, width) f32 pixel columns on the global grid: column c is
    c + x_shift (an exact f32 add of whole numbers)."""
    px = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    return px if not x_shift else px + float(x_shift)


def _winding_fixed(x0, y0, x1, y1, height: int, px):
    """Device-space pieces (n,) x4 -> (H, W') int64 32.32 winding of one
    layer at the columns ``px`` (1, W').

    The arithmetic is the kernels', so both agree bit for bit: per piece
    and touched row, pixels left of floor(xmn) get 0, pixels from
    ceil(xmx) on get dy, the columns between get the trapezoid ramp; the
    per-pixel sum over pieces is an exact fixed-point sum.  The reference
    sums the same f32 ramps in f32 (an MXU product per piece chunk plus a
    prefix plane), so it agrees to f32 rounding."""
    acc = torch.zeros((height, px.shape[1]), dtype=torch.int64,
                      device=px.device)
    rowbase = torch.floor(torch.minimum(y0, y1))
    zero = torch.zeros((), dtype=torch.float32, device=px.device)
    for k in (0.0, 1.0):
        py = rowbase + k
        dy, xmn, xmx = (v[:, None]
                        for v in edge_row_span(x0, y0, x1, y1, py))
        v = torch.where(px < torch.ceil(xmx), span_ramp(dy, xmn, xmx, px),
                        dy)
        v = torch.where(px < torch.floor(xmn), zero, v)
        q = _to_fixed(v)
        inside = (py >= 0.0) & (py < float(height))
        q = torch.where(inside[:, None], q, torch.zeros_like(q))
        acc.index_add_(0, torch.clamp(py, 0.0, height - 1.0).long(), q)
    return acc


def _from_fixed(acc):
    """32.32 fixed point -> f32, rounded once."""
    return (acc.double() * 2.0 ** -32).float()


def _frame_resolver(colors, colors_e, ratios, height: int, width: int,
                    paints=None, grad_mats=None, stop_colors=None,
                    fields=None, x_shift=None):
    """-> resolve(f, covs): frame f's per-layer coverages -> (H, W) int32
    packed RGBA through the paints and the shared composite tail
    (gradients read the global grid, fields the frame's columns)."""
    dev = colors.device
    morph = colors_e is not None
    if paints is not None:
        pint, pflt = paint_tables(tuple(paints))
        pflt_t = torch.as_tensor(pflt, device=dev)
        pxc = _grid(width, x_shift, dev) + 0.5
        pyc = torch.arange(height, dtype=torch.float32,
                           device=dev)[:, None] + 0.5

    def resolve(f, covs):
        if morph:
            t = ratios[f]
            omt = 1.0 - t
        if paints is not None:
            rows = _frame_paint_rows(pflt_t, paints, grad_mats, stop_colors,
                                     f)
        t_cache = {}

        def read_color(lyr, ch):
            if morph:
                return omt * colors[lyr, ch] + t * colors_e[lyr, ch]
            kind = KPAINT_COLOR if paints is None else paints[lyr].kind
            if kind == KPAINT_FIELD:
                return fields[paints[lyr].slot, f, :, :, ch]
            if kind in _GRADIENT_KINDS:
                if lyr not in t_cache:
                    t_cache[lyr] = _grad_t_plain(pint[lyr], rows[lyr], pxc,
                                                 pyc)
                return _grad_ramp_plain(pint[lyr], rows[lyr], t_cache[lyr],
                                        ch)
            return colors[f, lyr, ch] if colors.ndim == 3 else colors[lyr, ch]

        return _composite_pack(covs, read_color)

    return resolve


def sweep_plain(mats, tab_s, tab_e, ratios, colors, colors_e, height: int,
                width: int, rules, counts, paints=None, grad_mats=None,
                stop_colors=None, fields=None, x_shift=None):
    """Plain PyTorch version of the sweep kernels, every tiling -> (F, H,
    W) int32 packed RGBA.  ``mats`` None is the morph ratio sweep (no
    affine); ``tab_e`` / ``ratios`` / ``colors_e`` None is the affine
    sweep (no lerp).  ``rules`` and ``counts`` are per-layer tuples;
    ``paints`` None means every layer is a solid colour; ``x_shift`` (an
    int) the global column of frame column 0."""
    dev = tab_s.device
    layers = tab_s.shape[0]
    frames = (mats if mats is not None else ratios).shape[0]
    morph = tab_e is not None
    px = _grid(width, x_shift, dev)
    resolve = _frame_resolver(colors, colors_e, ratios, height, width,
                              paints, grad_mats, stop_colors, fields,
                              x_shift)
    out = torch.empty((frames, height, width), dtype=torch.int32, device=dev)
    for f in range(frames):
        if morph:
            t = ratios[f]
            omt = 1.0 - t
        covs = []
        for lyr in range(layers):
            n = min(int(counts[lyr]), tab_s.shape[-1])
            x0, y0, x1, y1 = (tab_s[lyr, ch, 0, :n] for ch in range(4))
            if morph:  # ratio lerp BEFORE the frame transform
                x0, y0, x1, y1 = (
                    omt * v + t * tab_e[lyr, ch, 0, :n]
                    for ch, v in enumerate((x0, y0, x1, y1)))
            if mats is not None:
                a, b, c, d, e, g = (mats[f, lyr] if mats.ndim == 3
                                    else mats[f])
                x0, y0, x1, y1 = (a * x0 + c * y0 + e, b * x0 + d * y0 + g,
                                  a * x1 + c * y1 + e, b * x1 + d * y1 + g)
            covs.append(_fill_cov(_from_fixed(
                _winding_fixed(x0, y0, x1, y1, height, px)), rules[lyr]))
        out[f] = resolve(f, covs)
    return out


def sweep_compact_plain(tables: CompactTables, colors, height: int,
                        width: int, rules, paints=None, grad_mats=None,
                        stop_colors=None, fields=None):
    """Plain PyTorch version of the compacted sweep kernel on
    ``compact_pre``'s tables -> (F, H, W) int32 packed RGBA: in each bin
    a row starts from the prefix plane and adds the 32.32 ramps of the
    bin's gathered pieces at the bin's columns only; then the paints and
    the composite tail of ``sweep_plain``."""
    dev = tables.tab.device
    frames, nb, layers = tables.counts.shape
    wb = tables.bin_w
    counts = tables.counts.cpu()
    px = torch.arange(nb * wb, dtype=torch.float32, device=dev)[None, :]
    resolve = _frame_resolver(colors, None, None, height, width, paints,
                              grad_mats, stop_colors, fields)
    out = torch.empty((frames, height, width), dtype=torch.int32, device=dev)
    for f in range(frames):
        covs = []
        for lyr in range(layers):
            acc = torch.empty((height, nb * wb), dtype=torch.int64,
                              device=dev)
            for b in range(nb):
                cols = slice(b * wb, (b + 1) * wb)
                acc[:, cols] = tables.prefix[f, lyr, b][:, None]
                n = int(counts[f, b, lyr])
                if n:
                    acc[:, cols] += _winding_fixed(
                        *(tables.tab[f, b, lyr, ch, :n] for ch in range(4)),
                        height, px[:, cols])
            covs.append(_fill_cov(_from_fixed(acc[:, :width]), rules[lyr]))
        out[f] = resolve(f, covs)
    return out


# ---------------------------------------------------------------------------
# Device half: launch and wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _device_counts(counts, device):
    return torch.tensor(counts, dtype=torch.int32, device=device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_sweep(mats, tab_s, tab_e, ratios, colors, colors_e, height: int,
                  width: int, rules, counts, paints=None, grad_mats=None,
                  stop_colors=None, fields=None, rows=False, x_shift=None):
    """Launch ``swf_sweep`` (csrc/sweep.cu; with ``rows`` the row-band
    ``swf_sweep_rows``, with ``x_shift`` ``swf_sweep_shift``) on the
    tensors' card; same arguments and result as ``sweep_plain``.  Raises
    if the library does not build or the launch is refused."""
    from . import cuda_lib

    given = [t for t in (mats, tab_s, tab_e, ratios, colors, colors_e,
                         grad_mats, stop_colors, fields) if t is not None]
    if not all(t.is_contiguous() for t in given):
        raise ValueError("kernel inputs must be contiguous")
    dev = tab_s.device
    layers, _, _, ep = tab_s.shape
    frames = (mats if mats is not None else ratios).shape[0]
    mode = 0 if tab_e is None else (1 if mats is not None else 2)
    rules_t, pint_t, pflt_t = _device_tables(
        tuple(rules), None if paints is None else tuple(paints), dev)
    counts_t = _device_counts(tuple(int(c) for c in counts), dev)
    out = torch.empty((frames, height, width), dtype=torch.int32, device=dev)
    # Scratch of the pre-pass: row bounds of every 16-piece chunk.
    bounds = torch.empty((frames, layers, -(-ep // FINE_CHUNK), 2),
                         dtype=torch.float32, device=dev)
    lib = cuda_lib.load("swfsweep")
    args = (mode, _ptr(mats), _ptr(tab_s), _ptr(tab_e), _ptr(ratios),
            _ptr(colors), _ptr(colors_e), _ptr(counts_t), _ptr(rules_t),
            _ptr(pint_t), _ptr(pflt_t), _ptr(grad_mats), _ptr(stop_colors),
            _ptr(fields), _ptr(bounds), _ptr(out), frames, layers, ep,
            height, width, int(mats is not None and mats.ndim == 3),
            int(colors.ndim == 3),
            0 if stop_colors is None else stop_colors.shape[2])
    stream = torch.cuda.current_stream(dev).cuda_stream
    if rows:
        err = lib.swf_sweep_rows(*args, stream)
    elif x_shift:
        err = lib.swf_sweep_shift(*args, x_shift, stream)
    else:   # swf_sweep_shift at 0, under the entry older builds share
        err = lib.swf_sweep(*args, stream)
    if err != 0:
        raise RuntimeError(f"sweep kernel launch failed: CUDA error {err}")
    return out


def _launch_sweep_compact(tables: CompactTables, colors, height: int,
                          width: int, rules, bins_per_block: int,
                          paints=None, grad_mats=None, stop_colors=None,
                          fields=None):
    """Launch ``swf_sweep_compact`` (csrc/sweep.cu) on the tables' card;
    same result as ``sweep_compact_plain``."""
    from . import cuda_lib

    given = [t for t in (colors, grad_mats, stop_colors, fields,
                         tables.tab, tables.counts, tables.bounds,
                         tables.prefix) if t is not None]
    if not all(t.is_contiguous() for t in given):
        raise ValueError("kernel inputs must be contiguous")
    dev = tables.tab.device
    frames, nb, layers = tables.counts.shape
    rules_t, pint_t, pflt_t = _device_tables(
        tuple(rules), None if paints is None else tuple(paints), dev)
    out = torch.empty((frames, height, width), dtype=torch.int32, device=dev)
    err = cuda_lib.load("swfsweep").swf_sweep_compact(
        _ptr(colors), _ptr(rules_t), _ptr(pint_t), _ptr(pflt_t),
        _ptr(grad_mats), _ptr(stop_colors), _ptr(fields), _ptr(tables.tab),
        _ptr(tables.counts), _ptr(tables.bounds), _ptr(tables.prefix),
        _ptr(out), frames, layers, height, width, tables.cap, nb,
        tables.bin_w, bins_per_block, int(colors.ndim == 3),
        0 if stop_colors is None else stop_colors.shape[2],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"compacted sweep kernel launch failed: CUDA error {err}")
    return out


def _check_sweep(tensors: dict, frames: int, layers: int, ep: int):
    """Shapes, types and devices of a sweep call -> the common device."""
    devices = {t.device for t, _ in tensors.values() if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devices))}")
    for name, (t, shapes) in tensors.items():
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) not in shapes:
            raise ValueError(f"{name}: expected float32 "
                             f"{' or '.join(map(str, shapes))}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not 1 <= layers <= MAX_KERNEL_LAYERS:
        raise ValueError(
            f"{layers} layers: one sweep launch composites 1.."
            f"{MAX_KERNEL_LAYERS}; the renderer sends deeper draw lists to "
            "the fused route's chained passes")
    if not 1 <= frames <= 65535:
        raise ValueError(f"{frames} frames: one launch takes 1..65535")
    if ep < 1:
        raise ValueError("empty piece table")
    return devices.pop()


def _layer_counts(layer_counts, layers: int, ep: int):
    if layer_counts is None:
        return (ep,) * layers
    if len(layer_counts) != layers:
        raise ValueError(
            f"{len(layer_counts)} layer_counts for {layers} layers")
    return tuple(min(int(c), ep) for c in layer_counts)


def _check_wchunk(wchunk):
    if wchunk not in ROW_CHUNKS:
        raise ValueError(f"wchunk={wchunk}: the row-band sweep takes column "
                         f"chunks of {' or '.join(map(str, ROW_CHUNKS))}")


def _count(counter, attr: str):
    setattr(counter, attr, getattr(counter, attr) + 1)


def _run(launch_counter, dev, *args, attr="launches", rows=False,
         x_shift=None, **kwargs):
    """The column (or, with ``rows``, row-band) sweep, at the column
    origin ``x_shift``: the plain version for CPU tensors, else the
    kernel, counted on ``launch_counter.attr``."""
    if dev.type == "cpu":
        return sweep_plain(*args, x_shift=x_shift, **kwargs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = _launch_sweep(*args, rows=rows, x_shift=x_shift, **kwargs)
    _count(launch_counter, attr)
    return out


def _run_compact(dev, matrices, tab, colors, height, width, rules,
                 compact_counts, wblock, bins_per_block, **paint_kwargs):
    """compact_pre, then the compacted kernel (counted on
    ``render_affine_sweep.compact_launches``) or, for CPU tensors, its
    plain version."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    tables = compact_pre(matrices, tab, compact_counts, wblock, height,
                         width)
    if dev.type == "cpu":
        return sweep_compact_plain(tables, colors, height, width, rules,
                                   **paint_kwargs)
    out = _launch_sweep_compact(tables, colors, height, width, rules,
                                bins_per_block, **paint_kwargs)
    _count(render_affine_sweep, "compact_launches")
    return out


def render_affine_sweep(matrices, tab, colors, height: int, width: int,
                        fill_rule=FILL_RULE_NONZERO, layer_counts=None,
                        paints=None, grad_mats=None, stop_colors=None,
                        fields=None, row_grid=None, compact_counts=None,
                        wblock=None, blocks_per_step=None, wchunk=256,
                        x_shift=None):
    """Rasterize one shape set under every frame's affine fully on device
    -> (F, H, W) int32 packed RGBA (counterpart of the TPU
    ``render_affine_sweep``; view with ops.morph.morph_frames_to_u8).

    Kernel: replaces ``_xform_kernel`` (swf_renderer_tpu/ops/
    transform.py:586).  A pre-pass writes the row bounds of every
    16-piece chunk; then one CUDA block per (128-column x row-band tile,
    frame) walks the chunks that reach its rows, scatters ramp
    differences in 32.32 fixed point into shared memory (a piece left of
    the tile into its row's carry), scans rows a warp each and resolves;
    a tile whose windings are all 0 writes zeros (csrc/sweep_device.cuh
    tile_sweep_block).  Bound on the H100: bytes (the packed output, plus
    field planes when a layer reads them).  On a card it equals
    ``sweep_plain`` word for word (chip_smoke.py).

    ``row_grid=True`` takes the row-band tiling (replaces
    ``_xform_kernel_rows``, transform.py:1012): one block per (band of
    rows, frame) sweeps the width in 256-column chunks, carrying each
    row's exact winding (``wchunk``, 128 or 256, is checked and leaves
    the frames as they are); counted on
    ``render_affine_sweep.row_launches``.  ``compact_counts`` (with
    ``wblock`` and ``blocks_per_step``: pass ``**plan_compact_sweep(...)``)
    takes the compacted tiling (replaces ``_xform_kernel(compact=True)``):
    ``compact_pre`` gathers each (frame, column bin, layer)'s crossing
    pieces and the prefix of the pieces left of it, and one block per
    (``blocks_per_step`` bins, row band, frame) walks only those through
    the column tiling's steps, the prefix seeding each row's carry
    (csrc/sweep_device.cuh bin_sweep_block); counted on
    ``render_affine_sweep.compact_launches``.  Both give the column
    tiling's frames byte for byte.

    ``matrices``: (F, 6) or per-layer (F, L, 6) f32 device affines;
    ``tab``: (L, 4, 1, EP) f32 local pieces (affine_pieces); ``colors``:
    (L, 4) or per-frame (F, L, 4) straight RGBA; ``fill_rule``: int or
    per-layer tuple; ``layer_counts``: per-layer real piece counts
    (layer_piece_counts).

    ``paints``: optional per-layer KernelPaint tuple — LINEAR/FOCAL
    gradient layers evaluate IN-KERNEL under ``grad_mats`` (F, L, 6), each
    frame's composed device->gradient affine (rows of other layers are
    ignored).  ``stop_colors`` (F, L, K, 4) optionally overrides every
    gradient layer's stop COLORS per frame (color-transform fades);
    ratios stay static.  ``fields`` (NF, F, H, W, 4) carries baked
    straight-RGBA planes for ``KernelPaint.field(slot)`` layers
    (bake_sweep_fields); the row-band tiling takes none, as the
    reference's.  ``x_shift``: the tile-shard origin (the module
    docstring), column tiling only; ``fields`` are then the shard's
    columns."""
    x_shift = _shift_origin(x_shift)
    if x_shift is not None and (compact_counts is not None or row_grid):
        raise ValueError(
            "x_shift needs the column-grid non-compact sweep kernel")
    if matrices.ndim not in (2, 3):
        raise ValueError("matrices must be (F, 6) or (F, L, 6)")
    frames = matrices.shape[0]
    layers, ep = tab.shape[0], tab.shape[-1]
    fill_rule = normalize_fill_rule(fill_rule, layers)
    if paints is not None and all(p.kind == KPAINT_COLOR for p in paints):
        paints = None  # pure-solid tuples take the solid instantiation
    n_fields = 0
    if paints is not None:
        paints = tuple(paints)
        if len(paints) != layers:
            raise ValueError(f"{len(paints)} paints for {layers} layers")
        paint_tables(paints)  # validates stop counts
        n_fields = 1 + max((p.slot for p in paints
                            if p.kind == KPAINT_FIELD), default=-1)
        if n_fields and (fields is None or tuple(fields.shape) != (
                n_fields, frames, height, width, 4)):
            raise ValueError(
                f"field paints need ({n_fields}, {frames}, {height}, "
                f"{width}, 4) fields, got "
                f"{None if fields is None else tuple(fields.shape)}")
        any_grad = any(p.kind in _GRADIENT_KINDS for p in paints)
        if any_grad and grad_mats is None:
            raise ValueError("gradient paints need (F, L, 6) grad_mats")
        if not any_grad:
            grad_mats = None
    if fields is not None and n_fields == 0:
        raise ValueError("fields passed without any FIELD paint")
    if stop_colors is not None:
        if paints is None:
            raise ValueError("stop_colors requires gradient paints")
        if (stop_colors.ndim != 4
                or tuple(stop_colors.shape[:2]) != (frames, layers)
                or stop_colors.shape[3] != 4):
            raise ValueError(f"stop_colors must be (F, L, K, 4), got "
                             f"{tuple(stop_colors.shape)}")
        k_need = max((len(p.stop_ratios) for p in paints
                      if p.kind != KPAINT_COLOR), default=0)
        if stop_colors.shape[2] < k_need:
            raise ValueError(
                f"stop_colors K={stop_colors.shape[2]} < the largest "
                f"gradient stop count {k_need}")
    dev = _check_sweep({
        "matrices": (matrices, ((frames, 6), (frames, layers, 6))),
        "tab": (tab, ((layers, 4, 1, ep),)),
        "colors": (colors, ((layers, 4), (frames, layers, 4))),
        "grad_mats": (grad_mats, ((frames, layers, 6),)),
        "stop_colors": (stop_colors, (tuple(stop_colors.shape),)
                        if stop_colors is not None else ()),
        "fields": (fields, ((n_fields, frames, height, width, 4),)),
    }, frames, layers, ep)
    rules = layer_rules(fill_rule, layers)
    counts = _layer_counts(layer_counts, layers, ep)
    paint_kwargs = dict(paints=paints, grad_mats=grad_mats,
                        stop_colors=stop_colors, fields=fields)
    if compact_counts is not None:
        hp = -(-height // LANE) * LANE
        wp8 = -(-width // 8) * 8
        wblock = wblock or _wblock_for(width, hp, lists=False)
        if not 1 <= wblock <= MAX_BIN_W:
            raise ValueError(f"wblock={wblock}: the compacted sweep takes "
                             f"column bins of 1..{MAX_BIN_W}")
        bps = blocks_per_step or (1 if n_fields else _auto_bps(
            layers, hp, 256, -(-wp8 // wblock)))
        return _run_compact(dev, matrices, tab, colors, height, width,
                            rules, compact_counts, wblock, bps,
                            **paint_kwargs)
    if wblock is not None or blocks_per_step is not None:
        raise ValueError("wblock= and blocks_per_step= tile the compacted "
                         "sweep (compact_counts=); the column tiling's "
                         "tiles are 128 columns wide")
    if row_grid:
        if n_fields:
            raise ValueError("field paints need the column-grid sweep "
                             "kernel (row_grid=False)")
        _check_wchunk(wchunk)
        return _run(render_affine_sweep, dev, matrices, tab, None, None,
                    colors, None, height, width, rules, counts,
                    attr="row_launches", rows=True, **paint_kwargs)
    return _run(render_affine_sweep, dev, matrices, tab, None, None, colors,
                None, height, width, rules, counts, x_shift=x_shift,
                **paint_kwargs)


render_affine_sweep.launches = 0
render_affine_sweep.row_launches = 0
render_affine_sweep.compact_launches = 0


def render_morph_affine_sweep(matrices, ratios, tab_s, tab_e, colors_s,
                              colors_e, height: int, width: int,
                              fill_rule=FILL_RULE_NONZERO, layer_counts=None,
                              row_grid=None, wchunk=256, x_shift=None):
    """Combined MORPH + TRANSFORM sweep -> (F, H, W) int32 packed RGBA
    (counterpart of the TPU ``render_morph_affine_sweep``): per frame,
    lerp the local piece tables and the colours by the frame's ratio,
    apply the frame's affine, rasterize.  Solid fills only (stroke
    outlines aren't linear in the ratio).

    Kernel: replaces ``_xform_kernel(morph=True)`` (swf_renderer_tpu/
    ops/transform.py:586 under the pallas_call at :1875): the affine
    sweep's kernel (csrc/sweep_device.cuh tile_sweep_block) with the
    ratio lerp in front of the transform, and the colours lerped in the
    set-up.  Same bound; on a card it equals ``sweep_plain`` word for
    word (chip_smoke.py).  ``row_grid=True`` takes the row-band
    tiling (``_xform_kernel_rows(morph=True)``, :1875), counted on
    ``render_morph_affine_sweep.row_launches``.

    ``matrices``: (F, 6) or (F, L, 6); ``ratios``: (F,) f32 in [0, 1];
    ``tab_s`` / ``tab_e``: (L, 4, 1, EP) start / end pieces
    (morph_affine_pieces); ``colors_s`` / ``colors_e``: (L, 4);
    ``x_shift``: the tile-shard origin, column tiling only."""
    x_shift = _shift_origin(x_shift)
    if x_shift is not None and row_grid:
        raise ValueError("x_shift needs the column-grid sweep kernel")
    if matrices.ndim not in (2, 3):
        raise ValueError("matrices must be (F, 6) or (F, L, 6)")
    frames = matrices.shape[0]
    layers, ep = tab_s.shape[0], tab_s.shape[-1]
    fill_rule = normalize_fill_rule(fill_rule, layers)
    dev = _check_sweep({
        "matrices": (matrices, ((frames, 6), (frames, layers, 6))),
        "ratios": (ratios, ((frames,),)),
        "tab_s": (tab_s, ((layers, 4, 1, ep),)),
        "tab_e": (tab_e, ((layers, 4, 1, ep),)),
        "colors_s": (colors_s, ((layers, 4),)),
        "colors_e": (colors_e, ((layers, 4),)),
    }, frames, layers, ep)
    if row_grid:
        _check_wchunk(wchunk)
    return _run(render_morph_affine_sweep, dev, matrices, tab_s, tab_e,
                ratios, colors_s, colors_e, height, width,
                layer_rules(fill_rule, layers),
                _layer_counts(layer_counts, layers, ep),
                attr="row_launches" if row_grid else "launches",
                rows=bool(row_grid), x_shift=x_shift)


render_morph_affine_sweep.launches = 0
render_morph_affine_sweep.row_launches = 0
