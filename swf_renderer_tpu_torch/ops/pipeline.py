"""Batched render pipelines.

Port of ``swf_renderer_tpu/ops/pipeline.py``.  The flagship route: the
native cell splitter lowers every (frame, layer) edge table to coalesced
winding deltas (in parallel: its C ABI drops the GIL), the native grouped
packer turns them into the fused kernels' placement blocks, and ONE
kernel launch renders the whole batch to packed RGBA.  Frames wider than
the chunk-major layout (stride > 8192 px) take the layered routes: the
solid pipeline scatters the deltas into planes resolved by the resolve
kernel (``ops/resolve.py``), the styled one composites scanline coverage
over paint fields (``render_styled_layered``).  ``render_solid_batch`` /
``render_morph_batch`` rasterize padded edge tables through the direct
coverage kernels (``ops/coverage.py``).

Routes this port does not have yet raise ``NotImplementedError`` naming
their ROADMAP.md item: masked/blended/filtered draw lists and draw lists
deeper than one kernel pass (multi-pass).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .coverage import FILL_RULE_NONZERO, coverage, normalize_fill_rule
from .flatblock import (
    LANE, MAX_CHUNKS, MAX_KERNEL_LAYERS, KPAINT_FOCAL, KPAINT_LINEAR,
    KernelPaint, field_to_chunkmajor, packed_to_frames, plane_geometry,
    render_fused_blocksn, render_fused_styled, strips_per_plane,
)

MAX_KERNEL_FIELDS = 4    # streamed field planes per kernel pass
GROUP = 6                # placement blocks per packer group


def lower_edge_table(table, height: int, width: int):
    """One draw's edge table -> sorted coalesced winding delta updates
    (rows, cols, values) through the native splitter, which also drops
    coalesced-to-zero updates."""
    from ..native.bindings import cells_split_delta_native

    return cells_split_delta_native(table, height, width)


def lower_update_lists(edge_tables, height: int, width: int,
                       max_workers: int = None):
    """Lower every (frame, layer) edge table to delta updates, in PARALLEL
    (the native C ABI releases the GIL for the whole call)."""
    from ..native.bindings import _pool_workers

    flat = [t for per_frame in edge_tables for t in per_frame]
    if max_workers is None:
        max_workers = _pool_workers()
    if max_workers > 1 and len(flat) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            lowered = list(pool.map(
                lambda t: lower_edge_table(t, height, width), flat))
    else:
        lowered = [lower_edge_table(t, height, width) for t in flat]
    layers = len(edge_tables[0])
    return [lowered[i * layers:(i + 1) * layers]
            for i in range(len(edge_tables))]


def _too_wide(height: int, width: int) -> bool:
    """True when the frame's stride exceeds the chunk-major layout of the
    fused kernels (8192 px)."""
    stride, _, _ = plane_geometry(height, width)
    return stride > MAX_CHUNKS * LANE


def _f32(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def render_solid_batch(edges_t, colors, height: int, width: int,
                       fill_rule: int = FILL_RULE_NONZERO, device=None):
    """Render a batch of frames made of solid-fill draws through the
    direct coverage kernels.

    ``edges_t``: (B, P, 4, E) f32 — B frames, P draws per frame (all-zero
    draws are no-ops), edge tables in device pixels, best pre-split to
    bounded y-extent (``geometry.split_edges_y``) so the banded kernel's
    windows stay tight.  ``colors``: (B, P, 4) straight RGBA.  Runs on
    the tensors' device, or ``device`` for numpy inputs (the card unless
    the caller asks for the CPU).  Returns (B, H, W, 4) uint8 (host)."""
    from .composite import composite_solid_layers, premul_to_straight_u8

    device = (edges_t.device if torch.is_tensor(edges_t) and device is None
              else resolve_device(device))
    edges_t, colors = _f32(edges_t, device), _f32(colors, device)
    b, p, four, e = edges_t.shape
    cov = coverage(edges_t.reshape(b * p, four, e), height, width,
                   fill_rule)
    frames_pm = composite_solid_layers(cov.view(b, p, height, width), colors)
    return premul_to_straight_u8(frames_pm)


def render_morph_batch(edges_start, edges_end, colors_start, colors_end,
                       ratios, height: int, width: int,
                       fill_rule: int = FILL_RULE_NONZERO, device=None):
    """A morph shape at a batch of ratio steps: (P, 4, E) paired draw
    tables (same topology), (P, 4) colours, (R,) ratios; the lerp runs on
    the device and one coverage launch rasterizes every step.  Returns
    (R, H, W, 4) uint8."""
    device = resolve_device(device)
    rr = _f32(ratios, device)[:, None, None, None]
    edges = (_f32(edges_start, device)[None] * (1.0 - rr)
             + _f32(edges_end, device)[None] * rr)
    rc = rr[..., 0]
    colors = (_f32(colors_start, device)[None] * (1.0 - rc)
              + _f32(colors_end, device)[None] * rc)
    return render_solid_batch(edges, colors, height, width, fill_rule,
                              device=device)


def _pack(edge_tables, height, width, cache, variant: str):
    """Lower + pack (cache-aware) -> (gsi, gfl, gla, grc, gcm, gvv, ns,
    nc, spp) host arrays."""
    from ..native.bindings import pack_grouped_native

    _, nc_geo, ns_geo = plane_geometry(height, width)
    spp = strips_per_plane(nc_geo, ns_geo)
    key = (cache.key_for(edge_tables, height, width, GROUP, spp=spp,
                         variant=variant)
           if cache is not None else None)
    packed = cache.get(key) if cache is not None else None
    if packed is None:
        update_lists = lower_update_lists(edge_tables, height, width)
        packed = pack_grouped_native(update_lists, height, width,
                                     group=GROUP, spp=spp)
        if cache is not None:
            cache.put(key, packed)
    return tuple(packed) + (spp,)


def render_batch_flatblock(edge_tables, colors, height: int, width: int,
                           fill_rule=FILL_RULE_NONZERO, cache=None,
                           device=None):
    """Flagship batched solid-layer renderer: native lowering + the fused
    solid kernel.

    ``edge_tables``: [frames][layers] of (E, 4) float32 edge tables in pixel
    space; ``colors``: (F, L, 4) straight RGBA.  Returns (F, H, W, 4) uint8
    frames (host numpy).  ``cache``: optional runtime.cache.PackedSceneCache
    memoizing the host lowering by geometry content hash."""
    from ..convert import packed_to_device

    device = resolve_device(device)
    frames = len(edge_tables)
    layers = len(edge_tables[0])
    fill_rule = normalize_fill_rule(fill_rule, layers)
    if _too_wide(height, width):
        from .resolve import pack_updates, render_scanline_updates

        flat = [u for per_frame in lower_update_lists(edge_tables, height,
                                                      width)
                for u in per_frame]
        rows, cols, vals = pack_updates(flat)
        return render_scanline_updates(
            rows.reshape(frames, layers, -1), cols.reshape(frames, layers, -1),
            vals.reshape(frames, layers, -1),
            np.asarray(colors, np.float32), height, width,
            fill_rule=fill_rule, device=device)
    *arrays, spp = _pack(edge_tables, height, width, cache, "solid")
    dev = packed_to_device(*arrays, device=device)
    out = render_fused_blocksn(
        dev["sidx"], dev["flags"], dev["lays"], dev["urc"], dev["ucm"],
        dev["uval"], torch.as_tensor(np.asarray(colors, np.float32),
                                     device=device),
        frames, layers, dev["ns"], dev["nc"], group=GROUP,
        fill_rule=fill_rule, spp=spp)
    return packed_to_frames(out, frames, dev["ns"], dev["nc"], spp, height,
                            width)


def _needs_field(p) -> bool:
    from . import style as style_ops

    return (p.kind == style_ops.PAINT_BITMAP
            or (p.kind in (style_ops.PAINT_LINEAR, style_ops.PAINT_FOCAL)
                and p.color_space == "linear-rgb"))


def split_layer_groups(paints, max_layers: int = MAX_KERNEL_LAYERS,
                       max_fields: int = MAX_KERNEL_FIELDS):
    """Cut a deep layer list into consecutive groups each within one
    kernel pass's budget (<= max_layers layers, <= max_fields streamed
    field planes).  Returns [(start, end), ...]."""
    groups = []
    start, n_fields = 0, 0
    for i, p in enumerate(paints):
        f = 1 if _needs_field(p) else 0
        if i > start and (i - start >= max_layers
                          or n_fields + f > max_fields):
            groups.append((start, i))
            start, n_fields = i, 0
        n_fields += f
    groups.append((start, len(paints)))
    return groups


def kernel_paints_for(paints, height: int, width: int, spp: int = 1,
                      device=None):
    """Map per-layer style Paints -> (KernelPaint tuple, field planes,
    (L, 4) colors) for render_fused_styled.

    Solid paints read per-(frame, layer) colors; bitmap paints evaluate
    their field once and stream chunk-major planes.  Gradients ALSO
    stream as prebaked fields while the pass's field budget allows; past
    it they evaluate in the kernel from their stop tables.  Field planes
    land on ``device``: the card unless the caller asks for the CPU."""
    from . import style as style_ops

    device = resolve_device(device)
    _, n_chunks, n_strips = plane_geometry(height, width)
    if spp > 1:
        n_strips = -(-n_strips // spp)  # strip-block count
    gradient_kinds = (style_ops.PAINT_LINEAR, style_ops.PAINT_FOCAL)
    must_field = sum(1 for p in paints if _needs_field(p))
    n_gradients = sum(1 for p in paints
                      if p.kind in gradient_kinds
                      and p.color_space != "linear-rgb")
    gradients_as_fields = (must_field + n_gradients
                           <= MAX_KERNEL_FIELDS)

    kpaints = []
    fields = []
    colors = np.zeros((len(paints), 4), np.float32)

    def add_field(p):
        field = style_ops.paint_field(p, height, width, device=device)
        fields.append(field_to_chunkmajor(field, n_strips, n_chunks,
                                          spp=spp))
        kpaints.append(KernelPaint.field(len(fields) - 1))

    for i, p in enumerate(paints):
        if p.kind == style_ops.PAINT_SOLID:
            kpaints.append(KernelPaint.color())
            colors[i] = p.color
        elif p.kind in gradient_kinds:
            if p.color_space == "linear-rgb" or gradients_as_fields:
                add_field(p)
                continue
            kind = (KPAINT_LINEAR if p.kind == style_ops.PAINT_LINEAR
                    else KPAINT_FOCAL)
            kpaints.append(KernelPaint.gradient(
                kind, p.inv_matrix, p.stop_ratios, p.stop_colors,
                focal=p.focal_point, spread=p.spread))
        elif p.kind == style_ops.PAINT_BITMAP:
            add_field(p)
        else:
            raise ValueError(f"unsupported paint kind {p.kind}")
    return tuple(kpaints), tuple(fields), colors


def _pack_styled(edge_tables, height, width, cache):
    """Shared lower+pack step of the styled pipeline (cache-aware) ->
    (gsi, gfl, gla, grc, gcm, gvv, ns, nc, spp)."""
    return _pack(edge_tables, height, width, cache, "styled")


def render_styled_layered(edge_tables, paints, height: int, width: int,
                          colors=None, fill_rule=FILL_RULE_NONZERO,
                          device=None):
    """Layered styled route for any frame width: per-frame scanline
    coverage (native cell splitter) + paint fields + premultiplied
    composite.  Same contract as ``render_batch_styled``."""
    from ..native.bindings import cells_split_native
    from . import style as style_ops
    from .composite import composite_to_u8
    from .scanline import coverage_scanline, pack_cells

    device = resolve_device(device)
    fields = [style_ops.paint_field(p, height, width, device=device)
              for p in paints]
    out = []
    for f, per_frame in enumerate(edge_tables):
        cells = [cells_split_native(np.asarray(t, np.float32), height, width)
                 for t in per_frame]
        cov = coverage_scanline(*pack_cells(cells), height, width,
                                fill_rule, device=device)
        layer_fields = []
        for lyr, p in enumerate(paints):
            if p.kind == style_ops.PAINT_SOLID and colors is not None:
                layer_fields.append(torch.as_tensor(
                    np.asarray(colors[f][lyr], np.float32),
                    device=device).expand(height, width, 4))
            else:
                layer_fields.append(fields[lyr])
        out.append(composite_to_u8(cov, torch.stack(layer_fields)))
    return np.stack(out)


def render_batch_styled(edge_tables, paints, height: int, width: int,
                        colors=None, fill_rule=FILL_RULE_NONZERO,
                        cache=None, mask_tree=None, device=None):
    """Styled flagship renderer: every paint kind rides the fused styled
    kernel.

    ``edge_tables``: [frames][layers] of (E, 4) f32 device-space edges.
    ``paints``: one style Paint per LAYER (static across frames).
    ``colors``: optional (F, L, 4) per-frame colors for SOLID layers
    (defaults to each solid paint's color).  Returns (F, H, W, 4) u8."""
    from ..convert import packed_to_device
    from . import style as style_ops

    device = resolve_device(device)
    frames = len(edge_tables)
    layers = len(edge_tables[0])
    assert layers == len(paints)
    fill_rule = normalize_fill_rule(fill_rule, layers)
    if _too_wide(height, width):
        if mask_tree is not None:
            # The layered route has no group compositor (as in the
            # reference).
            raise ValueError(
                f"masked scenes wider than {MAX_CHUNKS * LANE} px don't "
                "fit the fused program; use the layered renderer backends")
        return render_styled_layered(edge_tables, paints, height, width,
                                     colors=colors, fill_rule=fill_rule,
                                     device=device)
    if mask_tree is not None:
        raise NotImplementedError(
            "clip groups, blend modes and filters run the masked program: "
            "ROADMAP.md queue A (masks/blends/filters)")
    if len(split_layer_groups(paints)) > 1:
        raise NotImplementedError(
            f"{layers} layers exceed one kernel pass ({MAX_KERNEL_LAYERS} "
            f"layers, {MAX_KERNEL_FIELDS} field planes): ROADMAP.md queue "
            "A (multi-pass)")
    if colors is None:
        base_colors = np.zeros((layers, 4), np.float32)
        for i, p in enumerate(paints):
            if p.kind == style_ops.PAINT_SOLID:
                base_colors[i] = p.color
        colors = np.broadcast_to(base_colors, (frames, layers, 4))
    colors = np.array(colors, np.float32)  # owned, writable copy

    *arrays, spp = _pack_styled(edge_tables, height, width, cache)
    kpaints, fields, _ = kernel_paints_for(paints, height, width, spp=spp,
                                           device=device)
    dev = packed_to_device(*arrays, device=device)
    out = render_fused_styled(
        dev["sidx"], dev["flags"], dev["lays"], dev["urc"], dev["ucm"],
        dev["uval"], torch.as_tensor(colors, device=device), fields,
        frames, layers, dev["ns"], dev["nc"], kpaints, group=GROUP,
        fill_rule=fill_rule, spp=spp)
    return packed_to_frames(out, frames, dev["ns"], dev["nc"], spp, height,
                            width)
