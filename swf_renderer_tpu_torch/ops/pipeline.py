"""Batched render pipelines on the fused flat-block kernels.

Port of the flat-block half of ``swf_renderer_tpu/ops/pipeline.py``: the
native cell splitter lowers every (frame, layer) edge table to coalesced
winding deltas (in parallel: its C ABI drops the GIL), the native grouped
packer turns them into the kernels' placement blocks, and ONE kernel
launch renders the whole batch to packed RGBA.

Routes this port does not have yet raise ``NotImplementedError`` naming
their ROADMAP.md item: masked/blended/filtered draw lists, draw lists
deeper than one kernel pass (multi-pass), and frames wider than the
chunk-major layout (stride > 8192 px).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .coverage import FILL_RULE_NONZERO, normalize_fill_rule
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


def _check_width(height: int, width: int):
    stride, _, _ = plane_geometry(height, width)
    if stride > MAX_CHUNKS * LANE:
        raise NotImplementedError(
            f"frame stride {stride} > {MAX_CHUNKS * LANE} px needs the "
            "chunked-scatter/layered coverage routes: ROADMAP.md queue A "
            "(width > 8191)")


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
    _check_width(height, width)
    frames = len(edge_tables)
    layers = len(edge_tables[0])
    fill_rule = normalize_fill_rule(fill_rule, layers)
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
    _check_width(height, width)
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
