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

Draw lists deeper than one kernel pass (16 layers, 4 field planes) render
in chained passes whose premultiplied planes stay on the device
(``_render_styled_multipass``); clip groups, blend modes and filters run
the masked program (``plan_masked_program`` / ``exec_masked_program``):
premultiplied-plane algebra between kernel passes, a clip group whose
content fits one pass fused with its mask into one launch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .coverage import (
    FILL_RULE_NONZERO, coverage, layer_rules, normalize_fill_rule,
)
from .flatblock import (
    LANE, MAX_CHUNKS, MAX_KERNEL_LAYERS, KPAINT_FOCAL, KPAINT_LINEAR,
    KernelPaint, field_to_chunkmajor, frames_to_premul_planes,
    packed_to_frames, plane_geometry, premul_planes_to_frames,
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
    (defaults to each solid paint's color).  ``mask_tree``: the draw
    list's group tree (runtime.scene.build_mask_tree) for clip groups,
    blend modes and filters.  Draw lists deeper than one kernel pass
    render in chained passes.  Returns (F, H, W, 4) u8."""
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
    if colors is None:
        base_colors = np.zeros((layers, 4), np.float32)
        for i, p in enumerate(paints):
            if p.kind == style_ops.PAINT_SOLID:
                base_colors[i] = p.color
        colors = np.broadcast_to(base_colors, (frames, layers, 4))
    colors = np.array(colors, np.float32)  # owned, writable copy
    if mask_tree is not None:
        return _render_styled_masked(edge_tables, paints, height, width,
                                     colors, layer_rules(fill_rule, layers),
                                     cache, mask_tree, device)
    # Draw lists deeper than one pass's budget (16 layers, 4 field planes)
    # compose across passes through chained premultiplied planes.
    layer_groups = split_layer_groups(paints)
    if len(layer_groups) > 1:
        return _render_styled_multipass(edge_tables, paints, height, width,
                                        colors, fill_rule, cache,
                                        layer_groups, device)

    args, spp = _styled_pass(edge_tables, paints, colors, height, width,
                             cache, device)
    out = render_fused_styled(*args, group=GROUP, fill_rule=fill_rule,
                              spp=spp)
    return _to_frames(out, frames, spp, height, width)


# ---------------------------------------------------------------------------
# Multi-pass composition and the masked program
# ---------------------------------------------------------------------------


def _sub_rule(fill_rule, idxs):
    """The fill rule of the layers ``idxs`` of a normalized rule: an int
    when uniform, else a per-layer tuple."""
    if not isinstance(fill_rule, tuple):
        return fill_rule
    rules = tuple(fill_rule[i] for i in idxs)
    return rules[0] if len(set(rules)) == 1 else rules


def _styled_pass(edge_tables, paints, colors, height, width, cache, device):
    """Lower, pack and upload one kernel pass -> (positional arguments of
    render_fused_styled up to ``paints``, spp)."""
    from ..convert import packed_to_device

    frames = len(edge_tables)
    *arrays, spp = _pack_styled(edge_tables, height, width, cache)
    kpaints, fields, _ = kernel_paints_for(paints, height, width, spp=spp,
                                           device=device)
    dev = packed_to_device(*arrays, device=device)
    args = (dev["sidx"], dev["flags"], dev["lays"], dev["urc"], dev["ucm"],
            dev["uval"], torch.as_tensor(np.ascontiguousarray(colors),
                                         device=device),
            fields, frames, len(paints), dev["ns"], dev["nc"], kpaints)
    return args, spp


def _to_frames(out, frames, spp, height, width):
    """A u32 pass's output (F, NS+1, spp*8, stride) -> (F, H, W, 4) u8."""
    return packed_to_frames(out, frames, out.shape[1] - 1,
                            out.shape[3] // LANE, spp, height, width)


def _render_styled_multipass(edge_tables, paints, height, width, colors,
                             fill_rule, cache, layer_groups, device):
    """Deep draw lists through the fused kernel in PASSES: each pass
    renders <= 16 consecutive layers, seeding the chain composite from
    the previous pass's premultiplied planes, which stay on the device.
    The chain is a left fold, so G passes compose exactly like one chain
    over every layer; only the last pass quantizes and is downloaded."""
    frames = len(edge_tables)
    bg = out = spp = None
    for gi, (lo, hi) in enumerate(layer_groups):
        idxs = tuple(range(lo, hi))
        args, spp = _styled_pass([per[lo:hi] for per in edge_tables],
                                 paints[lo:hi], colors[:, lo:hi], height,
                                 width, cache, device)
        last = gi == len(layer_groups) - 1
        out = render_fused_styled(*args, group=GROUP,
                                  fill_rule=_sub_rule(fill_rule, idxs),
                                  spp=spp, chain=True, bg=bg,
                                  emit="u32" if last else "premul")
        bg = out
    return _to_frames(out, frames, spp, height, width)


def plan_masked_program(tree, paints, fill_rule):
    """Flatten a mask/blend/filter tree into (segments, program, final).

    ``segments``: ordered pass descriptors ``(idxs, paints, rule,
    force_white)`` — each one fused-kernel pass (draw runs split at the
    per-pass budget).  ``program``: nested steps — ``("passes", [seg_id,
    ...])`` chains passes over the accumulator, ``("mask", seg_ids,
    subprogram)``, ``("blend", mode, subprogram)`` and ``("filter",
    filters, subprogram)`` composite a group.  ``final``: the quantize
    segment (one empty zero-alpha layer), appended last.  ``fill_rule``:
    one rule per draw."""
    from . import style as style_ops

    white = style_ops.solid_paint((1.0, 1.0, 1.0, 1.0))
    segments = []

    def add_segment(idxs, force_white):
        sub_paints = [white if force_white else paints[i] for i in idxs]
        rule = _sub_rule(tuple(fill_rule), idxs)
        ids = []
        for lo, hi in split_layer_groups(sub_paints):
            part_rule = (rule if not isinstance(rule, tuple)
                         else _sub_rule(rule, range(lo, hi)))
            segments.append((tuple(idxs[lo:hi]), sub_paints[lo:hi],
                             part_rule, force_white))
            ids.append(len(segments) - 1)
        return ids

    def plan_items(items):
        prog = []
        run = []

        def flush():
            if run:
                prog.append(("passes", add_segment(tuple(run), False)))
                run.clear()

        for item in items:
            if item[0] == "draw":
                run.append(item[1])
                continue
            flush()
            if item[0] == "mask":
                _, mask_idxs, content_items = item
                # A deep mask splits into chained white passes: source-over
                # of unit-alpha coverages IS their union.
                msegs = add_segment(tuple(mask_idxs), True)
                prog.append(("mask", msegs, plan_items(content_items)))
            elif item[0] == "blend":
                _, mode, content_items = item
                prog.append(("blend", mode, plan_items(content_items)))
            else:
                _, filters, content_items = item
                prog.append(("filter", filters, plan_items(content_items)))
        flush()
        return prog

    program = plan_items(tree)
    final = len(segments)
    segments.append(((), [white], fill_rule[0], False))  # quantize pass
    return segments, program, final


def _fusible_mask_step(step):
    """A ("mask", msegs, content_prog) step whose content is ONE plain
    pass — the shape one mask_from kernel pass covers."""
    return (step[0] == "mask" and len(step[2]) == 1
            and step[2][0][0] == "passes" and len(step[2][0][1]) == 1)


def _rule_tuple(rule, n):
    return rule if isinstance(rule, tuple) else (rule,) * n


def build_fused_mask_pair(segments, cid, msids):
    """Merge a fusible (content segment, mask segments) pair into ONE
    kernel pass's (idxs, paints, rule, mask_from), or None when the
    combined layers exceed the pass budget."""
    ci, cp, crule, _ = segments[cid]
    mi, mp_, mrule = [], [], ()
    for msid in msids:
        s_i, s_p, s_rule, _ = segments[msid]
        mi.extend(s_i)
        mp_.extend(s_p)
        mrule = mrule + _rule_tuple(s_rule, len(s_i))
    if not ci or not 0 < len(ci) + len(mi) <= MAX_KERNEL_LAYERS:
        return None
    rule = _rule_tuple(crule, len(ci)) + mrule
    if len(set(rule)) == 1:
        rule = rule[0]
    return tuple(ci) + tuple(mi), list(cp) + list(mp_), rule, len(ci)


def exec_masked_program(program, final_seg, seg_call, plane_image=None,
                        seg_call_masked=None):
    """Run a plan_masked_program: ``seg_call(seg_id, bg, emit)`` renders
    one segment over ``bg`` (None = transparent) and returns premul
    planes (or the packed u32 strips for emit="u32").  ``plane_image``:
    (to_frames, to_planes) converters between the kernel's chunk-major
    planes and (F, H, W, 4) premul images, for filter nodes.

    ``seg_call_masked(content_sid, mask_sids, bg, emit)``: the FUSED
    clip-group pass (render_fused_styled mask_from), or None when the
    pair exceeds the pass budget (the plane-algebra path then runs).
    When the group is the program's last top-level step, the fused pass
    quantizes directly (emit "u32") and absorbs the final zero-alpha
    pass; both fusions are float-op identical to the unfused program."""
    from .composite import blend_premul

    def exec_prog(prog, bg, top=False):
        for i, step in enumerate(prog):
            if step[0] == "passes":
                for sid in step[1]:
                    bg = seg_call(sid, bg, "premul")
            elif step[0] == "mask":
                _, msegs, content_prog = step
                fused = None
                if seg_call_masked is not None and _fusible_mask_step(step):
                    last_top = top and i == len(prog) - 1
                    fused = seg_call_masked(step[2][0][1][0], tuple(msegs),
                                            bg, "u32" if last_top
                                            else "premul")
                    if fused is not None and last_top:
                        return ("u32", fused)
                if fused is not None:
                    bg = fused
                    continue
                mask = None
                for mseg in msegs:
                    mask = seg_call(mseg, mask, "premul")
                content = exec_prog(content_prog, None)
                if content is None:
                    continue
                scaled = content * mask[:, :, 3:4]
                bg = (scaled if bg is None
                      else scaled + bg * (1.0 - scaled[:, :, 3:4]))
            elif step[0] == "blend":
                _, mode, content_prog = step
                content = exec_prog(content_prog, None)
                if content is None:
                    continue
                if bg is None:
                    bg = torch.zeros_like(content)
                bg = blend_premul(bg, content, mode, channel_axis=2)
            else:
                from .filters import apply_filters

                _, filters, content_prog = step
                content = exec_prog(content_prog, None)
                if content is None:
                    continue
                if plane_image is None:
                    raise ValueError(
                        "filter nodes need plane<->image converters")
                to_frames, to_planes = plane_image
                img = apply_filters(to_frames(content), filters)
                content = to_planes(img, content)
                bg = (content if bg is None
                      else content + bg * (1.0 - content[:, :, 3:4]))
        return bg

    planes = exec_prog(program, None, top=True)
    if isinstance(planes, tuple) and planes and planes[0] == "u32":
        return planes[1]
    return seg_call(final_seg, planes, "u32")


def _segment_tables(edge_tables, idxs):
    if not idxs:  # the final quantize segment: one empty layer
        return [[np.zeros((0, 4), np.float32)] for _ in edge_tables]
    return [[per[i] for i in idxs] for per in edge_tables]


def _render_styled_masked(edge_tables, paints, height, width, colors,
                          fill_rule, cache, tree, device):
    """Clip groups, blend modes and filters on the fused kernel: the draw
    list's group tree executes as premultiplied-plane algebra on the
    device — draw runs chain through fused passes, a group's content
    renders on a transparent background, scales by the mask's union
    alpha (white unit-alpha fills over each other), blends or filters,
    and combines with the accumulated planes; a final zero-alpha chained
    pass quantizes through the kernel's own resolve.  A clip group whose
    content is one pass renders with its mask in ONE launch
    (``mask_from``).  Passes are lowered and packed on first use."""
    frames = len(edge_tables)
    segments, program, final_seg = plan_masked_program(tree, paints,
                                                       fill_rule)
    passes = {}

    def prepared(key, idxs, sub_paints, sub_colors):
        if key not in passes:
            passes[key] = _styled_pass(_segment_tables(edge_tables, idxs),
                                       sub_paints, sub_colors, height,
                                       width, cache, device)
        return passes[key]

    def seg_call(sid, bg, emit):
        idxs, sub_paints, rule, force_white = segments[sid]
        if force_white:
            sub_colors = np.ones((frames, len(idxs), 4), np.float32)
        elif not idxs:
            sub_colors = np.zeros((frames, 1, 4), np.float32)
        else:
            sub_colors = colors[:, list(idxs)]
        args, spp = prepared(sid, idxs, sub_paints, sub_colors)
        # chain=True even with bg=None: the fused and layered masked
        # routes agree on the chain form.
        return render_fused_styled(*args, group=GROUP, fill_rule=rule,
                                   spp=spp, chain=True, bg=bg, emit=emit)

    def seg_call_masked(cid, msids, bg, emit):
        pair = build_fused_mask_pair(segments, cid, msids)
        if pair is None:
            return None
        idxs, all_paints, rule, mfrom = pair
        cols = np.concatenate(
            [colors[:, list(idxs[:mfrom])],
             np.ones((frames, len(idxs) - mfrom, 4), np.float32)], axis=1)
        args, spp = prepared(("pair", cid, msids), idxs, all_paints, cols)
        return render_fused_styled(*args, group=GROUP, fill_rule=rule,
                                   spp=spp, chain=True, bg=bg, emit=emit,
                                   mask_from=mfrom)

    _, n_chunks, n_strips = plane_geometry(height, width)
    spp = strips_per_plane(n_chunks, n_strips)
    plane_image = (
        lambda planes: premul_planes_to_frames(planes, height, width,
                                               n_chunks, spp),
        lambda img, like: frames_to_premul_planes(
            img, n_chunks, spp, like.shape[1] - 1, like.shape[3]),
    )
    out = exec_masked_program(program, final_seg, seg_call,
                              plane_image=plane_image,
                              seg_call_masked=seg_call_masked)
    return _to_frames(out, frames, spp, height, width)
