"""Flat-block pipeline on PyTorch + CUDA: chunk-major geometry, the two
fused place-and-resolve kernels, and their plain PyTorch versions.

Port of ``swf_renderer_tpu/ops/flatblock.py``.  The host packers (native
``pack_grouped``) hand every (frame, strip block) "supergroup" its
coalesced winding deltas as grouped placement blocks; one kernel launch
places them, resolves winding through the fill rule, composites the
layers and writes packed little-endian RGBA u32 (held in int32 tensors:
PyTorch has no general uint32 arithmetic on CUDA; ``.numpy().view(
np.uint32)`` gives the reference's arrays).

The unfused pipeline takes the packer's blocks the other way: one
kernel places them into chunk-major winding planes in device memory
(``place_blocks``), a second resolves the planes (``resolve_planes_u32``,
or ``resolve_planes_u32_dma`` through a copy pipeline), both from
``csrc/planes.cu``; ``render_flat_blocks`` runs the two, and
``render_fused_blocks`` is the fused kernel's one-block-per-step form
over blocks sorted by ``sort_blocks_fused``.

Each wrapper launches its CUDA kernel (``csrc/flatblock.cu``,
``csrc/planes.cu``) for tensors on the card, and takes its plain version
only for tensors on the CPU; each counts its launches in ``.launches``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.numerics import floor_mod, ieee_sqrt, true_div
from .coverage import FILL_RULE_NONZERO, layer_rules

STRIP_H = 8
LANE = 128
BLK = 128           # updates per placement block
# Chunk-major plane sublane budget: n_chunks*8 rows, power-of-2 padded;
# the hard cap is 64 chunks (width 8191).
MAX_CHUNKS = 64
MAX_KERNEL_LAYERS = 16
MAX_STOPS = 15      # SWF gradients carry at most 15 stops


def plane_geometry(height: int, width: int):
    """Chunk-major plane geometry for a frame: (stride, n_chunks,
    n_strips).  Cell deltas land at cols 0..width, so the stride rounds
    width+1 up to the lane count — or width, when dropping the col-width
    updates (pure right-of-frame cancellations) packs strictly more
    strips per plane."""
    n_strips = -(-height // STRIP_H)
    nc_full = max(1, (width + 1 + LANE - 1) // LANE)
    nc_min = max(1, (width + LANE - 1) // LANE)
    n_chunks = nc_full
    if nc_min < nc_full and (strips_per_plane(nc_min, n_strips)
                             > strips_per_plane(nc_full, n_strips)):
        n_chunks = nc_min
    return n_chunks * LANE, n_chunks, n_strips


def _drop_overflow_cols(rows, cols, vals, stride: int):
    """Filter updates at cols >= stride (pure right-of-frame winding
    cancellations — see plane_geometry)."""
    if len(cols) == 0:
        return rows, cols, vals
    m = cols < stride
    return (rows, cols, vals) if m.all() else (rows[m], cols[m], vals[m])


def plane_rows_for(n_chunks: int, spp: int = 1) -> int:
    """Row count of the chunk-major strip plane (power of two >= 128,
    sized for ``spp`` packed strips)."""
    rows = 128
    while rows < spp * n_chunks * STRIP_H:
        rows *= 2
    return rows


def strips_per_plane(n_chunks: int, n_strips: int) -> int:
    """How many 8-row strips pack into one chunk-major plane (narrow
    frames pack several; frames with nc8 >= 32 pack up to double into a
    256-row plane)."""
    nc8 = n_chunks * STRIP_H
    per = max(1, LANE // nc8)
    if nc8 >= 32 and 2 * nc8 <= 256:
        per = min(256 // nc8, 2 * per)
    return max(1, min(per, n_strips))


# ---------------------------------------------------------------------------
# Paints of the styled kernel
# ---------------------------------------------------------------------------

KPAINT_COLOR = 0   # per-(frame, layer) constant RGBA from colors
KPAINT_LINEAR = 1  # linear gradient evaluated in the kernel
KPAINT_FOCAL = 2   # focal/radial gradient evaluated in the kernel
KPAINT_FIELD = 3   # per-pixel RGBA field input (bitmap paints)

_GRAD_RADIUS = 16384.0  # SWF gradient square radius in twips (style.py)


class KernelPaint(tuple):
    """Hashable static paint descriptor for the styled fused kernel.

    (kind, inv_matrix(6), stop_ratios(K), stop_colors(4K flat), focal,
    spread, field_slot).  Gradient parameters travel to the kernel as a
    small per-layer table (paint_tables); bitmap paints reference a field
    input slot."""

    __slots__ = ()

    @staticmethod
    def color():
        return KernelPaint((KPAINT_COLOR, (), (), (), 0.0, 0, -1))

    @staticmethod
    def gradient(kind, inv_matrix, stop_ratios, stop_colors,
                 focal: float = 0.0, spread: int = 0):
        return KernelPaint((
            kind, tuple(float(x) for x in inv_matrix),
            tuple(float(x) for x in stop_ratios),
            tuple(float(x) for x in np.asarray(stop_colors).reshape(-1)),
            float(focal), int(spread), -1))

    @staticmethod
    def field(slot: int):
        return KernelPaint((KPAINT_FIELD, (), (), (), 0.0, 0, int(slot)))

    kind = property(lambda self: self[0])
    inv_matrix = property(lambda self: self[1])
    stop_ratios = property(lambda self: self[2])
    stop_colors = property(lambda self: self[3])
    focal = property(lambda self: self[4])
    spread = property(lambda self: self[5])
    slot = property(lambda self: self[6])


# Paint record layout (csrc/flatblock_device.cuh kP*).
PINT_STRIDE = 8
PFLT_STRIDE = 128
_P_INV, _P_FX, _P_CDX, _P_QA, _P_SAFE_A, _P_RATIO = 0, 6, 7, 8, 9, 10
_P_DR = _P_RATIO + MAX_STOPS
_P_C0 = _P_DR + MAX_STOPS - 1
_P_DC = _P_C0 + 4


@functools.lru_cache(maxsize=64)
def paint_tables(paints):
    """Per-layer paint records -> (pint (L, 8) int32, pflt (L, 128) f32).

    Every constant is rounded to f32 exactly where the reference rounds
    it: the focal terms and segment widths are Python-double expressions
    that JAX weak-types to f32 (flatblock._grad_eval,
    style._focal_gradient_t), stop colour steps are f32 differences."""
    f32 = np.float32
    n = len(paints)
    pint = np.zeros((n, PINT_STRIDE), np.int32)
    pflt = np.zeros((n, PFLT_STRIDE), np.float32)
    for i, p in enumerate(paints):
        pint[i, 0] = p.kind
        pint[i, 3] = p.slot
        if p.kind not in (KPAINT_LINEAR, KPAINT_FOCAL):
            continue
        ratios = p.stop_ratios
        k = len(ratios)
        if not 1 <= k <= MAX_STOPS:
            raise ValueError(f"gradient with {k} stops: the kernel takes "
                             f"1..{MAX_STOPS} (the SWF maximum)")
        colors = np.asarray(p.stop_colors, f32).reshape(-1, 4)
        pint[i, 1] = p.spread
        pint[i, 2] = k
        if p.inv_matrix:  # sweep paints take a matrix per frame instead
            pflt[i, _P_INV:_P_INV + 6] = np.asarray(p.inv_matrix, f32)
        fx = p.focal * _GRAD_RADIUS
        cdx = -fx
        qa = cdx * cdx - _GRAD_RADIUS * _GRAD_RADIUS
        small = bool(np.abs(f32(qa)) < f32(1e-6))
        pint[i, 4] = int(small)
        pflt[i, _P_FX] = f32(fx)
        pflt[i, _P_CDX] = f32(cdx)
        pflt[i, _P_QA] = f32(qa)
        pflt[i, _P_SAFE_A] = f32(1e-6) if small else f32(qa)
        pflt[i, _P_RATIO:_P_RATIO + k] = np.asarray(ratios, f32)
        for j in range(k - 1):
            pflt[i, _P_DR + j] = f32(max(ratios[j + 1] - ratios[j], 1e-6))
            pflt[i, _P_DC + 4 * j:_P_DC + 4 * j + 4] = (
                colors[j + 1] - colors[j])
        pflt[i, _P_C0:_P_C0 + 4] = colors[0]
    return pint, pflt


def _grad_t_plain(pint_row, pflt_row, px, py):
    """Gradient parameter at pixel centres (the kernel's grad_t)."""
    c = [pflt_row[j] for j in range(PFLT_STRIDE)]
    sx = c[_P_INV] * px + c[_P_INV + 2] * py + c[_P_INV + 4]
    sy = c[_P_INV + 1] * px + c[_P_INV + 3] * py + c[_P_INV + 5]
    if int(pint_row[0]) == KPAINT_LINEAR:
        t = true_div(sx + 16384.0, 32768.0)
    else:
        pdx = sx - c[_P_FX]
        pdy = sy
        b = pdx * c[_P_CDX]
        cc = pdx * pdx + pdy * pdy
        if int(pint_row[4]):
            tiny = torch.abs(b) < np.float32(1e-9)
            safe_b = torch.where(tiny, torch.full_like(b, 1e-9), b)
            t = torch.where(tiny, torch.zeros_like(b), cc / (2.0 * safe_b))
        else:
            disc = torch.clamp(b * b - c[_P_QA] * cc, min=0.0)
            sq = ieee_sqrt(disc)
            t = torch.maximum((b + sq) / c[_P_SAFE_A],
                              (b - sq) / c[_P_SAFE_A])
    spread = int(pint_row[1])
    if spread == 0:
        return torch.clamp(t, 0.0, 1.0)
    if spread == 2:
        return floor_mod(t, 1.0)
    m = floor_mod(t, 2.0)
    return 1.0 - torch.abs(m - 1.0)


def _grad_ramp_plain(pint_row, pflt_row, t, ch: int):
    k = int(pint_row[2])
    acc = torch.zeros_like(t) + pflt_row[_P_C0 + ch]
    for j in range(k - 1):
        w = torch.clamp((t - pflt_row[_P_RATIO + j]) / pflt_row[_P_DR + j],
                        0.0, 1.0)
        acc = acc + pflt_row[_P_DC + 4 * j + ch] * w
    return acc


# ---------------------------------------------------------------------------
# Plain versions (PyTorch, any device)
# ---------------------------------------------------------------------------


def _winding_plain(sidx, flags, lays, urc, ucm, uval, frames: int,
                   layers: int, ns1: int, n_chunks: int, spp: int,
                   group: int):
    """Placement + in-chunk prefix + cross-chunk carry ->
    (F, NS+1, L, plane_rows, 128) winding.

    The arithmetic is the kernel's, so both agree bit for bit: the
    in-chunk prefix sums each row left to right in f32, and the carry
    (the deltas of the same row in earlier chunks of the strip's window)
    is an exact 32.32 fixed-point sum rounded once to f32.  The
    reference sums the same values in other orders (an MXU product and
    a stride-8 ladder), so it agrees to f32 rounding."""
    dev = urc.device
    ng = urc.shape[0]
    plane_rows = plane_rows_for(n_chunks, spp)
    nblk = torch.bitwise_right_shift(flags, 2)
    slot = torch.arange(group, device=dev)
    used = (nblk[:, None] == 0) | (slot[None, :] < nblk[:, None])
    f = (sidx // (layers * ns1)).long()
    s = (sidx % ns1).long()
    lay = lays.t().long()                                  # (NG, G)
    rc = urc.reshape(ng, group, BLK).long()
    cm = ucm.reshape(ng, group, BLK).long()
    v = torch.where(used[..., None], uval.reshape(ng, group, BLK),
                    torch.zeros((), dtype=torch.float32, device=dev))
    plane_id = ((f * ns1 + s)[:, None] * layers + lay)    # (NG, G)
    row_id = (plane_id[..., None] * plane_rows + rc).reshape(-1)
    n_rows = frames * ns1 * layers * plane_rows
    flat = torch.zeros(n_rows * LANE, dtype=torch.float32, device=dev)
    flat.index_add_(0, row_id * LANE + cm.reshape(-1), v.reshape(-1))
    x = _row_prefix(flat.view(frames, ns1, layers, plane_rows, LANE))

    # Row totals in 32.32 fixed point (exact integer sums), then the
    # exclusive prefix over the chunks of each strip window.
    q = torch.round(v.reshape(-1).double() * 2.0 ** 32).long()
    tot = torch.zeros(n_rows, dtype=torch.int64, device=dev)
    tot.index_add_(0, row_id, q)
    tot = tot.view(frames, ns1, layers, plane_rows)
    nc8 = n_chunks * STRIP_H
    win = tot[..., :spp * nc8].reshape(frames, ns1, layers, spp, n_chunks,
                                       STRIP_H)
    carry_q = torch.zeros_like(tot)
    carry_q[..., :spp * nc8] = (win.cumsum(-2) - win).reshape(
        frames, ns1, layers, spp * nc8)
    carry = (carry_q.double() * 2.0 ** -32).float()
    return x + carry[..., None]


def _row_prefix(raw):
    """Inclusive prefix along the last axis, summed left to right in f32
    (the kernels' one-thread-per-row walk)."""
    x = torch.empty_like(raw)
    acc = torch.zeros_like(raw[..., 0])
    for c in range(raw.shape[-1]):
        acc = acc + raw[..., c]
        x[..., c] = acc
    return x


def _fill_cov(winding, rule: int):
    if rule == FILL_RULE_NONZERO:
        return torch.clamp(torch.abs(winding), max=1.0)
    m = floor_mod(winding, 2.0)
    return 1.0 - torch.abs(m - 1.0)


def _suffix_composite(covs, read_color):
    """Suffix-product alpha-over composite (flatblock.
    composite_quantize_pack with chain=False): out = sum_l C_l ca_l S_l
    with S_l = prod_{j>l} (1 - ca_j).  Returns premultiplied ((r, g, b),
    a)."""
    layers = len(covs)
    cas = [read_color(lyr, 3) * covs[lyr] for lyr in range(layers)]
    weight = [None] * layers
    suffix = None
    for lyr in range(layers - 1, -1, -1):
        weight[lyr] = cas[lyr] if suffix is None else cas[lyr] * suffix
        kp = 1.0 - cas[lyr]
        suffix = kp if suffix is None else suffix * kp
    a = weight[0]
    for lyr in range(1, layers):
        a = a + weight[lyr]

    def channel(c_idx):
        out = read_color(0, c_idx) * weight[0]
        for lyr in range(1, layers):
            out = out + read_color(lyr, c_idx) * weight[lyr]
        return out

    return tuple(channel(c) for c in range(3)), a


def _chain_composite(covs, read_color, bg=None):
    """Sequential over chain (flatblock.composite_quantize_pack with
    chain=True): a left fold from a transparent frame, or from the
    premultiplied planes ``bg`` (r, g, b, a) of an earlier pass, layer by
    layer ``c = C * ca + c * (1 - ca)``, ``a = ca + a * (1 - ca)``.
    Returns premultiplied ((r, g, b), a)."""
    if bg is None:
        r = g = b = a = torch.zeros_like(covs[0])
    else:
        r, g, b, a = bg
    for lyr, cov in enumerate(covs):
        ca = read_color(lyr, 3) * cov
        kp = 1.0 - ca
        r = read_color(lyr, 0) * ca + r * kp
        g = read_color(lyr, 1) * ca + g * kp
        b = read_color(lyr, 2) * ca + b * kp
        a = ca + a * kp
    return (r, g, b), a


def _mask_group_composite(covs, read_color, mask_from: int, bg=None):
    """A clip group in one pass (composite_quantize_pack with
    ``mask_from``): layers [:mask_from] chain from a transparent frame,
    the mask layers' union alpha left-folds ``m = ca + m * (1 - ca)``, the
    group scales by it and goes over ``bg``.  Operation for operation the
    unfused program's planes (mask pass, content pass, ``scaled + bg *
    (1 - scaled_a)``).  Returns premultiplied ((r, g, b), a)."""
    (cr, cg, cb), ca_g = _chain_composite(covs[:mask_from], read_color)
    m = None
    for j in range(mask_from, len(covs)):
        ca = read_color(j, 3) * covs[j]
        m = ca if m is None else ca + m * (1.0 - ca)
    r, g, b, a = cr * m, cg * m, cb * m, ca_g * m
    if bg is not None:
        kp = 1.0 - a
        r = r + bg[0] * kp
        g = g + bg[1] * kp
        b = b + bg[2] * kp
        a = a + bg[3] * kp
    return (r, g, b), a


def _quantize_pack(pm, a):
    """Premultiplied-u8 quantization, un-premultiply and little-endian
    RGBA packing (flatblock._quantize_pack_tail) -> int32 bit patterns."""
    a8f = torch.round(torch.clamp(a, 0.0, 1.0) * 255.0)
    inv = true_div(255.0, torch.clamp(a8f, min=1.0))
    packed = a8f.to(torch.int64) << 24
    for c_idx in range(3):
        pm8 = torch.minimum(torch.round(pm[c_idx] * 255.0), a8f)
        packed = packed + (torch.round(pm8 * inv).to(torch.int64)
                           << (8 * c_idx))
    packed = torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed)
    return packed.to(torch.int32)


def _composite_pack(covs, read_color):
    """Suffix-product composite, then the quantize tail -> int32 packed
    RGBA (the fused and sweep kernels' resolve tail)."""
    return _quantize_pack(*_suffix_composite(covs, read_color))


def _strips_to_rows(pk, n_chunks: int, spp: int):
    """(F, NS+1, plane_rows, 128) -> (F, NS+1, spp*8, n_chunks*128): plane
    row sp*nc8 + chunk*8 + y%8 lands at output row sp*8 + y%8."""
    f, ns1 = pk.shape[:2]
    x = pk[:, :, :spp * n_chunks * STRIP_H]
    x = x.reshape(f, ns1, spp, n_chunks, STRIP_H, LANE)
    return x.permute(0, 1, 2, 4, 3, 5).reshape(
        f, ns1, spp * STRIP_H, n_chunks * LANE)


def fused_plain(sidx, flags, lays, urc, ucm, uval, colors, frames: int,
                layers: int, n_strips: int, n_chunks: int, group: int = 6,
                fill_rule=FILL_RULE_NONZERO, spp: int = 1, paints=None,
                fields=(), chain: bool = False, bg=None, emit: str = "u32",
                mask_from=None):
    """Plain PyTorch version of both fused kernels -> (F, NS+1, spp*8,
    n_chunks*128) int32 packed RGBA (the sentinel strip block NS, where
    the padding groups land, is zeros; callers slice [:, :NS]).
    ``paints`` None is the solid kernel; otherwise one KernelPaint per layer.

    ``chain``: the sequential over chain in place of the suffix form,
    seeded from ``bg`` (F, NS+1, 4, plane_rows, 128) premultiplied planes
    when given; ``mask_from``: layers [mask_from:] are a clip group's
    mask (_mask_group_composite); ``emit="premul"``: return the
    premultiplied (F, NS+1, 4, plane_rows, 128) f32 planes, zero in the
    padding rows and the sentinel strip block NS."""
    ns1 = n_strips + 1
    dev = urc.device
    winding = _winding_plain(sidx, flags, lays, urc, ucm, uval, frames,
                             layers, ns1, n_chunks, spp, group)
    rules = layer_rules(fill_rule, layers)
    covs = [_fill_cov(winding[:, :, lyr], rules[lyr])
            for lyr in range(layers)]
    colors = colors.to(torch.float32)

    def solid(lyr, ch):
        return colors[:, lyr, ch][:, None, None, None]

    read_color = solid
    if paints is not None:
        pint, pflt = paint_tables(tuple(paints))
        pflt_t = torch.as_tensor(pflt, device=dev)
        plane_rows = plane_rows_for(n_chunks, spp)
        nc8 = n_chunks * STRIP_H
        sub = torch.arange(plane_rows, device=dev)[:, None]
        lane = torch.arange(LANE, device=dev)[None, :]
        strip = torch.arange(ns1, device=dev)[:, None, None]
        if spp > 1:
            local = sub % nc8
            py = ((strip * spp + sub // nc8) * STRIP_H
                  + local % STRIP_H).to(torch.float32) + 0.5
            px = ((local // STRIP_H) * LANE + lane).to(torch.float32) + 0.5
        else:
            py = (strip * STRIP_H + sub % STRIP_H).to(torch.float32) + 0.5
            px = ((sub // STRIP_H) * LANE + lane).to(torch.float32) + 0.5
        t_cache = {}

        def styled(lyr, ch):
            kind = paints[lyr].kind
            if kind == KPAINT_COLOR:
                return solid(lyr, ch)
            if kind == KPAINT_FIELD:
                return fields[paints[lyr].slot][:, ch][None]
            if lyr not in t_cache:
                t_cache[lyr] = _grad_t_plain(pint[lyr], pflt_t[lyr], px, py)
            return _grad_ramp_plain(pint[lyr], pflt_t[lyr], t_cache[lyr],
                                    ch)[None]

        read_color = styled
    if not chain and mask_from is None:
        return _strips_to_rows(_composite_pack(covs, read_color), n_chunks,
                               spp)
    bg_planes = None if bg is None else tuple(bg[:, :, ch]
                                              for ch in range(4))
    if mask_from is not None:
        pm, a = _mask_group_composite(covs, read_color, mask_from,
                                      bg_planes)
    else:
        pm, a = _chain_composite(covs, read_color, bg_planes)
    if emit == "premul":
        planes = torch.stack(torch.broadcast_tensors(*pm, a), dim=2)
        planes = planes.contiguous()
        planes[:, n_strips] = 0.0
        planes[:, :, :, spp * n_chunks * STRIP_H:] = 0.0
        return planes
    return _strips_to_rows(_quantize_pack(pm, a), n_chunks, spp)


def fusedn_plain(sidx, flags, lays, urc, ucm, uval, colors, frames: int,
                 layers: int, n_strips: int, n_chunks: int, group: int = 6,
                 fill_rule=FILL_RULE_NONZERO, spp: int = 1):
    """Plain version of the solid fused kernel (render_fused_blocksn)."""
    return fused_plain(sidx, flags, lays, urc, ucm, uval, colors, frames,
                       layers, n_strips, n_chunks, group=group,
                       fill_rule=fill_rule, spp=spp)


def fused_styled_plain(sidx, flags, lays, urc, ucm, uval, colors, fields,
                       frames: int, layers: int, n_strips: int,
                       n_chunks: int, paints, group: int = 6,
                       fill_rule=FILL_RULE_NONZERO, spp: int = 1,
                       chain: bool = False, bg=None, emit: str = "u32",
                       mask_from=None):
    """Plain version of the styled fused kernel (render_fused_styled),
    every mode."""
    return fused_plain(sidx, flags, lays, urc, ucm, uval, colors, frames,
                       layers, n_strips, n_chunks, group=group,
                       fill_rule=fill_rule, spp=spp, paints=tuple(paints),
                       fields=tuple(fields), chain=chain, bg=bg, emit=emit,
                       mask_from=mask_from)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_inputs(sidx, flags, lays, urc, ucm, uval, colors, frames,
                  layers, group, fields=()):
    tensors = (sidx, flags, lays, urc, ucm, uval, colors) + tuple(fields)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devices))}")
    ng = urc.shape[0]
    gb = group * BLK
    want = ((sidx, (ng,), torch.int32), (flags, (ng,), torch.int32),
            (lays, (group, ng), torch.int32),
            (urc, (ng, 1, gb), torch.float32),
            (ucm, (ng, gb, 1), torch.float32),
            (uval, (ng, 1, gb), torch.float32),
            (colors, (frames, layers, 4), torch.float32))
    for t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"expected {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if not 1 <= layers <= MAX_KERNEL_LAYERS:
        raise ValueError(f"{layers} layers: one pass takes 1.."
                         f"{MAX_KERNEL_LAYERS}")
    if not 1 <= frames <= 65535:
        raise ValueError(f"{frames} frames: one launch takes 1..65535")
    return devices.pop()


@functools.lru_cache(maxsize=64)
def _device_tables(rules, paints, device):
    """(rules (L,) int32, pint, pflt) on ``device``: uploaded once per
    rule and paint set, so a launch enqueues only the kernels.  ``paints``
    None (the solid kernel) gives no paint tables."""
    rules_t = torch.tensor(rules, dtype=torch.int32, device=device)
    if paints is None:
        return rules_t, None, None
    pint, pflt = paint_tables(paints)
    return (rules_t, torch.as_tensor(pint, device=device),
            torch.as_tensor(pflt, device=device))


def _launch(styled: bool, sidx, flags, lays, urc, ucm, uval, colors,
            fields, paints, frames, layers, n_strips, n_chunks, group,
            fill_rule, spp, chain=False, bg=None, emit="u32",
            mask_from=None):
    from . import cuda_lib

    tensors = (sidx, flags, lays, urc, ucm, uval, colors) + tuple(fields)
    if bg is not None:
        tensors += (bg,)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")
    dev = urc.device
    ns1 = n_strips + 1
    plane_rows = plane_rows_for(n_chunks, spp)
    rules = tuple(int(r) for r in layer_rules(fill_rule, layers))
    rules_t, pint_t, pflt_t = _device_tables(
        rules, tuple(paints) if styled else None, dev)
    pint_ptr = pflt_ptr = None
    if styled:
        pint_ptr, pflt_ptr = pint_t.data_ptr(), pflt_t.data_ptr()
    field_ptrs = [f.data_ptr() for f in fields] + [None] * (4 - len(fields))
    sg_index = torch.empty(2 * frames * ns1, dtype=torch.int32, device=dev)
    if emit == "premul":
        out = torch.empty((frames, ns1, 4, plane_rows, LANE),
                          dtype=torch.float32, device=dev)
    else:
        out = torch.empty((frames, ns1, spp * STRIP_H, n_chunks * LANE),
                          dtype=torch.int32, device=dev)
    # mode: bit0 chain composite, bit1 premultiplied planes out.
    mode = int(chain) | (2 if emit == "premul" else 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = cuda_lib.load().swf_fused_flatblock(
        int(styled), mode, sidx.data_ptr(), flags.data_ptr(),
        lays.data_ptr(), urc.data_ptr(), ucm.data_ptr(), uval.data_ptr(),
        colors.data_ptr(), rules_t.data_ptr(), pint_ptr, pflt_ptr,
        *field_ptrs, None if bg is None else bg.data_ptr(),
        sg_index.data_ptr(), out.data_ptr(), urc.shape[0], group, frames,
        layers, ns1, n_chunks, spp, plane_rows,
        -1 if mask_from is None else int(mask_from), stream)
    if err != 0:
        raise RuntimeError(f"fused flat-block kernel launch failed: CUDA "
                           f"error {err}")
    return out


def render_fused_blocksn(sidx, flags, lays, urc, ucm, uval, colors,
                         frames: int, layers: int, n_strips: int,
                         n_chunks: int, group: int = 6,
                         fill_rule=FILL_RULE_NONZERO, spp: int = 1):
    """Group-per-step fused render -> (F, NS+1, spp*8, stride) int32
    packed RGBA (counterpart of the TPU ``render_fused_blocksn``).

    Kernel: replaces ``_fusedn_kernel`` (swf_renderer_tpu/ops/
    flatblock.py:784).  Bound on the H100: bytes — the packed output is
    written once (535 MB at the 60-frame 1080p headline, 0.18 ms at
    3.35 TB/s).  Design: one CUDA block per (chunk, strip block, frame)
    keeps its chunk's layer planes in shared memory and never writes
    winding planes to device memory (csrc/flatblock_device.cuh).  On a
    card it matches ``fusedn_plain`` byte for byte (chip_smoke.py).

    Inputs are the native packer's grouped arrays: sidx/flags (NG,) i32,
    lays (group, NG) i32, urc/uval (NG, 1, group*128) f32, ucm (NG,
    group*128, 1) f32, colors (F, L, 4) f32.  ``n_strips`` is the
    strip-BLOCK count when ``spp > 1``."""
    dev = _check_inputs(sidx, flags, lays, urc, ucm, uval, colors, frames,
                        layers, group)
    if dev.type == "cpu":
        return fusedn_plain(sidx, flags, lays, urc, ucm, uval, colors,
                            frames, layers, n_strips, n_chunks, group=group,
                            fill_rule=fill_rule, spp=spp)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = _launch(False, sidx, flags, lays, urc, ucm, uval, colors, (),
                  None, frames, layers, n_strips, n_chunks, group,
                  fill_rule, spp)
    render_fused_blocksn.launches += 1
    return out


render_fused_blocksn.launches = 0


def render_fused_styled(sidx, flags, lays, urc, ucm, uval, colors, fields,
                        frames: int, layers: int, n_strips: int,
                        n_chunks: int, paints, group: int = 6,
                        fill_rule=FILL_RULE_NONZERO, spp: int = 1,
                        chain: bool = False, bg=None, emit: str = "u32",
                        mask_from=None):
    """Styled fused render -> (F, NS+1, spp*8, stride) int32 packed RGBA,
    zero in the sentinel strip block NS (the launcher clears it, as the
    plain version writes it), or with ``emit="premul"`` (F, NS+1, 4,
    plane_rows, 128) f32 premultiplied planes in the kernel's plane-row
    order, zero in the padding rows and the sentinel strip block NS
    (counterpart of the TPU ``render_fused_styled``).

    Kernel: replaces ``_fused_styled_kernel`` (swf_renderer_tpu/ops/
    flatblock.py:1083) with ``styled_flatblock_kernel`` (csrc/
    flatblock_device.cuh ``styled_block``): the solid kernel's walk, per-
    layer paint records in shared memory (in-kernel gradients), field
    planes read once per pixel, and a resolve that goes layer by layer
    over a batch of pixels a thread, at the layer class the launcher
    picks (4 up to four layers, else 16).  ``chain=True`` composites with the sequential over
    chain (a left fold, so passes of <= 16 layers chained through their
    premultiplied planes equal one long chain), seeded from ``bg`` —
    premultiplied planes of an earlier pass, read once per pixel —
    when given; ``mask_from=k``: layers [k:] are a clip group's mask,
    whose union alpha scales the content layers [:k] before they go over
    ``bg``.  Bound: bytes (output plus field and background planes).  On
    a card it matches ``fused_styled_plain`` byte for byte
    (chip_smoke.py).  ``fields``: tuple of (NS+1, 4, plane_rows, 128)
    f32 chunk-major field planes (field_to_chunkmajor); ``paints``: one
    KernelPaint per layer."""
    if emit not in ("u32", "premul"):
        raise ValueError(f"emit {emit!r}: 'u32' or 'premul'")
    if not chain and (bg is not None or emit == "premul"
                      or mask_from is not None):
        raise ValueError("bg, emit='premul' and mask_from compose the "
                         "chain form: pass chain=True")
    if mask_from is not None and not 0 < mask_from < layers:
        raise ValueError(f"mask_from {mask_from} for {layers} layers: "
                         "content and mask need a layer each")
    paints = tuple(paints)
    fields = tuple(fields)
    if len(paints) != layers:
        raise ValueError(f"{len(paints)} paints for {layers} layers")
    if len(fields) > 4:
        raise ValueError(f"{len(fields)} field planes: one pass takes 4")
    dev = _check_inputs(sidx, flags, lays, urc, ucm, uval, colors, frames,
                        layers, group, fields + (() if bg is None
                                                 else (bg,)))
    plane_rows = plane_rows_for(n_chunks, spp)
    for fp in fields:
        if (tuple(fp.shape) != (n_strips + 1, 4, plane_rows, LANE)
                or fp.dtype != torch.float32):
            raise ValueError(f"field plane {fp.dtype} {tuple(fp.shape)}")
    want_bg = (frames, n_strips + 1, 4, plane_rows, LANE)
    if bg is not None and (tuple(bg.shape) != want_bg
                           or bg.dtype != torch.float32):
        raise ValueError(f"background planes {bg.dtype} {tuple(bg.shape)}, "
                         f"expected float32 {want_bg}")
    paint_tables(paints)  # validates stop counts
    if dev.type == "cpu":
        return fused_styled_plain(sidx, flags, lays, urc, ucm, uval,
                                  colors, fields, frames, layers, n_strips,
                                  n_chunks, paints, group=group,
                                  fill_rule=fill_rule, spp=spp, chain=chain,
                                  bg=bg, emit=emit, mask_from=mask_from)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = _launch(True, sidx, flags, lays, urc, ucm, uval, colors, fields,
                  paints, frames, layers, n_strips, n_chunks, group,
                  fill_rule, spp, chain=chain, bg=bg, emit=emit,
                  mask_from=mask_from)
    render_fused_styled.launches += 1
    return out


render_fused_styled.launches = 0


# ---------------------------------------------------------------------------
# The unfused pipeline (placement + resolve) and the one-block fused kernel
# ---------------------------------------------------------------------------
#
# The packer's placement blocks (pack_flat_blocks, or the native
# pack_blocks_native) go either through two kernels — ``place_blocks``
# writes one chunk-major (128, 128) winding plane per (frame, layer,
# strip) to device memory and ``resolve_planes_u32`` (or its pipelined
# twin ``resolve_planes_u32_dma``) turns the planes into packed RGBA —
# or, sorted by (frame, strip, layer) (sort_blocks_fused), through the
# one-block-per-step fused kernel ``render_fused_blocks``.  These are the
# forward step of the reference's ``__graft_entry__.entry()``
# (``render_flat_blocks``); the port's counterpart is ``entry.entry()``.


def pack_flat_blocks(update_lists, height: int, width: int,
                     block_pad_multiple: int = 1024):
    """Pack per-draw sorted coalesced updates into placement blocks.

    ``update_lists``: [frames][layers] of (rows, cols, vals) arrays.
    Returns (sidx, keep, urc, ucm, uval, n_strips, n_chunks):
      sidx (NB,) i32 — packed target ((frame*L + layer)*(NS+1) + strip)
      keep (NB,) i32 — 0 on the first block of a group, else 1
      urc  (NB, 1, BLK) f32 — chunk-major row id (col//128)*8 + row%8
      ucm  (NB, BLK, 1) f32 — column within the chunk
      uval (NB, 1, BLK) f32 — update values (0 on padding slots)
    Every (frame, layer, strip) group emits at least one block (so empty
    groups still zero their plane); global padding blocks target the
    sentinel strip ``n_strips`` of (frame 0, layer 0), which the resolve
    never reads.  The native ``pack_blocks_native`` returns the same
    arrays."""
    f = len(update_lists)
    l = len(update_lists[0])
    stride, n_chunks, n_strips = plane_geometry(height, width)
    if n_chunks > MAX_CHUNKS:
        raise ValueError(
            f"flat-block pipeline supports width < {MAX_CHUNKS * LANE}"
            f" (got padded stride {stride})")

    sidx, keep, urc, ucm, uval = [], [], [], [], []
    for i in range(f):
        for j in range(l):
            rows, cols, vals = update_lists[i][j]
            if stride <= width:
                rows, cols, vals = _drop_overflow_cols(
                    rows, cols, vals, stride)
            strip = rows // STRIP_H if len(rows) else rows
            # Updates arrive row-major sorted => strip-grouped already.
            bounds = np.searchsorted(strip, np.arange(n_strips + 1))
            for s in range(n_strips):
                lo, hi = int(bounds[s]), int(bounds[s + 1])
                r = rows[lo:hi]
                c = cols[lo:hi]
                v = vals[lo:hi]
                n = max(1, hi - lo)  # empty group -> one zero block
                nb = -(-n // BLK)
                rc = np.zeros(nb * BLK, np.float32)
                cm = np.zeros(nb * BLK, np.float32)
                vv = np.zeros(nb * BLK, np.float32)
                rc[: hi - lo] = (c // LANE) * STRIP_H + r % STRIP_H
                cm[: hi - lo] = c % LANE
                vv[: hi - lo] = v
                for b in range(nb):
                    sidx.append((i * l + j) * (n_strips + 1) + s)
                    keep.append(0 if b == 0 else 1)
                    sl = slice(b * BLK, (b + 1) * BLK)
                    urc.append(rc[sl])
                    ucm.append(cm[sl])
                    uval.append(vv[sl])
    nb = len(sidx)
    nb_pad = ((nb + block_pad_multiple - 1)
              // block_pad_multiple) * block_pad_multiple
    for _ in range(nb_pad - nb):
        sidx.append(n_strips)  # sentinel garbage strip of (0, 0)
        keep.append(0)
        urc.append(np.zeros(BLK, np.float32))
        ucm.append(np.zeros(BLK, np.float32))
        uval.append(np.zeros(BLK, np.float32))
    return (
        np.asarray(sidx, np.int32),
        np.asarray(keep, np.int32),
        np.stack(urc)[:, None, :],   # (NB, 1, BLK)
        np.stack(ucm)[:, :, None],   # (NB, BLK, 1)
        np.stack(uval)[:, None, :],  # (NB, 1, BLK)
        n_strips,
        n_chunks,
    )


def sort_blocks_fused(sidx, keep, urc, ucm, uval, layers: int,
                      n_strips: int, block_pad_multiple: int = 1024):
    """Reorder packer output from (f, l, s) order to the one-block fused
    kernel's (f, s, l) order, drop value-less blocks (the kernel zeroes
    ALL layer planes at each (f, s) supergroup start; each supergroup
    keeps one block so that its strip is emitted), and compute the
    per-(f, s) ``last`` flags.

    Returns (sidx, keep, last, urc, ucm, uval) with keep == 0 marking
    supergroup starts; the padding tail has keep 1, last 0 and zero
    values on the sentinel strip."""
    ns1 = n_strips + 1
    f = sidx // (layers * ns1)
    l = (sidx // ns1) % layers
    s = sidx % ns1

    real = s != n_strips  # drop the packer's global sentinel padding
    order = np.lexsort((l[real], s[real], f[real]))

    def take(x):
        return x[real][order]

    sidx2, urc2, ucm2, uval2 = map(take, (sidx, urc, ucm, uval))
    f2, s2 = take(f), take(s)
    group = f2.astype(np.int64) * ns1 + s2

    zero_blk = ~np.any(uval2.reshape(len(uval2), -1) != 0.0, axis=1)
    retain = ~zero_blk
    if len(group):
        starts = np.r_[True, group[1:] != group[:-1]]
        # A supergroup whose blocks are all value-less keeps its first
        # block (something must zero + emit the strip).
        gid = np.cumsum(starts) - 1
        has_value = np.zeros(gid[-1] + 1, bool)
        np.logical_or.at(has_value, gid, retain)
        retain |= starts & ~has_value[gid]

    sidx2, urc2, ucm2, uval2 = (x[retain] for x in
                                (sidx2, urc2, ucm2, uval2))
    group = group[retain]
    nb = len(sidx2)
    first = np.r_[True, group[1:] != group[:-1]] if nb else np.zeros(0, bool)
    last = np.zeros(nb, np.int32)
    if nb:
        last[np.nonzero(first)[0][1:] - 1] = 1
        last[-1] = 1
    keep2 = (~first).astype(np.int32)

    nb_pad = ((nb + block_pad_multiple - 1)
              // block_pad_multiple) * block_pad_multiple
    pad = nb_pad - nb
    if pad:
        # Sentinel tail: keep=1 (no reset), last=0, zero values targeting
        # the garbage strip of frame 0.
        sidx2 = np.concatenate(
            [sidx2, np.full(pad, n_strips, np.int32)])
        keep2 = np.concatenate([keep2, np.ones(pad, np.int32)])
        last = np.concatenate([last, np.zeros(pad, np.int32)])
        urc2 = np.concatenate(
            [urc2, np.zeros((pad,) + urc2.shape[1:], np.float32)])
        ucm2 = np.concatenate(
            [ucm2, np.zeros((pad,) + ucm2.shape[1:], np.float32)])
        uval2 = np.concatenate(
            [uval2, np.zeros((pad,) + uval2.shape[1:], np.float32)])
    return sidx2, keep2, last, urc2, ucm2, uval2


def group_blocks_fused(sidx, keep, last, urc, ucm, uval, layers: int,
                       n_strips: int, group: int = 4,
                       group_pad_multiple: int = 256):
    """Group sort_blocks_fused output into ``group`` blocks per step
    (supergroups padded to multiples of ``group`` with zero filler): the
    grouped arrays of render_fused_blocksn, which the native
    pack_grouped_native builds in one pass."""
    ns1 = n_strips + 1
    nb = len(sidx)
    f = sidx // (layers * ns1)
    s = sidx % ns1
    l = (sidx // ns1) % layers
    gkey = f.astype(np.int64) * ns1 + s

    out_sidx, out_flags, out_lays = [], [], []
    out_rc, out_cm, out_vv = [], [], []
    zero = np.zeros(BLK, np.float32)
    i = 0
    while i < nb:
        j = i
        while j < nb and gkey[j] == gkey[i]:
            j += 1
        blocks = list(range(i, j))
        while len(blocks) % group:
            blocks.append(-1)
        for k in range(0, len(blocks), group):
            sub = blocks[k:k + group]
            # Bits 2+: used slot count (matches the native packer).
            flags = (1 if k == 0 else 0) | (sum(b >= 0 for b in sub) << 2)
            if k + group >= len(blocks):
                lb = next(b for b in reversed(sub) if b >= 0)
                if last[lb]:
                    flags |= 2
            out_sidx.append(int(sidx[sub[0] if sub[0] >= 0 else i]))
            out_flags.append(flags)
            out_lays.append([int(l[b]) if b >= 0 else 0 for b in sub])
            out_rc.append(np.concatenate(
                [urc[b, 0] if b >= 0 else zero for b in sub])[None, :])
            out_cm.append(np.concatenate(
                [ucm[b, :, 0] if b >= 0 else zero for b in sub])[:, None])
            out_vv.append(np.concatenate(
                [uval[b, 0] if b >= 0 else zero for b in sub])[None, :])
        i = j
    ng = len(out_sidx)
    ng_pad = ((ng + group_pad_multiple - 1)
              // group_pad_multiple) * group_pad_multiple
    for _ in range(ng_pad - ng):
        out_sidx.append(n_strips)
        out_flags.append(0)
        out_lays.append([0] * group)
        out_rc.append(np.zeros((1, group * BLK), np.float32))
        out_cm.append(np.zeros((group * BLK, 1), np.float32))
        out_vv.append(np.zeros((1, group * BLK), np.float32))
    return (np.asarray(out_sidx, np.int32),
            np.asarray(out_flags, np.int32),
            np.asarray(out_lays, np.int32).T.copy(),
            np.stack(out_rc), np.stack(out_cm), np.stack(out_vv))


def place_plain(sidx, keep, urc, ucm, uval, frames: int, layers: int,
                n_strips: int, step: bool = True):
    """Plain PyTorch version of the placement kernel -> (F, L, NS+1, 128,
    128) f32 chunk-major planes, plane [f, l, s, (col//128)*8 + row%8,
    col%128].

    A group's plane sums the blocks from its last ``keep == 0`` block to
    its last block (pack_flat_blocks' order: a group's blocks are
    consecutive, the first resets); slots outside the (128, 128) plane
    are dropped, as the reference's one-hot product drops them.  The
    updates of one group never share a target (the splitter coalesces
    them), so the raw deltas land exactly (``step=False``: equal to the
    reference); ``step=True`` then sums each row left to right within
    its chunk (the reference's step-matrix product sums in another
    order: within 1e-5).  The sentinel strip NS of every (frame, layer)
    holds zeros."""
    dev = urc.device
    ns1 = n_strips + 1
    n_groups = frames * layers * ns1
    nb = sidx.shape[0]
    g = sidx.long()
    i = torch.arange(nb, device=dev)
    real = (g >= 0) & (g < n_groups) & (g % ns1 != n_strips)
    gi = torch.where(real, g, torch.zeros_like(g))
    start = real & (keep == 0)
    first = torch.full((n_groups,), -1, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, gi[start], i[start], "amax")
    f0 = first[gi]
    counted = real & (f0 >= 0) & (i >= f0)
    rc = urc.reshape(nb, BLK).long()
    cm = ucm.reshape(nb, BLK).long()
    v = uval.reshape(nb, BLK).to(torch.float32)
    ok = (counted[:, None] & (rc >= 0) & (rc < LANE) & (cm >= 0)
          & (cm < LANE))
    target = (gi[:, None] * LANE + rc) * LANE + cm
    flat = torch.zeros(n_groups * LANE * LANE, dtype=torch.float32,
                       device=dev)
    flat.index_add_(0, target[ok], v[ok])
    planes = flat.view(frames, layers, ns1, LANE, LANE)
    return _row_prefix(planes) if step else planes


def _chunk_carry(totals, n_chunks: int):
    """Cross-chunk carry of each plane row from the chunks' lane-127
    totals (..., n_chunks*8): the reference's inclusive stride-8 ladder
    (shifts of 1, 2, 4, 8 chunks, adding 0.0 below the shift), then
    ``incl - totals``."""
    lead = totals.shape[:-1]
    t = totals.reshape(*lead, n_chunks, STRIP_H)
    incl = t
    shift = 1
    while shift * STRIP_H < LANE:
        if shift < n_chunks:
            below = torch.cat([torch.zeros_like(incl[..., :shift, :]),
                               incl[..., :n_chunks - shift, :]], dim=-2)
        else:
            below = torch.zeros_like(incl)
        incl = incl + below
        shift *= 2
    return (incl - t).reshape(*lead, n_chunks * STRIP_H)


def resolve_u32_plain(planes, colors, n_chunks: int,
                      fill_rule=FILL_RULE_NONZERO, prefixed: bool = True):
    """Plain PyTorch version of both plane resolves -> (F, NS*8, stride)
    int32 packed RGBA.

    ``prefixed=False`` first runs the reference's lane ladder (shifts 1 to
    64, adding 0.0 below each shift) within every chunk; then the
    cross-chunk carry (``winding = x + (incl - totals)``, _chunk_carry),
    the fill rule of each layer, the sequential over chain and the
    quantize tail — the reference's order, operation for operation."""
    from .resolve import lane_prefix

    f, l, ns1 = planes.shape[:3]
    ns = ns1 - 1
    nc8 = n_chunks * STRIP_H
    x = planes[:, :, :ns, :nc8].to(torch.float32)
    if not prefixed:
        x = lane_prefix(x)
    winding = x + _chunk_carry(x[..., LANE - 1], n_chunks)[..., None]
    rules = layer_rules(fill_rule, l)
    covs = [_fill_cov(winding[:, lyr], rules[lyr]) for lyr in range(l)]
    colors = colors.to(torch.float32)

    def read_color(lyr, ch):
        return colors[:, lyr, ch][:, None, None, None]

    pk = _quantize_pack(*_chain_composite(covs, read_color))
    pk = pk.reshape(f, ns, n_chunks, STRIP_H, LANE).permute(0, 1, 3, 2, 4)
    return pk.reshape(f, ns * STRIP_H, n_chunks * LANE)


def _split_bf16x2(v):
    """bf16(v) + bf16(v - bf16(v)), round to nearest even: the value the
    reference's two-pass placement carries."""
    hi = v.to(torch.bfloat16).to(torch.float32)
    return hi + (v - hi).to(torch.bfloat16).to(torch.float32)


def fused_blocks_plain(sidx, keep, last, urc, ucm, uval, colors,
                       frames: int, layers: int, n_strips: int,
                       n_chunks: int, fill_rule=FILL_RULE_NONZERO,
                       passes: int = 3):
    """Plain PyTorch version of the one-block fused kernel -> (F, NS+1,
    8, stride) int32 packed RGBA, strip NS zeros.

    Blocks sorted by (frame, strip, layer) as sort_blocks_fused gives
    them: ``keep == 0`` starts a supergroup (all layer planes reset),
    ``last == 1`` ends it (resolve); the sentinel tail lands in strip NS.
    ``passes < 3`` places each value split in two bf16 parts.  The
    arithmetic is render_fused_blocksn's (fused_plain with one block a
    group: left-to-right prefix, fixed-point carry, suffix composite)."""
    ns1 = n_strips + 1
    v = uval.to(torch.float32)
    if passes < 3:
        v = _split_bf16x2(v)
    flags = ((keep == 0).to(torch.int32)
             | ((last == 1).to(torch.int32) << 1))
    lays = ((sidx // ns1) % layers).to(torch.int32)[None]
    out = fused_plain(sidx, flags, lays, urc, ucm, v, colors, frames,
                      layers, n_strips, n_chunks, group=1,
                      fill_rule=fill_rule)
    out[:, n_strips] = 0
    return out


def _as_tensors(device, arrays, dtypes):
    """numpy arrays or tensors -> contiguous tensors on one device:
    ``device`` when given, else the tensors' own, else the card."""
    if device is None:
        device = next((a.device for a in arrays if torch.is_tensor(a)),
                      None)
    dev = resolve_device(device)
    out = [torch.as_tensor(np.ascontiguousarray(a) if isinstance(
        a, np.ndarray) else a).to(device=dev, dtype=dt).contiguous()
        for a, dt in zip(arrays, dtypes)]
    return dev, out


_BLOCK_DTYPES = (torch.int32, torch.int32, torch.float32, torch.float32,
                 torch.float32)


def _check_blocks(sidx, urc, ucm, uval, *flags):
    nb = sidx.shape[0]
    for t in flags:
        if tuple(t.shape) != (nb,):
            raise ValueError(f"block flags {tuple(t.shape)} for {nb} blocks")
    for t in (urc, ucm, uval):
        if t.numel() != nb * BLK:
            raise ValueError(f"block array {tuple(t.shape)} for {nb} blocks "
                             f"of {BLK} slots")


def _check_width(n_chunks: int, what: str):
    if n_chunks * STRIP_H > LANE:
        raise ValueError(f"{what} supports width < 2048; use "
                         "render_fused_blocksn for wider frames")


def _launch_planes(fn, *args):
    from . import cuda_lib

    err = getattr(cuda_lib.load("swfplanes"), fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def place_blocks(sidx, keep, urc, ucm, uval, frames: int, layers: int,
                 n_strips: int, step: bool = True, device=None):
    """Placement blocks -> (F, L, NS+1, 128, 128) f32 chunk-major planes
    (counterpart of the TPU ``place_blocks``; ``device`` takes the place
    of ``interpret``: the card by default, or the inputs' device).

    Kernel: replaces ``_place_kernel`` (swf_renderer_tpu/ops/
    flatblock.py:486).  One CUDA block per (frame, layer, strip) group
    scatters its raw deltas into a shared 128x129 plane, prefix-sums each
    row left to right (``step``), and writes the plane with coalesced
    stores (csrc/planes_device.cuh).  Bound: bytes (the planes written
    once).  On the CPU ``place_plain`` runs instead; on a card the kernel
    equals it bit for bit (chip_smoke.py)."""
    dev, (sidx, keep, urc, ucm, uval) = _as_tensors(
        device, (sidx, keep, urc, ucm, uval), _BLOCK_DTYPES)
    _check_blocks(sidx, urc, ucm, uval, keep)
    if dev.type == "cpu":
        return place_plain(sidx, keep, urc, ucm, uval, frames, layers,
                           n_strips, step=step)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    ns1 = n_strips + 1
    n_groups = frames * layers * ns1
    out = torch.empty((frames, layers, ns1, LANE, LANE), dtype=torch.float32,
                      device=dev)
    index = torch.empty(2 * n_groups, dtype=torch.int32, device=dev)
    _launch_planes("swf_place", sidx.data_ptr(), keep.data_ptr(),
                   urc.data_ptr(), ucm.data_ptr(), uval.data_ptr(),
                   index.data_ptr(), out.data_ptr(), sidx.shape[0],
                   n_groups, ns1, int(step), _stream(dev))
    place_blocks.launches += 1
    return out


place_blocks.launches = 0


def _resolve_inputs(planes, colors, n_chunks, fill_rule, device):
    dev, (planes, colors) = _as_tensors(device, (planes, colors),
                                        (torch.float32, torch.float32))
    if planes.dim() != 5 or tuple(planes.shape[3:]) != (LANE, LANE):
        raise ValueError(f"planes {tuple(planes.shape)}: expected (F, L, "
                         f"NS+1, {LANE}, {LANE})")
    f, l, ns1 = planes.shape[:3]
    if tuple(colors.shape) != (f, l, 4):
        raise ValueError(f"colors {tuple(colors.shape)} for planes "
                         f"{tuple(planes.shape)}")
    if ns1 < 2:
        raise ValueError("planes hold no strip besides the sentinel")
    _check_width(n_chunks, "the plane resolve")
    rules = tuple(int(r) for r in layer_rules(fill_rule, l))
    return dev, planes, colors, rules


def resolve_planes_u32(planes, colors, n_chunks: int,
                       fill_rule=FILL_RULE_NONZERO, prefixed: bool = True,
                       device=None):
    """(F, L, NS+1, 128, 128) chunk-major planes + (F, L, 4) straight
    colours -> (F, NS*8, stride) int32 packed RGBA (counterpart of the TPU
    ``resolve_planes_u32``; its grid knob ``strips_per_step`` is a TPU
    pipelining budget that does not change the result, and is dropped).
    ``prefixed=True`` expects place_blocks(step=True) planes.

    Kernel: replaces ``_resolve_u32_kernel`` (swf_renderer_tpu/ops/
    flatblock.py:556).  One CUDA block per (frame, strip), one warp per
    pixel row: the carry ladder over the chunks' totals, then chunk by
    chunk the rule, the sequential over chain and the quantize tail in
    registers (csrc/planes_device.cuh).  Bound: bytes (planes read once,
    frames written once).  On the CPU ``resolve_u32_plain`` runs instead;
    on a card the kernel equals it word for word (chip_smoke.py)."""
    dev, planes, colors, rules = _resolve_inputs(planes, colors, n_chunks,
                                                 fill_rule, device)
    if dev.type == "cpu":
        return resolve_u32_plain(planes, colors, n_chunks, rules, prefixed)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    f, l, ns1 = planes.shape[:3]
    out = torch.empty((f, (ns1 - 1) * STRIP_H, n_chunks * LANE),
                      dtype=torch.int32, device=dev)
    rules_t = _device_tables(rules, None, dev)[0]
    _launch_planes("swf_resolve_u32", planes.data_ptr(), colors.data_ptr(),
                   rules_t.data_ptr(), out.data_ptr(), f, l, ns1, n_chunks,
                   int(prefixed), _stream(dev))
    resolve_planes_u32.launches += 1
    return out


resolve_planes_u32.launches = 0


def resolve_planes_u32_dma(planes, colors, n_chunks: int,
                           fill_rule=FILL_RULE_NONZERO, n_buf: int = 3,
                           device=None):
    """The plane resolve through an ``n_buf``-deep copy pipeline ->
    (F, NS*8, stride) int32 packed RGBA, equal to resolve_planes_u32 on
    place_blocks(step=True) planes (counterpart of the TPU
    ``resolve_planes_u32_dma``).

    Kernel: replaces ``_resolve_dma_kernel`` (swf_renderer_tpu/ops/
    flatblock.py:1364).  Persistent blocks each own a run of one frame's
    strips and stream them through a ring of ``n_buf`` shared-memory
    stages filled by ``cp.async`` (a stage: one 128-column chunk of a
    strip, all layers; the ring goes shallower where ``n_buf`` stages of
    that size do not fit shared memory), resolving each stage through
    the device function of ``resolve_planes_u32`` (csrc/
    planes_device.cuh).  On the CPU ``resolve_u32_plain`` runs
    instead."""
    if n_buf < 1:
        raise ValueError(f"n_buf {n_buf}: the pipeline needs >= 1 stage")
    dev, planes, colors, rules = _resolve_inputs(planes, colors, n_chunks,
                                                 fill_rule, device)
    if dev.type == "cpu":
        return resolve_u32_plain(planes, colors, n_chunks, rules, True)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    f, l, ns1 = planes.shape[:3]
    out = torch.empty((f, (ns1 - 1) * STRIP_H, n_chunks * LANE),
                      dtype=torch.int32, device=dev)
    rules_t = _device_tables(rules, None, dev)[0]
    _launch_planes("swf_resolve_u32_dma", planes.data_ptr(),
                   colors.data_ptr(), rules_t.data_ptr(), out.data_ptr(), f,
                   l, ns1, n_chunks, n_buf, _stream(dev))
    resolve_planes_u32_dma.launches += 1
    return out


resolve_planes_u32_dma.launches = 0


def render_flat_blocks(sidx, keep, urc, ucm, uval, colors, height: int,
                       width: int, frames: int, layers: int, n_strips: int,
                       n_chunks: int, fill_rule=FILL_RULE_NONZERO,
                       device=None):
    """Full two-kernel flat-block pipeline -> (F, NS*8, stride) int32
    packed RGBA: place_blocks(step=True), then resolve_planes_u32
    (prefixed) — one launch of each on a card.  Crop and convert on the
    host with ``frames_u32_to_u8(out.cpu().numpy().view(np.uint32),
    height, width)``."""
    _check_width(n_chunks, "two-kernel path")
    dev, (sidx, keep, urc, ucm, uval, colors) = _as_tensors(
        device, (sidx, keep, urc, ucm, uval, colors),
        _BLOCK_DTYPES + (torch.float32,))
    planes = place_blocks(sidx, keep, urc, ucm, uval, frames, layers,
                          n_strips, step=True)
    return resolve_planes_u32(planes, colors, n_chunks, fill_rule=fill_rule,
                              prefixed=True)


def render_fused_blocks(sidx, keep, last, urc, ucm, uval, colors,
                        frames: int, layers: int, n_strips: int,
                        n_chunks: int, fill_rule=FILL_RULE_NONZERO,
                        passes: int = 3, device=None):
    """One-block-per-step fused render -> (F, NS+1, 8, stride) int32
    packed RGBA, strip NS zeros (callers slice [:, :NS]).  Requires
    blocks sorted by (frame, strip, layer) — see sort_blocks_fused.
    ``passes < 3`` places the reference's two-pass bf16 split of each
    value.

    Kernel: replaces ``_fused_kernel`` (swf_renderer_tpu/ops/
    flatblock.py:618) with render_fused_blocksn's kernel body
    (``solid_flatblock_kernel<kVarOne, kLc>``: one CUDA block per
    128-column chunk of a strip, the layer planes in shared memory,
    four slots' loads in flight, left-to-right prefix, fixed-point carry
    as two 32-bit adds, the composite in registers), reading the sorted
    blocks directly: supergroups start at ``keep == 0`` and end at
    ``last == 1`` (csrc/flatblock.cu).  It equals render_fused_blocksn
    on group_blocks_fused of the same blocks word for word.  Bound:
    bytes (the packed output written once).  On the CPU
    ``fused_blocks_plain`` runs instead."""
    _check_width(n_chunks, "render_fused_blocks")
    dev, (sidx, keep, last, urc, ucm, uval, colors) = _as_tensors(
        device, (sidx, keep, last, urc, ucm, uval, colors),
        (torch.int32,) + _BLOCK_DTYPES + (torch.float32,))
    _check_blocks(sidx, urc, ucm, uval, keep, last)
    if tuple(colors.shape) != (frames, layers, 4):
        raise ValueError(f"colors {tuple(colors.shape)} for {frames} frames "
                         f"of {layers} layers")
    if not 1 <= layers <= MAX_KERNEL_LAYERS:
        raise ValueError(f"{layers} layers: one pass takes 1.."
                         f"{MAX_KERNEL_LAYERS}")
    if dev.type == "cpu":
        return fused_blocks_plain(sidx, keep, last, urc, ucm, uval, colors,
                                  frames, layers, n_strips, n_chunks,
                                  fill_rule=fill_rule, passes=passes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from . import cuda_lib

    ns1 = n_strips + 1
    rules = tuple(int(r) for r in layer_rules(fill_rule, layers))
    rules_t = _device_tables(rules, None, dev)[0]
    sg_index = torch.empty(2 * frames * ns1, dtype=torch.int32, device=dev)
    out = torch.empty((frames, ns1, STRIP_H, n_chunks * LANE),
                      dtype=torch.int32, device=dev)
    err = cuda_lib.load().swf_fused_blocks1(
        sidx.data_ptr(), keep.data_ptr(), last.data_ptr(), urc.data_ptr(),
        ucm.data_ptr(), uval.data_ptr(), colors.data_ptr(),
        rules_t.data_ptr(), sg_index.data_ptr(), out.data_ptr(),
        sidx.shape[0], frames, layers, ns1, n_chunks, int(passes),
        _stream(dev))
    if err != 0:
        raise RuntimeError(f"one-block fused kernel launch failed: CUDA "
                           f"error {err}")
    render_fused_blocks.launches += 1
    return out


render_fused_blocks.launches = 0


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------


def field_to_chunkmajor(field, n_strips: int, n_chunks: int, spp: int = 1):
    """(H, W, 4) straight-RGBA field tensor -> (NS+1, 4, plane_rows, 128)
    chunk-major planes for render_fused_styled
    (row rc = ((row//8) % spp) * n_chunks*8 + (col//128)*8 + row%8).

    ``spp > 1``: ``n_strips`` is the STRIP-BLOCK count and each plane
    packs spp consecutive 8-row strips in n_chunks*8-row windows."""
    field = torch.as_tensor(field, dtype=torch.float32)
    h, w = field.shape[:2]
    stride = n_chunks * LANE
    hp = n_strips * spp * STRIP_H
    plane_rows = plane_rows_for(n_chunks, spp)
    fp = torch.zeros((hp, stride, 4), dtype=torch.float32,
                     device=field.device)
    fp[:h, :w] = field
    x = fp.reshape(n_strips, spp, STRIP_H, n_chunks, LANE, 4)
    x = x.permute(0, 5, 1, 3, 2, 4)  # (NS, 4, spp, chunks, 8, 128)
    x = x.reshape(n_strips, 4, spp * n_chunks * STRIP_H, LANE)
    out = torch.zeros((n_strips + 1, 4, plane_rows, LANE),
                      dtype=torch.float32, device=field.device)
    # Padding rows and the sentinel strip block NS read as zeros.
    out[:n_strips, :, :spp * n_chunks * STRIP_H] = x
    return out


def premul_planes_to_frames(planes, height: int, width: int,
                            n_chunks: int, spp: int):
    """Chunk-major premultiplied planes (F, NSp+1, 4, plane_rows, 128) ->
    (F, height, width, 4) premultiplied f32 on the planes' device: plane
    row sp*n_chunks*8 + chunk*8 + y%8 of strip block p is pixel row
    (p*spp + sp)*8 + y%8.  Reshapes and permutes only."""
    f, nsp1, _, pr, lane = planes.shape
    ns_p = nsp1 - 1
    nc8 = n_chunks * STRIP_H
    x = planes[:, :ns_p, :, :spp * nc8]
    x = x.reshape(f, ns_p, 4, spp, n_chunks, STRIP_H, lane)
    x = x.permute(0, 1, 3, 5, 4, 6, 2)   # f, plane, sp, y8, chunk, lane, c
    x = x.reshape(f, ns_p * spp * STRIP_H, n_chunks * lane, 4)
    return x[:, :height, :width]


def frames_to_premul_planes(frames, n_chunks: int, spp: int,
                            ns_planes: int, plane_rows: int):
    """Inverse of premul_planes_to_frames: (F, H, W, 4) premultiplied f32
    -> (F, NSp+1, 4, plane_rows, 128) on the frames' device, zero in the
    padding rows and the sentinel strip block (the layout every premul
    pass emits)."""
    f, h, w, _ = frames.shape
    nc8 = n_chunks * STRIP_H
    x = torch.zeros((f, ns_planes * spp * STRIP_H, n_chunks * LANE, 4),
                    dtype=frames.dtype, device=frames.device)
    x[:, :h, :w] = frames
    x = x.reshape(f, ns_planes, spp, STRIP_H, n_chunks, LANE, 4)
    x = x.permute(0, 1, 6, 2, 4, 3, 5)   # f, plane, c, sp, chunk, y8, lane
    out = torch.zeros((f, ns_planes + 1, 4, plane_rows, LANE),
                      dtype=frames.dtype, device=frames.device)
    out[:, :ns_planes, :, :spp * nc8] = x.reshape(f, ns_planes, 4,
                                                  spp * nc8, LANE)
    return out


def frames_u32_to_u8(frames_u32: np.ndarray, height: int,
                     width: int) -> np.ndarray:
    """(F, HP, S) packed uint32 -> (F, height, width, 4) u8 (host view)."""
    arr = np.ascontiguousarray(frames_u32[:, :height, :width])
    if arr.dtype.byteorder == ">":  # big-endian host (not our targets)
        arr = arr.astype("<u4")
    return arr.view(np.uint8).reshape(arr.shape + (4,))


def packed_to_frames(out, frames: int, n_strips: int, n_chunks: int,
                     spp: int, height: int, width: int) -> np.ndarray:
    """Kernel output (F, NS+1, spp*8, stride) int32 -> (F, H, W, 4) u8
    numpy: crop on the device, then one copy to the host."""
    rows = out[:, :n_strips].reshape(frames, n_strips * spp * STRIP_H,
                                     n_chunks * LANE)
    crop = rows[:, :height, :width].contiguous()
    host = crop.cpu().numpy().view(np.uint32)
    return frames_u32_to_u8(host, height, width)
