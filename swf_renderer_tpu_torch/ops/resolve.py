"""Scanline resolve: row prefix sum + fill rule + composite in one pass.

Port of ``swf_renderer_tpu/ops/resolve.py``.  After the scanline scatter
each layer's delta plane holds, per pixel cell, the cell's area at its
column and cover - area at the next, so its row prefix sum is the exact
winding integral.  ``resolve_frames`` turns (F, L, H, S) delta planes and
(F, L, 4) colours into (F, 4, H, S) premultiplied frames: prefix, fill
rule and painter's composite per layer.  It is the wide-frame route of
the batch pipelines (frames whose stride exceeds the chunk-major layout's
8192 px): ``render_scanline_updates`` scatters the native splitter's
coalesced delta updates into the planes and resolves them.

For tensors on the card ``resolve_frames`` launches ``csrc/resolve.cu``
and counts ``resolve_frames.launches``; on the CPU it runs
``resolve_plain``, the same arithmetic in PyTorch.  Both keep the
reference's prefix order (a Hillis-Steele ladder per 128-column chunk,
then the running carry), so they equal the JAX kernel bit for bit on the
same planes.  The rule is read per layer (the reference applies even-odd
to every layer when given a mixed tuple; ROADMAP.md queue C).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .coverage import FILL_RULE_NONZERO, apply_fill_rule, layer_rules
from .coverage import normalize_fill_rule
from .scanline import scatter_add

STRIP_H = 8
LANE = 128
LADDER = (1, 2, 4, 8, 16, 32, 64)


def lane_prefix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix along the last axis (128 lanes) in the
    reference's order: x[i] += x[i - s] for s = 1, 2, ..., 64, adding 0.0
    where i < s."""
    for s in LADDER:
        zeros = torch.zeros(x.shape[:-1] + (s,), dtype=x.dtype,
                            device=x.device)
        x = x + torch.cat([zeros, x[..., :-s]], dim=-1)
    return x


def resolve_plain(delta: torch.Tensor, colors: torch.Tensor,
                  rules) -> torch.Tensor:
    """Plain PyTorch version of the resolve kernel: (F, L, H, S) delta
    planes, (F, L, 4) straight colours, one rule per layer -> (F, 4, H,
    S) premultiplied."""
    f, l, h, s = delta.shape
    n = s // LANE
    ladder = lane_prefix(delta.reshape(f, l, h, n, LANE))
    winding = torch.empty_like(ladder)
    carry = torch.zeros((f, l, h, 1), dtype=torch.float32,
                        device=delta.device)
    for c in range(n):
        winding[:, :, :, c] = ladder[:, :, :, c] + carry
        carry = winding[:, :, :, c, LANE - 1:]
    del ladder
    winding = winding.view(f, l, h, s)
    r, g, b, a = (torch.zeros((f, h, s), dtype=torch.float32,
                              device=delta.device) for _ in range(4))
    for layer in range(l):
        col = colors[:, layer, :, None, None]
        ca = col[:, 3] * apply_fill_rule(winding[:, layer], rules[layer])
        keep = 1.0 - ca
        r = col[:, 0] * ca + r * keep
        g = col[:, 1] * ca + g * keep
        b = col[:, 2] * ca + b * keep
        a = ca + a * keep
    return torch.stack([r, g, b, a], dim=1)


def _launch(delta, colors, rules):
    """Launch ``swf_resolve`` (csrc/resolve.cu) on the tensors' card.
    Raises if the library does not build or the launch is refused."""
    from . import cuda_lib

    f, l, h, s = delta.shape
    out = torch.empty((f, 4, h, s), dtype=torch.float32, device=delta.device)
    rule_t = torch.tensor(rules, dtype=torch.int32, device=delta.device)
    err = cuda_lib.load("swfresolve").swf_resolve(
        delta.data_ptr(), colors.data_ptr(), rule_t.data_ptr(),
        out.data_ptr(), f, l, h, s,
        torch.cuda.current_stream(delta.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"resolve kernel launch failed: CUDA error {err}")
    return out


def resolve_frames(delta_plane, colors, fill_rule=FILL_RULE_NONZERO):
    """(F, L, H, S) delta planes (S a multiple of 128, H of 8) + (F, L, 4)
    straight colours -> (F, 4, H, S) premultiplied frames, channel major,
    on the planes' device.  ``fill_rule``: one rule, or one per layer.

    Kernel: replaces ``_resolve_kernel`` (swf_renderer_tpu/ops/
    resolve.py:53).  One warp per row walks the 128-column chunks, each
    lane holding 4 columns: the ladder in registers and shuffles, the
    layer composite in registers, one read of each delta and one write
    of each output channel.  On the CPU ``resolve_plain`` runs instead."""
    n_frames, n_layers, height, stride = delta_plane.shape
    if stride % LANE or height % STRIP_H:
        raise ValueError(f"planes {tuple(delta_plane.shape)}: stride must be "
                         f"a multiple of {LANE}, height of {STRIP_H}")
    rules = layer_rules(normalize_fill_rule(fill_rule, n_layers), n_layers)
    delta_plane = delta_plane.to(torch.float32).contiguous()
    colors = colors.to(device=delta_plane.device,
                       dtype=torch.float32).contiguous()
    if tuple(colors.shape) != (n_frames, n_layers, 4):
        raise ValueError(f"colors {tuple(colors.shape)} for planes "
                         f"{tuple(delta_plane.shape)}")
    if delta_plane.device.type == "cpu":
        return resolve_plain(delta_plane, colors, rules)
    if delta_plane.device.type != "cuda":
        raise ValueError(f"unsupported device {delta_plane.device}")
    out = _launch(delta_plane, colors, rules)
    resolve_frames.launches += 1
    return out


resolve_frames.launches = 0


def resolve_frame(area_plane, cover_plane, colors,
                  fill_rule=FILL_RULE_NONZERO):
    """One frame from separate area / cover planes: (L, H, S) -> (4, H,
    S), through the delta encoding delta[c] = area[c] - area[c-1] +
    cover[c]."""
    shifted = torch.nn.functional.pad(area_plane[:, :, :-1], (1, 0))
    delta = area_plane - shifted + cover_plane
    return resolve_frames(delta[None], colors[None], fill_rule)[0]


def _geometry(height, width):
    stride = ((width + 1 + LANE - 1) // LANE) * LANE
    h_pad = height + (-height % STRIP_H)
    return stride, h_pad


def _frames_u8(planes, colors, fill_rule, height, width):
    from .composite import premul_to_straight_u8

    frames_pm = resolve_frames(planes, colors, fill_rule)
    return premul_to_straight_u8(
        frames_pm.permute(0, 2, 3, 1)[:, :height, :width])


def _tensors(device, *arrays):
    return [a.to(device) if torch.is_tensor(a)
            else torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def render_scanline_updates(rows, cols, vals, colors, height: int,
                            width: int, fill_rule=FILL_RULE_NONZERO,
                            device=None):
    """Resolve pre-coalesced delta updates (the native splitter's output,
    sorted per draw, padded with value 0 at the draw's last position):
    rows / cols / vals (F, L, N), colours (F, L, 4) -> (F, H, W, 4) uint8.

    The updates of all frames scatter into one set of planes,
    accumulating (the padding adds 0.0 onto the draw's last target), and
    resolve in one kernel launch (the reference scans 4 frames at a
    time)."""
    device = resolve_device(device) if not torch.is_tensor(rows) \
        else rows.device
    rows, cols, vals, colors = _tensors(device, rows, cols, vals, colors)
    f, l, _ = rows.shape
    stride, h_pad = _geometry(height, width)
    plane = h_pad * stride
    base = torch.arange(f * l, device=device).view(f, l, 1) * plane
    planes = scatter_add(f * l * plane,
                         base + rows.long() * stride + cols.long(),
                         vals.to(torch.float32))
    return _frames_u8(planes.view(f, l, h_pad, stride), colors, fill_rule,
                      height, width)


def render_scanline_fused(rows, cols, area, cover, colors, height: int,
                          width: int, fill_rule=FILL_RULE_NONZERO,
                          device=None):
    """Cell lists (F, L, N) -> (F, H, W, 4) uint8 through the resolve
    kernel: each cell adds its area at its column and cover - area at the
    next (padding cells, zero area and cover, go to a spare position at
    the plane's end)."""
    device = resolve_device(device) if not torch.is_tensor(rows) \
        else rows.device
    rows, cols, area, cover, colors = _tensors(device, rows, cols, area,
                                               cover, colors)
    f, l, _ = rows.shape
    stride, h_pad = _geometry(height, width)
    plane = h_pad * stride
    area = area.to(torch.float32)
    cover = cover.to(torch.float32)
    is_pad = (area == 0.0) & (cover == 0.0)
    pos = torch.where(is_pad, torch.full_like(rows.long(), plane - 2),
                      rows.long() * stride + cols.long())
    base = torch.arange(f * l, device=device).view(f, l, 1) * plane + pos
    planes = scatter_add(f * l * plane,
                         torch.stack([base, base + 1], dim=-1),
                         torch.stack([area, cover - area], dim=-1))
    return _frames_u8(planes.view(f, l, h_pad, stride), colors, fill_rule,
                      height, width)


def pack_updates(update_lists, pad_multiple: int = 512):
    """Pad per-draw (rows, cols, vals) update lists to a common length.
    Padding entries carry value 0 at the draw's last position, so each
    draw's sorted order is kept."""
    count = max(1, max(r.shape[0] for r, _, _ in update_lists))
    n = ((count + pad_multiple - 1) // pad_multiple) * pad_multiple
    p = len(update_lists)
    rows = np.zeros((p, n), np.int32)
    cols = np.zeros((p, n), np.int32)
    vals = np.zeros((p, n), np.float32)
    for i, (r, c, v) in enumerate(update_lists):
        k = r.shape[0]
        rows[i, :k] = r
        cols[i, :k] = c
        vals[i, :k] = v
        if k:
            rows[i, k:] = r[-1]
            cols[i, k:] = c[-1]
    return rows, cols, vals
