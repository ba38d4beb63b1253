"""Premultiplied alpha-over compositing and u8 quantization (port of
``swf_renderer_tpu/ops/composite.py``): the layered backends composite
per-draw coverage planes here, painter's order, in premultiplied space,

    dst = src_rgb * src_a * cov + dst * (1 - src_a * cov),

and every path quantizes through premultiplied bytes.  Blend modes
composite a group's premultiplied image onto its backdrop
(``blend_premul``), on the fused route's planes and on the layered
backends' frames alike."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.numerics import true_div

BLEND_MODES = (
    "multiply", "screen", "lighten", "darken", "difference", "add",
    "subtract", "invert", "overlay", "hardlight",
)

# Group-compositing modes: not separable colour blends — they act on the
# BACKDROP plane as a whole (Flash's layer/alpha/erase family).  "layer"
# is plain source-over of the composed group; "alpha" rewrites the
# backdrop's alpha from the source's (a soft mask); "erase" removes
# backdrop where the source is opaque.  alpha/erase only make sense
# inside an offscreen group buffer — the scene compiler guarantees one.
GROUP_MODES = ("layer", "alpha", "erase")


def _blend_fn(mode: str):
    """Separable blend function B(Cb, Cs) on straight colours in [0, 1]:
    the W3C compositing-1 formulas, Flash's clamped add / subtract, and
    ``invert`` (1 - Cb, the source colour ignored)."""
    if mode == "multiply":
        return lambda cb, cs: cb * cs
    if mode == "screen":
        return lambda cb, cs: cb + cs - cb * cs
    if mode == "lighten":
        return torch.maximum
    if mode == "darken":
        return torch.minimum
    if mode == "difference":
        return lambda cb, cs: torch.abs(cb - cs)
    if mode == "add":
        return lambda cb, cs: torch.clamp(cb + cs, max=1.0)
    if mode == "subtract":
        return lambda cb, cs: torch.clamp(cb - cs, min=0.0)
    if mode == "invert":
        return lambda cb, cs: 1.0 - cb
    if mode == "hardlight":
        return lambda cb, cs: torch.where(
            cs <= 0.5, cb * (2.0 * cs),
            cb + (2.0 * cs - 1.0) - cb * (2.0 * cs - 1.0))
    if mode == "overlay":
        hl = _blend_fn("hardlight")
        return lambda cb, cs: hl(cs, cb)
    raise ValueError(f"unsupported blend mode {mode!r}")


def blend_premul(dst_pm, src_pm, mode: str, channel_axis: int = -1):
    """Composite premultiplied ``src_pm`` onto ``dst_pm`` under a blend
    mode (PDF/W3C group compositing):

        Co_pm = (1-ab)*Cs_pm + (1-as)*Cb_pm + as*ab*B(Cb, Cs)
        ao    = as + ab - as*ab

    ``channel_axis`` locates the 4-wide (r, g, b, a) axis (2 on the
    fused kernel's planes, -1 on frames).  GROUP_MODES bypass the
    separable formula: "layer" is source-over, "alpha" scales every
    backdrop channel by the source alpha, "erase" by its complement."""

    def take(x, lo, hi):
        return x.narrow(channel_axis, lo, hi - lo)

    if mode in GROUP_MODES:
        src_a = take(src_pm, 3, 4)
        if mode == "layer":
            return src_pm + dst_pm * (1.0 - src_a)
        if mode == "alpha":
            return dst_pm * src_a
        return dst_pm * (1.0 - src_a)
    b = _blend_fn(mode)
    src_rgb, src_a = take(src_pm, 0, 3), take(src_pm, 3, 4)
    dst_rgb, dst_a = take(dst_pm, 0, 3), take(dst_pm, 3, 4)
    cs = src_rgb / torch.clamp(src_a, min=1e-6)
    cb = dst_rgb / torch.clamp(dst_a, min=1e-6)
    out_rgb = ((1.0 - dst_a) * src_rgb + (1.0 - src_a) * dst_rgb
               + src_a * dst_a * b(cb, cs))
    out_a = src_a + dst_a - src_a * dst_a
    return torch.cat([out_rgb, out_a], dim=channel_axis)


def premul_to_straight_u8(frame_pm) -> np.ndarray:
    """Premultiplied float RGBA -> straight u8 through PREMULTIPLIED-u8
    quantization (ARGB32 parity): round premul and alpha to bytes first,
    then un-premultiply the bytes.  Pixels whose alpha byte is 0 are
    fully zero."""
    pm = torch.as_tensor(frame_pm, dtype=torch.float32)
    a8 = torch.round(torch.clamp(pm[..., 3:4], 0.0, 1.0) * 255.0)
    pm8 = torch.minimum(torch.round(pm[..., :3] * 255.0), a8)
    rgb8 = torch.round(pm8 * true_div(255.0, torch.clamp(a8, min=1.0)))
    out = torch.cat([rgb8, a8], dim=-1).to(torch.uint8)
    return out.cpu().numpy()


def over_premul(dst_pm, src_rgba, coverage):
    """One painter's-algorithm step: ``dst_pm`` (..., H, W, 4)
    premultiplied, ``src_rgba`` (..., H, W, 4) straight colour field,
    ``coverage`` (..., H, W) in [0, 1]."""
    cov = coverage[..., None]
    src_a = src_rgba[..., 3:4]
    src_pm = torch.cat([src_rgba[..., :3] * src_a, src_a], dim=-1)
    return src_pm * cov + dst_pm * (1.0 - src_a * cov)


def composite_draws(coverages, colors):
    """Composite P draws in order: coverages (P, H, W), colours (P, H, W,
    4) straight -> (H, W, 4) premultiplied."""
    p, h, w = coverages.shape
    out = torch.zeros((h, w, 4), dtype=torch.float32,
                      device=coverages.device)
    for i in range(p):
        out = over_premul(out, colors[i], coverages[i])
    return out


def composite_to_u8(coverages, colors) -> np.ndarray:
    return premul_to_straight_u8(composite_draws(coverages, colors))


def composite_solid_layers(coverages, colors):
    """Painter's composite of CONSTANT-colour layers: coverages (..., L,
    H, W), colours (..., L, 4) straight -> (..., H, W, 4) premultiplied
    (leading dimensions are frames)."""
    *lead, layers, h, w = coverages.shape
    out = torch.zeros((*lead, h, w, 4), dtype=torch.float32,
                      device=coverages.device)
    for i in range(layers):
        col = colors[..., i, :]
        src_a = col[..., 3:4]
        src_pm = torch.cat([col[..., :3] * src_a, src_a], dim=-1)
        src_pm = src_pm[..., None, None, :]
        cov = coverages[..., i, :, :, None]
        out = src_pm * cov + out * (1.0 - src_a[..., None, None, :] * cov)
    return out
