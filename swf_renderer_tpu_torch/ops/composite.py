"""Premultiplied alpha-over compositing and u8 quantization (port of
``swf_renderer_tpu/ops/composite.py``): the layered backends composite
per-draw coverage planes here, painter's order, in premultiplied space,

    dst = src_rgb * src_a * cov + dst * (1 - src_a * cov),

and every path quantizes through premultiplied bytes.  Blend-mode
compositing belongs to the masked program, which this port does not have
yet (ROADMAP.md queue A)."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.numerics import true_div

# Blend modes the scene compiler accepts as group tokens (the executors
# that composite them are out of this port's slice).
BLEND_MODES = (
    "multiply", "screen", "lighten", "darken", "difference", "add",
    "subtract", "invert", "overlay", "hardlight",
)


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
