"""Fill-style (paint) evaluation: per-pixel straight-alpha RGBA fields.

Port of ``swf_renderer_tpu/ops/style.py``: solid colors, linear and
focal gradients (sRGB and linear-RGB interpolation, pad/reflect/repeat
spreads) and bitmap patterns.  Gradient fields are plain PyTorch tensor
code on the caller's device.  A smoothed bitmap under an axis-aligned
matrix takes the separable resampling route (two contractions); any
other bitmap fill — rotated, skewed or unsmoothed — samples through the
texfield kernel (``ops/texfield.py``).

The separable bitmap route contracts with ``torch.einsum`` in float32.
The reference contracts at ``Precision.HIGHEST``, so it switches TF32
matrix products off (``torch.backends.cuda.matmul.allow_tf32 = False``)
before it multiplies.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.numerics import floor_mod, true_div
from .texfield import (
    bitmap_field_planes, premultiplied_texels, texfield_plain, unpremultiply,
)

GRAD_RADIUS = 16384.0

SPREAD_PAD = 0
SPREAD_REFLECT = 1
SPREAD_REPEAT = 2

PAINT_SOLID = 0
PAINT_LINEAR = 1
PAINT_FOCAL = 2
PAINT_BITMAP = 3


@dataclasses.dataclass(frozen=True)
class Paint:
    """A resolved, device-space paint.

    ``inv_matrix`` maps device pixel coordinates into paint space (gradient
    units / bitmap pixels): the inverse of CTM ∘ fill_matrix.
    """

    kind: int
    color: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    inv_matrix: Tuple[float, float, float, float, float, float] = (
        1.0, 0.0, 0.0, 1.0, 0.0, 0.0,
    )
    # Gradients
    stop_ratios: Optional[np.ndarray] = None  # (K,) f32 in [0, 1]
    stop_colors: Optional[np.ndarray] = None  # (K, 4) f32 straight RGBA
    focal_point: float = 0.0
    spread: int = SPREAD_PAD
    # "s-rgb" interpolates stop colors directly; "linear-rgb" applies the
    # sRGB transfer function around the interpolation (SWF colorSpace).
    color_space: str = "s-rgb"
    # Bitmaps
    image: Optional[np.ndarray] = None  # (h, w, 4) uint8
    repeating: bool = False
    smoothed: bool = True
    # Non-repeating pattern edge semantics: 'canvas' renders TRANSPARENT
    # outside the image; 'flash' clamps edge texels outward.
    edge_mode: str = "flash"
    # Box supersampling per axis of bitmap sampling (Flash quality high).
    supersample: int = 4


def solid_paint(rgba) -> Paint:
    return Paint(kind=PAINT_SOLID, color=tuple(float(c) for c in rgba))


def _apply_spread(t, spread: int):
    if spread == SPREAD_PAD:
        return torch.clamp(t, 0.0, 1.0)
    if spread == SPREAD_REPEAT:
        return floor_mod(t, 1.0)
    if spread == SPREAD_REFLECT:
        m = floor_mod(t, 2.0)
        return 1.0 - torch.abs(m - 1.0)
    raise ValueError(f"unknown spread {spread}")


def _interp(x, xp, fp):
    """jnp.interp (constant extrapolation) of f32 samples: ``x`` (N,)
    against values ``fp`` (K,), or ``x`` (F, N) against per-frame values
    ``fp`` (F, K)."""
    k = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, k - 1)

    def take(j):
        return fp[j] if fp.ndim == 1 else torch.gather(fp, 1, j)

    lo, hi = take(i - 1), take(i)
    df = hi - lo
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, lo,
                    lo + (delta / torch.where(
                        dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[..., :1], f)
    return torch.where(x > xp[-1], fp[..., -1:], f)


def _interp_stops(t, ratios, colors):
    """Piecewise-linear color ramp (Canvas gradient semantics), straight
    alpha.  ``t``: (H, W) or (F, H, W); ratios (K,); colors (K, 4), or
    (F, K, 4) per-frame stops for a (F, H, W) ``t``."""
    flat = (t.reshape(-1) if colors.ndim == 2
            else t.reshape(t.shape[0], -1)).contiguous()
    channels = [_interp(flat, ratios, colors[..., ch].contiguous())
                .reshape(t.shape) for ch in range(4)]
    return torch.stack(channels, dim=-1)


def _focal_gradient_t(sx, sy, focal_point: float):
    """Canvas createRadialGradient((f*R, 0), 0) -> ((0, 0), R) parameter:
    the greatest root t of |p - t*c| = t*R.  Constants round to f32 where
    the reference weak-types its Python-double expressions."""
    f32 = np.float32
    fx = focal_point * GRAD_RADIUS
    cdx = -fx  # c1 - c0
    a = cdx * cdx - GRAD_RADIUS * GRAD_RADIUS
    pdx = sx - float(f32(fx))
    pdy = sy
    b = pdx * float(f32(cdx))
    cc = pdx * pdx + pdy * pdy
    a32 = f32(a)
    if np.abs(a32) < f32(1e-6):
        tiny = torch.abs(b) < f32(1e-9)
        safe_b = torch.where(tiny, torch.full_like(b, 1e-9), b)
        return torch.where(tiny, torch.zeros_like(b), cc / (2.0 * safe_b))
    disc = torch.clamp(b * b - float(a32) * cc, min=0.0)
    sq = torch.sqrt(disc)
    return torch.maximum(true_div(b + sq, float(a32)),
                         true_div(b - sq, float(a32)))


def _srgb_to_linear(c):
    """sRGB EOTF, applied to straight RGB channels (alpha stays linear)."""
    return torch.where(c <= 0.04045, true_div(c, 12.92),
                       true_div(c + 0.055, 1.055) ** 2.4)


def _linear_to_srgb(c):
    c = torch.clamp(c, min=0.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * c ** (1.0 / 2.4) - 0.055)


def _gradient_rgba(paint: Paint, t, device, stop_colors=None) -> torch.Tensor:
    """Stop interpolation honoring the SWF colorSpace flag.
    ``stop_colors``: optional (F, K, 4) per-frame override of the paint's
    stop colours, for a (F, H, W) ``t``."""
    ratios = torch.as_tensor(np.asarray(paint.stop_ratios, np.float32),
                             device=device)
    colors = (stop_colors if stop_colors is not None else torch.as_tensor(
        np.asarray(paint.stop_colors, np.float32), device=device))
    if paint.color_space == "linear-rgb":
        colors = torch.cat([_srgb_to_linear(colors[..., :3]),
                            colors[..., 3:]], dim=-1)
        out = _interp_stops(t, ratios, colors)
        return torch.cat([_linear_to_srgb(out[..., :3]), out[..., 3:]],
                         dim=-1)
    return _interp_stops(t, ratios, colors)


def paint_field_traced(paint: Paint, invs, height: int, width: int,
                       stop_colors=None) -> torch.Tensor:
    """``paint_field`` under PER-FRAME device->paint matrices: ``invs``
    (F, 6) f32 tensor -> (F, H, W, 4) straight RGBA on its device.  The
    batched twin used by the transform sweep's field baking
    (ops.transform.bake_sweep_fields); ``stop_colors``: optional (F, K, 4)
    per-frame stop colours (color-transform fades).  Every step is the
    same f32 operation ``paint_field`` performs for one matrix.  Bitmaps
    take the supersampled gather at every matrix: the texfield kernel's
    plain version."""
    device = invs.device
    if paint.kind == PAINT_SOLID:
        color = torch.tensor(paint.color, dtype=torch.float32, device=device)
        return color.expand(invs.shape[0], height, width, 4)
    if paint.kind == PAINT_BITMAP:
        return texfield_plain(
            torch.as_tensor(np.asarray(paint.image), device=device), invs,
            height, width, max(1, int(paint.supersample)), paint.repeating,
            paint.smoothed, paint.edge_mode)
    if paint.kind not in (PAINT_LINEAR, PAINT_FOCAL):
        raise ValueError(f"unknown paint kind {paint.kind}")
    a, b, c, d, e, f = (invs[:, k, None, None] for k in range(6))
    py = torch.arange(height, dtype=torch.float32,
                      device=device)[None, :, None] + 0.5
    px = torch.arange(width, dtype=torch.float32,
                      device=device)[None, None, :] + 0.5
    sx = a * px + c * py + e
    sy = b * px + d * py + f
    if paint.kind == PAINT_LINEAR:
        t = true_div(sx + GRAD_RADIUS, 2.0 * GRAD_RADIUS)
    else:
        t = _focal_gradient_t(sx, sy, paint.focal_point)
    return _gradient_rgba(paint, _apply_spread(t, paint.spread), device,
                          stop_colors)


def paint_field(paint: Paint, height: int, width: int,
                device=None) -> torch.Tensor:
    """Evaluate a paint to an (H, W, 4) straight-alpha RGBA f32 field on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    if paint.kind == PAINT_SOLID:
        color = torch.tensor(paint.color, dtype=torch.float32, device=device)
        return color.expand(height, width, 4)

    inv = np.asarray([paint.inv_matrix], np.float32)
    if paint.kind in (PAINT_LINEAR, PAINT_FOCAL):
        return paint_field_traced(paint, torch.as_tensor(inv, device=device),
                                  height, width)[0]

    if paint.kind == PAINT_BITMAP:
        a, b, c, d, e, f = paint.inv_matrix
        if b == 0.0 and c == 0.0 and paint.smoothed:
            # The reference builds these weights from the matrix's
            # Python floats, not their f32 roundings.
            return _separable_fields(paint, [(a, e, d, f)], height, width,
                                     device)[0]
        # Rotated, skewed or unsmoothed: the supersampled gather of the
        # texfield kernel, at every texture size.
        return bitmap_field_planes(
            paint.image, inv, height, width,
            supersample=max(1, int(paint.supersample)),
            repeating=paint.repeating, smoothed=paint.smoothed,
            edge_mode=paint.edge_mode, device=device)[0]

    raise ValueError(f"unknown paint kind {paint.kind}")


def separable_frames_mask(paint: "Paint", invs) -> np.ndarray:
    """(F,) bool: which composed device->paint inverses ``paint_field``
    routes through the separable axis-aligned path.  The sweep bake sends
    exactly these frames through the same weights: supersampled bilinear
    there would differ from per-frame renders wherever an axis is
    DOWNSCALED (the separable path then uses the exact box filter)."""
    invs = np.asarray(invs, np.float32).reshape(-1, 6)
    if paint.kind != PAINT_BITMAP or not paint.smoothed:
        return np.zeros(invs.shape[0], bool)
    return (invs[:, 1] == 0.0) & (invs[:, 2] == 0.0)


def separable_field_stack(paint: "Paint", invs, height: int, width: int,
                          device=None) -> torch.Tensor:
    """(F, H, W, 4) straight-RGBA fields of axis-aligned frames through
    the separable path, from the f32 composed inverses ``invs`` (F, 6) —
    the same weights ``paint_field`` builds for one such matrix."""
    invs = np.asarray(invs, np.float32).reshape(-1, 6)
    return _separable_fields(
        paint, [(float(a), float(e), float(d), float(f))
                for a, _b, _c, d, e, f in invs],
        height, width, resolve_device(device))


def _separable_fields(paint: "Paint", scales, height: int, width: int,
                      device) -> torch.Tensor:
    """[(x scale, x offset, y scale, y offset)] per frame -> (F, H, W, 4):
    per-frame weight matrices built on the host, two batched float32
    contractions on ``device`` (TF32 off: the reference contracts at
    Precision.HIGHEST)."""
    img = premultiplied_texels(
        torch.as_tensor(np.asarray(paint.image), device=device))
    wx = torch.as_tensor(np.stack([
        _separable_axis_weights(paint, width, img.shape[1], a, e)
        for a, e, _d, _f in scales]), device=device)   # (F, W, Tw)
    wy = torch.as_tensor(np.stack([
        _separable_axis_weights(paint, height, img.shape[0], d, f)
        for _a, _e, d, f in scales]), device=device)   # (F, H, Th)
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = torch.einsum("hwc,fxw->fhxc", img, wx)
    return unpremultiply(torch.einsum("fhxc,fyh->fyxc", tmp, wy))


def _box_weights(n_out: int, n_img: int, scale: float, offset: float,
                 repeating: bool, edge_mode: str = "flash") -> np.ndarray:
    """(n_out, n_img) EXACT box-filter weights along one axis: output pixel
    i averages the texels its footprint [scale*i+offset, scale*(i+1)+offset)
    overlaps (texel j covers [j, j+1)) — the area average for DOWNSCALED
    patterns."""
    out = np.arange(n_out, dtype=np.float64)[:, None]
    lo = scale * out + offset
    hi = scale * (out + 1.0) + offset
    lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    length = np.maximum(hi - lo, 1e-12)
    j = np.arange(n_img, dtype=np.float64)[None, :]
    if repeating:
        w = np.zeros((n_out, n_img))
        k0 = int(np.floor(lo.min() / n_img))
        k1 = int(np.floor(hi.max() / n_img))
        for k in range(k0, k1 + 1):
            jj = j + k * n_img
            w += np.clip(np.minimum(hi, jj + 1.0) - np.maximum(lo, jj),
                         0.0, None)
    else:
        w = np.clip(np.minimum(hi, j + 1.0) - np.maximum(lo, j), 0.0, None)
        if edge_mode != "canvas":
            # Clamp-to-edge: out-of-range footprint lands on edge texels.
            w[:, 0:1] += np.clip(np.minimum(hi, 0.0) - lo, 0.0, None)
            w[:, -1:] += np.clip(hi - np.maximum(lo, float(n_img)), 0.0,
                                 None)
    return np.asarray(w / length, np.float32)


def _resample_weights(n_out: int, n_img: int, scale: float, offset: float,
                      supersample: int, repeating: bool,
                      edge_mode: str = "flash") -> np.ndarray:
    """(n_out, n_img) weights: output pixel i = sum_j w[i, j] * img[j]
    under box-supersampled bilinear sampling along one axis
    (coords = scale * (i + (k+0.5)/n) + offset, texel centers at +0.5),
    with SWF wrap (repeat) or clamp-to-edge semantics, in f32."""
    out_ids = np.arange(n_out, dtype=np.float32)[:, None]
    img_ids = np.arange(n_img, dtype=np.float32)[None, :]
    w = np.zeros((n_out, n_img), np.float32)
    f32 = np.float32
    for k in range(supersample):
        coord = (f32(scale) * (out_ids + f32((k + 0.5) / supersample))
                 + f32(offset) - f32(0.5))
        x0 = np.floor(coord)
        t = coord - x0
        if repeating:
            i0 = np.mod(x0, f32(n_img))
            i1 = np.mod(x0 + f32(1.0), f32(n_img))
        elif edge_mode == "canvas":
            # Out-of-range taps contribute nothing (transparent outside).
            i0, i1 = x0, x0 + f32(1.0)
        else:
            i0 = np.clip(x0, f32(0.0), f32(n_img - 1.0))
            i1 = np.clip(x0 + f32(1.0), f32(0.0), f32(n_img - 1.0))
        w = w + np.where(img_ids == i0, f32(1.0) - t, f32(0.0))
        w = w + np.where(img_ids == i1, t, f32(0.0))
    return (w / f32(supersample)).astype(np.float32)


def _separable_axis_weights(paint: "Paint", n_out: int, n_img: int,
                            scale: float, offset: float) -> np.ndarray:
    """One axis of the separable (axis-aligned, smoothed) resampling: the
    EXACT box filter on downscaled axes when supersampling, folded
    supersampled bilinear otherwise."""
    n = max(1, int(paint.supersample))
    if abs(scale) >= 1.0 and n > 1:
        return _box_weights(n_out, n_img, scale, offset,
                            paint.repeating, paint.edge_mode)
    return _resample_weights(n_out, n_img, scale, offset, n,
                             paint.repeating, paint.edge_mode)
