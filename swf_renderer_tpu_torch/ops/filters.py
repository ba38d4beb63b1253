"""Bitmap filters (PlaceObject3 SURFACEFILTERLIST): all eight kinds —
drop shadow, blur, glow, bevel, gradient glow, convolution, colour
matrix, gradient bevel (port of ``swf_renderer_tpu/ops/filters.py``).

Filters apply to a display object's COMPOSED premultiplied image (the
same group isolation as masks and blends): blur is the player's
iterated box blur (a box of width ``ceil(2 * blur)`` per pass approaches
a Gaussian by 3 passes), drop shadow / glow / bevel build on blurred,
optionally shifted silhouettes, the gradient variants map those fields
through a 256-entry premultiplied gradient table, convolution is a small
dense kernel on straight RGBA, and colour matrix the 20-term affine on
straight RGBA.  Every op is a PyTorch op on (..., H, W, 4) premultiplied
f32 on the image's device, with transparent black outside the frame;
the box blur is a cumulative-sum prefix difference (O(H*W) per pass
whatever the radius).  The reference runs these in XLA, not Pallas:
there is no kernel to port.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch

from ..utils.numerics import true_div


@dataclasses.dataclass(frozen=True)
class BlurFilter:
    blur_x: float  # px
    blur_y: float
    passes: int = 1


@dataclasses.dataclass(frozen=True)
class DropShadowFilter:
    color: Tuple[float, float, float, float]  # straight RGBA [0,1]
    blur_x: float
    blur_y: float
    angle: float      # radians
    distance: float   # px
    strength: float = 1.0
    inner: bool = False
    knockout: bool = False
    passes: int = 1


@dataclasses.dataclass(frozen=True)
class GlowFilter:
    color: Tuple[float, float, float, float]
    blur_x: float
    blur_y: float
    strength: float = 1.0
    inner: bool = False
    knockout: bool = False
    passes: int = 1


@dataclasses.dataclass(frozen=True)
class ColorMatrixFilter:
    # Row-major 4x5: out_ch = sum(m[ch, :4] * in_rgba) + m[ch, 4]/255
    matrix: Tuple[float, ...]  # 20 terms


@dataclasses.dataclass(frozen=True)
class BevelFilter:
    """Raised-edge lighting: the highlight rides the side FACING the
    light (at ``angle``), the shadow the opposite side.  ``inner``
    shades inside the silhouette (the player's default raised-button
    look), ``on_top`` ("full bevel") drops the silhouette mask."""

    shadow_color: Tuple[float, float, float, float]     # straight RGBA
    highlight_color: Tuple[float, float, float, float]
    blur_x: float
    blur_y: float
    angle: float      # radians
    distance: float   # px
    strength: float = 1.0
    inner: bool = False
    knockout: bool = False
    on_top: bool = False
    passes: int = 1


@dataclasses.dataclass(frozen=True)
class GradientGlowFilter:
    """Glow whose color AND alpha come from a gradient lookup of the
    blurred (optionally shifted) silhouette: index 0 = fully outside,
    1 = fully covered.  The player's GradientGlowFilter."""

    colors: Tuple[Tuple[float, float, float, float], ...]  # straight
    ratios: Tuple[float, ...]  # [0,1] stop positions, ascending
    blur_x: float
    blur_y: float
    angle: float = 0.0
    distance: float = 0.0
    strength: float = 1.0
    inner: bool = False
    knockout: bool = False
    on_top: bool = False
    passes: int = 1


@dataclasses.dataclass(frozen=True)
class GradientBevelFilter:
    """Bevel whose two sides sample a gradient: the midpoint (ratio
    0.5) is the neutral flat-surface entry, ratios above it color the
    highlight side, below it the shadow side."""

    colors: Tuple[Tuple[float, float, float, float], ...]
    ratios: Tuple[float, ...]
    blur_x: float
    blur_y: float
    angle: float = 0.0
    distance: float = 0.0
    strength: float = 1.0
    inner: bool = False
    knockout: bool = False
    on_top: bool = False
    passes: int = 1


@dataclasses.dataclass(frozen=True)
class ConvolutionFilter:
    """General small-kernel convolution on STRAIGHT RGBA (the player
    un-premultiplies first).  ``bias`` is in the wire format's 0-255
    color units; ``clamp`` replicates edge texels, otherwise the
    out-of-frame color is ``default_color``; ``preserve_alpha`` passes
    the alpha channel through untouched."""

    matrix_x: int
    matrix_y: int
    matrix: Tuple[float, ...]  # row-major, matrix_y rows
    divisor: float = 1.0
    bias: float = 0.0
    default_color: Tuple[float, float, float, float] = (0, 0, 0, 0)
    clamp: bool = True
    preserve_alpha: bool = True


Filter = object  # union of the above, by isinstance


def _box_blur_axis(img, radius_px: float, axis: int):
    """One box-blur pass along ``axis`` with a FRACTIONAL box width
    (2*radius+1 px) and zero (transparent) padding — the fractional edge
    taps make the kernel vary continuously with the blur amount — as a
    cumulative-sum prefix difference."""
    if radius_px <= 0:
        return img
    axis = axis % img.dim()
    n = img.shape[axis]
    r_int = int(math.floor(radius_px))
    frac = radius_px - r_int
    width = 2.0 * radius_px + 1.0
    # Prefix sums with a leading zero: window sum = c[i+hi] - c[i-lo].
    c = torch.cumsum(img, dim=axis)
    c = torch.cat([torch.zeros_like(c.narrow(axis, 0, 1)), c], dim=axis)
    idx = torch.arange(n, device=img.device)

    def win(lo, hi):
        # Sum over [i-lo, i+hi] inclusive, clipped to the frame.
        top = torch.clamp(idx + hi + 1, 0, n)
        bot = torch.clamp(idx - lo, 0, n)
        return (torch.index_select(c, axis, top)
                - torch.index_select(c, axis, bot))

    total = win(r_int, r_int)
    if frac > 0:
        # The fractional tails: frac of the next texel on each side.
        left = win(r_int + 1, r_int) - total
        right = win(r_int, r_int + 1) - total
        total = total + frac * (left + right)
    return true_div(total, width)


def box_blur(img, blur_x: float, blur_y: float, passes: int = 1):
    """The player's blur: ``passes`` iterated box blurs of radius blur/2
    on each axis (blur_x/blur_y are the filter's FULL widths in px)."""
    out = img
    for _ in range(max(1, int(passes))):
        if blur_x > 1:
            out = _box_blur_axis(out, (blur_x - 1.0) / 2.0, axis=-2)
        if blur_y > 1:
            out = _box_blur_axis(out, (blur_y - 1.0) / 2.0, axis=-3)
    return out


def _premul_const(color, like):
    """Straight RGBA tuple -> premultiplied (4,) constant."""
    r, g, b, a = color
    return torch.tensor([r * a, g * a, b * a, a], dtype=like.dtype,
                        device=like.device)


@functools.lru_cache(maxsize=256)
def _gradient_table(colors, ratios, n: int = 256) -> np.ndarray:
    """(n, 4) PREMULTIPLIED lookup table of a gradient given as
    straight-RGBA stops at ascending [0, 1] ratios (piecewise linear,
    clamped ends: the player's 256-entry gradient map)."""
    stops = np.asarray(ratios, np.float32)
    cols = np.asarray(colors, np.float32).reshape(-1, 4)
    xs = np.linspace(0.0, 1.0, n, dtype=np.float32)
    out = np.empty((n, 4), np.float32)
    for ch in range(4):
        out[:, ch] = np.interp(xs, stops, cols[:, ch])
    out[:, :3] *= out[:, 3:4]
    return out


def _sample_gradient(table: np.ndarray, idx01):
    """Linear-interpolated table sample: idx01 (..., H, W, 1) in [0, 1]
    -> premultiplied (..., H, W, 4)."""
    t = torch.as_tensor(table, device=idx01.device)
    x = torch.clamp(idx01[..., 0], 0.0, 1.0) * (t.shape[0] - 1.0)
    i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, t.shape[0] - 2)
    frac = (x - i0.to(x.dtype))[..., None]
    return t[i0] * (1.0 - frac) + t[i0 + 1] * frac


def _directional_alphas(img_pm, filt):
    """(toward-light, away-from-light) blurred silhouettes: ``angle`` is
    the shadow direction, so the alpha shifted BY -distance leads on the
    lit side and the +distance shift on the shadow side."""
    alpha = img_pm[..., 3:4]
    dx = filt.distance * math.cos(filt.angle)
    dy = filt.distance * math.sin(filt.angle)
    fwd = _shift2d(alpha, dy, dx) if filt.distance else alpha
    bwd = _shift2d(alpha, -dy, -dx) if filt.distance else alpha
    f = box_blur(fwd, filt.blur_x, filt.blur_y, filt.passes)
    g = box_blur(bwd, filt.blur_x, filt.blur_y, filt.passes)
    return g, f


def _place_effect(src_pm, layer_pm, filt):
    """Shared bevel/gradient compositing: ``on_top`` keeps the effect
    unmasked over the source ("full" mode), ``inner`` masks it to the
    silhouette and draws over the source, the default masks it to the
    OUTSIDE and draws under; ``knockout`` discards the source pixels."""
    a = src_pm[..., 3:4]
    base = torch.zeros_like(src_pm) if filt.knockout else src_pm
    if filt.on_top:
        return layer_pm + base * (1.0 - layer_pm[..., 3:4])
    if filt.inner:
        layer_pm = layer_pm * a
        return layer_pm + base * (1.0 - layer_pm[..., 3:4])
    if filt.knockout:
        # The effect rides UNDER the removed object: only the part
        # outside the silhouette survives.
        return layer_pm * (1.0 - a)
    return src_pm + layer_pm * (1.0 - a)


def _straight(img_pm):
    """Premultiplied -> straight RGBA (colour 0 where alpha <= 1e-6)."""
    a = img_pm[..., 3:4]
    safe = torch.clamp(a, min=1e-6)
    rgb = torch.where(a > 1e-6, img_pm[..., :3] / safe,
                      torch.zeros((), dtype=img_pm.dtype,
                                  device=img_pm.device))
    return torch.cat([rgb, a], dim=-1)


def _colored(alpha, color, like):
    """alpha (..., 1) -> premultiplied (..., 4) of a straight colour."""
    rgb = torch.tensor(color[:3], dtype=like.dtype, device=like.device)
    return torch.cat([alpha * rgb * color[3], alpha * color[3]], dim=-1)


def apply_filter(img_pm, filt):
    """Apply one filter to a premultiplied (..., H, W, 4) image."""
    if isinstance(filt, BlurFilter):
        return box_blur(img_pm, filt.blur_x, filt.blur_y, filt.passes)
    if isinstance(filt, (DropShadowFilter, GlowFilter)):
        distance = getattr(filt, "distance", 0.0)
        angle = getattr(filt, "angle", 0.0)
        alpha = img_pm[..., 3:4]
        if distance:
            dx = distance * math.cos(angle)
            dy = distance * math.sin(angle)
            alpha = _shift2d(alpha, dy, dx)
        shadow_a = box_blur(alpha, filt.blur_x, filt.blur_y,
                            filt.passes) * filt.strength
        if filt.inner:
            # Inner shadow/glow: shade the OBJECT where the (inverted,
            # shifted) silhouette is missing coverage.
            inv = torch.clamp(1.0 - shadow_a, 0.0, 1.0) * img_pm[..., 3:4]
            shade = _colored(inv, filt.color, img_pm)
            base = torch.zeros_like(img_pm) if filt.knockout else img_pm
            return shade + base * (1.0 - shade[..., 3:4])
        shadow = _colored(torch.clamp(shadow_a, 0.0, 1.0), filt.color,
                          img_pm)
        if filt.knockout:
            # Knockout: the shadow shows only OUTSIDE the object.
            return shadow * (1.0 - img_pm[..., 3:4])
        # Object over its shadow.
        return img_pm + shadow * (1.0 - img_pm[..., 3:4])
    if isinstance(filt, ColorMatrixFilter):
        m = torch.tensor(filt.matrix, dtype=img_pm.dtype,
                         device=img_pm.device).reshape(4, 5)
        straight = _straight(img_pm)
        out = (torch.einsum("...c,kc->...k", straight, m[:, :4])
               + true_div(m[:, 4], 255.0))
        out = torch.clamp(out, 0.0, 1.0)
        oa = out[..., 3:4]
        return torch.cat([out[..., :3] * oa, oa], dim=-1)
    if isinstance(filt, BevelFilter):
        g, f = _directional_alphas(img_pm, filt)
        h = torch.clamp((g - f) * filt.strength, 0.0, 1.0)
        s = torch.clamp((f - g) * filt.strength, 0.0, 1.0)
        layer = (_premul_const(filt.highlight_color, img_pm) * h
                 + _premul_const(filt.shadow_color, img_pm) * s)
        return _place_effect(img_pm, layer, filt)
    if isinstance(filt, GradientGlowFilter):
        table = _gradient_table(tuple(filt.colors), tuple(filt.ratios))
        alpha = img_pm[..., 3:4]
        field = 1.0 - alpha if filt.inner else alpha
        if filt.distance:
            dx = filt.distance * math.cos(filt.angle)
            dy = filt.distance * math.sin(filt.angle)
            field = _shift2d(field, dy, dx)
        field = box_blur(field, filt.blur_x, filt.blur_y, filt.passes)
        layer = _sample_gradient(
            table, torch.clamp(field * filt.strength, 0.0, 1.0))
        return _place_effect(img_pm, layer, filt)
    if isinstance(filt, GradientBevelFilter):
        table = _gradient_table(tuple(filt.colors), tuple(filt.ratios))
        g, f = _directional_alphas(img_pm, filt)
        idx = 0.5 + (g - f) * (filt.strength * 0.5)
        layer = _sample_gradient(table, idx)
        return _place_effect(img_pm, layer, filt)
    if isinstance(filt, ConvolutionFilter):
        return _convolve(img_pm, filt)
    raise NotImplementedError(f"NotImplementedFilter: {filt!r}")


def _convolve(img_pm, filt):
    """ConvolutionFilter on straight RGBA: edge texels replicated
    (``clamp``) or ``default_color`` outside the frame, taps summed in
    row-major order, then divisor, bias, clamp."""
    mx, my = int(filt.matrix_x), int(filt.matrix_y)
    w = np.asarray(filt.matrix, np.float64).reshape(my, mx)
    div = float(filt.divisor) or 1.0  # divisor 0 acts as 1
    a = img_pm[..., 3:4]
    straight = _straight(img_pm)
    cy, cx = my // 2, mx // 2
    h, wd = straight.shape[-3], straight.shape[-2]
    padded = _pad_hw(straight, cy, my - 1 - cy, cx, mx - 1 - cx,
                     edge=filt.clamp)
    if not filt.clamp:
        inside = _pad_hw(torch.ones((h, wd, 1), dtype=straight.dtype,
                                    device=straight.device),
                         cy, my - 1 - cy, cx, mx - 1 - cx, edge=False)
        padded = padded + (1.0 - inside) * torch.tensor(
            filt.default_color, dtype=straight.dtype,
            device=straight.device)
    acc = torch.zeros_like(straight)
    for j in range(my):
        for i in range(mx):
            if w[j, i]:
                acc = acc + float(np.float32(w[j, i])) * padded[
                    ..., j:j + h, i:i + wd, :]
    out = true_div(acc, div) + filt.bias / 255.0
    out = torch.clamp(out, 0.0, 1.0)
    if filt.preserve_alpha:
        out = torch.cat([out[..., :3], a], dim=-1)
    oa = out[..., 3:4]
    return torch.cat([out[..., :3] * oa, oa], dim=-1)


def _pad_hw(x, top: int, bottom: int, left: int, right: int, edge: bool):
    """Pad the H and W axes of (..., H, W, C): with the edge texels
    (``edge``) or zeros."""
    if edge:
        idx_h = torch.clamp(torch.arange(-top, x.shape[-3] + bottom,
                                         device=x.device),
                            0, x.shape[-3] - 1)
        idx_w = torch.clamp(torch.arange(-left, x.shape[-2] + right,
                                         device=x.device),
                            0, x.shape[-2] - 1)
        return torch.index_select(torch.index_select(x, -3 % x.dim(),
                                                     idx_h),
                                  -2 % x.dim(), idx_w)
    return torch.nn.functional.pad(x, (0, 0, left, right, top, bottom))


def apply_filters(img_pm, filters):
    for f in filters:
        img_pm = apply_filter(img_pm, f)
    return img_pm


def _shift2d(img, dy: float, dx: float):
    """Subpixel translate with bilinear weights and transparent-black
    borders (shadow offsets are rarely integral)."""
    iy, fy = int(math.floor(dy)), dy - math.floor(dy)
    ix, fx = int(math.floor(dx)), dx - math.floor(dx)
    h, w = img.shape[-3], img.shape[-2]
    ys = torch.arange(h, device=img.device)
    xs = torch.arange(w, device=img.device)

    def ishift(a, sy, sx):
        out = torch.roll(a, (sy, sx), dims=(-3, -2))
        ymask = (ys >= sy) if sy >= 0 else (ys < h + sy)
        xmask = (xs >= sx) if sx >= 0 else (xs < w + sx)
        return out * ymask[:, None, None] * xmask[None, :, None]

    w00 = (1 - fy) * (1 - fx)
    w01 = (1 - fy) * fx
    w10 = fy * (1 - fx)
    w11 = fy * fx
    out = w00 * ishift(img, iy, ix)
    if w01:
        out = out + w01 * ishift(img, iy, ix + 1)
    if w10:
        out = out + w10 * ishift(img, iy + 1, ix)
    if w11:
        out = out + w11 * ishift(img, iy + 1, ix + 1)
    return out
