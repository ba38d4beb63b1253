"""The reference's paints and matrices, in plain PyTorch: SWF matrices as
affine maps, a straight colour under a colour transform, a linear
gradient sampled at pixel centres.

- a colour transform maps each straight colour
  ``clamp(c * mult / 256 + add / 255)``;
- a linear gradient spans the square of +-16384 twips under its matrix,
  then the instance's; pad spread, stops at ratio / 255, straight RGBA
  interpolated.
"""

from __future__ import annotations

import torch

GRAD_RADIUS = 16384.0


def affine(m):
    """SWF matrix ints -> (a, b, c, d, e, f): x' = a x + c y + e,
    y' = b x + d y + f."""
    if m is None:
        return (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
    sx, sy, r0, r1, tx, ty = m
    return (sx / 65536, r0 / 65536, r1 / 65536, sy / 65536, float(tx),
            float(ty))


def compose(outer, inner):
    """outer o inner: apply ``inner`` first."""
    a, b, c, d, e, f = outer
    A, B, C, D, E, F = inner
    return (a * A + c * B, b * A + d * B, a * C + c * D, b * C + d * D,
            a * E + c * F + e, b * E + d * F + f)


def inverse(m):
    a, b, c, d, e, f = m
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    return (ia, ib, ic, id_, -(ia * e + ic * f), -(ib * e + id_ * f))


def color(rgba, cxform, dtype, device):
    c = torch.tensor([v / 255.0 for v in rgba], dtype=dtype, device=device)
    if cxform is not None:
        mult, add = cxform
        c = torch.clamp(
            c * torch.tensor([v / 256.0 for v in mult], dtype=dtype,
                             device=device)
            + torch.tensor([v / 255.0 for v in add], dtype=dtype,
                           device=device), 0.0, 1.0)
    return c


def gradient(matrix, aff, stops, cxform, height, width, dtype, device,
             geo_dtype):
    """(H, W, 4) straight colours of a linear gradient with SWF matrix
    ``matrix`` under the instance's ``aff``: pixels are mapped into the
    gradient square in ``geo_dtype``, the colours interpolated in
    ``dtype``."""
    to_px = compose((0.05, 0.0, 0.0, 0.05, 0.0, 0.0),
                    compose(aff, affine(matrix)))
    a, b, c, d, e, f = inverse(to_px)
    py = torch.arange(height, dtype=geo_dtype, device=device)[:, None] + 0.5
    px = torch.arange(width, dtype=geo_dtype, device=device)[None, :] + 0.5
    gx = a * px + c * py + e
    t = torch.clamp((gx + GRAD_RADIUS) / (2 * GRAD_RADIUS), 0.0,
                    1.0).to(dtype)
    ratios = [r / 255.0 for r, _ in stops]
    cols = [color(col, cxform, dtype, device) for _, col in stops]
    out = cols[0].expand(height, width, 4).clone()
    for i in range(1, len(stops)):
        span = ratios[i] - ratios[i - 1]
        if span <= 0:
            continue
        w = torch.clamp((t - ratios[i - 1]) / span, 0.0, 1.0)[..., None]
        seg = cols[i - 1] + w * (cols[i] - cols[i - 1])
        out = torch.where((t > ratios[i - 1])[..., None], seg, out)
    return out
