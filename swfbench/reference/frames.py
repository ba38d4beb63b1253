"""The plain reference: a clip's content -> its frames, in plain PyTorch.

It reads only the generator's numbers (``gen.Clip``) and follows the
semantics the SWF content states:

- each character gives its outlines in twips and its fill
  (``outlines(inst, aff)``; ``chars/``): a shape its contours, quadratic
  edges cut into uniform-t chords within ``CURVE_TOLERANCE`` pixels of
  the curve (finer than any renderer needs); a morph its outline
  ``end * r + start * (1 - r)`` at ratio ``r = u16 / 65536``;
- geometry in twips under the instance's SWF matrix, then / 20 to pixels;
- coverage is the exact area integral of the winding number, nonzero
  rule (``raster.coverage``);
- each fill paints itself (``fills/``, ``paint.py``);
- layers composite source-over in premultiplied alpha, bottom to top,
  over a transparent frame, quantized to premultiplied u8 and then
  un-premultiplied to straight u8 bytes; an opaque stage background is
  then composited under that frame and quantized again the same way.

Everything is computed in ``dtype`` on ``device``.  Nothing of the
program under test is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..gen import Clip
from .paint import affine
from .raster import coverage

CURVE_TOLERANCE = 0.01   # px, largest gap between a curve and its chords


def _apply(aff, p):
    a, b, c, d, e, f = aff
    return np.stack([a * p[..., 0] + c * p[..., 1] + e,
                     b * p[..., 0] + d * p[..., 1] + f], -1)


def polyline(pts, ctrl, curved, aff):
    """A closed contour's vertices in twips (f64), curves cut into chords
    by the deviation of their pixel-space images."""
    p0 = pts.astype(np.float64)
    p1 = np.roll(p0, -1, axis=0)
    c = np.where(curved[:, None], ctrl.astype(np.float64), (p0 + p1) / 2)
    dev = np.hypot(*(_apply(aff, p0 - 2 * c + p1)
                     - _apply(aff, np.zeros_like(p0))).T) / 20.0
    n = np.where(curved, np.maximum(1, np.ceil(np.sqrt(
        dev / (4 * CURVE_TOLERANCE)))), 1).astype(np.int64)
    idx = np.repeat(np.arange(len(p0)), n)
    k = np.arange(idx.size) - (np.cumsum(n) - n)[idx] + 1
    t = (k / n[idx])[:, None]
    return ((1 - t) ** 2 * p0[idx] + 2 * (1 - t) * t * c[idx]
            + t * t * p1[idx])


def _quantize(pm, a):
    """Premultiplied (..., 3) and alpha (..., 1) -> straight u8-valued
    floats through premultiplied u8."""
    a8 = torch.round(torch.clamp(a, 0.0, 1.0) * 255.0)
    pm8 = torch.minimum(torch.round(pm * 255.0), a8)
    rgb = torch.round(pm8 * (255.0 / torch.clamp(a8, min=1.0)))
    return torch.cat([rgb, a8], -1)


def _geometry(clip: Clip, f: int, dtype, device):
    """Frame ``f``'s edges in pixels, the layer of each, and each layer's
    (fill, colour transform, matrix)."""
    pts, nxt, mats, owner, fills = [], [], [], [], []
    n = 0
    for layer, inst in enumerate(clip.frames[f]):
        aff = affine(inst.matrix)
        polys, fill = inst.char.outlines(inst, aff)
        for poly in polys:
            k = len(poly)
            pts.append(np.asarray(poly, np.float64))
            nxt.append(n + (np.arange(k) + 1) % k)
            mats.append(np.broadcast_to(np.asarray(aff), (k, 6)))
            owner.append(np.full(k, layer))
            n += k
        fills.append((fill, inst.cxform, aff))

    def put(x, dt):
        return torch.as_tensor(np.concatenate(x)).to(device=device, dtype=dt)

    p, m = put(pts, dtype), put(mats, dtype)
    x = (m[:, 0] * p[:, 0] + m[:, 2] * p[:, 1] + m[:, 4]) / 20.0
    y = (m[:, 1] * p[:, 0] + m[:, 3] * p[:, 1] + m[:, 5]) / 20.0
    q = torch.stack([x, y], 1)
    nx = put(nxt, torch.int64)
    return torch.cat([q, q[nx]], 1), put(owner, torch.int64), fills


def covered_pixels(clip: Clip, f: int, device="cpu") -> list:
    """Pixels each layer of frame ``f`` covers at all."""
    edges, owner, fills = _geometry(clip, f, torch.float32, device)
    cov = coverage(edges, owner, len(fills), clip.height, clip.width)
    return [int(n) for n in (cov > 0).sum((1, 2)).tolist()]


def frame(clip: Clip, f: int, dtype=torch.float64, device="cpu",
          paint_dtype=None):
    """Frame ``f`` of ``clip`` as an (H, W, 4) uint8 tensor: geometry and
    coverage in ``dtype``, paints, composite and quantize in
    ``paint_dtype`` (``dtype`` when None)."""
    h, w = clip.height, clip.width
    edges, owner, fills = _geometry(clip, f, dtype, device)
    cov = coverage(edges, owner, len(fills), h, w)
    geo_dtype, dtype = dtype, paint_dtype or dtype
    cov = cov.to(dtype)
    paints = [fill.paint(cxform, aff, h, w, dtype, device, geo_dtype)
              for fill, cxform, aff in fills]
    rgb = torch.zeros((h, w, 3), dtype=dtype, device=device)
    alpha = torch.zeros((h, w, 1), dtype=dtype, device=device)
    for layer, paint in enumerate(paints):
        ca = paint[..., 3:4] * cov[layer][..., None]
        rgb = paint[..., :3] * ca + rgb * (1.0 - ca)
        alpha = ca + alpha * (1.0 - ca)
    out = _quantize(rgb, alpha)
    bg = clip.background
    if bg[3]:
        a = out[..., 3:] / 255.0
        ba = bg[3] / 255.0
        bg_pm = torch.tensor([v / 255.0 * ba for v in bg[:3]], dtype=dtype,
                             device=device)
        out = _quantize(out[..., :3] / 255.0 * a + bg_pm * (1.0 - a),
                        a + ba * (1.0 - a))
    return out.to(torch.uint8)
