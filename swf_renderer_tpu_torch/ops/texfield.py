"""Bitmap field planes: a texture sampled under per-frame matrices.

Port of ``swf_renderer_tpu/ops/texfield.py``.  ``bitmap_field_planes``
maps a (Th, Tw, 4) u8 texture and (F, 6) device->texel inverses to
(F, H, W, 4) f32 straight-RGBA planes: n x n box-supersampled bilinear
(or nearest) sampling of the premultiplied texture with the wrap /
clamp / transparent-outside fetch rules, un-premultiplied at the end —
the function of the reference's gather twin ``style.paint_field_traced``
for bitmaps.  Its users are ``style.paint_field`` (a bitmap fill under a
rotating or skewing matrix, or unsmoothed) and ``transform.
bake_sweep_fields`` (bitmap layers of the animation sweeps).

For tensors on the card the wrapper launches ``csrc/texfield.cu`` (a
direct gather, four pixels a thread) and counts
``bitmap_field_planes.launches``; on the CPU it runs ``texfield_plain``,
the same arithmetic in PyTorch.  The reference's tiling knobs (``xblk``,
``dot_mode``, ``ywin``, ``kstack``, ``frames_per_step``) and its texel cap
(``MAX_KERNEL_TEXELS``) budget its VMEM and matrix unit; one gather
kernel serves every texture size here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.numerics import floor_mod, true_div

EDGE_MODES = ("flash", "canvas")
MAX_SUPERSAMPLE = 64          # csrc/texfield.cu refuses more
# Pixels sampled at once by the plain version: bounds its gathers'
# intermediates (a few hundred MB) on frames of 1080p and above.
_PLAIN_CHUNK_PIXELS = 1 << 22


def premultiplied_texels(img: torch.Tensor) -> torch.Tensor:
    """(Th, Tw, 4) u8 straight RGBA -> f32 premultiplied texels (the
    filters run on premultiplied values; IEEE division by 255)."""
    x = true_div(img.to(torch.float32), 255.0)
    return torch.cat([x[..., :3] * x[..., 3:4], x[..., 3:4]], dim=-1)


def _fetch(tex, ix, iy, repeating: bool, canvas: bool):
    """style._fetch: texels at integral float coordinates (any shape)."""
    h, w = tex.shape[:2]
    flat = tex.reshape(-1, 4)
    if repeating:
        cx = floor_mod(ix, float(w)).long()
        cy = floor_mod(iy, float(h)).long()
        return flat[cy * w + cx]
    cx = torch.clamp(ix, 0.0, w - 1.0).long()
    cy = torch.clamp(iy, 0.0, h - 1.0).long()
    texel = flat[cy * w + cx]
    if canvas:
        inside = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        texel = torch.where(inside[..., None], texel,
                            torch.zeros((), dtype=texel.dtype,
                                        device=texel.device))
    return texel


def _sample(tex, sx, sy, repeating: bool, smoothed: bool, canvas: bool):
    """One subsample: style._bilinear_sample (texel centres at integer +
    0.5) or style._nearest_sample."""
    if not smoothed:
        return _fetch(tex, torch.floor(sx), torch.floor(sy), repeating,
                      canvas)
    x = sx - 0.5
    y = sy - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = (x - x0)[..., None]
    ty = (y - y0)[..., None]
    c00 = _fetch(tex, x0, y0, repeating, canvas)
    c10 = _fetch(tex, x0 + 1.0, y0, repeating, canvas)
    c01 = _fetch(tex, x0, y0 + 1.0, repeating, canvas)
    c11 = _fetch(tex, x0 + 1.0, y0 + 1.0, repeating, canvas)
    top = c00 * (1.0 - tx) + c10 * tx
    bot = c01 * (1.0 - tx) + c11 * tx
    return top * (1.0 - ty) + bot * ty


def unpremultiply(field_pm):
    """Premultiplied RGBA -> straight (the fields' contract)."""
    alpha = field_pm[..., 3:4]
    safe = torch.clamp(alpha, min=1e-6)
    rgb = torch.where(alpha > 1e-6, field_pm[..., :3] / safe,
                      torch.zeros_like(field_pm[..., :3]))
    return torch.cat([rgb, alpha], dim=-1)


def texfield_plain(img, invs, height: int, width: int, supersample: int,
                   repeating: bool, smoothed: bool, edge_mode: str):
    """Plain PyTorch version of the texfield kernel, on the tensors'
    device: ``img`` (Th, Tw, 4) u8, ``invs`` (F, 6) f32 -> (F, H, W, 4)
    f32.  The reference's gather (``paint_field_traced``), operation for
    operation in f32: per pixel and subsample (ky outer, kx inner, offsets
    f32((k + 0.5) / n)) the coordinate ``a*(px + ox) + c*(py + oy) + e``
    without fused multiply-adds, a sample added to the sum, the sum
    divided by n*n, then un-premultiplied.  Frames are sampled a few at a
    time so the gathers stay small."""
    dev = invs.device
    tex = premultiplied_texels(img)
    canvas = edge_mode == "canvas"
    n = max(1, int(supersample))
    frames = invs.shape[0]
    out = torch.empty((frames, height, width, 4), dtype=torch.float32,
                      device=dev)
    py = torch.arange(height, dtype=torch.float32, device=dev)[None, :, None]
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, None, :]
    step = max(1, _PLAIN_CHUNK_PIXELS // max(1, height * width))
    for f0 in range(0, frames, step):
        a, b, c, d, e, f = (invs[f0:f0 + step, k, None, None]
                            for k in range(6))
        acc = None
        for ky in range(n):
            pyo = py + float(np.float32((ky + 0.5) / n))
            for kx in range(n):
                pxo = px + float(np.float32((kx + 0.5) / n))
                sx = a * pxo + c * pyo + e
                sy = b * pxo + d * pyo + f
                s = _sample(tex, sx, sy, repeating, smoothed, canvas)
                acc = s if acc is None else acc + s
        out[f0:f0 + step] = unpremultiply(true_div(acc, float(n * n)))
    return out


def _launch(img, invs, height, width, n, repeating, smoothed, canvas):
    """Launch ``swf_texfield`` (csrc/texfield.cu) on the tensors' card.
    Raises if the library does not build or the launch is refused."""
    from . import cuda_lib

    dev = invs.device
    th, tw = img.shape[:2]
    out = torch.empty((invs.shape[0], height, width, 4), dtype=torch.float32,
                      device=dev)
    tex = torch.empty((th, tw, 4), dtype=torch.float32, device=dev)
    err = cuda_lib.load("swftexfield").swf_texfield(
        img.data_ptr(), tex.data_ptr(), invs.data_ptr(), out.data_ptr(),
        th, tw, invs.shape[0], height, width, n, int(repeating),
        int(smoothed), int(canvas),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"texfield kernel launch failed: CUDA error {err}")
    return out


def bitmap_field_planes(img, invs, height: int, width: int,
                        supersample: int = 4, repeating: bool = False,
                        smoothed: bool = True, edge_mode: str = "flash",
                        device=None) -> torch.Tensor:
    """(Th, Tw, 4) u8 texture + (F, 6) device->texel inverses -> (F, H, W,
    4) f32 straight-RGBA field planes on ``device`` (the card unless the
    caller asks for the CPU).

    Kernel: replaces ``_texfield_kernel`` (swf_renderer_tpu/ops/
    texfield.py:186).  A pre-pass premultiplies the texels; a grid of
    (32 x 32 tile, frame) blocks gathers them through the read-only
    cache, unrolled for supersample 1, 2 and 4, and writes one float4
    per pixel.  Bound on the H100: the bytes of the f32 planes.  On a
    card it equals ``texfield_plain`` bit for bit (chip_smoke.py).

    ``img`` and ``invs`` may be numpy arrays or tensors; ``edge_mode``
    "flash" clamps edge texels outward, "canvas" reads transparent
    outside the image (ignored when ``repeating``)."""
    device = resolve_device(device)
    if edge_mode not in EDGE_MODES:
        raise ValueError(f"unknown edge_mode {edge_mode!r}")
    n = int(supersample)
    if not 1 <= n <= MAX_SUPERSAMPLE:
        raise ValueError(f"supersample {supersample}: 1..{MAX_SUPERSAMPLE}")
    img = (img if torch.is_tensor(img)
           else torch.from_numpy(np.ascontiguousarray(img))).to(device)
    if img.dtype != torch.uint8 or img.ndim != 3 or img.shape[2] != 4 \
            or img.shape[0] < 1 or img.shape[1] < 1:
        raise ValueError(f"texture must be (Th, Tw, 4) uint8, got "
                         f"{img.dtype} {tuple(img.shape)}")
    if not torch.is_tensor(invs):
        invs = torch.from_numpy(np.asarray(invs, np.float32))
    invs = invs.to(device=device, dtype=torch.float32)
    if invs.ndim == 1:
        invs = invs[None]
    if invs.ndim != 2 or invs.shape[1] != 6 or invs.shape[0] < 1:
        raise ValueError(f"invs must be (F, 6), got {tuple(invs.shape)}")
    if height < 1 or width < 1:
        raise ValueError(f"empty field {height}x{width}")
    img, invs = img.contiguous(), invs.contiguous()
    if device.type == "cpu":
        return texfield_plain(img, invs, height, width, n, repeating,
                              smoothed, edge_mode)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = _launch(img, invs, height, width, n, repeating, smoothed,
                  edge_mode == "canvas")
    bitmap_field_planes.launches += 1
    return out


bitmap_field_planes.launches = 0
