"""Bitmap asset service: decode and register SWF bitmaps by character id.

The core codec handles the ``image/x-swf-bmp`` container (reference
ts/src/lib/decode-x-swf-bmp.ts:9-41): header ``formatId(=3 only) u8,
width u16LE, height u16LE, colorCount-1 u8`` followed by a zlib stream
holding an RGB palette (opaque) and palettized pixels with rows padded to
4 bytes.  Out-of-range palette indices resolve to opaque black
(decode-x-swf-bmp.ts:35-36).

Framework extensions beyond the reference (which throws
``NotImplemented: Support for <type> images`` for anything else,
node-canvas-bitmap-service.ts:33):

- ``image/x-swf-bmp-full`` — DefineBitsLossless (tag 20) direct-color
  formats: PIX15 (format 4, rows padded to 4 bytes) and PIX24
  (format 5, pad byte + RGB), both opaque.
- ``image/x-swf-bmp2`` — DefineBitsLossless2 (tag 36): format 3
  (colormapped with an RGBA palette; out-of-range index resolves to
  TRANSPARENT black, the alpha twin of the reference's opaque-black
  rule) and format 5 (ARGB32 with PREMULTIPLIED alpha per the SWF
  spec, un-premultiplied to the straight RGBA this service stores).

Unknown media types keep the reference's error semantics.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Dict, Optional

import numpy as np

from ..models import ast


def decode_x_swf_bmp(data: bytes) -> np.ndarray:
    """Decode ``image/x-swf-bmp`` bytes into an (H, W, 4) uint8 RGBA array."""
    format_id = data[0]
    if format_id != 3:
        raise ValueError(f"UnsupportedXSwfBmpFormatId: {format_id}")
    width, height = struct.unpack_from("<HH", data, 1)
    color_count = data[5] + 1
    padded_width = width + ((4 - (width % 4)) % 4)
    src = zlib.decompress(data[6:])

    table_size = 3 * color_count
    palette = np.frombuffer(src[:table_size], dtype=np.uint8).reshape(-1, 3)
    # Out-of-range indices -> opaque black: pad the lookup table to 256.
    lut = np.zeros((256, 4), dtype=np.uint8)
    lut[:, 3] = 255
    lut[: len(palette), :3] = palette

    pixels = np.frombuffer(
        src[table_size : table_size + height * padded_width], dtype=np.uint8
    ).reshape(height, padded_width)[:, :width]
    return lut[pixels]


def decode_x_swf_bmp_full(data: bytes) -> np.ndarray:
    """Decode DefineBitsLossless direct-color payloads (formats 4/5).

    PIX15 (format 4): big-endian u16 per pixel, 1 reserved bit + 5/5/5
    RGB, scanlines padded to 4 bytes; 5-bit channels expand with the
    endpoint-exact ``(c << 3) | (c >> 2)`` map.  PIX24 (format 5): pad
    byte + RGB, 4 bytes per pixel (inherently 4-aligned).  Both opaque.
    """
    format_id = data[0]
    width, height = struct.unpack_from("<HH", data, 1)
    src = zlib.decompress(data[5:])
    out = np.empty((height, width, 4), dtype=np.uint8)
    out[..., 3] = 255
    if format_id == 4:
        stride = (2 * width + 3) & ~3
        rows = np.frombuffer(
            src[: height * stride], dtype=np.uint8).reshape(height, stride)
        pix = (rows[:, : 2 * width : 2].astype(np.uint16) << 8
               | rows[:, 1 : 2 * width : 2])
        for ch, shift in enumerate((10, 5, 0)):
            c5 = ((pix >> shift) & 0x1F).astype(np.uint8)
            out[..., ch] = (c5 << 3) | (c5 >> 2)
        return out
    if format_id == 5:
        rows = np.frombuffer(
            src[: height * width * 4], dtype=np.uint8
        ).reshape(height, width, 4)
        out[..., :3] = rows[..., 1:]  # pad byte, R, G, B
        return out
    raise ValueError(f"UnsupportedXSwfBmpFormatId: {format_id}")


def _unpremultiply_u8(pm: np.ndarray) -> np.ndarray:
    """Premultiplied u8 RGBA -> straight u8 RGBA (round-half-up, the
    shared quantization convention of ops/composite.py); alpha 0 pixels
    become transparent black.  Color channels clamp to alpha (malformed
    premul bytes with c > a would otherwise overflow)."""
    a = pm[..., 3:4].astype(np.uint32)
    c = np.minimum(pm[..., :3].astype(np.uint32), a)
    straight = np.zeros_like(pm)
    nz = a[..., 0] > 0
    straight[nz, :3] = ((c[nz] * 255 + a[nz] // 2) // np.maximum(a[nz], 1)
                        ).astype(np.uint8)
    straight[..., 3] = pm[..., 3]
    return straight


def decode_x_swf_bmp2(data: bytes) -> np.ndarray:
    """Decode DefineBitsLossless2 payloads (formats 3/5) to straight RGBA.

    Format 3: ``colorCount-1 u8`` then zlib(RGBA palette + 4-byte-padded
    index rows); out-of-range index -> transparent black.  Format 5:
    zlib of ARGB32 with premultiplied alpha (SWF spec ``ALPHABITMAPDATA``),
    converted to the straight RGBA this service stores.
    """
    format_id = data[0]
    width, height = struct.unpack_from("<HH", data, 1)
    if format_id == 3:
        color_count = data[5] + 1
        src = zlib.decompress(data[6:])
        palette = np.frombuffer(
            src[: 4 * color_count], dtype=np.uint8).reshape(-1, 4)
        lut = np.zeros((256, 4), dtype=np.uint8)  # OOR -> transparent black
        lut[: len(palette)] = palette
        padded_width = width + ((4 - (width % 4)) % 4)
        pixels = np.frombuffer(
            src[4 * color_count : 4 * color_count + height * padded_width],
            dtype=np.uint8,
        ).reshape(height, padded_width)[:, :width]
        return lut[pixels]
    if format_id == 5:
        src = zlib.decompress(data[5:])
        argb = np.frombuffer(
            src[: height * width * 4], dtype=np.uint8
        ).reshape(height, width, 4)
        pm = np.concatenate([argb[..., 1:], argb[..., :1]], axis=-1)
        return _unpremultiply_u8(pm)
    raise ValueError(f"UnsupportedXSwfBmpFormatId: {format_id}")


def encode_x_swf_bmp2_argb(rgba: np.ndarray) -> bytes:
    """Straight (H, W, 4) u8 RGBA -> format-5 DefineBitsLossless2 payload
    (premultiplied ARGB32, round-half-up — the builder-side twin of
    ``decode_x_swf_bmp2``)."""
    rgba = np.asarray(rgba, dtype=np.uint8)
    h, w = rgba.shape[:2]
    a = rgba[..., 3:4].astype(np.uint32)
    pm = ((rgba[..., :3].astype(np.uint32) * a + 127) // 255).astype(np.uint8)
    argb = np.concatenate([rgba[..., 3:4], pm], axis=-1)
    return (bytes([5]) + struct.pack("<HH", w, h)
            + zlib.compress(argb.tobytes()))


def encode_x_swf_bmp2_colormapped(palette: np.ndarray,
                                  indices: np.ndarray) -> bytes:
    """(K, 4) u8 RGBA palette + (H, W) u8 indices -> format-3
    DefineBitsLossless2 payload (rows padded to 4 bytes)."""
    palette = np.asarray(palette, dtype=np.uint8)
    indices = np.asarray(indices, dtype=np.uint8)
    h, w = indices.shape
    stride = (w + 3) & ~3
    rows = np.zeros((h, stride), dtype=np.uint8)
    rows[:, :w] = indices
    return (bytes([3]) + struct.pack("<HH", w, h)
            + bytes([len(palette) - 1])
            + zlib.compress(palette.tobytes() + rows.tobytes()))


def encode_x_swf_bmp_pix24(rgb: np.ndarray) -> bytes:
    """(H, W, 3) u8 RGB -> format-5 DefineBitsLossless payload (pad
    byte + RGB per pixel)."""
    rgb = np.asarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    quads = np.zeros((h, w, 4), dtype=np.uint8)
    quads[..., 1:] = rgb
    return (bytes([5]) + struct.pack("<HH", w, h)
            + zlib.compress(quads.tobytes()))


def encode_x_swf_bmp_pix15(rgb: np.ndarray) -> bytes:
    """(H, W, 3) u8 RGB -> format-4 DefineBitsLossless payload (5/5/5
    big-endian u16, rows padded to 4 bytes; channels truncate to their
    top 5 bits)."""
    rgb = np.asarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    c5 = (rgb.astype(np.uint16) >> 3)
    pix = (c5[..., 0] << 10) | (c5[..., 1] << 5) | c5[..., 2]
    stride = (2 * w + 3) & ~3
    rows = np.zeros((h, stride), dtype=np.uint8)
    rows[:, : 2 * w : 2] = (pix >> 8).astype(np.uint8)
    rows[:, 1 : 2 * w : 2] = (pix & 0xFF).astype(np.uint8)
    return (bytes([4]) + struct.pack("<HH", w, h)
            + zlib.compress(rows.tobytes()))


def decode_swf_jpeg(data: bytes) -> np.ndarray:
    """Decode a DefineBitsJPEG2 payload to straight RGBA.

    SWF quirk: pre-SWF8 writers prepend an erroneous EOI+SOI pair
    (``FF D9 FF D8``) before the real SOI — stripped here.  SWF >= 8
    allows PNG and GIF89a payloads in the same tag; Pillow sniffs the
    container, so all three decode through one path."""
    from io import BytesIO

    from PIL import Image

    if data[:4] in (b"\xff\xd9\xff\xd8", b"\xff\xd8\xff\xd9"):
        data = data[4:]
    img = Image.open(BytesIO(data)).convert("RGBA")
    return np.asarray(img, dtype=np.uint8)


def decode_x_swf_jpeg3(data: bytes) -> np.ndarray:
    """Decode a DefineBitsJPEG3 payload (tag body minus the character
    id): ``alphaDataOffset u32LE``, JPEG/PNG/GIF bytes, then a
    zlib-compressed 8-bit alpha plane.  The color data decodes like
    DefineBitsJPEG2; the alpha plane replaces its alpha channel (color
    treated as straight, clamped nowhere — JPEG loss makes premul
    reconstruction moot; documented extension choice)."""
    (alpha_off,) = struct.unpack_from("<I", data, 0)
    rgba = decode_swf_jpeg(data[4 : 4 + alpha_off]).copy()
    h, w = rgba.shape[:2]
    alpha = np.frombuffer(
        zlib.decompress(data[4 + alpha_off :])[: h * w], dtype=np.uint8
    ).reshape(h, w)
    rgba[..., 3] = alpha
    return rgba


_DECODERS = {
    "image/x-swf-bmp": decode_x_swf_bmp,
    "image/x-swf-bmp-full": decode_x_swf_bmp_full,
    "image/x-swf-bmp2": decode_x_swf_bmp2,
    "image/jpeg": decode_swf_jpeg,
    "image/x-swf-jpeg3": decode_x_swf_jpeg3,
}


@dataclasses.dataclass
class Bitmap:
    width: int
    height: int
    rgba: Optional[np.ndarray]  # (H, W, 4) uint8, or None if decode unavailable


class BitmapService:
    """id -> decoded bitmap registry (reference bitmap-service.ts:3-16,
    node-canvas-bitmap-service.ts:7-46)."""

    def __init__(self) -> None:
        self._bitmaps: Dict[int, Bitmap] = {}

    def add_bitmap(self, tag: ast.DefineBitmap) -> None:
        decoder = _DECODERS.get(tag.media_type)
        if decoder is None:
            raise NotImplementedError(
                f"NotImplemented: Support for {tag.media_type} images"
            )
        rgba = decoder(tag.data)
        self._bitmaps[tag.id] = Bitmap(
            width=rgba.shape[1], height=rgba.shape[0], rgba=rgba
        )

    def get_by_id(self, bitmap_id: int) -> Bitmap:
        bitmap = self._bitmaps.get(bitmap_id)
        if bitmap is None:
            raise KeyError(f"BitmapNotFound: {bitmap_id}")
        return bitmap

    def try_get(self, bitmap_id: int) -> Optional[Bitmap]:
        return self._bitmaps.get(bitmap_id)

    def __contains__(self, bitmap_id: int) -> bool:
        return bitmap_id in self._bitmaps
