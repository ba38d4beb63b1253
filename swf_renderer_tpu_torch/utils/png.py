"""Minimal PNG codec (pure Python + zlib + numpy).

Used to read the golden raster files (all RGBA8, non-interlaced) and to write
test/bench artifacts.  No external imaging dependency is available in this
environment, and the formats we need are narrow: 8-bit depth, color types
0 (gray), 2 (RGB), 3 (palette), 6 (RGBA), no interlacing.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(data: bytes):
    pos = 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        yield kind, body
        pos += 12 + length


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG per-row filtering.  ``raw`` is the decompressed byte stream."""
    raw = raw.reshape(height, stride + 1)
    filters = raw[:, 0]
    out = np.zeros((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.int32)
    for y in range(height):
        f = int(filters[y])
        cur = raw[y, 1:].astype(np.int32)
        if f == 0:
            row = cur
        elif f == 1:  # Sub
            row = cur.copy()
            for x in range(bpp, stride):
                row[x] = (row[x] + row[x - bpp]) & 0xFF
        elif f == 2:  # Up
            row = (cur + prev) & 0xFF
        elif f == 3:  # Average
            row = cur.copy()
            for x in range(stride):
                left = row[x - bpp] if x >= bpp else 0
                row[x] = (row[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif f == 4:  # Paeth
            row = cur.copy()
            for x in range(stride):
                a = row[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                if pa <= pb and pa <= pc:
                    pred = a
                elif pb <= pc:
                    pred = b
                else:
                    pred = c
                row[x] = (row[x] + pred) & 0xFF
        else:
            raise ValueError(f"unsupported PNG filter {f}")
        out[y] = row.astype(np.uint8)
        prev = row
    return out


def read_png(path_or_bytes) -> np.ndarray:
    """Read a PNG into an (H, W, 4) uint8 RGBA array."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")

    width = height = None
    color_type = bit_depth = None
    palette = None
    trns = None
    idat = bytearray()
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            width, height, bit_depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", body
            )
            if interlace != 0:
                raise ValueError("interlaced PNG not supported")
            if bit_depth != 8:
                raise ValueError(f"unsupported bit depth {bit_depth}")
        elif kind == b"PLTE":
            palette = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, dtype=np.uint8)
        elif kind == b"IDAT":
            idat.extend(body)
        elif kind == b"IEND":
            break

    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    stride = width * channels
    raw = np.frombuffer(zlib.decompress(bytes(idat)), dtype=np.uint8)
    px = _unfilter(raw, height, stride, channels).reshape(height, width, channels)

    out = np.empty((height, width, 4), dtype=np.uint8)
    if color_type == 6:
        out[:] = px
    elif color_type == 2:
        out[..., :3] = px
        out[..., 3] = 255
    elif color_type == 0:
        out[..., :3] = px
        out[..., 3] = 255
    elif color_type == 4:
        out[..., 0] = out[..., 1] = out[..., 2] = px[..., 0]
        out[..., 3] = px[..., 1]
    elif color_type == 3:
        idx = px[..., 0]
        out[..., :3] = palette[idx]
        if trns is not None:
            alpha = np.full(256, 255, dtype=np.uint8)
            alpha[: len(trns)] = trns
            out[..., 3] = alpha[idx]
        else:
            out[..., 3] = 255
    else:
        raise ValueError(f"unsupported color type {color_type}")
    return out


def encode_png(rgba: np.ndarray) -> bytes:
    """Encode an (H, W, 4) uint8 RGBA array as PNG bytes (filter 0, RGBA8)."""
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError("expected (H, W, 4) uint8 RGBA")
    height, width = rgba.shape[:2]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (
            struct.pack(">I", len(body))
            + kind
            + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", width, height, 8, 6, 0, 0, 0)
    filtered = np.concatenate(
        [np.zeros((height, 1), dtype=np.uint8), rgba.reshape(height, -1)], axis=1
    )
    idat = zlib.compress(filtered.tobytes(), 6)
    payload = (
        _SIGNATURE
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", idat)
        + chunk(b"IEND", b"")
    )
    return payload


def write_png(path, rgba: np.ndarray) -> None:
    """Write an (H, W, 4) uint8 RGBA array as a PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png(rgba))
