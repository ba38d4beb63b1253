"""Screen Video (SWF codec 3) packets: pure zlib + numpy, both ways.

The SWF embedded-video path the reference never had: DefineVideoStream
(tag 60) declares a stream, VideoFrame (tag 61) carries one
SCREENVIDEOPACKET per timeline frame (SWF spec v19, 'Screen Video bit
stream format').  The packet is a grid of tiles, each an independently
zlib-deflated block of bottom-up BGR24 rows; interframes send dataSize=0
for unchanged tiles.  Packet header fields are BIG-endian (FLV heritage),
unlike the rest of the SWF wire format.

Decode folds packets left-to-right over the previous frame (tile
replacement), so any frame is reachable by replaying from the last
keyframe — the loader replays from frame 0 and caches.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np


def decode_screen_video_packet(
        data: bytes, prev: Optional[np.ndarray] = None) -> np.ndarray:
    """One SCREENVIDEOPACKET -> (H, W, 3) u8 RGB (top-down rows).

    ``prev`` supplies the tiles an interframe leaves unchanged
    (dataSize 0); a keyframe never needs it.  Raises on a dimension
    mismatch with ``prev`` or on an unchanged tile with no ``prev``.
    """
    b0, b1, b2, b3 = data[0], data[1], data[2], data[3]
    block_w = ((b0 >> 4) + 1) * 16
    width = ((b0 & 0x0F) << 8) | b1
    block_h = ((b2 >> 4) + 1) * 16
    height = ((b2 & 0x0F) << 8) | b3
    if prev is not None and prev.shape[:2] != (height, width):
        raise ValueError("screen-video interframe size mismatch")
    out = (np.zeros((height, width, 3), np.uint8) if prev is None
           else prev.copy())
    pos = 4
    # Tiles run from the BOTTOM-left, right then up (spec block order).
    rows = (height + block_h - 1) // block_h
    cols = (width + block_w - 1) // block_w
    for r in range(rows):
        y1 = height - r * block_h
        y0 = max(0, y1 - block_h)
        for c in range(cols):
            (size,) = struct.unpack_from(">H", data, pos)
            pos += 2
            x0 = c * block_w
            x1 = min(width, x0 + block_w)
            if size == 0:
                if prev is None:
                    raise ValueError(
                        "unchanged tile in a frame with no predecessor")
                continue
            raw = zlib.decompress(data[pos:pos + size])
            pos += size
            bw, bh = x1 - x0, y1 - y0
            bgr = np.frombuffer(raw, np.uint8).reshape(bh, bw, 3)
            # Block rows are bottom-up BGR; flip to top-down RGB.
            out[y0:y1, x0:x1] = bgr[::-1, :, ::-1]
    return out


def encode_screen_video_packet(
        frame: np.ndarray, prev: Optional[np.ndarray] = None,
        block: int = 32) -> bytes:
    """(H, W, 3) u8 RGB -> SCREENVIDEOPACKET bytes (the decode twin).

    With ``prev``, tiles equal to the previous frame emit dataSize 0
    (interframe); without it every tile is sent (keyframe).  ``block``
    must be a multiple of 16 in [16, 256].
    """
    frame = np.asarray(frame, np.uint8)
    height, width = frame.shape[:2]
    if block % 16 or not 16 <= block <= 256:
        raise ValueError("screen-video block size must be 16..256, /16")
    if width >= 1 << 12 or height >= 1 << 12:
        raise ValueError("screen-video frames are limited to 4095 px")
    out = bytearray()
    out.append(((block // 16 - 1) << 4) | (width >> 8))
    out.append(width & 0xFF)
    out.append(((block // 16 - 1) << 4) | (height >> 8))
    out.append(height & 0xFF)
    rows = (height + block - 1) // block
    cols = (width + block - 1) // block
    for r in range(rows):
        y1 = height - r * block
        y0 = max(0, y1 - block)
        for c in range(cols):
            x0 = c * block
            x1 = min(width, x0 + block)
            tile = frame[y0:y1, x0:x1]
            if prev is not None and np.array_equal(
                    tile, prev[y0:y1, x0:x1]):
                out.extend(b"\x00\x00")
                continue
            raw = tile[::-1, :, ::-1].tobytes()
            comp = zlib.compress(raw)
            out.extend(struct.pack(">H", len(comp)))
            out.extend(comp)
    return bytes(out)
