"""Netpbm PAM export (reference ts/src/lib/image-data-to-pam.ts:8-28,
rs/src/pam.rs:3-34).  Byte-compatible with the reference writers."""

from __future__ import annotations

import numpy as np


def rgba_to_pam(rgba: np.ndarray) -> bytes:
    """(H, W, 4) uint8 RGBA -> PAM (P7, DEPTH 4, RGB_ALPHA) bytes."""
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError("expected (H, W, 4) uint8 RGBA")
    height, width = rgba.shape[:2]
    header = (
        f"P7\nWIDTH {width}\nHEIGHT {height}\nDEPTH 4\nMAXVAL 255\n"
        "TUPLTYPE RGB_ALPHA\nENDHDR\n"
    ).encode("ascii")
    return header + rgba.tobytes()


def pam_to_rgba(data: bytes) -> np.ndarray:
    """PAM bytes -> (H, W, 4) uint8 RGBA array."""
    end = data.index(b"ENDHDR\n") + len(b"ENDHDR\n")
    header = data[:end].decode("ascii").split("\n")
    fields = {}
    for line in header:
        parts = line.split()
        if len(parts) == 2:
            fields[parts[0]] = parts[1]
    width = int(fields["WIDTH"])
    height = int(fields["HEIGHT"])
    depth = int(fields["DEPTH"])
    if depth != 4:
        raise ValueError(f"unsupported PAM depth {depth}")
    px = np.frombuffer(data[end : end + width * height * 4], dtype=np.uint8)
    return px.reshape(height, width, 4).copy()
