"""An uncompressed SWF writer for the tags the benchmark's movies use:
the header, SetBackgroundColor, DefineShape3, DefineMorphShape2,
PlaceObject2 (place, move, replace), ShowFrame and End, written from the
SWF File Format Specification (version 19), independent of the program's
own writer.  ``movie_bytes(clip)`` turns a ``gen.Clip`` into a movie:
each character writes its own definition tag (``swf_tag()``, with the
records below), each depth's character is placed on its first frame,
then moved (same character) or replaced (another character) by
PlaceObject2 with PlaceFlagMove."""

from __future__ import annotations

import struct

from .gen import Clip

SWF_VERSION = 10


class Bits:
    """MSB-first bit writer."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def ub(self, value: int, nbits: int) -> None:
        if value < 0 or value >= 1 << nbits:
            raise ValueError(f"{value} does not fit {nbits} unsigned bits")
        for k in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> k) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                self.acc = self.n = 0

    def sb(self, value: int, nbits: int) -> None:
        if sbits(value) > nbits:
            raise ValueError(f"{value} does not fit {nbits} signed bits")
        self.ub(value & ((1 << nbits) - 1), nbits)

    def align(self) -> bytes:
        if self.n:
            self.out.append(self.acc << (8 - self.n))
            self.acc = self.n = 0
        return bytes(self.out)


def sbits(*values: int) -> int:
    """Bits of the widest two's-complement field holding every value."""
    return max(1, *((int(v) if v >= 0 else ~int(v)).bit_length() + 1
                    for v in values))


def tag(code: int, body: bytes) -> bytes:
    if len(body) >= 0x3F:
        return struct.pack("<HI", (code << 6) | 0x3F, len(body)) + body
    return struct.pack("<H", (code << 6) | len(body)) + body


def rect(w: Bits, x0: int, x1: int, y0: int, y1: int) -> None:
    n = sbits(x0, x1, y0, y1)
    w.ub(n, 5)
    for v in (x0, x1, y0, y1):
        w.sb(v, n)


def matrix(w: Bits, m) -> None:
    sx, sy, r0, r1, tx, ty = m
    has_scale = (sx, sy) != (65536, 65536)
    w.ub(int(has_scale), 1)
    if has_scale:
        n = sbits(sx, sy)
        w.ub(n, 5)
        w.sb(sx, n)
        w.sb(sy, n)
    has_rot = (r0, r1) != (0, 0)
    w.ub(int(has_rot), 1)
    if has_rot:
        n = sbits(r0, r1)
        w.ub(n, 5)
        w.sb(r0, n)
        w.sb(r1, n)
    n = sbits(tx, ty)
    w.ub(n, 5)
    w.sb(tx, n)
    w.sb(ty, n)


def cxform(w: Bits, cx) -> None:
    mult, add = cx
    has_mult = tuple(mult) != (256, 256, 256, 256)
    has_add = tuple(add) != (0, 0, 0, 0)
    w.ub(int(has_add), 1)
    w.ub(int(has_mult), 1)
    terms = (list(mult) if has_mult else []) + (list(add) if has_add else [])
    n = sbits(*terms) if terms else 1
    w.ub(n, 4)
    for v in terms:
        w.sb(v, n)


def _move(w: Bits, x: int, y: int, fill0: int, fill_bits: int) -> None:
    """A style-change record: move to (x, y), optionally FillStyle0."""
    w.ub(0, 1)                       # not an edge
    w.ub(0, 1)                       # no new styles
    w.ub(0, 1)                       # no line style
    w.ub(0, 1)                       # no fill style 1
    w.ub(int(fill0 > 0), 1)
    w.ub(1, 1)                       # move to
    n = sbits(x, y)
    w.ub(n, 5)
    w.sb(x, n)
    w.sb(y, n)
    if fill0 > 0:
        w.ub(fill0, fill_bits)


def _line(w: Bits, dx: int, dy: int) -> None:
    w.ub(1, 1)                       # edge
    w.ub(1, 1)                       # straight
    n = max(2, sbits(dx, dy))
    w.ub(n - 2, 4)
    if dx and dy:
        w.ub(1, 1)                   # general line
        w.sb(dx, n)
        w.sb(dy, n)
    else:
        w.ub(0, 1)
        w.ub(int(dx == 0), 1)        # vertical
        w.sb(dy if dx == 0 else dx, n)


def _curve(w: Bits, cx: int, cy: int, ax: int, ay: int) -> None:
    w.ub(1, 1)                       # edge
    w.ub(0, 1)                       # curved
    n = max(2, sbits(cx, cy, ax, ay))
    w.ub(n - 2, 4)
    for v in (cx, cy, ax, ay):
        w.sb(v, n)


def contour(w: Bits, pts, ctrl, curved, fill0: int, fill_bits: int) -> None:
    n = len(pts)
    _move(w, int(pts[0][0]), int(pts[0][1]), fill0, fill_bits)
    for i in range(n):
        x0, y0 = (int(v) for v in pts[i])
        x1, y1 = (int(v) for v in pts[(i + 1) % n])
        if curved is not None and curved[i]:
            cx, cy = (int(v) for v in ctrl[i])
            _curve(w, cx - x0, cy - y0, x1 - cx, y1 - cy)
        else:
            _line(w, x1 - x0, y1 - y0)


def bounds(arrays, pad: int = 20):
    lo = min(int(a.min()) for a in arrays) - pad
    hi = max(int(a.max()) for a in arrays) + pad
    return lo, hi, lo, hi


def place_object2(inst, prev) -> bytes:
    """PlaceObject2 for ``inst`` given the depth's previous occupant."""
    replace = prev is None or prev.char is not inst.char
    flags = int(prev is not None)            # move
    flags |= 0x02 if replace else 0
    flags |= 0x04 if inst.matrix is not None else 0
    flags |= 0x08 if inst.cxform is not None else 0
    flags |= 0x10 if inst.ratio is not None else 0
    body = bytearray(struct.pack("<BH", flags, inst.depth))
    if replace:
        body += struct.pack("<H", inst.char.cid)
    if inst.matrix is not None or inst.cxform is not None:
        w = Bits()
        if inst.matrix is not None:
            matrix(w, inst.matrix)
            w.align()
        if inst.cxform is not None:
            cxform(w, inst.cxform)
        body += w.align()
    if inst.ratio is not None:
        body += struct.pack("<H", inst.ratio)
    return tag(26, bytes(body))


def movie_bytes(clip: Clip) -> bytes:
    """The clip as an uncompressed SWF: frame RECT of whole pixels, its
    rate, an opaque or transparent background, every definition before
    the frame that first shows it."""
    tags = [tag(9, bytes(clip.background[:3]))]
    defined, state = set(), {}
    for row in clip.frames:
        for inst in row:
            if id(inst.char) not in defined:
                defined.add(id(inst.char))
                tags.append(inst.char.swf_tag())
            tags.append(place_object2(inst, state.get(inst.depth)))
            state[inst.depth] = inst
        tags.append(tag(1, b""))
    tags.append(tag(0, b""))
    w = Bits()
    rect(w, 0, clip.width * 20, 0, clip.height * 20)
    head = w.align() + struct.pack("<HH", int(round(clip.frame_rate * 256)),
                                   len(clip.frames))
    body = head + b"".join(tags)
    return (b"FWS" + bytes([SWF_VERSION])
            + struct.pack("<I", 8 + len(body)) + body)
