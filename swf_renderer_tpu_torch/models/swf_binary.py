"""SWF binary emitter + parser for shape movies.

The analog of the reference's movie builder (reference tests/build.js:12-21,
which shells out to the external ``swf-emitter`` npm package): emits an
uncompressed ``.swf`` (FWS) containing DefineShape3 tags, places them, and
shows a frame — a movie the real Flash player can run for ground-truth
capture (tools/capture_server.py).  The matching parser reads shape tags
back into the AST; emitter and parser validate each other by round-tripping
the golden corpus (tests/test_swf_binary.py).

Format essentials (SWF file format spec v19):
* header ``FWS`` + version + file length + frame RECT + rate + count,
* tags as RECORDHEADER (code << 6 | length, 0x3F escape to u32),
* DefineShape3 (tag 32): character id, RECT bounds, SHAPEWITHSTYLE —
  fill/line style arrays then bit-packed style-change/edge records.

Scope: solid, gradient (linear/radial) and bitmap fills; solid line styles
(DefineShape3 LINESTYLE), and DefineShape4 (tag 83) with LINESTYLE2 —
caps, joins and miter limits round-trip, which DefineShape3 cannot
express.  Enough to emit every static shape in the corpus.

Morph shapes: DefineMorphShape (tag 46) and DefineMorphShape2 (tag 84,
MORPHLINESTYLE2 caps/joins + stroke-scaling flags).  The merged
start/end AST records (swf-tree morph schema, the form
decode_morph_shape consumes) split into the wire format's StartEdges /
EndEdges streams on emit and re-pair on parse: every edge pairs 1:1
across the streams, and every start style-change that moves the pen
pairs with an end style-change carrying only the end move
(the swf-emitter convention the reference's build.js relies on).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

from ..utils.bits import BitReader, BitWriter, sbits_for, ubits_for
from ..utils.fixed import Sfixed16P16
from . import ast

TAG_END = 0
TAG_SHOW_FRAME = 1
TAG_DEFINE_SHAPE = 2
TAG_DEFINE_SHAPE2 = 22
TAG_DEFINE_SHAPE3 = 32
TAG_DEFINE_SHAPE4 = 83
TAG_DEFINE_MORPH_SHAPE = 46
TAG_DEFINE_MORPH_SHAPE2 = 84
TAG_DEFINE_BITS_LOSSLESS = 20
TAG_DEFINE_BITS_LOSSLESS2 = 36
TAG_DEFINE_BITS = 6
TAG_JPEG_TABLES = 8
TAG_DEFINE_BITS_JPEG2 = 21
TAG_DEFINE_BITS_JPEG3 = 35
TAG_DEFINE_BITS_JPEG4 = 90
TAG_SET_BACKGROUND = 9
TAG_DEFINE_SPRITE = 39
TAG_DEFINE_SCALING_GRID = 78
TAG_DEFINE_VIDEO_STREAM = 60
TAG_VIDEO_FRAME = 61
TAG_DEFINE_SOUND = 14
TAG_START_SOUND = 15
TAG_SOUND_STREAM_HEAD = 18
TAG_SOUND_STREAM_BLOCK = 19
TAG_SOUND_STREAM_HEAD2 = 45
TAG_EXPORT_ASSETS = 56
TAG_IMPORT_ASSETS = 57
TAG_IMPORT_ASSETS2 = 71
TAG_METADATA = 77
TAG_DEFINE_SCENE_AND_FRAME_LABEL_DATA = 86
TAG_DEFINE_FONT_NAME = 88
TAG_FRAME_LABEL = 43
TAG_PLACE_OBJECT = 4
TAG_PLACE_OBJECT2 = 26
TAG_PLACE_OBJECT3 = 70
TAG_REMOVE_OBJECT = 5
TAG_REMOVE_OBJECT2 = 28

# PlaceObject3 blend mode ordinals (SWF spec v19).  0/1 normal.
# "alpha"/"erase" are the layer-alpha group modes (soft mask / alpha
# knockout inside an offscreen group); "layer" composites its subtree
# offscreen (observable only when it carries alpha/erase children).
_BLEND_ORDINALS = {
    0: None, 1: None, 2: "layer", 3: "multiply", 4: "screen",
    5: "lighten", 6: "darken", 7: "difference", 8: "add", 9: "subtract",
    10: "invert", 11: "alpha", 12: "erase", 13: "overlay", 14: "hardlight",
}
_BLEND_NAMES = {v: k for k, v in _BLEND_ORDINALS.items() if v}

_SPREAD_TO_BITS = {
    ast.GradientSpread.PAD: 0,
    ast.GradientSpread.REFLECT: 1,
    ast.GradientSpread.REPEAT: 2,
}
_BITS_TO_SPREAD = {v: k for k, v in _SPREAD_TO_BITS.items()}


# ---------------------------------------------------------------------------
# Primitive writers
# ---------------------------------------------------------------------------


def _write_rect(w: BitWriter, rect: ast.Rect) -> None:
    nbits = sbits_for(rect.x_min, rect.x_max, rect.y_min, rect.y_max)
    w.write_ub(nbits, 5)
    for v in (rect.x_min, rect.x_max, rect.y_min, rect.y_max):
        w.write_sb(v, nbits)
    w.align()


def _read_rect(r: BitReader) -> ast.Rect:
    nbits = r.read_ub(5)
    vals = [r.read_sb(nbits) for _ in range(4)]
    r.align()
    return ast.Rect(x_min=vals[0], x_max=vals[1], y_min=vals[2], y_max=vals[3])


def _write_matrix(w: BitWriter, m: ast.Matrix) -> None:
    w.align()
    has_scale = not (m.scale_x.epsilons == 65536 and m.scale_y.epsilons == 65536)
    w.write_ub(1 if has_scale else 0, 1)
    if has_scale:
        nbits = sbits_for(m.scale_x.epsilons, m.scale_y.epsilons)
        w.write_ub(nbits, 5)
        w.write_sb(m.scale_x.epsilons, nbits)
        w.write_sb(m.scale_y.epsilons, nbits)
    has_rot = not (m.rotate_skew0.epsilons == 0 and m.rotate_skew1.epsilons == 0)
    w.write_ub(1 if has_rot else 0, 1)
    if has_rot:
        nbits = sbits_for(m.rotate_skew0.epsilons, m.rotate_skew1.epsilons)
        w.write_ub(nbits, 5)
        w.write_sb(m.rotate_skew0.epsilons, nbits)
        w.write_sb(m.rotate_skew1.epsilons, nbits)
    nbits = sbits_for(m.translate_x, m.translate_y)
    w.write_ub(nbits, 5)
    w.write_sb(m.translate_x, nbits)
    w.write_sb(m.translate_y, nbits)
    w.align()


def _read_matrix(r: BitReader) -> ast.Matrix:
    r.align()
    one = Sfixed16P16.from_value(1.0)
    zero = Sfixed16P16.from_value(0.0)
    sx, sy = one, one
    if r.read_ub(1):
        nbits = r.read_ub(5)
        sx = Sfixed16P16.from_epsilons(r.read_sb(nbits))
        sy = Sfixed16P16.from_epsilons(r.read_sb(nbits))
    r0, r1 = zero, zero
    if r.read_ub(1):
        nbits = r.read_ub(5)
        r0 = Sfixed16P16.from_epsilons(r.read_sb(nbits))
        r1 = Sfixed16P16.from_epsilons(r.read_sb(nbits))
    nbits = r.read_ub(5)
    tx = r.read_sb(nbits)
    ty = r.read_sb(nbits)
    r.align()
    return ast.Matrix(scale_x=sx, scale_y=sy, rotate_skew0=r0,
                      rotate_skew1=r1, translate_x=tx, translate_y=ty)


def _write_rgba(out: bytearray, c: ast.StraightSRgba8) -> None:
    out.extend((c.r, c.g, c.b, c.a))


def _read_rgba(data: bytes, pos: int) -> Tuple[ast.StraightSRgba8, int]:
    r, g, b, a = data[pos : pos + 4]
    return ast.StraightSRgba8(r, g, b, a), pos + 4


def _read_rgb(data: bytes, pos: int) -> Tuple[ast.StraightSRgba8, int]:
    """Pre-DefineShape3 tags store opaque RGB colors."""
    r, g, b = data[pos : pos + 3]
    return ast.StraightSRgba8(r, g, b, 255), pos + 3


# ---------------------------------------------------------------------------
# Styles
# ---------------------------------------------------------------------------


def _emit_fill_style(fill: ast.FillStyle) -> bytes:
    out = bytearray()
    if isinstance(fill, ast.SolidFill):
        out.append(0x00)
        _write_rgba(out, fill.color)
    elif isinstance(fill, (ast.LinearGradientFill, ast.RadialGradientFill,
                           ast.FocalGradientFill)):
        if isinstance(fill, ast.LinearGradientFill):
            out.append(0x10)
        elif isinstance(fill, ast.RadialGradientFill):
            out.append(0x12)
        else:
            out.append(0x13)
        w = BitWriter()
        _write_matrix(w, fill.matrix)
        out.extend(w.bytes())
        g = fill.gradient
        if len(g.colors) > 15:
            # The count shares a byte with spread/colorSpace (4 bits);
            # 16+ stops would silently corrupt those fields.
            raise ValueError(
                f"SWF gradients cap at 15 stops (got {len(g.colors)})")
        out.append(
            (_SPREAD_TO_BITS[g.spread] << 6)
            | ((0 if g.color_space == ast.ColorSpace.S_RGB else 1) << 4)
            | len(g.colors)
        )
        for stop in g.colors:
            out.append(stop.ratio)
            _write_rgba(out, stop.color)
        if isinstance(fill, ast.FocalGradientFill):
            out.extend(struct.pack("<h", fill.focal_point_epsilons))
    elif isinstance(fill, ast.BitmapFill):
        # 0x40 repeating smoothed / 41 clipped / 42 non-smoothed repeat /
        # 43 non-smoothed clipped
        code = 0x40 + (0 if fill.repeating else 1) + (0 if fill.smoothed else 2)
        out.append(code)
        out.extend(struct.pack("<H", fill.bitmap_id))
        w = BitWriter()
        _write_matrix(w, fill.matrix)
        out.extend(w.bytes())
    else:
        raise ValueError(f"cannot emit fill style {fill!r}")
    return bytes(out)


def _parse_fill_style(data: bytes, pos: int,
                      rgb: bool = False) -> Tuple[ast.FillStyle, int]:
    read_color = _read_rgb if rgb else _read_rgba
    kind = data[pos]
    pos += 1
    if kind == 0x00:
        color, pos = read_color(data, pos)
        return ast.SolidFill(color=color), pos
    if kind in (0x10, 0x12, 0x13):
        r = BitReader(data, pos)
        matrix = _read_matrix(r)
        pos = r.byte_pos
        packed = data[pos]
        pos += 1
        spread = _BITS_TO_SPREAD[(packed >> 6) & 3]
        cs = (ast.ColorSpace.S_RGB if ((packed >> 4) & 3) == 0
              else ast.ColorSpace.LINEAR_RGB)
        count = packed & 0x0F
        stops = []
        for _ in range(count):
            ratio = data[pos]
            pos += 1
            color, pos = read_color(data, pos)
            stops.append(ast.GradientStop(ratio=ratio, color=color))
        grad = ast.Gradient(spread=spread, color_space=cs, colors=tuple(stops))
        if kind == 0x10:
            return ast.LinearGradientFill(matrix=matrix, gradient=grad), pos
        if kind == 0x12:
            return ast.RadialGradientFill(matrix=matrix, gradient=grad), pos
        (focal,) = struct.unpack_from("<h", data, pos)
        pos += 2
        return ast.FocalGradientFill(matrix=matrix, gradient=grad,
                                     focal_point_epsilons=focal), pos
    if 0x40 <= kind <= 0x43:
        (bitmap_id,) = struct.unpack_from("<H", data, pos)
        pos += 2
        r = BitReader(data, pos)
        matrix = _read_matrix(r)
        pos = r.byte_pos
        return ast.BitmapFill(
            bitmap_id=bitmap_id, matrix=matrix,
            repeating=(kind in (0x40, 0x42)),
            smoothed=(kind in (0x40, 0x41)),
        ), pos
    raise ValueError(f"unknown fill style kind 0x{kind:02x}")


def _emit_styles(styles: ast.ShapeStyles, line2: bool = False) -> bytes:
    out = bytearray()
    fills = list(styles.fill)
    if len(fills) >= 0xFF:
        out.append(0xFF)
        out.extend(struct.pack("<H", len(fills)))
    else:
        out.append(len(fills))
    for f in fills:
        out.extend(_emit_fill_style(f))
    lines = list(styles.line)
    if len(lines) >= 0xFF:
        out.append(0xFF)
        out.extend(struct.pack("<H", len(lines)))
    else:
        out.append(len(lines))
    for l in lines:
        if line2:
            out.extend(_emit_line_style2(l))
            continue
        out.extend(struct.pack("<H", l.width))
        if not isinstance(l.fill, ast.SolidFill):
            raise ValueError("DefineShape3 line styles are solid-only")
        _write_rgba(out, l.fill.color)
    return bytes(out)


def _default_line(width: int, color: ast.StraightSRgba8) -> ast.LineStyle:
    return ast.LineStyle(
        width=width, start_cap="round", end_cap="round",
        join={"type": "round"}, no_h_scale=False, no_v_scale=False,
        no_close=False, pixel_hinting=False,
        fill=ast.SolidFill(color=color),
    )


def _parse_styles(data: bytes, pos: int, line2: bool = False,
                  rgb: bool = False) -> Tuple[ast.ShapeStyles, int]:
    count = data[pos]
    pos += 1
    if count == 0xFF:
        (count,) = struct.unpack_from("<H", data, pos)
        pos += 2
    fills = []
    for _ in range(count):
        fill, pos = _parse_fill_style(data, pos, rgb)
        fills.append(fill)
    count = data[pos]
    pos += 1
    if count == 0xFF:
        (count,) = struct.unpack_from("<H", data, pos)
        pos += 2
    lines = []
    for _ in range(count):
        if line2:
            line, pos = _parse_line_style2(data, pos)
            lines.append(line)
            continue
        (width,) = struct.unpack_from("<H", data, pos)
        pos += 2
        color, pos = (_read_rgb if rgb else _read_rgba)(data, pos)
        lines.append(_default_line(width, color))
    return ast.ShapeStyles(fill=tuple(fills), line=tuple(lines)), pos


# ---------------------------------------------------------------------------
# Shape records
# ---------------------------------------------------------------------------


def _write_style_change_fields(w: BitWriter, record, fill_bits: int,
                               line_bits: int) -> None:
    """The move/fill/line flag bits + payloads of a style-change record
    (everything after the is-edge and new-styles flags) — shared by the
    static SHAPEWITHSTYLE emitter and the morph record streams."""
    has_line = record.line_style is not None
    has_f1 = record.right_fill is not None
    has_f0 = record.left_fill is not None
    has_move = record.move_to is not None
    w.write_ub(1 if has_line else 0, 1)
    w.write_ub(1 if has_f1 else 0, 1)
    w.write_ub(1 if has_f0 else 0, 1)
    w.write_ub(1 if has_move else 0, 1)
    if has_move:
        nbits = sbits_for(record.move_to.x, record.move_to.y)
        w.write_ub(nbits, 5)
        w.write_sb(record.move_to.x, nbits)
        w.write_sb(record.move_to.y, nbits)
    if has_f0:
        w.write_ub(record.left_fill, fill_bits)
    if has_f1:
        w.write_ub(record.right_fill, fill_bits)
    if has_line:
        w.write_ub(record.line_style, line_bits)


def _read_style_change_fields(r: BitReader, flags: int, fill_bits: int,
                              line_bits: int):
    """Twin of _write_style_change_fields: (move_to, left, right, line)
    from the 4 low flag bits."""
    move_to = left = right = line = None
    if flags & 0b00001:
        nbits = r.read_ub(5)
        move_to = ast.Vector2D(r.read_sb(nbits), r.read_sb(nbits))
    if flags & 0b00010:
        left = r.read_ub(fill_bits)
    if flags & 0b00100:
        right = r.read_ub(fill_bits)
    if flags & 0b01000:
        line = r.read_ub(line_bits)
    return move_to, left, right, line


def _write_edge(w: BitWriter, delta: ast.Vector2D,
                control_delta) -> None:
    """One edge record's bits (after the is-edge flag)."""
    w.write_ub(1, 1)  # edge
    if control_delta is None:
        w.write_ub(1, 1)  # straight
        dx, dy = delta.x, delta.y
        nbits = max(2, sbits_for(dx, dy))
        w.write_ub(nbits - 2, 4)
        if dx != 0 and dy != 0:
            w.write_ub(1, 1)  # general line
            w.write_sb(dx, nbits)
            w.write_sb(dy, nbits)
        else:
            w.write_ub(0, 1)
            vertical = dx == 0
            w.write_ub(1 if vertical else 0, 1)
            w.write_sb(dy if vertical else dx, nbits)
    else:
        w.write_ub(0, 1)  # curved
        cx, cy = control_delta.x, control_delta.y
        ax = delta.x - cx
        ay = delta.y - cy
        nbits = max(2, sbits_for(cx, cy, ax, ay))
        w.write_ub(nbits - 2, 4)
        w.write_sb(cx, nbits)
        w.write_sb(cy, nbits)
        w.write_sb(ax, nbits)
        w.write_sb(ay, nbits)


def _read_edge(r: BitReader) -> ast.EdgeRecord:
    """One edge record's bits (after the is-edge flag)."""
    straight = r.read_ub(1)
    nbits = r.read_ub(4) + 2
    if straight:
        if r.read_ub(1):  # general
            dx = r.read_sb(nbits)
            dy = r.read_sb(nbits)
        elif r.read_ub(1):  # vertical
            dx, dy = 0, r.read_sb(nbits)
        else:
            dx, dy = r.read_sb(nbits), 0
        return ast.EdgeRecord(delta=ast.Vector2D(dx, dy))
    cx = r.read_sb(nbits)
    cy = r.read_sb(nbits)
    ax = r.read_sb(nbits)
    ay = r.read_sb(nbits)
    return ast.EdgeRecord(
        delta=ast.Vector2D(cx + ax, cy + ay),
        control_delta=ast.Vector2D(cx, cy),
    )


def _emit_shape_records(body: ast.ShapeBody, line2: bool = False) -> bytes:
    out = bytearray(_emit_styles(body.initial_styles, line2))
    styles = body.initial_styles

    def style_bits(s: ast.ShapeStyles):
        return ubits_for(len(s.fill)), ubits_for(len(s.line))

    fill_bits, line_bits = style_bits(styles)
    w = BitWriter()
    w.write_ub(fill_bits, 4)
    w.write_ub(line_bits, 4)

    for record in body.records:
        if isinstance(record, ast.StyleChangeRecord):
            w.write_ub(0, 1)  # non-edge
            has_new = record.new_styles is not None
            w.write_ub(1 if has_new else 0, 1)
            _write_style_change_fields(w, record, fill_bits, line_bits)
            if has_new:
                w.align()
                out.extend(w.bytes())
                out.extend(_emit_styles(record.new_styles, line2))
                styles = record.new_styles
                fill_bits, line_bits = style_bits(styles)
                w = BitWriter()
                w.write_ub(fill_bits, 4)
                w.write_ub(line_bits, 4)
        elif isinstance(record, ast.EdgeRecord):
            _write_edge(w, record.delta, record.control_delta)
        else:
            raise ValueError(f"unknown record {record!r}")

    w.write_ub(0, 6)  # end record
    w.align()
    out.extend(w.bytes())
    return bytes(out)


def _parse_shape_records(data: bytes, pos: int, line2: bool = False,
                         rgb: bool = False) -> Tuple[ast.ShapeBody, int]:
    initial_styles, pos = _parse_styles(data, pos, line2, rgb)
    records: List[ast.ShapeRecord] = []
    r = BitReader(data, pos)
    fill_bits = r.read_ub(4)
    line_bits = r.read_ub(4)

    while True:
        is_edge = r.read_ub(1)
        if not is_edge:
            flags = r.read_ub(5)
            if flags == 0:
                break  # end record
            has_new = bool(flags & 0b10000)
            new_styles = None
            move_to, left, right, line = _read_style_change_fields(
                r, flags, fill_bits, line_bits)
            if has_new:
                r.align()
                new_styles, pos = _parse_styles(data, r.byte_pos, line2,
                                                rgb)
                r = BitReader(data, pos)
                fill_bits = r.read_ub(4)
                line_bits = r.read_ub(4)
            records.append(ast.StyleChangeRecord(
                move_to=move_to, left_fill=left, right_fill=right,
                line_style=line, new_styles=new_styles,
            ))
        else:
            records.append(_read_edge(r))
    r.align()
    return ast.ShapeBody(initial_styles=initial_styles,
                         records=tuple(records)), r.byte_pos


# ---------------------------------------------------------------------------
# Placements (PlaceObject2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Placement:
    """One PlaceObject2: what the display list shows at a depth.

    ``ratio`` is the morph ratio in [0, 1] (u16/65536 on the wire);
    ``color_transform`` is (mult4, add4) floats on [0, 1] straight
    colors (CXFORMWITHALPHA fixed 8.8 mults / 0..255 adds).
    ``move``: the PlaceFlagMove form — modify (or, with a character id,
    replace) whatever occupies the depth; fields left None RETAIN the
    previous occupant's values (player semantics)."""

    depth: int
    character_id: Optional[int] = None
    matrix: ast.Matrix = None
    color_transform: Tuple[Tuple[float, ...], Tuple[float, ...]] = None
    ratio: float = None
    move: bool = False
    # PlaceObject2 instance name (flag 0x20) — carried, not interpreted.
    name: Optional[str] = None
    # PlaceObject2 clip depth (flag 0x40): this character is a MASK for
    # depths (depth, clip_depth]; the movie loader builds a
    # display.MaskedGroup from it.
    clip_depth: Optional[int] = None
    # PlaceObject3 blend mode name (ops.composite.BLEND_MODES, or
    # "layer"); None = normal.  Set -> emits as tag 70.
    blend: Optional[str] = None
    # PlaceObject3 HasVisible flag: False hides the instance (it keeps
    # its depth slot but draws nothing); None = unspecified (a move
    # retains the previous value).
    visible: Optional[bool] = None
    # PlaceObject3 surface filter list: ops.filters dataclasses
    # (DropShadow/Blur/Glow/ColorMatrix; bevel/gradient/convolution
    # parse-skip with a warning).
    filters: Tuple = ()
    # Emit as the SWF1 PlaceObject (tag 4): character id + depth +
    # mandatory matrix + optional RGB CXFORM.  Parsing tag 4 sets this.
    legacy: bool = False
    # Resolved timelines only: the frame index (within the containing
    # timeline) at which this depth's CURRENT character appeared —
    # move-modify retains it, replacing the character resets it.  Sprite
    # instances derive their loop phase from it.
    placed_frame: int = 0


@dataclasses.dataclass(frozen=True)
class RemoveObject:
    """RemoveObject2: clear a depth from the display list.

    ``character_id`` set emits/parses as the SWF1 RemoveObject (tag 5),
    whose removal names both the character and the depth."""

    depth: int
    character_id: Optional[int] = None


def _write_cxform_alpha(w: BitWriter, mult, add) -> None:
    """CXFORMWITHALPHA: fixed-8.8 mult terms, integer 0..255 add terms
    (both RGBA), shared signed bit width."""
    w.align()
    mi = [int(round(float(m) * 256.0)) for m in mult]
    ai = [int(round(float(a) * 255.0)) for a in add]
    has_mult = mi != [256, 256, 256, 256]
    has_add = ai != [0, 0, 0, 0]
    w.write_ub(1 if has_add else 0, 1)
    w.write_ub(1 if has_mult else 0, 1)
    terms = (mi if has_mult else []) + (ai if has_add else [])
    nbits = sbits_for(*terms) if terms else 1
    w.write_ub(nbits, 4)
    if has_mult:
        for v in mi:
            w.write_sb(v, nbits)
    if has_add:
        for v in ai:
            w.write_sb(v, nbits)
    w.align()


def _read_cxform_alpha(r: BitReader):
    r.align()
    has_add = r.read_ub(1)
    has_mult = r.read_ub(1)
    nbits = r.read_ub(4)
    mult = (1.0, 1.0, 1.0, 1.0)
    add = (0.0, 0.0, 0.0, 0.0)
    if has_mult:
        mult = tuple(r.read_sb(nbits) / 256.0 for _ in range(4))
    if has_add:
        add = tuple(r.read_sb(nbits) / 255.0 for _ in range(4))
    r.align()
    return mult, add


def _write_cxform_rgb(w: BitWriter, mult, add) -> None:
    """CXFORM (no alpha, PlaceObject tag 4): RGB-only fixed-8.8 mults /
    0..255 adds; the alpha terms of the (mult4, add4) tuple must be
    identity (1, 0)."""
    w.align()
    mi = [int(round(float(m) * 256.0)) for m in mult[:3]]
    ai = [int(round(float(a) * 255.0)) for a in add[:3]]
    has_mult = mi != [256, 256, 256]
    has_add = ai != [0, 0, 0]
    w.write_ub(1 if has_add else 0, 1)
    w.write_ub(1 if has_mult else 0, 1)
    terms = (mi if has_mult else []) + (ai if has_add else [])
    nbits = sbits_for(*terms) if terms else 1
    w.write_ub(nbits, 4)
    if has_mult:
        for v in mi:
            w.write_sb(v, nbits)
    if has_add:
        for v in ai:
            w.write_sb(v, nbits)
    w.align()


def _read_cxform_rgb(r: BitReader):
    r.align()
    has_add = r.read_ub(1)
    has_mult = r.read_ub(1)
    nbits = r.read_ub(4)
    mult = (1.0, 1.0, 1.0)
    add = (0.0, 0.0, 0.0)
    if has_mult:
        mult = tuple(r.read_sb(nbits) / 256.0 for _ in range(3))
    if has_add:
        add = tuple(r.read_sb(nbits) / 255.0 for _ in range(3))
    r.align()
    return mult + (1.0,), add + (0.0,)


def _identity_matrix() -> ast.Matrix:
    from ..utils.fixed import Sfixed16P16

    one = Sfixed16P16.from_value(1)
    zero = Sfixed16P16.from_value(0)
    return ast.Matrix(scale_x=one, scale_y=one, rotate_skew0=zero,
                      rotate_skew1=zero, translate_x=0, translate_y=0)


def _emit_place_object(p: Placement) -> bytes:
    """SWF1 PlaceObject (tag 4): character id + depth + MATRIX
    (mandatory — identity when the placement carries none) + optional
    RGB CXFORM."""
    if p.character_id is None:
        raise ValueError("PlaceObject needs a character id")
    if p.move or p.ratio is not None or p.name is not None:
        raise ValueError(
            "PlaceObject carries no move/ratio/name (PlaceObject2 forms)")
    if p.color_transform is not None:
        mult, add = p.color_transform
        if tuple(mult)[3] != 1.0 or tuple(add)[3] != 0.0:
            raise ValueError("PlaceObject CXFORM has no alpha terms")
    body = bytearray(struct.pack("<HH", p.character_id, p.depth))
    w = BitWriter()
    _write_matrix(w, p.matrix if p.matrix is not None
                  else _identity_matrix())
    if p.color_transform is not None:
        _write_cxform_rgb(w, *p.color_transform)
    body.extend(w.bytes())
    return _tag(TAG_PLACE_OBJECT, bytes(body))


def _parse_place_object(body: bytes) -> Placement:
    char_id, depth = struct.unpack_from("<HH", body, 0)
    r = BitReader(body, 4)
    matrix = _read_matrix(r)
    ct = None
    if r.byte_pos < len(body):
        ct = _read_cxform_rgb(r)
    return Placement(depth=depth, character_id=char_id, matrix=matrix,
                     color_transform=ct, legacy=True)


def _place_flags_and_fields(p: Placement):
    """The PlaceObject2/3 shared flag byte + post-depth field bytes."""
    flags = 0
    if p.move:
        flags |= 0x01
    if p.character_id is not None:
        flags |= 0x02
    elif not p.move:
        raise ValueError("new placements need a character id")
    if p.matrix is not None:
        flags |= 0x04
    if p.color_transform is not None:
        flags |= 0x08
    if p.ratio is not None:
        flags |= 0x10
    if p.name is not None:
        flags |= 0x20
    if p.clip_depth is not None:
        flags |= 0x40
    body = bytearray()
    if p.character_id is not None:
        body.extend(struct.pack("<H", p.character_id))
    if p.matrix is not None or p.color_transform is not None:
        w = BitWriter()
        if p.matrix is not None:
            _write_matrix(w, p.matrix)
        if p.color_transform is not None:
            _write_cxform_alpha(w, *p.color_transform)
        body.extend(w.bytes())
    if p.ratio is not None:
        ratio_u16 = min(65535, max(0, int(round(float(p.ratio) * 65536))))
        body.extend(struct.pack("<H", ratio_u16))
    if p.name is not None:
        body.extend(p.name.encode("utf-8") + b"\x00")
    if p.clip_depth is not None:
        body.extend(struct.pack("<H", p.clip_depth))
    return flags, bytes(body)


def _parse_filter_list(body: bytes, pos: int):
    """PlaceObject3 SURFACEFILTERLIST -> ops.filters dataclasses (all
    eight spec kinds: drop shadow, blur, glow, bevel, gradient glow,
    convolution, color matrix, gradient bevel)."""
    from ..ops.filters import (
        BevelFilter, BlurFilter, ColorMatrixFilter, ConvolutionFilter,
        DropShadowFilter, GlowFilter, GradientBevelFilter,
        GradientGlowFilter,
    )

    def fixed(off):
        (v,) = struct.unpack_from("<i", body, off)
        return v / 65536.0

    def fixed8(off):
        (v,) = struct.unpack_from("<h", body, off)
        return v / 256.0

    def rgba(off):
        r, g, b, a = body[off : off + 4]
        return (r / 255.0, g / 255.0, b / 255.0, a / 255.0)

    count = body[pos]
    pos += 1
    filters = []
    for _ in range(count):
        fid = body[pos]
        pos += 1
        if fid == 0:  # drop shadow
            color = rgba(pos)
            bx, by = fixed(pos + 4), fixed(pos + 8)
            angle, dist = fixed(pos + 12), fixed(pos + 16)
            strength = fixed8(pos + 20)
            flags = body[pos + 22]
            filters.append(DropShadowFilter(
                color=color, blur_x=bx, blur_y=by, angle=angle,
                distance=dist, strength=strength,
                inner=bool(flags & 0x80), knockout=bool(flags & 0x40),
                passes=flags & 0x1F))
            pos += 23
        elif fid == 1:  # blur
            bx, by = fixed(pos), fixed(pos + 4)
            flags = body[pos + 8]
            filters.append(BlurFilter(blur_x=bx, blur_y=by,
                                      passes=flags >> 3))
            pos += 9
        elif fid == 2:  # glow
            color = rgba(pos)
            bx, by = fixed(pos + 4), fixed(pos + 8)
            strength = fixed8(pos + 12)
            flags = body[pos + 14]
            filters.append(GlowFilter(
                color=color, blur_x=bx, blur_y=by, strength=strength,
                inner=bool(flags & 0x80), knockout=bool(flags & 0x40),
                passes=flags & 0x1F))
            pos += 15
        elif fid == 6:  # color matrix
            terms = struct.unpack_from("<20f", body, pos)
            filters.append(ColorMatrixFilter(matrix=tuple(terms)))
            pos += 80
        elif fid == 3:  # bevel
            shadow, highlight = rgba(pos), rgba(pos + 4)
            bx, by = fixed(pos + 8), fixed(pos + 12)
            angle, dist = fixed(pos + 16), fixed(pos + 20)
            strength = fixed8(pos + 24)
            flags = body[pos + 26]
            filters.append(BevelFilter(
                shadow_color=shadow, highlight_color=highlight,
                blur_x=bx, blur_y=by, angle=angle, distance=dist,
                strength=strength, inner=bool(flags & 0x80),
                knockout=bool(flags & 0x40),
                on_top=bool(flags & 0x10), passes=flags & 0x0F))
            pos += 27
        elif fid in (4, 7):  # gradient glow / gradient bevel
            n = body[pos]
            pos += 1
            colors = tuple(rgba(pos + 4 * i) for i in range(n))
            pos += 4 * n
            ratios = tuple(body[pos + i] / 255.0 for i in range(n))
            pos += n
            bx, by = fixed(pos), fixed(pos + 4)
            angle, dist = fixed(pos + 8), fixed(pos + 12)
            strength = fixed8(pos + 16)
            flags = body[pos + 18]
            pos += 19
            cls = GradientGlowFilter if fid == 4 else GradientBevelFilter
            filters.append(cls(
                colors=colors, ratios=ratios, blur_x=bx, blur_y=by,
                angle=angle, distance=dist, strength=strength,
                inner=bool(flags & 0x80), knockout=bool(flags & 0x40),
                on_top=bool(flags & 0x10), passes=flags & 0x0F))
        elif fid == 5:  # convolution
            mx, my = body[pos], body[pos + 1]
            divisor, bias = struct.unpack_from("<2f", body, pos + 2)
            terms = struct.unpack_from(f"<{mx * my}f", body, pos + 10)
            off = pos + 10 + 4 * mx * my
            default = rgba(off)
            flags = body[off + 4]
            filters.append(ConvolutionFilter(
                matrix_x=mx, matrix_y=my, matrix=tuple(terms),
                divisor=divisor, bias=bias, default_color=default,
                clamp=bool(flags & 0x02),
                preserve_alpha=bool(flags & 0x01)))
            pos = off + 5
        else:
            raise ValueError(f"unknown filter id {fid}")
    return tuple(filters), pos


def _emit_filter_list(filters) -> bytes:
    from ..ops.filters import (
        BevelFilter, BlurFilter, ColorMatrixFilter, ConvolutionFilter,
        DropShadowFilter, GlowFilter, GradientBevelFilter,
        GradientGlowFilter,
    )

    def fixed(v):
        return struct.pack("<i", int(round(v * 65536)))

    def fixed8(v):
        return struct.pack("<h", int(round(v * 256)))

    def rgba(c):
        return bytes(int(round(ch * 255)) for ch in c)

    out = bytearray((len(filters),))
    for f in filters:
        if isinstance(f, DropShadowFilter):
            out.append(0)
            out.extend(rgba(f.color))
            out.extend(fixed(f.blur_x) + fixed(f.blur_y))
            out.extend(fixed(f.angle) + fixed(f.distance))
            out.extend(fixed8(f.strength))
            out.append((0x80 if f.inner else 0)
                       | (0x40 if f.knockout else 0) | 0x20
                       | (f.passes & 0x1F))
        elif isinstance(f, BlurFilter):
            out.append(1)
            out.extend(fixed(f.blur_x) + fixed(f.blur_y))
            out.append((f.passes & 0x1F) << 3)
        elif isinstance(f, GlowFilter):
            out.append(2)
            out.extend(rgba(f.color))
            out.extend(fixed(f.blur_x) + fixed(f.blur_y))
            out.extend(fixed8(f.strength))
            out.append((0x80 if f.inner else 0)
                       | (0x40 if f.knockout else 0) | 0x20
                       | (f.passes & 0x1F))
        elif isinstance(f, ColorMatrixFilter):
            out.append(6)
            out.extend(struct.pack("<20f", *f.matrix))
        elif isinstance(f, BevelFilter):
            out.append(3)
            out.extend(rgba(f.shadow_color) + rgba(f.highlight_color))
            out.extend(fixed(f.blur_x) + fixed(f.blur_y))
            out.extend(fixed(f.angle) + fixed(f.distance))
            out.extend(fixed8(f.strength))
            out.append((0x80 if f.inner else 0)
                       | (0x40 if f.knockout else 0) | 0x20
                       | (0x10 if f.on_top else 0) | (f.passes & 0x0F))
        elif isinstance(f, (GradientGlowFilter, GradientBevelFilter)):
            out.append(4 if isinstance(f, GradientGlowFilter) else 7)
            out.append(len(f.colors))
            for c in f.colors:
                out.extend(rgba(c))
            out.extend(int(round(r * 255)) for r in f.ratios)
            out.extend(fixed(f.blur_x) + fixed(f.blur_y))
            out.extend(fixed(f.angle) + fixed(f.distance))
            out.extend(fixed8(f.strength))
            out.append((0x80 if f.inner else 0)
                       | (0x40 if f.knockout else 0) | 0x20
                       | (0x10 if f.on_top else 0) | (f.passes & 0x0F))
        elif isinstance(f, ConvolutionFilter):
            out.append(5)
            out.append(f.matrix_x)
            out.append(f.matrix_y)
            out.extend(struct.pack("<2f", f.divisor, f.bias))
            out.extend(struct.pack(f"<{f.matrix_x * f.matrix_y}f",
                                   *f.matrix))
            out.extend(rgba(f.default_color))
            out.append((0x02 if f.clamp else 0)
                       | (0x01 if f.preserve_alpha else 0))
        else:
            raise ValueError(f"cannot emit filter {f!r}")
    return bytes(out)


def _emit_place_object3(p: Placement) -> bytes:
    """PlaceObject3 (tag 70): the PlaceObject2 fields plus a flags2
    byte; emitted for blend-mode and visibility placements (filters,
    class names and the other flags2 features are not written)."""
    flags, fields = _place_flags_and_fields(p)
    flags2 = 0
    tail = bytearray()
    if p.filters:
        flags2 |= 0x01  # HasFilterList
        tail.extend(_emit_filter_list(p.filters))
    if p.blend is not None:
        if p.blend not in _BLEND_NAMES:
            raise ValueError(f"unknown blend mode {p.blend!r}")
        flags2 |= 0x02  # HasBlendMode
        tail.append(_BLEND_NAMES[p.blend])
    if p.visible is not None:
        flags2 |= 0x20  # HasVisible
        tail.append(1 if p.visible else 0)
    return _tag(TAG_PLACE_OBJECT3,
                struct.pack("<BBH", flags, flags2, p.depth) + fields
                + bytes(tail))


def _parse_place_object3(body: bytes) -> Placement:
    flags, flags2 = body[0], body[1]
    if flags & 0x80:
        raise ValueError(
            f"unsupported PlaceObject3 flags 0x{flags:02x} (clip actions)")
    (depth,) = struct.unpack_from("<H", body, 2)
    pos = 4
    if flags2 & 0x08 or (flags2 & 0x10 and flags & 0x02):
        pos = body.index(b"\x00", pos) + 1  # class name: skipped
    char_id = None
    if flags & 0x02:
        (char_id,) = struct.unpack_from("<H", body, pos)
        pos += 2
    matrix = None
    ct = None
    if flags & (0x04 | 0x08):
        r = BitReader(body, pos)
        if flags & 0x04:
            matrix = _read_matrix(r)
        if flags & 0x08:
            ct = _read_cxform_alpha(r)
        pos = r.byte_pos
    ratio = None
    if flags & 0x10:
        (ratio_u16,) = struct.unpack_from("<H", body, pos)
        ratio = ratio_u16 / 65536.0
        pos += 2
    name = None
    if flags & 0x20:
        end = body.index(b"\x00", pos)
        name = body[pos:end].decode("utf-8")
        pos = end + 1
    clip_depth = None
    if flags & 0x40:
        (clip_depth,) = struct.unpack_from("<H", body, pos)
        pos += 2
    filters = ()
    if flags2 & 0x01:
        filters, pos = _parse_filter_list(body, pos)
    blend = None
    if flags2 & 0x02:
        blend = _BLEND_ORDINALS.get(body[pos])
        if body[pos] not in _BLEND_ORDINALS:
            raise ValueError(f"unknown blend mode ordinal {body[pos]}")
        pos += 1
    if flags2 & 0x04:
        pos += 1  # bitmap-cache hint: ignored
    visible = None
    if flags2 & 0x20:
        visible = bool(body[pos])
        pos += 1
        # OpaqueBackground color (RGBA) follows when 0x40 is also set;
        # trailing — nothing further is consumed either way.
    return Placement(depth=depth, character_id=char_id, matrix=matrix,
                     color_transform=ct, ratio=ratio,
                     move=bool(flags & 0x01), name=name,
                     clip_depth=clip_depth, blend=blend, visible=visible,
                     filters=filters)


def _emit_place_object2(p: Placement) -> bytes:
    if p.legacy:
        return _emit_place_object(p)
    if p.blend is not None or p.visible is not None or p.filters:
        return _emit_place_object3(p)
    flags, fields = _place_flags_and_fields(p)
    return _tag(TAG_PLACE_OBJECT2,
                struct.pack("<BH", flags, p.depth) + fields)


def _parse_place_object2(body: bytes) -> Placement:
    flags = body[0]
    if flags & 0x80:
        raise ValueError(
            f"unsupported PlaceObject2 flags 0x{flags:02x} (clip actions)")
    move = bool(flags & 0x01)
    if not (flags & 0x02) and not move:
        raise ValueError("PlaceObject2 without a character id")
    (depth,) = struct.unpack_from("<H", body, 1)
    pos = 3
    char_id = None
    if flags & 0x02:
        (char_id,) = struct.unpack_from("<H", body, pos)
        pos += 2
    matrix = None
    ct = None
    if flags & (0x04 | 0x08):
        r = BitReader(body, pos)
        if flags & 0x04:
            matrix = _read_matrix(r)
        if flags & 0x08:
            ct = _read_cxform_alpha(r)
        pos = r.byte_pos
    ratio = None
    if flags & 0x10:
        (ratio_u16,) = struct.unpack_from("<H", body, pos)
        ratio = ratio_u16 / 65536.0
        pos += 2
    name = None
    if flags & 0x20:
        end = body.index(b"\x00", pos)
        name = body[pos:end].decode("utf-8")
        pos = end + 1
    clip_depth = None
    if flags & 0x40:
        (clip_depth,) = struct.unpack_from("<H", body, pos)
    return Placement(depth=depth, character_id=char_id, matrix=matrix,
                     color_transform=ct, ratio=ratio, move=move, name=name,
                     clip_depth=clip_depth)


# ---------------------------------------------------------------------------
# Tags and movies
# ---------------------------------------------------------------------------


def _tag(code: int, body: bytes) -> bytes:
    if len(body) >= 0x3F:
        return struct.pack("<HI", (code << 6) | 0x3F, len(body)) + body
    return struct.pack("<H", (code << 6) | len(body)) + body


def emit_define_shape(tag: ast.DefineShape) -> bytes:
    """DefineShape3 tag bytes for a DefineShape AST."""
    body = bytearray(struct.pack("<H", tag.id))
    w = BitWriter()
    _write_rect(w, tag.bounds)
    body.extend(w.bytes())
    body.extend(_emit_shape_records(tag.shape))
    return _tag(TAG_DEFINE_SHAPE3, bytes(body))


def parse_define_shape_tag(body: bytes) -> ast.DefineShape:
    (shape_id,) = struct.unpack_from("<H", body, 0)
    r = BitReader(body, 2)
    bounds = _read_rect(r)
    shape, _ = _parse_shape_records(body, r.byte_pos)
    return ast.DefineShape(id=shape_id, bounds=bounds, shape=shape)


def parse_define_shape12_tag(body: bytes) -> ast.DefineShape:
    """DefineShape (tag 2) / DefineShape2 (tag 22): the pre-alpha
    encodings old movies ship — identical structure with opaque RGB
    style colors (parse-only; the emitter writes DefineShape3+)."""
    (shape_id,) = struct.unpack_from("<H", body, 0)
    r = BitReader(body, 2)
    bounds = _read_rect(r)
    shape, _ = _parse_shape_records(body, r.byte_pos, rgb=True)
    return ast.DefineShape(id=shape_id, bounds=bounds, shape=shape)


_CAP_TO_BITS = {"round": 0, "none": 1, "square": 2}
_BITS_TO_CAP = {v: k for k, v in _CAP_TO_BITS.items()}
_JOIN_TO_BITS = {"round": 0, "bevel": 1, "miter": 2}
_BITS_TO_JOIN = {v: k for k, v in _JOIN_TO_BITS.items()}


def _emit_line_style2(l: ast.LineStyle) -> bytes:
    """DefineShape4 LINESTYLE2: caps/joins/miter encoded (spec v19 p.153)."""
    if not isinstance(l.fill, ast.SolidFill):
        raise ValueError("LINESTYLE2 fill styles not supported (solid only)")
    out = bytearray(struct.pack("<H", l.width))
    join = l.join.get("type", "round") if isinstance(l.join, dict) \
        else str(l.join)
    b = 0
    b |= _CAP_TO_BITS[l.start_cap] << 6
    b |= _JOIN_TO_BITS[join] << 4
    # HasFillFlag = 0 (solid color), NoHScale, NoVScale, PixelHinting
    b |= (1 if l.no_h_scale else 0) << 2
    b |= (1 if l.no_v_scale else 0) << 1
    b |= 1 if l.pixel_hinting else 0
    out.append(b)
    b2 = 0  # 5 reserved bits
    b2 |= (1 if l.no_close else 0) << 2
    b2 |= _CAP_TO_BITS[l.end_cap]
    out.append(b2)
    if join == "miter":
        limit = float(l.join.get("limit", 3.0)) \
            if isinstance(l.join, dict) else 3.0
        out.extend(struct.pack("<H", int(round(limit * 256)) & 0xFFFF))
    _write_rgba(out, l.fill.color)
    return bytes(out)


def _parse_line_style2(data: bytes, pos: int) -> Tuple[ast.LineStyle, int]:
    (width,) = struct.unpack_from("<H", data, pos)
    pos += 2
    b = data[pos]
    pos += 1
    start_cap = _BITS_TO_CAP[(b >> 6) & 3]
    join_bits = (b >> 4) & 3
    has_fill = bool((b >> 3) & 1)
    no_h = bool((b >> 2) & 1)
    no_v = bool((b >> 1) & 1)
    hinting = bool(b & 1)
    b2 = data[pos]
    pos += 1
    no_close = bool((b2 >> 2) & 1)
    end_cap = _BITS_TO_CAP[b2 & 3]
    join: dict = {"type": _BITS_TO_JOIN[join_bits]}
    if join_bits == 2:
        (ml,) = struct.unpack_from("<H", data, pos)
        pos += 2
        join["limit"] = ml / 256.0
    if has_fill:
        raise ValueError("LINESTYLE2 fill styles not supported")
    color, pos = _read_rgba(data, pos)
    return ast.LineStyle(
        width=width, start_cap=start_cap, end_cap=end_cap, join=join,
        no_h_scale=no_h, no_v_scale=no_v, no_close=no_close,
        pixel_hinting=hinting, fill=ast.SolidFill(color=color),
    ), pos


def emit_define_shape4(tag: ast.DefineShape) -> bytes:
    """DefineShape4 tag bytes: LINESTYLE2 line styles (caps/joins/miter
    survive the round trip, unlike DefineShape3)."""
    body = bytearray(struct.pack("<H", tag.id))
    w = BitWriter()
    _write_rect(w, tag.bounds)
    _write_rect(w, tag.bounds)  # edge bounds: reuse shape bounds
    body.extend(w.bytes())
    # Flags: reserved(5) | UsesFillWindingRule | UsesNonScalingStrokes |
    # UsesScalingStrokes — default strokes scale, so bit 0.
    body.append((1 if tag.has_fill_winding else 0) << 2 | 0b01)
    body.extend(_emit_shape_records(tag.shape, line2=True))
    return _tag(TAG_DEFINE_SHAPE4, bytes(body))


def parse_define_shape4_tag(body: bytes) -> ast.DefineShape:
    (shape_id,) = struct.unpack_from("<H", body, 0)
    r = BitReader(body, 2)
    bounds = _read_rect(r)
    _read_rect(r)  # edge bounds (unused: emit mirrors shape bounds)
    flags = body[r.byte_pos]
    shape, _ = _parse_shape_records(body, r.byte_pos + 1, line2=True)
    return ast.DefineShape(id=shape_id, bounds=bounds, shape=shape,
                           has_fill_winding=bool((flags >> 2) & 1))


# ---------------------------------------------------------------------------
# Bitmaps (DefineBitsLossless)
# ---------------------------------------------------------------------------


def emit_define_bits_lossless(tag: ast.DefineBitmap) -> bytes:
    """DefineBitsLossless (tag 20) bytes.

    The ``image/x-swf-bmp`` payload the AST carries IS the tag body
    minus the character id — formatId u8, width u16LE, height u16LE,
    colorTableSize u8, zlib(palette + padded indices) — exactly the
    header decode-x-swf-bmp.ts:9-41 parses, so emission is id + data
    after validating the header against the AST's declared geometry."""
    formats = {"image/x-swf-bmp": (3,), "image/x-swf-bmp-full": (4, 5)}
    allowed = formats.get(tag.media_type)
    if allowed is None:
        raise ValueError(
            f"cannot emit media type {tag.media_type!r} "
            "(x-swf-bmp / x-swf-bmp-full only)")
    if len(tag.data) < 5 or tag.data[0] not in allowed:
        raise ValueError(
            f"{tag.media_type} payload must start with formatId "
            f"{' or '.join(map(str, allowed))}")
    width, height = struct.unpack_from("<HH", tag.data, 1)
    if (width, height) != (tag.width, tag.height):
        raise ValueError(
            f"payload geometry {width}x{height} != declared "
            f"{tag.width}x{tag.height}")
    return _tag(TAG_DEFINE_BITS_LOSSLESS,
                struct.pack("<H", tag.id) + tag.data)


def parse_define_bits_lossless_tag(body: bytes) -> ast.DefineBitmap:
    (bitmap_id,) = struct.unpack_from("<H", body, 0)
    data = body[2:]
    if len(data) < 5 or data[0] not in (3, 4, 5):
        raise ValueError(
            "only colormapped (format 3) or direct-color (formats 4/5) "
            "DefineBitsLossless is supported")
    width, height = struct.unpack_from("<HH", data, 1)
    media = ("image/x-swf-bmp" if data[0] == 3 else "image/x-swf-bmp-full")
    return ast.DefineBitmap(id=bitmap_id, width=width, height=height,
                            media_type=media, data=data)


def emit_define_bits_lossless2(tag: ast.DefineBitmap) -> bytes:
    """DefineBitsLossless2 (tag 36) bytes: the ``image/x-swf-bmp2``
    payload (formatId 3 with an RGBA palette, or formatId 5 ARGB32
    premultiplied) is the tag body minus the character id — the alpha
    sibling of tag 20, beyond the reference's format-3-only codec
    (decode-x-swf-bmp.ts:9-41)."""
    if tag.media_type != "image/x-swf-bmp2":
        raise ValueError(
            f"cannot emit media type {tag.media_type!r} (x-swf-bmp2 only)")
    if len(tag.data) < 5 or tag.data[0] not in (3, 5):
        raise ValueError("x-swf-bmp2 payload must start with formatId 3 or 5")
    width, height = struct.unpack_from("<HH", tag.data, 1)
    if (width, height) != (tag.width, tag.height):
        raise ValueError(
            f"payload geometry {width}x{height} != declared "
            f"{tag.width}x{tag.height}")
    return _tag(TAG_DEFINE_BITS_LOSSLESS2,
                struct.pack("<H", tag.id) + tag.data)


def parse_define_bits_lossless2_tag(body: bytes) -> ast.DefineBitmap:
    (bitmap_id,) = struct.unpack_from("<H", body, 0)
    data = body[2:]
    if len(data) < 5 or data[0] not in (3, 5):
        raise ValueError(
            "only colormapped (format 3) or ARGB32 (format 5) "
            "DefineBitsLossless2 is supported")
    width, height = struct.unpack_from("<HH", data, 1)
    return ast.DefineBitmap(id=bitmap_id, width=width, height=height,
                            media_type="image/x-swf-bmp2", data=data)


def _strip_jpeg_quirk(data: bytes) -> bytes:
    """Pre-SWF8 writers prepend an erroneous EOI+SOI pair to JPEG
    payloads (SWF spec, DefineBitsJPEG2)."""
    if data[:4] in (b"\xff\xd9\xff\xd8", b"\xff\xd8\xff\xd9"):
        return data[4:]
    return data


def image_dimensions(data: bytes):
    """(width, height) from a JPEG (SOF marker scan), PNG (IHDR), or
    GIF header — the three payload containers DefineBitsJPEG2 allows.
    Pure header parsing; no image codec dependency in the models layer."""
    data = _strip_jpeg_quirk(data)
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        w, h = struct.unpack_from(">II", data, 16)
        return int(w), int(h)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        w, h = struct.unpack_from("<HH", data, 6)
        return int(w), int(h)
    if data[:2] == b"\xff\xd8":
        pos = 2
        while pos + 4 <= len(data):
            if data[pos] != 0xFF:
                pos += 1
                continue
            marker = data[pos + 1]
            if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
                pos += 2
                continue
            (seg_len,) = struct.unpack_from(">H", data, pos + 2)
            # SOF0..SOF15 except DHT(C4)/JPG(C8)/DAC(CC) carry the frame
            # header: precision u8, height u16, width u16.
            if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
                h, w = struct.unpack_from(">HH", data, pos + 5)
                return int(w), int(h)
            pos += 2 + seg_len
        raise ValueError("no JPEG SOF marker found")
    raise ValueError(f"unrecognized image container {data[:4]!r}")


def emit_define_bits_jpeg2(tag: ast.DefineBitmap) -> bytes:
    """DefineBitsJPEG2 (tag 21): character id + the image bytes (JPEG,
    or PNG/GIF89a from SWF 8 on) — an ``image/jpeg`` DefineBitmap's
    payload IS the tag body minus the id."""
    if tag.media_type != "image/jpeg":
        raise ValueError(
            f"cannot emit media type {tag.media_type!r} (image/jpeg only)")
    if image_dimensions(tag.data) != (tag.width, tag.height):
        raise ValueError("payload geometry != declared geometry")
    return _tag(TAG_DEFINE_BITS_JPEG2, struct.pack("<H", tag.id) + tag.data)


def parse_define_bits_jpeg2_tag(body: bytes) -> ast.DefineBitmap:
    (bitmap_id,) = struct.unpack_from("<H", body, 0)
    data = body[2:]
    w, h = image_dimensions(data)
    return ast.DefineBitmap(id=bitmap_id, width=w, height=h,
                            media_type="image/jpeg", data=data)


def emit_define_bits_jpeg3(tag: ast.DefineBitmap) -> bytes:
    """DefineBitsJPEG3 (tag 35): id, alphaDataOffset u32, image bytes,
    zlib alpha plane — the ``image/x-swf-jpeg3`` payload is the tag
    body minus the id."""
    if tag.media_type != "image/x-swf-jpeg3":
        raise ValueError(
            f"cannot emit media type {tag.media_type!r} (x-swf-jpeg3 only)")
    (alpha_off,) = struct.unpack_from("<I", tag.data, 0)
    if image_dimensions(tag.data[4 : 4 + alpha_off]) != (tag.width,
                                                         tag.height):
        raise ValueError("payload geometry != declared geometry")
    return _tag(TAG_DEFINE_BITS_JPEG3, struct.pack("<H", tag.id) + tag.data)


def parse_define_bits_jpeg3_tag(body: bytes) -> ast.DefineBitmap:
    (bitmap_id,) = struct.unpack_from("<H", body, 0)
    data = body[2:]
    (alpha_off,) = struct.unpack_from("<I", data, 0)
    w, h = image_dimensions(data[4 : 4 + alpha_off])
    return ast.DefineBitmap(id=bitmap_id, width=w, height=h,
                            media_type="image/x-swf-jpeg3", data=data)


def parse_define_bits_jpeg4_tag(body: bytes) -> ast.DefineBitmap:
    """DefineBitsJPEG4 (tag 90): DefineBitsJPEG3 plus a u16 deblocking
    hint between the alpha offset and the image data — the hint is a
    decoder parameter we don't apply, so the payload normalizes to the
    x-swf-jpeg3 form."""
    (bitmap_id,) = struct.unpack_from("<H", body, 0)
    (alpha_off,) = struct.unpack_from("<I", body, 2)
    data = body[2:6] + body[8:]  # drop the deblock u16
    w, h = image_dimensions(data[4 : 4 + alpha_off])
    return ast.DefineBitmap(id=bitmap_id, width=w, height=h,
                            media_type="image/x-swf-jpeg3", data=data)


def _define_bits_v1_jpeg(jpeg_tables: bytes, body: bytes) -> ast.DefineBitmap:
    """DefineBits (tag 6) + JPEGTables (tag 8): the SWF1 split-stream
    JPEG.  The tables stream is SOI..tables..EOI and the per-character
    stream SOI..scan..EOI; splicing tables[:-2] + data[2:] rebuilds one
    decodable JPEG (the classic player concatenation)."""
    (bitmap_id,) = struct.unpack_from("<H", body, 0)
    data = _strip_jpeg_quirk(body[2:])
    tables = _strip_jpeg_quirk(jpeg_tables)
    if len(tables) > 4:
        data = tables[:-2] + data[2:]
    w, h = image_dimensions(data)
    return ast.DefineBitmap(id=bitmap_id, width=w, height=h,
                            media_type="image/jpeg", data=data)


def emit_define_bitmap(tag: ast.DefineBitmap) -> bytes:
    """Route a DefineBitmap to its wire tag by media type (tag 20 for
    the x-swf-bmp families, 36 for x-swf-bmp2, 21 for image/jpeg,
    35 for x-swf-jpeg3)."""
    if tag.media_type == "image/x-swf-bmp2":
        return emit_define_bits_lossless2(tag)
    if tag.media_type == "image/jpeg":
        return emit_define_bits_jpeg2(tag)
    if tag.media_type == "image/x-swf-jpeg3":
        return emit_define_bits_jpeg3(tag)
    return emit_define_bits_lossless(tag)


# ---------------------------------------------------------------------------
# Morph shapes (DefineMorphShape / DefineMorphShape2)
# ---------------------------------------------------------------------------


def _emit_morph_fill_style(fill: ast.MorphFillStyle) -> bytes:
    if isinstance(fill, ast.MorphSolidFill):
        out = bytearray((0x00,))
        _write_rgba(out, fill.color)
        _write_rgba(out, fill.morph_color)
        return bytes(out)
    if isinstance(fill, ast.MorphExtendedFill):
        s, e = fill.start, fill.end
        if (isinstance(s, (ast.LinearGradientFill, ast.RadialGradientFill))
                and type(s) is type(e)):
            out = bytearray(
                (0x10 if isinstance(s, ast.LinearGradientFill) else 0x12,))
            w = BitWriter()
            _write_matrix(w, s.matrix)
            _write_matrix(w, e.matrix)
            out.extend(w.bytes())
            gs, ge = s.gradient, e.gradient
            if len(gs.colors) != len(ge.colors):
                raise ValueError("morph gradient stop counts must match")
            if len(gs.colors) > 15:
                raise ValueError("SWF gradients cap at 15 stops")
            out.append(
                (_SPREAD_TO_BITS[gs.spread] << 6)
                | ((0 if gs.color_space == ast.ColorSpace.S_RGB else 1) << 4)
                | len(gs.colors))
            for st, en in zip(gs.colors, ge.colors):
                out.append(st.ratio)
                _write_rgba(out, st.color)
                out.append(en.ratio)
                _write_rgba(out, en.color)
            return bytes(out)
        if isinstance(s, ast.BitmapFill) and isinstance(e, ast.BitmapFill):
            if (s.bitmap_id, s.repeating, s.smoothed) != (
                    e.bitmap_id, e.repeating, e.smoothed):
                raise ValueError(
                    "morph bitmap fills share one bitmap + mode")
            code = 0x40 + (0 if s.repeating else 1) + (0 if s.smoothed
                                                       else 2)
            out = bytearray((code,))
            out.extend(struct.pack("<H", s.bitmap_id))
            w = BitWriter()
            _write_matrix(w, s.matrix)
            _write_matrix(w, e.matrix)
            out.extend(w.bytes())
            return bytes(out)
    raise ValueError(f"cannot emit morph fill style {fill!r}")


def _parse_morph_fill_style(data: bytes, pos: int
                            ) -> Tuple[ast.MorphFillStyle, int]:
    kind = data[pos]
    pos += 1
    if kind == 0x00:
        color, pos = _read_rgba(data, pos)
        morph_color, pos = _read_rgba(data, pos)
        return ast.MorphSolidFill(color=color, morph_color=morph_color), pos
    if kind in (0x10, 0x12):
        r = BitReader(data, pos)
        m_start = _read_matrix(r)
        r.align()
        m_end = _read_matrix(r)
        pos = r.byte_pos
        packed = data[pos]
        pos += 1
        spread = _BITS_TO_SPREAD[(packed >> 6) & 3]
        cs = (ast.ColorSpace.S_RGB if ((packed >> 4) & 3) == 0
              else ast.ColorSpace.LINEAR_RGB)
        count = packed & 0x0F
        starts, ends = [], []
        for _ in range(count):
            ratio_s = data[pos]
            color_s, pos = _read_rgba(data, pos + 1)
            ratio_e = data[pos]
            color_e, pos = _read_rgba(data, pos + 1)
            starts.append(ast.GradientStop(ratio=ratio_s, color=color_s))
            ends.append(ast.GradientStop(ratio=ratio_e, color=color_e))
        cls = (ast.LinearGradientFill if kind == 0x10
               else ast.RadialGradientFill)
        return ast.MorphExtendedFill(
            start=cls(matrix=m_start, gradient=ast.Gradient(
                spread=spread, color_space=cs, colors=tuple(starts))),
            end=cls(matrix=m_end, gradient=ast.Gradient(
                spread=spread, color_space=cs, colors=tuple(ends)))), pos
    if 0x40 <= kind <= 0x43:
        (bitmap_id,) = struct.unpack_from("<H", data, pos)
        pos += 2
        r = BitReader(data, pos)
        m_start = _read_matrix(r)
        r.align()
        m_end = _read_matrix(r)
        pos = r.byte_pos
        repeating = kind in (0x40, 0x42)
        smoothed = kind in (0x40, 0x41)
        return ast.MorphExtendedFill(
            start=ast.BitmapFill(bitmap_id=bitmap_id, matrix=m_start,
                                 repeating=repeating, smoothed=smoothed),
            end=ast.BitmapFill(bitmap_id=bitmap_id, matrix=m_end,
                               repeating=repeating, smoothed=smoothed)), pos
    raise ValueError(f"unsupported morph fill style kind 0x{kind:02x}")


def _default_morph_line(width: int, morph_width: int,
                        fill: ast.MorphFillStyle) -> ast.MorphLineStyle:
    return ast.MorphLineStyle(
        width=width, morph_width=morph_width,
        start_cap="round", end_cap="round", join={"type": "round"},
        no_h_scale=False, no_v_scale=False, no_close=False,
        pixel_hinting=False, fill=fill,
    )


def _emit_morph_line_style(l: ast.MorphLineStyle, line2: bool) -> bytes:
    if not isinstance(l.fill, ast.MorphSolidFill):
        raise ValueError("morph line styles are solid-only")
    out = bytearray(struct.pack("<HH", l.width, l.morph_width))
    if not line2:
        # MORPHLINESTYLE (tag 46): widths + colors only.  Caps/joins are
        # not expressible — like DefineShape3's LINESTYLE, non-default
        # values are dropped and parse back as the round defaults.
        _write_rgba(out, l.fill.color)
        _write_rgba(out, l.fill.morph_color)
        return bytes(out)
    join = l.join.get("type", "round") if isinstance(l.join, dict) \
        else str(l.join)
    b = 0
    b |= _CAP_TO_BITS[l.start_cap] << 6
    b |= _JOIN_TO_BITS[join] << 4
    # HasFillFlag = 0 (solid colors), NoHScale, NoVScale, PixelHinting
    b |= (1 if l.no_h_scale else 0) << 2
    b |= (1 if l.no_v_scale else 0) << 1
    b |= 1 if l.pixel_hinting else 0
    out.append(b)
    b2 = 0  # 5 reserved bits
    b2 |= (1 if l.no_close else 0) << 2
    b2 |= _CAP_TO_BITS[l.end_cap]
    out.append(b2)
    if join == "miter":
        limit = float(l.join.get("limit", 3.0)) \
            if isinstance(l.join, dict) else 3.0
        out.extend(struct.pack("<H", int(round(limit * 256)) & 0xFFFF))
    _write_rgba(out, l.fill.color)
    _write_rgba(out, l.fill.morph_color)
    return bytes(out)


def _parse_morph_line_style(data: bytes, pos: int, line2: bool
                            ) -> Tuple[ast.MorphLineStyle, int]:
    width, morph_width = struct.unpack_from("<HH", data, pos)
    pos += 4
    if not line2:
        color, pos = _read_rgba(data, pos)
        morph_color, pos = _read_rgba(data, pos)
        return _default_morph_line(
            width, morph_width,
            ast.MorphSolidFill(color=color, morph_color=morph_color)), pos
    b = data[pos]
    pos += 1
    start_cap = _BITS_TO_CAP[(b >> 6) & 3]
    join_bits = (b >> 4) & 3
    has_fill = bool((b >> 3) & 1)
    no_h = bool((b >> 2) & 1)
    no_v = bool((b >> 1) & 1)
    hinting = bool(b & 1)
    b2 = data[pos]
    pos += 1
    no_close = bool((b2 >> 2) & 1)
    end_cap = _BITS_TO_CAP[b2 & 3]
    join: dict = {"type": _BITS_TO_JOIN[join_bits]}
    if join_bits == 2:
        (ml,) = struct.unpack_from("<H", data, pos)
        pos += 2
        join["limit"] = ml / 256.0
    if has_fill:
        raise ValueError("MORPHLINESTYLE2 fill styles not supported")
    color, pos = _read_rgba(data, pos)
    morph_color, pos = _read_rgba(data, pos)
    return ast.MorphLineStyle(
        width=width, morph_width=morph_width,
        start_cap=start_cap, end_cap=end_cap, join=join,
        no_h_scale=no_h, no_v_scale=no_v, no_close=no_close,
        pixel_hinting=hinting,
        fill=ast.MorphSolidFill(color=color, morph_color=morph_color),
    ), pos


def _emit_morph_styles(styles: ast.MorphShapeStyles, line2: bool) -> bytes:
    out = bytearray()
    fills = list(styles.fill)
    if len(fills) >= 0xFF:
        out.append(0xFF)
        out.extend(struct.pack("<H", len(fills)))
    else:
        out.append(len(fills))
    for f in fills:
        out.extend(_emit_morph_fill_style(f))
    lines = list(styles.line)
    if len(lines) >= 0xFF:
        out.append(0xFF)
        out.extend(struct.pack("<H", len(lines)))
    else:
        out.append(len(lines))
    for l in lines:
        out.extend(_emit_morph_line_style(l, line2))
    return bytes(out)


def _parse_morph_styles(data: bytes, pos: int, line2: bool
                        ) -> Tuple[ast.MorphShapeStyles, int]:
    count = data[pos]
    pos += 1
    if count == 0xFF:
        (count,) = struct.unpack_from("<H", data, pos)
        pos += 2
    fills = []
    for _ in range(count):
        fill, pos = _parse_morph_fill_style(data, pos)
        fills.append(fill)
    count = data[pos]
    pos += 1
    if count == 0xFF:
        (count,) = struct.unpack_from("<H", data, pos)
        pos += 2
    lines = []
    for _ in range(count):
        line, pos = _parse_morph_line_style(data, pos, line2)
        lines.append(line)
    return ast.MorphShapeStyles(fill=tuple(fills), line=tuple(lines)), pos


def _split_morph_records(records) -> Tuple[list, list]:
    """Merged AST records -> (start stream, end stream) static records.

    Edges pair 1:1; a style-change that moves the pen emits an
    end-stream style-change holding only the end move (morph streams
    cannot carry new-styles — the spec reserves the flag)."""
    start: list = []
    end: list = []
    for rec in records:
        if isinstance(rec, ast.MorphStyleChangeRecord):
            if rec.new_styles is not None:
                raise ValueError(
                    "morph shapes cannot carry new-styles records")
            if (rec.move_to is None) != (rec.morph_move_to is None):
                raise ValueError(
                    "morph style-change needs both moves or neither")
            if (rec.move_to is None and rec.left_fill is None
                    and rec.right_fill is None and rec.line_style is None):
                raise ValueError(
                    "empty morph style-change would encode as end-of-shape")
            start.append(ast.StyleChangeRecord(
                move_to=rec.move_to, left_fill=rec.left_fill,
                right_fill=rec.right_fill, line_style=rec.line_style))
            if rec.morph_move_to is not None:
                end.append(ast.StyleChangeRecord(move_to=rec.morph_move_to))
        elif isinstance(rec, ast.MorphEdgeRecord):
            start.append(ast.EdgeRecord(
                delta=rec.delta, control_delta=rec.control_delta))
            end.append(ast.EdgeRecord(
                delta=rec.morph_delta,
                control_delta=rec.morph_control_delta))
        else:
            raise ValueError(f"unknown morph record {rec!r}")
    return start, end


def _merge_morph_records(start, end) -> Tuple[ast.MorphShapeRecord, ...]:
    """Re-pair StartEdges/EndEdges streams into merged AST records."""
    out: List[ast.MorphShapeRecord] = []
    ei = iter(end)
    for rec in start:
        if isinstance(rec, ast.StyleChangeRecord):
            morph_move = None
            if rec.move_to is not None:
                try:
                    e = next(ei)
                except StopIteration:
                    raise ValueError("end stream ended before its move")
                if not isinstance(e, ast.StyleChangeRecord) \
                        or e.move_to is None:
                    raise ValueError(
                        "start move must pair with an end move")
                morph_move = e.move_to
            out.append(ast.MorphStyleChangeRecord(
                move_to=rec.move_to, morph_move_to=morph_move,
                left_fill=rec.left_fill, right_fill=rec.right_fill,
                line_style=rec.line_style))
        else:
            try:
                e = next(ei)
            except StopIteration:
                raise ValueError("end stream has fewer edges than start")
            if not isinstance(e, ast.EdgeRecord):
                raise ValueError("start edge must pair with an end edge")
            out.append(ast.MorphEdgeRecord(
                delta=rec.delta, morph_delta=e.delta,
                control_delta=rec.control_delta,
                morph_control_delta=e.control_delta))
    if next(ei, None) is not None:
        raise ValueError("end stream has more records than start")
    return tuple(out)


def _emit_record_stream(records, fill_bits: int, line_bits: int) -> bytes:
    """A SHAPE record stream (nibble style bits + records, no
    new-styles) — the StartEdges/EndEdges payload."""
    w = BitWriter()
    w.write_ub(fill_bits, 4)
    w.write_ub(line_bits, 4)
    for record in records:
        if isinstance(record, ast.StyleChangeRecord):
            w.write_ub(0, 1)  # non-edge
            w.write_ub(0, 1)  # never new styles in morph streams
            _write_style_change_fields(w, record, fill_bits, line_bits)
        else:
            _write_edge(w, record.delta, record.control_delta)
    w.write_ub(0, 6)  # end record
    w.align()
    return w.bytes()


def _parse_record_stream(data: bytes, pos: int) -> Tuple[list, int]:
    records: list = []
    r = BitReader(data, pos)
    fill_bits = r.read_ub(4)
    line_bits = r.read_ub(4)
    while True:
        is_edge = r.read_ub(1)
        if not is_edge:
            flags = r.read_ub(5)
            if flags == 0:
                break  # end record
            if flags & 0b10000:
                raise ValueError(
                    "morph record streams cannot carry new styles")
            move_to, left, right, line = _read_style_change_fields(
                r, flags, fill_bits, line_bits)
            records.append(ast.StyleChangeRecord(
                move_to=move_to, left_fill=left, right_fill=right,
                line_style=line))
        else:
            records.append(_read_edge(r))
    r.align()
    return records, r.byte_pos


def emit_define_morph_shape(tag: ast.DefineMorphShape,
                            shape2: bool = False) -> bytes:
    """DefineMorphShape (tag 46) or DefineMorphShape2 (tag 84) bytes.

    ``shape2`` preserves line caps/joins/miter (MORPHLINESTYLE2) and
    the stroke-scaling flags, which tag 46 cannot express."""
    body = bytearray(struct.pack("<H", tag.id))
    w = BitWriter()
    _write_rect(w, tag.bounds)
    _write_rect(w, tag.morph_bounds)
    if shape2:
        # Edge bounds: reuse the shape bounds (like emit_define_shape4).
        _write_rect(w, tag.bounds)
        _write_rect(w, tag.morph_bounds)
    body.extend(w.bytes())
    if shape2:
        body.append((1 if tag.has_non_scaling_strokes else 0) << 1
                    | (1 if tag.has_scaling_strokes else 0))
    styles = tag.shape.initial_styles
    style_bytes = _emit_morph_styles(styles, line2=shape2)
    start, end = _split_morph_records(tag.shape.records)
    fill_bits = ubits_for(len(styles.fill))
    line_bits = ubits_for(len(styles.line))
    start_bytes = _emit_record_stream(start, fill_bits, line_bits)
    end_bytes = _emit_record_stream(end, 0, 0)
    # Offset: from just after this u32 to the start of EndEdges.
    body.extend(struct.pack("<I", len(style_bytes) + len(start_bytes)))
    body.extend(style_bytes)
    body.extend(start_bytes)
    body.extend(end_bytes)
    return _tag(TAG_DEFINE_MORPH_SHAPE2 if shape2
                else TAG_DEFINE_MORPH_SHAPE, bytes(body))


def _parse_morph_body(body: bytes, pos: int, shape2: bool,
                      ) -> ast.MorphShapeBody:
    (offset,) = struct.unpack_from("<I", body, pos)
    pos += 4
    end_pos = pos + offset
    styles, pos = _parse_morph_styles(body, pos, line2=shape2)
    start, pos = _parse_record_stream(body, pos)
    if pos > end_pos:
        raise ValueError("StartEdges overran the EndEdges offset")
    end, _ = _parse_record_stream(body, end_pos)
    return ast.MorphShapeBody(
        initial_styles=styles,
        records=_merge_morph_records(start, end))


def parse_define_morph_shape_tag(body: bytes) -> ast.DefineMorphShape:
    (shape_id,) = struct.unpack_from("<H", body, 0)
    r = BitReader(body, 2)
    bounds = _read_rect(r)
    morph_bounds = _read_rect(r)
    return ast.DefineMorphShape(
        id=shape_id, bounds=bounds, morph_bounds=morph_bounds,
        shape=_parse_morph_body(body, r.byte_pos, shape2=False))


def parse_define_morph_shape2_tag(body: bytes) -> ast.DefineMorphShape:
    (shape_id,) = struct.unpack_from("<H", body, 0)
    r = BitReader(body, 2)
    bounds = _read_rect(r)
    morph_bounds = _read_rect(r)
    _read_rect(r)  # start edge bounds (emit mirrors shape bounds)
    _read_rect(r)  # end edge bounds
    flags = body[r.byte_pos]
    return ast.DefineMorphShape(
        id=shape_id, bounds=bounds, morph_bounds=morph_bounds,
        has_non_scaling_strokes=bool((flags >> 1) & 1),
        has_scaling_strokes=bool(flags & 1),
        shape=_parse_morph_body(body, r.byte_pos + 1, shape2=True))


def emit_movie(shapes: List[ast.DefineShape],
               background: ast.StraightSRgba8 = ast.StraightSRgba8(
                   255, 255, 255, 255),
               frame_rate: float = 24.0,
               shape4: bool = False,
               morphs: List[Tuple[ast.DefineMorphShape, float]] = (),
               morph2: bool = False,
               bitmaps: List[ast.DefineBitmap] = (),
               shape_matrices: Optional[List[ast.Matrix]] = None,
               morph_matrices: Optional[List[ast.Matrix]] = None,
               stage_rect: Optional[ast.Rect] = None,
               shape_color_transforms: Optional[List] = None) -> bytes:
    """Assemble an uncompressed .swf placing each shape on one frame
    (the reference build.js analog).  ``shape4`` emits DefineShape4 tags
    (LINESTYLE2: caps/joins/miter preserved).  ``morphs`` is a list of
    (DefineMorphShape, ratio in [0, 1]) placed after the static shapes
    with PlaceObject2's HasRatio flag (how the reference's morph goldens
    were captured at 0/32768/65536); ``morph2`` emits tag 84.
    ``bitmaps`` emit as DefineBitsLossless before the shapes so bitmap
    fills can resolve them by character id.  ``shape_matrices`` /
    ``morph_matrices`` carry optional per-placement matrices (the
    reference harness translates each shape by -bounds.min); None
    entries place at identity.  ``stage_rect`` overrides the frame
    RECT (twips) the header advertises.  ``shape_color_transforms``
    carries optional (mult4, add4) CXFORMWITHALPHA tuples per shape."""
    x_max = max((s.bounds.x_max for s in shapes), default=11000)
    y_max = max((s.bounds.y_max for s in shapes), default=8000)
    for m, _ in morphs:
        x_max = max(x_max, m.bounds.x_max, m.morph_bounds.x_max)
        y_max = max(y_max, m.bounds.y_max, m.morph_bounds.y_max)
    placements: List[Placement] = []
    for depth, shape in enumerate(shapes, start=1):
        placements.append(Placement(
            depth=depth, character_id=shape.id,
            matrix=(shape_matrices[depth - 1]
                    if shape_matrices is not None else None),
            color_transform=(shape_color_transforms[depth - 1]
                             if shape_color_transforms is not None
                             else None)))
    for i, (morph, ratio) in enumerate(morphs):
        placements.append(Placement(
            depth=len(shapes) + 1 + i, character_id=morph.id,
            matrix=(morph_matrices[i]
                    if morph_matrices is not None else None),
            ratio=float(ratio)))
    return emit_movie_timeline(
        [placements], shapes=shapes, morphs=[m for m, _ in morphs],
        bitmaps=bitmaps, background=background, frame_rate=frame_rate,
        shape4=shape4, morph2=morph2,
        stage_rect=(stage_rect if stage_rect is not None
                    else ast.Rect(0, x_max, 0, y_max)))


def emit_movie_timeline(
        frames: List[List],
        shapes: List[ast.DefineShape] = (),
        morphs: List[ast.DefineMorphShape] = (),
        bitmaps: List[ast.DefineBitmap] = (),
        background: ast.StraightSRgba8 = ast.StraightSRgba8(
            255, 255, 255, 255),
        frame_rate: float = 24.0,
        shape4: bool = False,
        morph2: bool = False,
        stage_rect: Optional[ast.Rect] = None,
        sprites: Tuple = (),
        frame_labels: Optional[dict] = None,
        fonts: Tuple = (),
        texts: Tuple = (),
        buttons: Tuple = (),
        button_sounds: Optional[dict] = None,
        button_cxforms: Optional[dict] = None,
        scaling_grids: Tuple = (),
        videos: Tuple = (),
        sounds: Tuple = (),
        sound_events: Optional[dict] = None,
        sound_stream=None,
        exports: Optional[dict] = None,
        metadata: Optional[str] = None) -> bytes:
    """A multi-frame movie: define tags up front, then per frame a list
    of Placement / RemoveObject display-list operations followed by
    ShowFrame.  Placement.move carries the PlaceFlagMove form (modify
    or replace the depth's occupant) — the wire-level analog of the
    renderer's timeline tracks (render_batch consumes the loaded
    stages; moving-matrix animations auto-route to the on-device
    sweep).  ``sprites``: (sprite_id, frames) pairs emitted as
    DefineSprite tags, where each frames entry is the same per-frame
    op-list form as ``frames``."""
    if stage_rect is None:
        x_max = max((s.bounds.x_max for s in shapes), default=11000)
        y_max = max((s.bounds.y_max for s in shapes), default=8000)
        for m in morphs:
            x_max = max(x_max, m.bounds.x_max, m.morph_bounds.x_max)
            y_max = max(y_max, m.bounds.y_max, m.morph_bounds.y_max)
        stage_rect = ast.Rect(0, x_max, 0, y_max)
    w = BitWriter()
    _write_rect(w, stage_rect)

    tags = bytearray()
    tags.extend(_tag(TAG_SET_BACKGROUND,
                     bytes((background.r, background.g, background.b))))
    for bitmap in bitmaps:
        tags.extend(emit_define_bitmap(bitmap))
    for shape in shapes:
        tags.extend(emit_define_shape4(shape) if shape4
                    else emit_define_shape(shape))
    for morph in morphs:
        tags.extend(emit_define_morph_shape(morph, shape2=morph2))
    for font in fonts:
        tags.extend(emit_define_font(font) if font.divisor == 1
                    and not font.name and not font.code_table
                    else emit_define_font2(font))
    for text in texts:
        if isinstance(text, EditText):
            tags.extend(emit_define_edit_text(text))
        else:
            tags.extend(emit_define_text(
                text, text2=any(r.color is not None and r.color.a != 255
                                for r in text.runs)))
    for button in buttons:
        tags.extend(emit_define_button2(button))
    for entry in sprites:
        # (id, frames) or (id, frames, sprite_sound_stream)
        tags.extend(emit_define_sprite(*entry))
    for character_id, grid_rect in scaling_grids:
        tags.extend(emit_define_scaling_grid(character_id, grid_rect))
    for stream in videos:
        tags.extend(emit_define_video_stream(stream))
        for num in sorted(stream.frames):
            tags.extend(emit_video_frame(stream.id, num,
                                         stream.frames[num]))
    for snd in sounds:
        tags.extend(emit_define_sound(snd))
    for bid, slots in (button_sounds or {}).items():
        tags.extend(emit_define_button_sound(bid, slots))
    for bid, bct in (button_cxforms or {}).items():
        tags.extend(emit_define_button_cxform(bid, bct))
    if sound_stream is not None:
        tags.extend(emit_sound_stream_head(sound_stream))
    if metadata is not None:
        tags.extend(_tag(TAG_METADATA,
                         metadata.encode("utf-8") + b"\x00"))
    if exports:
        tags.extend(emit_export_assets(exports))
    for fi, ops in enumerate(frames):
        if frame_labels and fi in frame_labels:
            tags.extend(_tag(TAG_FRAME_LABEL,
                             frame_labels[fi].encode("utf-8") + b"\x00"))
        for sid, info in (sound_events or {}).get(fi, ()):
            tags.extend(emit_start_sound(sid, info))
        if sound_stream is not None and fi in sound_stream.blocks:
            tags.extend(_tag(TAG_SOUND_STREAM_BLOCK,
                             sound_stream.blocks[fi]))
        tags.extend(_emit_display_ops(ops))
        tags.extend(_tag(TAG_SHOW_FRAME, b""))
    tags.extend(_tag(TAG_END, b""))

    header_body = (
        w.bytes()
        + struct.pack("<HH", int(frame_rate * 256), len(frames))
        + bytes(tags)
    )
    # DefineShape4 (83) / DefineMorphShape2 (84) need SWF version >= 8.
    header = b"FWS" + bytes([8 if (shape4 or morph2) else 6])
    total = len(header) + 4 + len(header_body)
    return header + struct.pack("<I", total) + header_body


# ---------------------------------------------------------------------------
# Buttons (DefineButton/DefineButton2) — rendered in their UP state
# ---------------------------------------------------------------------------

TAG_DEFINE_BUTTON = 7
TAG_DEFINE_BUTTON2 = 34
TAG_DEFINE_BUTTON_SOUND = 17
TAG_DEFINE_BUTTON_CXFORM = 23


@dataclasses.dataclass(frozen=True)
class ButtonRecord:
    """One BUTTONRECORD: a character shown in some button states."""

    character_id: int
    depth: int
    matrix: ast.Matrix
    states: int  # bit0 up, bit1 over, bit2 down, bit3 hit-test
    color_transform: Optional[Tuple] = None  # button2 only
    filters: Tuple = ()        # button2 SWF8 trailer (flags & 0x10)
    # button2 SWF8 trailer (flags & 0x20): blend mode NAME, the same
    # vocabulary as Placement.blend (ops.composite.BLEND_MODES/"layer").
    blend: Optional[str] = None


BUTTON_STATE_BITS = {"up": 0x01, "over": 0x02, "down": 0x04,
                     "hit": 0x08}


@dataclasses.dataclass(frozen=True)
class Button:
    """A button character.  The renderer draws a selected state (UP by
    default; the loaders accept over/down/hit) — interactivity is
    ActionScript's job, but buttons are placeable characters and real
    movies are full of them."""

    id: int
    records: Tuple[ButtonRecord, ...]

    def state_records(self, bit: int = 0x01):
        """Records visible in one state.  The hit-test bit is just
        another selector: a record flagged up|hit still DRAWS in the up
        state (the hit flag only matters when the hit mask is asked
        for)."""
        return tuple(r for r in self.records if r.states & bit)


def emit_define_button2(button: Button) -> bytes:
    body = bytearray(struct.pack("<H", button.id))
    body.append(0)                      # flags: not TrackAsMenu
    body.extend(struct.pack("<H", 0))   # action offset: no actions
    for rec in button.records:
        body.append((rec.states & 0x0F)
                    | (0x10 if rec.filters else 0)
                    | (0x20 if rec.blend is not None else 0))
        body.extend(struct.pack("<HH", rec.character_id, rec.depth))
        w = BitWriter()
        _write_matrix(w, rec.matrix if rec.matrix is not None
                      else _identity_matrix())
        _write_cxform_alpha(w, *(rec.color_transform
                                 or ((1.0,) * 4, (0.0,) * 4)))
        body.extend(w.bytes())
        if rec.filters:
            body.extend(_emit_filter_list(rec.filters))
        if rec.blend is not None:
            if rec.blend not in _BLEND_NAMES:
                raise ValueError(f"unknown blend mode {rec.blend!r}")
            body.append(_BLEND_NAMES[rec.blend])
    body.append(0)  # end of button records
    return _tag(TAG_DEFINE_BUTTON2, bytes(body))


def _parse_button_records(body: bytes, pos: int, button2: bool):
    records = []
    while True:
        flags = body[pos]
        pos += 1
        if flags == 0:
            break
        char_id, depth = struct.unpack_from("<HH", body, pos)
        pos += 4
        r = BitReader(body, pos)
        matrix = _read_matrix(r)
        ct = None
        if button2:
            ct = _read_cxform_alpha(r)
        pos = r.byte_pos
        filters: Tuple = ()
        blend = None
        if button2 and flags & 0x10:  # ButtonHasFilterList (SWF8)
            filters, pos = _parse_filter_list(body, pos)
        if button2 and flags & 0x20:  # ButtonHasBlendMode (SWF8)
            if body[pos] not in _BLEND_ORDINALS:
                raise ValueError(
                    f"unknown blend mode ordinal {body[pos]}")
            blend = _BLEND_ORDINALS.get(body[pos])  # 0/1 -> None
            pos += 1
        records.append(ButtonRecord(
            character_id=char_id, depth=depth, matrix=matrix,
            states=flags & 0x0F, color_transform=ct, filters=filters,
            blend=blend))
    return tuple(records), pos


def parse_define_button2_tag(body: bytes) -> Button:
    (button_id,) = struct.unpack_from("<H", body, 0)
    (action_offset,) = struct.unpack_from("<H", body, 3)
    records, _ = _parse_button_records(body, 5, button2=True)
    # Trailing BUTTONCONDACTION blocks (ActionScript) are ignored.
    return Button(id=button_id, records=records)


def parse_define_button_tag(body: bytes) -> Button:
    """SWF1 DefineButton (tag 7): records without color transforms,
    trailed by actions (ignored)."""
    (button_id,) = struct.unpack_from("<H", body, 0)
    records, _ = _parse_button_records(body, 2, button2=False)
    return Button(id=button_id, records=records)


# ---------------------------------------------------------------------------
# Fonts and static text (DefineFont/2/3, DefineText/2)
# ---------------------------------------------------------------------------

TAG_DEFINE_FONT = 10
TAG_DEFINE_FONT2 = 48
TAG_DEFINE_FONT3 = 75
TAG_DEFINE_FONT_INFO = 13
TAG_DEFINE_FONT_INFO2 = 62
TAG_DEFINE_TEXT = 11
TAG_DEFINE_TEXT2 = 33


def parse_define_font_info_tag(body: bytes, info2: bool = False):
    """(font_id, name, code_table) from DefineFontInfo/2 — attaches
    character codes to a tag-10 font's glyphs."""
    (font_id,) = struct.unpack_from("<H", body, 0)
    name_len = body[2]
    name = body[3 : 3 + name_len].decode("utf-8", "replace")
    pos = 3 + name_len
    flags = body[pos]
    pos += 1
    if info2:
        pos += 1  # language code
    wide = info2 or bool(flags & 0x01)
    fmt, step = ("<H", 2) if wide else ("<B", 1)
    codes = tuple(struct.unpack_from(fmt, body, pos + step * i)[0]
                  for i in range((len(body) - pos) // step))
    return font_id, name, codes


def emit_define_font_info(font_id: int, name: str, codes,
                          info2: bool = False) -> bytes:
    nm = name.encode("utf-8")
    body = bytearray(struct.pack("<H", font_id))
    body.append(len(nm))
    body.extend(nm)
    body.append(0x01)  # wide codes
    if info2:
        body.append(0)  # language
    for c in codes:
        body.extend(struct.pack("<H", c))
    return _tag(TAG_DEFINE_FONT_INFO2 if info2 else TAG_DEFINE_FONT_INFO,
                bytes(body))


@dataclasses.dataclass
class Font:
    """A glyph font: each glyph is a style-less SHAPE on the 1024-unit
    em square (``divisor`` 20 for DefineFont3's 1/20th-unit glyphs).
    ``glyph_shape(i)`` wraps glyph ``i`` as a cached white-filled
    DefineShape — identity-stable so renderer caches and sweep routing
    treat repeated text frames like any other shape instance."""

    id: int
    glyphs: Tuple[Tuple[ast.ShapeRecord, ...], ...]
    divisor: int = 1
    name: str = ""
    code_table: Tuple[int, ...] = ()
    # DefineFont2/3 layout block (em-square units): present when
    # ``advances`` is non-empty.  EditText layout needs these.
    ascent: int = 0
    descent: int = 0
    leading: int = 0
    advances: Tuple[int, ...] = ()
    _shape_defs: dict = dataclasses.field(default_factory=dict,
                                          compare=False, repr=False)

    def glyph_for_code(self, code: int) -> Optional[int]:
        try:
            return self.code_table.index(code)
        except ValueError:
            return None

    def glyph_shape(self, index: int) -> ast.DefineShape:
        hit = self._shape_defs.get(index)
        if hit is None:
            em = 1024 * self.divisor
            hit = ast.DefineShape(
                id=-(self.id * 65536 + index + 1),  # synthetic, unplaced
                bounds=ast.Rect(-em, 2 * em, -2 * em, em),
                shape=ast.ShapeBody(
                    initial_styles=ast.ShapeStyles(
                        fill=(ast.SolidFill(color=ast.StraightSRgba8(
                            255, 255, 255, 255)),),
                        line=()),
                    records=self.glyphs[index]))
            self._shape_defs[index] = hit
        return hit


@dataclasses.dataclass(frozen=True)
class TextRun:
    """One TEXTRECORD: style updates (fields left None RETAIN the
    previous run's values — player semantics) + glyph entries.
    ``height`` is in twips; advances are twips of the scaled text;
    offsets are absolute pen positions in twips."""

    glyphs: Tuple[Tuple[int, int], ...]  # (glyph index, advance twips)
    font_id: Optional[int] = None
    height: Optional[int] = None
    color: Optional[ast.StraightSRgba8] = None
    x_offset: Optional[int] = None
    y_offset: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Text:
    """DefineText/2: a static glyph layout."""

    id: int
    bounds: ast.Rect
    matrix: ast.Matrix
    runs: Tuple[TextRun, ...]


def _emit_glyph(records) -> bytes:
    """A glyph SHAPE: 1 fill bit / 0 line bits, style-change + edge
    records selecting fill 0/1, end record (SWF spec DefineFont)."""
    w = BitWriter()
    w.write_ub(1, 4)
    w.write_ub(0, 4)
    for record in records:
        if isinstance(record, ast.StyleChangeRecord):
            if record.new_styles is not None:
                raise ValueError("glyph shapes carry no style arrays")
            w.write_ub(0, 1)
            w.write_ub(0, 1)
            _write_style_change_fields(w, record, 1, 0)
        elif isinstance(record, ast.EdgeRecord):
            _write_edge(w, record.delta, record.control_delta)
        else:
            raise ValueError(f"unknown record {record!r}")
    w.write_ub(0, 6)
    w.align()
    return w.bytes()


def _parse_glyph(data: bytes, pos: int) -> Tuple[Tuple, int]:
    r = BitReader(data, pos)
    fill_bits = r.read_ub(4)
    line_bits = r.read_ub(4)
    records = []
    while True:
        if r.read_ub(1):
            records.append(_read_edge(r))
            continue
        flags = r.read_ub(5)
        if flags == 0:
            break
        if flags & 0b10000:
            raise ValueError("glyph shapes carry no style arrays")
        move_to, left, right, line = _read_style_change_fields(
            r, flags, fill_bits, line_bits)
        records.append(ast.StyleChangeRecord(
            move_to=move_to, left_fill=left, right_fill=right,
            line_style=line))
    r.align()
    return tuple(records), r.byte_pos


def emit_define_font(font: Font) -> bytes:
    """DefineFont (tag 10): id + u16 offset table (relative to the
    table start) + glyph shape table."""
    glyph_blobs = [_emit_glyph(g) for g in font.glyphs]
    n = len(glyph_blobs)
    offsets = []
    cursor = 2 * n
    for blob in glyph_blobs:
        offsets.append(cursor)
        cursor += len(blob)
    body = bytearray(struct.pack("<H", font.id))
    for off in offsets:
        body.extend(struct.pack("<H", off))
    for blob in glyph_blobs:
        body.extend(blob)
    return _tag(TAG_DEFINE_FONT, bytes(body))


def parse_define_font_tag(body: bytes) -> Font:
    (font_id,) = struct.unpack_from("<H", body, 0)
    table = 2
    (off0,) = struct.unpack_from("<H", body, table)
    n = off0 // 2
    glyphs = []
    for i in range(n):
        (off,) = struct.unpack_from("<H", body, table + 2 * i)
        records, _ = _parse_glyph(body, table + off)
        glyphs.append(records)
    return Font(id=font_id, glyphs=tuple(glyphs))


def emit_define_font2(font: Font) -> bytes:
    """DefineFont2/3 (tags 48/75; tag 75 when ``divisor`` is 20): wide
    offsets + wide codes, no layout block."""
    glyph_blobs = [_emit_glyph(g) for g in font.glyphs]
    n = len(glyph_blobs)
    codes = font.code_table or tuple(range(n))
    if len(codes) != n:
        raise ValueError("code table length != glyph count")
    has_layout = bool(font.advances)
    if has_layout and len(font.advances) != n:
        raise ValueError("advance table length != glyph count")
    name = font.name.encode("utf-8")
    body = bytearray(struct.pack("<H", font.id))
    body.append((0x80 if has_layout else 0) | 0x08 | 0x04)
    body.append(0)            # language code
    body.append(len(name))
    body.extend(name)
    body.extend(struct.pack("<H", n))
    table = len(body)
    cursor = 4 * (n + 1)
    offs = []
    for blob in glyph_blobs:
        offs.append(cursor)
        cursor += len(blob)
    offs.append(cursor)  # code table offset
    for off in offs:
        body.extend(struct.pack("<I", off))
    for blob in glyph_blobs:
        body.extend(blob)
    assert len(body) - table == cursor
    for code in codes:
        body.extend(struct.pack("<H", code))
    if has_layout:
        body.extend(struct.pack("<HHh", font.ascent, font.descent,
                                font.leading))
        for adv in font.advances:
            body.extend(struct.pack("<h", adv))
        w = BitWriter()
        for _ in range(n):
            _write_rect(w, ast.Rect(0, 0, 0, 0))
        body.extend(w.bytes())
        body.extend(struct.pack("<H", 0))  # kerning count
    return _tag(TAG_DEFINE_FONT3 if font.divisor == 20
                else TAG_DEFINE_FONT2, bytes(body))


def parse_define_font2_tag(body: bytes, font3: bool = False) -> Font:
    (font_id,) = struct.unpack_from("<H", body, 0)
    flags = body[2]
    name_len = body[4]
    name = body[5 : 5 + name_len].decode("utf-8", "replace")
    pos = 5 + name_len
    (n,) = struct.unpack_from("<H", body, pos)
    pos += 2
    table = pos
    wide_off = bool(flags & 0x08)
    fmt, step = ("<I", 4) if wide_off else ("<H", 2)
    offs = [struct.unpack_from(fmt, body, table + step * i)[0]
            for i in range(n + 1)]
    glyphs = []
    for i in range(n):
        records, _ = _parse_glyph(body, table + offs[i])
        glyphs.append(records)
    wide_codes = font3 or bool(flags & 0x04)
    cfmt, cstep = ("<H", 2) if wide_codes else ("<B", 1)
    cpos = table + offs[n]
    codes = tuple(struct.unpack_from(cfmt, body, cpos + cstep * i)[0]
                  for i in range(n))
    ascent = descent = leading = 0
    advances: Tuple[int, ...] = ()
    if flags & 0x80:  # layout block: ascent/descent/leading + advances
        lpos = cpos + cstep * n
        ascent, descent, leading = struct.unpack_from("<HHh", body, lpos)
        lpos += 6
        advances = tuple(
            struct.unpack_from("<h", body, lpos + 2 * i)[0]
            for i in range(n))
        # Glyph bounds and kerning records trail; nothing the renderer
        # needs lives there.
    return Font(id=font_id, glyphs=tuple(glyphs),
                divisor=20 if font3 else 1, name=name, code_table=codes,
                ascent=ascent, descent=descent, leading=leading,
                advances=advances)


def emit_define_text(text: Text, text2: bool = False) -> bytes:
    """DefineText (tag 11, RGB colors) / DefineText2 (tag 33, RGBA)."""
    indices = [g for run in text.runs for g, _ in run.glyphs]
    advances = [a for run in text.runs for _, a in run.glyphs]
    glyph_bits = max((ubits_for(i + 1) for i in indices), default=1)
    advance_bits = max((sbits_for(a) for a in advances), default=2)
    w = BitWriter()
    _write_rect(w, text.bounds)
    _write_matrix(w, text.matrix)
    body = bytearray(struct.pack("<H", text.id)) + w.bytes()
    body.append(glyph_bits)
    body.append(advance_bits)
    for run in text.runs:
        flags = 0x80
        if run.font_id is not None:
            if run.height is None:
                raise ValueError("a font update carries the text height")
            flags |= 0x08
        if run.color is not None:
            flags |= 0x04
        if run.y_offset is not None:
            flags |= 0x02
        if run.x_offset is not None:
            flags |= 0x01
        body.append(flags)
        if run.font_id is not None:
            body.extend(struct.pack("<H", run.font_id))
        if run.color is not None:
            c = run.color
            body.extend((c.r, c.g, c.b) if not text2
                        else (c.r, c.g, c.b, c.a))
        if run.x_offset is not None:
            body.extend(struct.pack("<h", run.x_offset))
        if run.y_offset is not None:
            body.extend(struct.pack("<h", run.y_offset))
        if run.font_id is not None:
            body.extend(struct.pack("<H", run.height))
        body.append(len(run.glyphs))
        gw = BitWriter()
        for gi, adv in run.glyphs:
            gw.write_ub(gi, glyph_bits)
            gw.write_sb(adv, advance_bits)
        gw.align()
        body.extend(gw.bytes())
    body.append(0)  # end of text records
    return _tag(TAG_DEFINE_TEXT2 if text2 else TAG_DEFINE_TEXT,
                bytes(body))


TAG_DEFINE_EDIT_TEXT = 37


@dataclasses.dataclass(frozen=True)
class EditText:
    """DefineEditText (tag 37): a text field.  The renderer draws its
    INITIAL text with the embedded (use-outlines) font — no editing or
    ActionScript, but the static look of the ubiquitous dynamic text
    field.  Margins/indent/leading in twips; align 0..3 =
    left/right/center/justify (justify renders as left)."""

    id: int
    bounds: ast.Rect
    font_id: Optional[int] = None
    height: int = 240
    color: ast.StraightSRgba8 = ast.StraightSRgba8(0, 0, 0, 255)
    text: str = ""
    word_wrap: bool = False
    multiline: bool = False
    use_outlines: bool = False
    align: int = 0
    left_margin: int = 0
    right_margin: int = 0
    indent: int = 0
    leading: int = 0
    var_name: str = ""


def emit_define_edit_text(field: EditText) -> bytes:
    w = BitWriter()
    _write_rect(w, field.bounds)
    body = bytearray(struct.pack("<H", field.id)) + w.bytes()
    flags1 = 0x08  # ReadOnly (we never edit)
    if field.text:
        flags1 |= 0x80
    if field.word_wrap:
        flags1 |= 0x40
    if field.multiline:
        flags1 |= 0x20
    flags1 |= 0x04  # HasTextColor
    if field.font_id is not None:
        flags1 |= 0x01
    flags2 = 0x20 | (0x01 if field.use_outlines else 0)  # HasLayout
    body.extend((flags1, flags2))
    if field.font_id is not None:
        body.extend(struct.pack("<HH", field.font_id, field.height))
    c = field.color
    body.extend((c.r, c.g, c.b, c.a))
    body.extend(struct.pack("<BHHHh", field.align, field.left_margin,
                            field.right_margin, field.indent,
                            field.leading))
    body.extend(field.var_name.encode("utf-8") + b"\x00")
    if field.text:
        body.extend(field.text.encode("utf-8") + b"\x00")
    return _tag(TAG_DEFINE_EDIT_TEXT, bytes(body))


def parse_define_edit_text_tag(body: bytes) -> EditText:
    (field_id,) = struct.unpack_from("<H", body, 0)
    r = BitReader(body, 2)
    bounds = _read_rect(r)
    pos = r.byte_pos
    flags1, flags2 = body[pos], body[pos + 1]
    pos += 2
    font_id = None
    height = 240
    if flags1 & 0x01:
        font_id, height = struct.unpack_from("<HH", body, pos)
        pos += 4
    if flags2 & 0x80:  # font class name
        pos = body.index(b"\x00", pos) + 1
    color = ast.StraightSRgba8(0, 0, 0, 255)
    if flags1 & 0x04:
        color, pos = _read_rgba(body, pos)
    if flags1 & 0x02:  # max length
        pos += 2
    align = left_m = right_m = indent = leading = 0
    if flags2 & 0x20:
        align, left_m, right_m, indent, leading = struct.unpack_from(
            "<BHHHh", body, pos)
        pos += 9
    end = body.index(b"\x00", pos)
    var_name = body[pos:end].decode("utf-8", "replace")
    pos = end + 1
    text = ""
    if flags1 & 0x80:
        end = body.index(b"\x00", pos)
        text = body[pos:end].decode("utf-8", "replace")
    return EditText(
        id=field_id, bounds=bounds, font_id=font_id, height=height,
        color=color, text=text,
        word_wrap=bool(flags1 & 0x40), multiline=bool(flags1 & 0x20),
        use_outlines=bool(flags2 & 0x01), align=align,
        left_margin=left_m, right_margin=right_m, indent=indent,
        leading=leading, var_name=var_name)


def parse_define_text_tag(body: bytes, text2: bool = False) -> Text:
    (text_id,) = struct.unpack_from("<H", body, 0)
    r = BitReader(body, 2)
    bounds = _read_rect(r)
    matrix = _read_matrix(r)
    pos = r.byte_pos
    glyph_bits = body[pos]
    advance_bits = body[pos + 1]
    pos += 2
    runs = []
    while True:
        flags = body[pos]
        pos += 1
        if flags == 0:
            break
        if not flags & 0x80:
            raise ValueError("DefineText record type must be 1")
        font_id = height = color = x_off = y_off = None
        if flags & 0x08:
            (font_id,) = struct.unpack_from("<H", body, pos)
            pos += 2
        if flags & 0x04:
            if text2:
                color, pos = _read_rgba(body, pos)
            else:
                color, pos = _read_rgb(body, pos)
        if flags & 0x01:
            (x_off,) = struct.unpack_from("<h", body, pos)
            pos += 2
        if flags & 0x02:
            (y_off,) = struct.unpack_from("<h", body, pos)
            pos += 2
        if flags & 0x08:
            (height,) = struct.unpack_from("<H", body, pos)
            pos += 2
        count = body[pos]
        pos += 1
        gr = BitReader(body, pos)
        glyphs = tuple(
            (gr.read_ub(glyph_bits), gr.read_sb(advance_bits))
            for _ in range(count))
        gr.align()
        pos = gr.byte_pos
        runs.append(TextRun(glyphs=glyphs, font_id=font_id, height=height,
                            color=color, x_offset=x_off, y_offset=y_off))
    return Text(id=text_id, bounds=bounds, matrix=matrix,
                runs=tuple(runs))


class _DisplayList:
    """Resolved display-list state machine — the PlaceObject/2,
    RemoveObject/2, ShowFrame semantics shared by the movie root
    timeline and DefineSprite timelines.  Each ShowFrame snapshots the
    depth-sorted state; resolved placements carry ``placed_frame`` (the
    frame their current character appeared) for sprite loop phases."""

    def __init__(self) -> None:
        self._state: dict = {}
        self.frames: List[Tuple[Placement, ...]] = []

    def handle(self, code: int, body: bytes) -> bool:
        """Apply a display-list control tag; False if ``code`` is not
        one (callers route define tags etc. themselves)."""
        if code == TAG_PLACE_OBJECT2:
            self._place2(_parse_place_object2(body))
        elif code == TAG_PLACE_OBJECT3:
            self._place2(_parse_place_object3(body))
        elif code == TAG_PLACE_OBJECT:
            # SWF1 form: places (or replaces) the depth's occupant.
            p = _parse_place_object(body)
            self._state[p.depth] = dataclasses.replace(
                p, placed_frame=len(self.frames))
        elif code == TAG_REMOVE_OBJECT:
            char_id, depth = struct.unpack_from("<HH", body, 0)
            prev = self._state.get(depth)
            if prev is not None and prev.character_id != char_id:
                raise ValueError(
                    f"RemoveObject names character {char_id} but depth "
                    f"{depth} holds {prev.character_id}")
            self._state.pop(depth, None)
        elif code == TAG_REMOVE_OBJECT2:
            (depth,) = struct.unpack_from("<H", body, 0)
            self._state.pop(depth, None)
        elif code == TAG_SHOW_FRAME:
            self.frames.append(tuple(
                self._state[d] for d in sorted(self._state)))
        else:
            return False
        return True

    def _place2(self, p: Placement) -> None:
        if p.move:
            prev = self._state.get(p.depth)
            if prev is None:
                raise ValueError(f"PlaceFlagMove at empty depth {p.depth}")
            replaced = (p.character_id is not None
                        and p.character_id != prev.character_id)
            self._state[p.depth] = Placement(
                depth=p.depth,
                character_id=(p.character_id
                              if p.character_id is not None
                              else prev.character_id),
                matrix=(p.matrix if p.matrix is not None
                        else prev.matrix),
                color_transform=(p.color_transform
                                 if p.color_transform is not None
                                 else prev.color_transform),
                ratio=(p.ratio if p.ratio is not None else prev.ratio),
                name=(p.name if p.name is not None else prev.name),
                clip_depth=(p.clip_depth if p.clip_depth is not None
                            else prev.clip_depth),
                blend=(p.blend if p.blend is not None else prev.blend),
                visible=(p.visible if p.visible is not None
                         else prev.visible),
                filters=(p.filters if p.filters else prev.filters),
                placed_frame=(len(self.frames) if replaced
                              else prev.placed_frame))
        else:
            if self._state.get(p.depth) is not None:
                raise ValueError(
                    f"new placement at occupied depth {p.depth}")
            self._state[p.depth] = dataclasses.replace(
                p, placed_frame=len(self.frames))


@dataclasses.dataclass(frozen=True)
class Sprite:
    """A DefineSprite (tag 39): an embedded looping timeline.  ``frames``
    are resolved display-list snapshots exactly like ``Movie.frames``;
    instances of the sprite replay them, looping, phased from the frame
    the instance was placed."""

    id: int
    frames: Tuple[Tuple[Placement, ...], ...]
    # Sprite-local SoundStreamHead(+blocks), keyed by SPRITE frame
    # index — plays from the frame an instance is placed.
    sound_stream: Optional[object] = None


_SPRITE_DEFINE_CODES = frozenset({
    TAG_DEFINE_SHAPE, TAG_DEFINE_SHAPE2, TAG_DEFINE_SHAPE3,
    TAG_DEFINE_SHAPE4, TAG_DEFINE_MORPH_SHAPE, TAG_DEFINE_MORPH_SHAPE2,
    TAG_DEFINE_BITS_LOSSLESS, TAG_DEFINE_BITS_LOSSLESS2,
    TAG_DEFINE_SPRITE, TAG_SET_BACKGROUND,
})


def parse_define_sprite(body: bytes) -> Sprite:
    """Sprite body: id u16, declared frame count u16, then control tags
    (display-list ops, ShowFrame, End).  Define tags are illegal inside
    sprites per the SWF spec; other control tags (labels, actions) are
    skipped."""
    (sprite_id,) = struct.unpack_from("<H", body, 0)
    dl = _DisplayList()
    stream = None
    for code, tbody in _iter_tag_records(body, 4):
        if code == TAG_END:
            break
        if dl.handle(code, tbody):
            continue
        if code in (TAG_SOUND_STREAM_HEAD, TAG_SOUND_STREAM_HEAD2):
            stream = parse_sound_stream_head_tag(tbody)
            continue
        if code == TAG_SOUND_STREAM_BLOCK:
            if stream is not None:
                stream.blocks[len(dl.frames)] = tbody
            continue
        if code in _SPRITE_DEFINE_CODES:
            raise ValueError(
                f"define tag {code} inside DefineSprite {sprite_id}")
    return Sprite(id=sprite_id, frames=tuple(dl.frames),
                  sound_stream=stream)


def _zstring(data: bytes, pos: int) -> Tuple[str, int]:
    end = data.index(b"\x00", pos)
    return data[pos:end].decode("utf-8"), end + 1


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    """SWF EncodedU32 (LEB128, 1-5 bytes)."""
    v = 0
    for i in range(5):
        b = data[pos + i]
        v |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return v, pos + i + 1
    return v, pos + 5


def emit_export_assets(exports: dict) -> bytes:
    """ExportAssets (tag 56): name -> character id."""
    body = bytearray(struct.pack("<H", len(exports)))
    for name, cid in exports.items():
        body.extend(struct.pack("<H", cid))
        body.extend(name.encode("utf-8") + b"\x00")
    return _tag(TAG_EXPORT_ASSETS, bytes(body))


def parse_export_assets_tag(body: bytes) -> dict:
    (count,) = struct.unpack_from("<H", body, 0)
    pos = 2
    out = {}
    for _ in range(count):
        (cid,) = struct.unpack_from("<H", body, pos)
        name, pos = _zstring(body, pos + 2)
        out[name] = cid
    return out


def parse_import_assets_tag(body: bytes, assets2: bool = False) -> dict:
    """ImportAssets/2 (tags 57/71): name -> (url, local id).  The
    characters live in another movie; the mapping is carried so an
    embedder can resolve them, nothing renders from it."""
    url, pos = _zstring(body, 0)
    if assets2:
        pos += 2  # reserved version bytes
    (count,) = struct.unpack_from("<H", body, pos)
    pos += 2
    out = {}
    for _ in range(count):
        (cid,) = struct.unpack_from("<H", body, pos)
        name, pos = _zstring(body, pos + 2)
        out[name] = (url, cid)
    return out


def parse_scene_frame_label_tag(body: bytes):
    """DefineSceneAndFrameLabelData (tag 86): ((offset, scene name)...),
    {frame -> label}."""
    count, pos = _read_varint(body, 0)
    scenes = []
    for _ in range(count):
        off, pos = _read_varint(body, pos)
        name, pos = _zstring(body, pos)
        scenes.append((off, name))
    count, pos = _read_varint(body, pos)
    labels = {}
    for _ in range(count):
        num, pos = _read_varint(body, pos)
        name, pos = _zstring(body, pos)
        labels[num] = name
    return tuple(scenes), labels


def _sound_flags(format: int, rate: int, bits: int, channels: int) -> int:
    from .sound import RATES

    return ((format << 4) | (RATES.index(rate) << 2)
            | ((1 if bits == 16 else 0) << 1)
            | (1 if channels == 2 else 0))


def emit_define_sound(snd) -> bytes:
    """DefineSound (tag 14): id, format/rate/size/type flags, sample
    count, codec data (models.sound codecs)."""
    return _tag(TAG_DEFINE_SOUND, struct.pack(
        "<HBI", snd.id,
        _sound_flags(snd.format, snd.rate, snd.bits, snd.channels),
        snd.sample_count) + snd.data)


def parse_define_sound_tag(body: bytes):
    from .sound import RATES, Sound

    sid, flags, count = struct.unpack_from("<HBI", body, 0)
    return Sound(id=sid, format=flags >> 4, rate=RATES[(flags >> 2) & 3],
                 bits=16 if (flags >> 1) & 1 else 8,
                 channels=2 if flags & 1 else 1, sample_count=count,
                 data=body[7:])


def _sound_head_bytes(sound_id: int, info=None) -> bytes:
    """Sound id u16 + SOUNDINFO (shared by StartSound and
    DefineButtonSound)."""
    from .sound import SoundInfo

    info = info or SoundInfo()
    flags = ((0x20 if info.stop else 0)
             | (0x10 if info.no_multiple else 0)
             | (0x04 if info.loops != 1 else 0)
             | (0x02 if info.out_point is not None else 0)
             | (0x01 if info.in_point is not None else 0))
    body = bytearray(struct.pack("<HB", sound_id, flags))
    if info.in_point is not None:
        body.extend(struct.pack("<I", info.in_point))
    if info.out_point is not None:
        body.extend(struct.pack("<I", info.out_point))
    if info.loops != 1:
        body.extend(struct.pack("<H", info.loops))
    return bytes(body)


def _parse_sound_head(body: bytes, pos: int):
    """-> (sound_id, SoundInfo, next_pos)."""
    from .sound import SoundInfo

    sid, flags = struct.unpack_from("<HB", body, pos)
    pos += 3
    in_point = out_point = None
    loops = 1
    if flags & 0x01:
        (in_point,) = struct.unpack_from("<I", body, pos)
        pos += 4
    if flags & 0x02:
        (out_point,) = struct.unpack_from("<I", body, pos)
        pos += 4
    if flags & 0x04:
        (loops,) = struct.unpack_from("<H", body, pos)
        pos += 2
    if flags & 0x08:
        # Envelope records: consumed (count * 8 bytes), not modeled.
        pos += 1 + body[pos] * 8
    return sid, SoundInfo(stop=bool(flags & 0x20),
                          no_multiple=bool(flags & 0x10),
                          in_point=in_point, out_point=out_point,
                          loops=loops), pos


def emit_start_sound(sound_id: int, info=None) -> bytes:
    """StartSound (tag 15): sound id + SOUNDINFO."""
    return _tag(TAG_START_SOUND, _sound_head_bytes(sound_id, info))


def parse_start_sound_tag(body: bytes):
    sid, info, _pos = _parse_sound_head(body, 0)
    return sid, info


# The four DefineButtonSound slots, in wire order (state transitions).
BUTTON_SOUND_TRANSITIONS = ("over_up_to_idle", "idle_to_over_up",
                            "over_up_to_over_down", "over_down_to_over_up")


def emit_define_button_cxform(button_id: int, color_transform) -> bytes:
    """DefineButtonCxform (tag 23): an RGB CXFORM applied to the
    (SWF1 DefineButton) character's records; alpha terms must be
    identity."""
    mult, add = color_transform
    if tuple(mult[3:]) not in ((), (1.0,)) or tuple(add[3:]) not in (
            (), (0.0,)):
        raise ValueError("DefineButtonCxform carries RGB terms only")
    w = BitWriter()
    _write_cxform_rgb(w, mult, add)
    return _tag(TAG_DEFINE_BUTTON_CXFORM,
                struct.pack("<H", button_id) + w.bytes())


def parse_define_button_cxform_tag(body: bytes):
    (button_id,) = struct.unpack_from("<H", body, 0)
    r = BitReader(body[2:])
    return button_id, _read_cxform_rgb(r)


def emit_define_button_sound(button_id: int, sounds) -> bytes:
    """DefineButtonSound (tag 17): per state-transition sound triggers.

    ``sounds``: 4 entries (wire order BUTTON_SOUND_TRANSITIONS), each
    None or (sound_id, SoundInfo)."""
    body = bytearray(struct.pack("<H", button_id))
    for entry in sounds:
        if entry is None:
            body.extend(struct.pack("<H", 0))
        else:
            sid, info = entry
            if sid == 0:
                raise ValueError("button sound id 0 means 'none'")
            body.extend(_sound_head_bytes(sid, info))
    return _tag(TAG_DEFINE_BUTTON_SOUND, bytes(body))


def parse_define_button_sound_tag(body: bytes):
    """-> (button_id, 4-tuple of None | (sound_id, SoundInfo))."""
    (button_id,) = struct.unpack_from("<H", body, 0)
    pos = 2
    out = []
    for _ in range(4):
        (sid,) = struct.unpack_from("<H", body, pos)
        if sid == 0:
            out.append(None)
            pos += 2
        else:
            sid, info, pos = _parse_sound_head(body, pos)
            out.append((sid, info))
    return button_id, tuple(out)


def emit_sound_stream_head(stream, head2: Optional[bool] = None) -> bytes:
    """SoundStreamHead/Head2 (tags 18/45): playback hint byte, stream
    format byte, average samples per frame.

    Tag 18 only admits ADPCM/MP3 compression (SWF spec v19); any other
    format auto-selects Head2, which allows them all."""
    from .sound import FORMAT_ADPCM, FORMAT_MP3

    if head2 is None:
        head2 = stream.format not in (FORMAT_ADPCM, FORMAT_MP3)
    playback = _sound_flags(0, stream.rate, stream.bits, stream.channels)
    streamf = _sound_flags(stream.format, stream.rate, stream.bits,
                           stream.channels)
    return _tag(TAG_SOUND_STREAM_HEAD2 if head2 else TAG_SOUND_STREAM_HEAD,
                struct.pack("<BBH", playback & 0x0F, streamf,
                            stream.samples_per_frame))


def parse_sound_stream_head_tag(body: bytes):
    from .sound import RATES, SoundStream

    _playback, streamf, spf = struct.unpack_from("<BBH", body, 0)
    return SoundStream(format=streamf >> 4, rate=RATES[(streamf >> 2) & 3],
                       bits=16 if (streamf >> 1) & 1 else 8,
                       channels=2 if streamf & 1 else 1,
                       samples_per_frame=spf)


@dataclasses.dataclass
class VideoStream:
    """DefineVideoStream (tag 60) + its VideoFrame (tag 61) packets.

    ``frames`` maps frame number -> raw codec packet bytes (for codec 3,
    a SCREENVIDEOPACKET — models.screenvideo decodes/encodes it).
    ``decoded`` / ``frame_bitmap_ids`` are loader-side caches
    (runtime.movie materializes decoded frames as synthetic bitmap
    characters); they never touch the wire."""

    id: int
    width: int
    height: int
    num_frames: int = 0
    codec: int = 3  # 3 = Screen Video
    smoothing: bool = True
    frames: dict = dataclasses.field(default_factory=dict)
    decoded: dict = dataclasses.field(default_factory=dict)
    frame_bitmap_ids: dict = dataclasses.field(default_factory=dict)


def emit_define_video_stream(stream: VideoStream) -> bytes:
    """DefineVideoStream tag 60: id, frame count, dimensions, flags
    (bit 0 = smoothing), codec id."""
    return _tag(TAG_DEFINE_VIDEO_STREAM, struct.pack(
        "<HHHHBB", stream.id, stream.num_frames or len(stream.frames),
        stream.width, stream.height, 1 if stream.smoothing else 0,
        stream.codec))


def parse_define_video_stream_tag(body: bytes) -> VideoStream:
    sid, num, w, h, flags, codec = struct.unpack_from("<HHHHBB", body, 0)
    return VideoStream(id=sid, width=w, height=h, num_frames=num,
                       codec=codec, smoothing=bool(flags & 0x01))


def emit_video_frame(stream_id: int, frame_num: int,
                     packet: bytes) -> bytes:
    """VideoFrame tag 61: stream id, frame number, raw codec packet."""
    return _tag(TAG_VIDEO_FRAME,
                struct.pack("<HH", stream_id, frame_num) + packet)


def parse_video_frame_tag(body: bytes) -> Tuple[int, int, bytes]:
    sid, num = struct.unpack_from("<HH", body, 0)
    return sid, num, body[4:]


def emit_define_scaling_grid(character_id: int,
                             grid_rect: ast.Rect) -> bytes:
    """DefineScalingGrid (tag 78, SWF8): character id + the 9-slice
    center RECT in the character's local twips (SWF spec v19 §'
    DefineScalingGrid')."""
    w = BitWriter()
    _write_rect(w, grid_rect)
    return _tag(TAG_DEFINE_SCALING_GRID,
                struct.pack("<H", character_id) + w.bytes())


def parse_define_scaling_grid_tag(body: bytes) -> Tuple[int, ast.Rect]:
    (character_id,) = struct.unpack_from("<H", body, 0)
    return character_id, _read_rect(BitReader(body, 2))


def emit_define_sprite(sprite_id: int, frames: List[List],
                       sound_stream=None) -> bytes:
    """DefineSprite (tag 39) bytes from per-frame display-list op lists
    (Placement / RemoveObject, the ``emit_movie_timeline`` frame form).
    ``sound_stream``: optional sprite-local SoundStreamHead + per-frame
    blocks (keyed by sprite frame index)."""
    tags = bytearray()
    if sound_stream is not None:
        tags.extend(emit_sound_stream_head(sound_stream))
    for fi, ops in enumerate(frames):
        if sound_stream is not None and fi in sound_stream.blocks:
            tags.extend(_tag(TAG_SOUND_STREAM_BLOCK,
                             sound_stream.blocks[fi]))
        tags.extend(_emit_display_ops(ops))
        tags.extend(_tag(TAG_SHOW_FRAME, b""))
    tags.extend(_tag(TAG_END, b""))
    return _tag(TAG_DEFINE_SPRITE,
                struct.pack("<HH", sprite_id, len(frames)) + bytes(tags))


def _emit_display_ops(ops) -> bytes:
    """Placement / RemoveObject ops -> their wire tags (shared by the
    root timeline emitter and DefineSprite)."""
    tags = bytearray()
    for op in ops:
        if isinstance(op, RemoveObject):
            if op.character_id is not None:
                tags.extend(_tag(TAG_REMOVE_OBJECT, struct.pack(
                    "<HH", op.character_id, op.depth)))
            else:
                tags.extend(_tag(TAG_REMOVE_OBJECT2,
                                 struct.pack("<H", op.depth)))
        else:
            tags.extend(_emit_place_object2(op))
    return bytes(tags)


def decompress_movie(data: bytes) -> bytes:
    """CWS (zlib) and ZWS (LZMA, SWF >= 13) movies inflate to their FWS
    twin; FWS passes through.  Real-world .swf files are almost always
    CWS; ZWS appears in late-era mobile/AIR content.

    ZWS layout (SWF spec, file header): ``ZWS`` + version + u32
    uncompressed length (header included), then u32 compressed length,
    5 LZMA property bytes, and a raw LZMA1 stream with no end marker.
    stdlib ``lzma`` decodes it as a FORMAT_ALONE stream once the
    13-byte alone-header (props + u64 uncompressed size) is rebuilt."""
    if data[:3] == b"CWS":
        import zlib

        return b"FWS" + data[3:8] + zlib.decompress(data[8:])
    if data[:3] == b"ZWS":
        import lzma

        (uncomp_len,) = struct.unpack_from("<I", data, 4)
        # data[8:12] is the compressed length (redundant); 12:17 props.
        alone = (data[12:17]
                 + struct.pack("<Q", uncomp_len - 8) + data[17:])
        body = lzma.LZMADecompressor(format=lzma.FORMAT_ALONE).decompress(
            alone)
        return b"FWS" + data[3:8] + body
    return data


def compress_movie(data: bytes, signature: str = "CWS") -> bytes:
    """FWS movie bytes -> their CWS (zlib) or ZWS (LZMA) twin.  The
    8-byte header stays uncompressed; ZWS additionally records the
    compressed payload length and the 5 LZMA property bytes the player
    expects (decoder counterpart above)."""
    if data[:3] != b"FWS":
        raise ValueError(f"not an uncompressed movie ({data[:3]!r})")
    if signature == "CWS":
        import zlib

        return b"CWS" + data[3:8] + zlib.compress(data[8:], 9)
    if signature == "ZWS":
        import lzma

        alone = lzma.compress(data[8:], format=lzma.FORMAT_ALONE)
        props, payload = alone[:5], alone[13:]  # drop the u64 size
        version = max(data[3], 13)  # ZWS is only legal from SWF 13
        return (b"ZWS" + bytes([version]) + data[4:8]
                + struct.pack("<I", len(payload)) + props + payload)
    raise ValueError(f"unknown movie signature {signature!r}")


def _iter_tag_records(data: bytes, pos: int):
    """(code, body) for each RECORDHEADER tag starting at ``pos``, up to
    and including TAG_END (shared by the movie body and sprite bodies)."""
    while pos < len(data):
        (head,) = struct.unpack_from("<H", data, pos)
        pos += 2
        code = head >> 6
        length = head & 0x3F
        if length == 0x3F:
            (length,) = struct.unpack_from("<I", data, pos)
            pos += 4
        yield code, data[pos : pos + length]
        pos += length
        if code == TAG_END:
            break


def _iter_tags(data: bytes):
    """(code, body) for each top-level tag of a movie, up to and
    including TAG_END."""
    data = decompress_movie(data)
    if data[:3] != b"FWS":
        raise ValueError(f"not a .swf movie (signature {data[:3]!r})")
    r = BitReader(data, 8)
    _read_rect(r)
    yield from _iter_tag_records(data, r.byte_pos + 4)  # rate + count


def parse_movie_shapes(data: bytes) -> List[ast.DefineShape]:
    """Extract every DefineShape3/DefineShape4 from an uncompressed
    movie."""
    shapes = []
    for code, body in _iter_tags(data):
        if code in (TAG_DEFINE_SHAPE, TAG_DEFINE_SHAPE2):
            shapes.append(parse_define_shape12_tag(body))
        if code == TAG_DEFINE_SHAPE3:
            shapes.append(parse_define_shape_tag(body))
        if code == TAG_DEFINE_SHAPE4:
            shapes.append(parse_define_shape4_tag(body))
    return shapes


def parse_movie_morph_shapes(
        data: bytes) -> List[Tuple[ast.DefineMorphShape, float]]:
    """Extract every DefineMorphShape/DefineMorphShape2 from a movie,
    paired with its FIRST placed ratio (PlaceObject2 HasRatio; 0.0 if
    the movie never places it).  Built on the resolved timeline, so
    PlaceFlagMove ratio updates (which carry no character id on the
    wire) attribute correctly."""
    movie = parse_movie(data)
    ratios = {}
    for frame in movie.frames:
        for p in frame:
            if (p.character_id in movie.morph_shapes
                    and p.ratio is not None
                    and p.character_id not in ratios):
                ratios[p.character_id] = p.ratio
    return [(m, ratios.get(m.id, 0.0))
            for m in movie.morph_shapes.values()]


def parse_movie_bitmaps(data: bytes) -> List[ast.DefineBitmap]:
    """Extract every bitmap define tag (Lossless/Lossless2, DefineBits
    + JPEGTables, JPEG2/JPEG3) from a movie."""
    out = []
    jpeg_tables = b""
    for code, body in _iter_tags(data):
        if code == TAG_DEFINE_BITS_LOSSLESS:
            out.append(parse_define_bits_lossless_tag(body))
        elif code == TAG_DEFINE_BITS_LOSSLESS2:
            out.append(parse_define_bits_lossless2_tag(body))
        elif code == TAG_JPEG_TABLES:
            jpeg_tables = body
        elif code == TAG_DEFINE_BITS:
            out.append(_define_bits_v1_jpeg(jpeg_tables, body))
        elif code == TAG_DEFINE_BITS_JPEG2:
            out.append(parse_define_bits_jpeg2_tag(body))
        elif code == TAG_DEFINE_BITS_JPEG3:
            out.append(parse_define_bits_jpeg3_tag(body))
    return out


@dataclasses.dataclass(frozen=True)
class Movie:
    """Everything a movie declares: the header frame RECT (twips),
    background color, define tags by character id, and the display
    list's per-ShowFrame snapshots (depth-ordered, fully resolved —
    PlaceFlagMove modifications and RemoveObject2 already applied)."""

    frame_rect: ast.Rect
    frame_rate: float
    background: ast.StraightSRgba8
    shapes: dict            # id -> ast.DefineShape
    morph_shapes: dict      # id -> ast.DefineMorphShape
    bitmaps: dict           # id -> ast.DefineBitmap
    frames: Tuple[Tuple[Placement, ...], ...]
    sprites: dict = dataclasses.field(default_factory=dict)  # id -> Sprite
    # frame index -> label (FrameLabel tags), informational.
    frame_labels: dict = dataclasses.field(default_factory=dict)
    fonts: dict = dataclasses.field(default_factory=dict)    # id -> Font
    texts: dict = dataclasses.field(default_factory=dict)    # id -> Text
    edit_texts: dict = dataclasses.field(default_factory=dict)  # -> EditText
    buttons: dict = dataclasses.field(default_factory=dict)  # id -> Button
    # DefineButtonSound: button id -> 4-tuple (wire order
    # BUTTON_SOUND_TRANSITIONS) of None | (sound id, SoundInfo).
    button_sounds: dict = dataclasses.field(default_factory=dict)
    # DefineButtonCxform: button id -> (mult4, add4) RGB color transform.
    button_cxforms: dict = dataclasses.field(default_factory=dict)
    # DefineScalingGrid: character id -> 9-slice center ast.Rect (twips).
    scaling_grids: dict = dataclasses.field(default_factory=dict)
    videos: dict = dataclasses.field(default_factory=dict)  # -> VideoStream
    sounds: dict = dataclasses.field(default_factory=dict)  # id -> Sound
    # StartSound events: frame index -> [(sound id, SoundInfo), ...]
    sound_events: dict = dataclasses.field(default_factory=dict)
    # Main-timeline SoundStreamHead(+blocks), or None.
    sound_stream: Optional[object] = None
    exported: dict = dataclasses.field(default_factory=dict)  # name -> id
    imported: dict = dataclasses.field(default_factory=dict)  # -> (url,id)
    metadata: Optional[str] = None      # Metadata tag XML
    scenes: Tuple = ()                  # ((frame offset, name), ...)
    font_names: dict = dataclasses.field(default_factory=dict)

    @property
    def placements(self) -> Tuple[Placement, ...]:
        """The first frame's display list."""
        return self.frames[0] if self.frames else ()


def parse_movie(data: bytes) -> Movie:
    """Full movie parse: define tags + the display-list timeline.

    PlaceObject2 semantics per frame: a new-character placement
    occupies its depth; a PlaceFlagMove placement modifies (or, with a
    character id, replaces) the occupant, retaining any attribute left
    unspecified; RemoveObject2 clears the depth.  Each ShowFrame
    snapshots the resolved, depth-sorted display list."""
    data = decompress_movie(data)
    if data[:3] != b"FWS":
        raise ValueError(f"not a .swf movie (signature {data[:3]!r})")
    r = BitReader(data, 8)
    frame_rect = _read_rect(r)
    (rate_fixed, _count) = struct.unpack_from("<HH", data, r.byte_pos)
    background = ast.StraightSRgba8(255, 255, 255, 255)
    shapes, morphs, bitmaps, sprites = {}, {}, {}, {}
    fonts, texts, edit_texts, buttons = {}, {}, {}, {}
    scaling_grids: dict = {}
    videos: dict = {}
    sounds: dict = {}
    sound_events: dict = {}
    button_sounds: dict = {}
    button_cxforms: dict = {}
    sound_stream = None
    exported: dict = {}
    imported: dict = {}
    metadata = None
    scenes: tuple = ()
    font_names: dict = {}
    labels: dict = {}
    jpeg_tables = b""
    dl = _DisplayList()
    for code, body in _iter_tags(data):
        if dl.handle(code, body):
            pass
        elif code == TAG_SET_BACKGROUND:
            background = ast.StraightSRgba8(body[0], body[1], body[2], 255)
        elif code in (TAG_DEFINE_SHAPE, TAG_DEFINE_SHAPE2):
            tag = parse_define_shape12_tag(body)
            shapes[tag.id] = tag
        elif code == TAG_DEFINE_SHAPE3:
            tag = parse_define_shape_tag(body)
            shapes[tag.id] = tag
        elif code == TAG_DEFINE_SHAPE4:
            tag = parse_define_shape4_tag(body)
            shapes[tag.id] = tag
        elif code == TAG_DEFINE_MORPH_SHAPE:
            tag = parse_define_morph_shape_tag(body)
            morphs[tag.id] = tag
        elif code == TAG_DEFINE_MORPH_SHAPE2:
            tag = parse_define_morph_shape2_tag(body)
            morphs[tag.id] = tag
        elif code == TAG_DEFINE_BITS_LOSSLESS:
            tag = parse_define_bits_lossless_tag(body)
            bitmaps[tag.id] = tag
        elif code == TAG_DEFINE_BITS_LOSSLESS2:
            tag = parse_define_bits_lossless2_tag(body)
            bitmaps[tag.id] = tag
        elif code == TAG_JPEG_TABLES:
            jpeg_tables = body
        elif code == TAG_DEFINE_BITS:
            tag = _define_bits_v1_jpeg(jpeg_tables, body)
            bitmaps[tag.id] = tag
        elif code == TAG_DEFINE_BITS_JPEG2:
            tag = parse_define_bits_jpeg2_tag(body)
            bitmaps[tag.id] = tag
        elif code == TAG_DEFINE_BITS_JPEG3:
            tag = parse_define_bits_jpeg3_tag(body)
            bitmaps[tag.id] = tag
        elif code == TAG_DEFINE_BITS_JPEG4:
            tag = parse_define_bits_jpeg4_tag(body)
            bitmaps[tag.id] = tag
        elif code == TAG_DEFINE_SPRITE:
            sprite = parse_define_sprite(body)
            sprites[sprite.id] = sprite
        elif code == TAG_DEFINE_FONT:
            font = parse_define_font_tag(body)
            fonts[font.id] = font
        elif code in (TAG_DEFINE_FONT2, TAG_DEFINE_FONT3):
            font = parse_define_font2_tag(body,
                                          font3=code == TAG_DEFINE_FONT3)
            fonts[font.id] = font
        elif code in (TAG_DEFINE_TEXT, TAG_DEFINE_TEXT2):
            text = parse_define_text_tag(body,
                                         text2=code == TAG_DEFINE_TEXT2)
            texts[text.id] = text
        elif code == TAG_DEFINE_EDIT_TEXT:
            field = parse_define_edit_text_tag(body)
            edit_texts[field.id] = field
        elif code in (TAG_DEFINE_FONT_INFO, TAG_DEFINE_FONT_INFO2):
            fid, fname, codes = parse_define_font_info_tag(
                body, info2=code == TAG_DEFINE_FONT_INFO2)
            if fid in fonts:
                fonts[fid] = dataclasses.replace(
                    fonts[fid], name=fname or fonts[fid].name,
                    code_table=codes)
        elif code in (TAG_DEFINE_BUTTON, TAG_DEFINE_BUTTON2):
            button = (parse_define_button2_tag(body)
                      if code == TAG_DEFINE_BUTTON2
                      else parse_define_button_tag(body))
            buttons[button.id] = button
        elif code == TAG_DEFINE_BUTTON_SOUND:
            bid, slots = parse_define_button_sound_tag(body)
            button_sounds[bid] = slots
        elif code == TAG_DEFINE_BUTTON_CXFORM:
            bid, bct = parse_define_button_cxform_tag(body)
            button_cxforms[bid] = bct
        elif code == TAG_FRAME_LABEL:
            end = body.index(b"\x00")
            labels[len(dl.frames)] = body[:end].decode("utf-8")
        elif code == TAG_DEFINE_SCALING_GRID:
            cid, grid_rect = parse_define_scaling_grid_tag(body)
            scaling_grids[cid] = grid_rect
        elif code == TAG_DEFINE_VIDEO_STREAM:
            stream = parse_define_video_stream_tag(body)
            videos[stream.id] = stream
        elif code == TAG_VIDEO_FRAME:
            sid, num, packet = parse_video_frame_tag(body)
            if sid in videos:
                videos[sid].frames[num] = packet
        elif code == TAG_DEFINE_SOUND:
            snd = parse_define_sound_tag(body)
            sounds[snd.id] = snd
        elif code == TAG_START_SOUND:
            sid, info = parse_start_sound_tag(body)
            sound_events.setdefault(len(dl.frames), []).append(
                (sid, info))
        elif code in (TAG_SOUND_STREAM_HEAD, TAG_SOUND_STREAM_HEAD2):
            sound_stream = parse_sound_stream_head_tag(body)
        elif code == TAG_SOUND_STREAM_BLOCK:
            if sound_stream is not None:
                sound_stream.blocks[len(dl.frames)] = body
        elif code == TAG_EXPORT_ASSETS:
            exported.update(parse_export_assets_tag(body))
        elif code in (TAG_IMPORT_ASSETS, TAG_IMPORT_ASSETS2):
            imported.update(parse_import_assets_tag(
                body, assets2=code == TAG_IMPORT_ASSETS2))
        elif code == TAG_METADATA:
            metadata = _zstring(body, 0)[0]
        elif code == TAG_DEFINE_SCENE_AND_FRAME_LABEL_DATA:
            scenes, scene_labels = parse_scene_frame_label_tag(body)
            for num, name in scene_labels.items():
                labels.setdefault(num, name)
        elif code == TAG_DEFINE_FONT_NAME:
            (fid,) = struct.unpack_from("<H", body, 0)
            display, pos = _zstring(body, 2)
            copyright_, _pos = _zstring(body, pos)
            font_names[fid] = (display, copyright_)
    return Movie(frame_rect=frame_rect, frame_rate=rate_fixed / 256.0,
                 background=background, shapes=shapes,
                 morph_shapes=morphs, bitmaps=bitmaps,
                 frames=tuple(dl.frames), sprites=sprites,
                 frame_labels=labels, fonts=fonts, texts=texts,
                 edit_texts=edit_texts, buttons=buttons,
                 button_sounds=button_sounds,
                 button_cxforms=button_cxforms,
                 scaling_grids=scaling_grids, videos=videos,
                 sounds=sounds, sound_events=sound_events,
                 sound_stream=sound_stream, exported=exported,
                 imported=imported, metadata=metadata, scenes=scenes,
                 font_names=font_names)
