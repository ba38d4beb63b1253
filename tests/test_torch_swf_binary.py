"""The SWF binary front end of the port (``models/swf_binary.py`` with
``utils/bits.py``, ``models/sound.py``, ``models/screenvideo.py``)
against the JAX package's, on the CPU.

Every input is built once per package by the same builder function
(``Kit``: the package's ``ast``, ``fixed``, ``swf_binary``, ``sound`` and
filter modules), with random content drawn from
``np.random.default_rng(seed)`` in the same order.  What holds:

- every tag emitter gives the same bytes in both packages, and parsing
  those bytes gives the same ``convert.to_plain`` form (the cases of the
  reference's tests/test_swf_binary.py, test_text.py, test_sprites.py,
  test_scale9.py, test_video.py and test_sound.py, with the corpus tags
  they read built in code);
- whole movies are equal bytes in FWS, CWS and ZWS, and ``parse_movie``
  gives equal forms (random timelines of PlaceFlagMove / replace /
  RemoveObject2 too), with the same refusals;
- ``convert.to_plain`` tells different trees apart and keeps NaN and
  -0.0 bit for bit.
"""

import dataclasses
import importlib
import math
import struct
import zlib

import numpy as np
import pytest

from swf_renderer_tpu_torch.convert import to_plain

JAX = "swf_renderer_tpu"
PORT = "swf_renderer_tpu_torch"
SEED = 1607


class Kit:
    """One package's modules and constructors over them."""

    def __init__(self, pkg):
        def mod(name):
            return importlib.import_module(f"{pkg}.{name}")

        self.pkg = pkg
        self.ast = mod("models.ast")
        self.fixed = mod("utils.fixed").Sfixed16P16
        self.sb = mod("models.swf_binary")
        self.sound = mod("models.sound")
        self.sv = mod("models.screenvideo")
        self.bits = mod("utils.bits")
        self.filters = mod("ops.filters")
        self.bmp = mod("runtime.bitmap_service")
        self.display = mod("models.display")
        self.movie = mod("runtime.movie")

    def mat(self, sx=1.0, sy=1.0, r0=0.0, r1=0.0, tx=0, ty=0):
        f = self.fixed.from_value
        return self.ast.Matrix(scale_x=f(sx), scale_y=f(sy),
                               rotate_skew0=f(r0), rotate_skew1=f(r1),
                               translate_x=int(tx), translate_y=int(ty))

    def rot(self, th, s=1.0, tx=0, ty=0):
        c, n = math.cos(th) * s, math.sin(th) * s
        return self.mat(c, c, n, -n, tx, ty)

    def rgba(self, r, g, b, a=255):
        return self.ast.StraightSRgba8(int(r), int(g), int(b), int(a))

    def rand_rgba(self, rng, alpha=True):
        c = [int(v) for v in rng.integers(0, 256, 4)]
        return self.rgba(*c[:3], c[3] if alpha else 255)

    def v(self, x, y):
        return self.ast.Vector2D(int(x), int(y))

    def gradient(self, rng, n=3, spread="PAD", space="S_RGB"):
        a = self.ast
        ratios = sorted(int(r) for r in rng.integers(0, 256, n))
        return a.Gradient(
            spread=a.GradientSpread[spread],
            color_space=a.ColorSpace[space],
            colors=tuple(a.GradientStop(ratio=r, color=self.rand_rgba(rng))
                         for r in ratios))

    def fill(self, rng, kind, bitmap_id=50):
        a = self.ast
        if kind == "solid":
            return a.SolidFill(color=self.rand_rgba(rng))
        m = self.mat(float(rng.uniform(0.02, 0.2)),
                     float(rng.uniform(0.02, 0.2)),
                     float(rng.uniform(-0.05, 0.05)), 0.0,
                     int(rng.integers(0, 2000)), int(rng.integers(0, 2000)))
        if kind == "linear":
            return a.LinearGradientFill(matrix=m, gradient=self.gradient(
                rng, 3, "REFLECT"))
        if kind == "radial":
            return a.RadialGradientFill(matrix=m, gradient=self.gradient(
                rng, 4, "REPEAT", "LINEAR_RGB"))
        if kind == "focal":
            return a.FocalGradientFill(matrix=m, gradient=self.gradient(
                rng, 2), focal_point_epsilons=int(rng.integers(-200, 200)))
        return a.BitmapFill(bitmap_id=bitmap_id, matrix=self.mat(20, 20),
                            repeating=bool(rng.integers(0, 2)),
                            smoothed=bool(rng.integers(0, 2)))

    def line(self, rng, fill=None):
        caps = ("round", "none", "square")
        joins = ({"type": "round"}, {"type": "bevel"},
                 {"type": "miter", "limit": 2.5})
        return self.ast.LineStyle(
            width=int(rng.integers(20, 200)),
            start_cap=caps[int(rng.integers(0, 3))],
            end_cap=caps[int(rng.integers(0, 3))],
            join=joins[int(rng.integers(0, 3))],
            no_h_scale=bool(rng.integers(0, 2)),
            no_v_scale=bool(rng.integers(0, 2)),
            no_close=bool(rng.integers(0, 2)),
            pixel_hinting=bool(rng.integers(0, 2)),
            fill=fill or self.ast.SolidFill(color=self.rand_rgba(rng)))

    def polygon_records(self, rng, cx, cy, radius, n, curved=0.4,
                        star=False, fill=1, line=None):
        """A closed polygon (or star) of ``n`` edges around (cx, cy),
        some edges quadratic; deltas close exactly."""
        a = self.ast
        pts = []
        for i in range(n):
            th = 2 * math.pi * i / n
            r = radius * (0.5 if star and i % 2 else 1.0)
            pts.append((int(round(cx + r * math.cos(th))),
                        int(round(cy + r * math.sin(th)))))
        recs = [a.StyleChangeRecord(move_to=self.v(*pts[0]), left_fill=fill,
                                    line_style=line)]
        for i in range(n):
            x0, y0 = pts[i]
            x1, y1 = pts[(i + 1) % n]
            if rng.random() < curved:
                mx, my = (x0 + x1) // 2, (y0 + y1) // 2
                ox = int(round((mx - cx) * 0.15))
                oy = int(round((my - cy) * 0.15))
                cdx, cdy = mx + ox - x0, my + oy - y0
                recs.append(a.EdgeRecord(
                    delta=self.v(x1 - x0 - cdx, y1 - y0 - cdy),
                    control_delta=self.v(cdx, cdy)))
            else:
                recs.append(a.EdgeRecord(delta=self.v(x1 - x0, y1 - y0)))
        return recs

    def shape(self, sid, records, fills, lines=(), bounds=None, **kw):
        a = self.ast
        return a.DefineShape(
            id=sid, bounds=bounds or a.Rect(-4000, 4000, -4000, 4000),
            shape=a.ShapeBody(
                initial_styles=a.ShapeStyles(fill=tuple(fills),
                                             line=tuple(lines)),
                records=tuple(records)), **kw)

    def rect_shape(self, sid, w, h, color, x=0, y=0):
        a = self.ast
        recs = (a.StyleChangeRecord(move_to=self.v(x, y), left_fill=1),
                a.EdgeRecord(delta=self.v(w, 0)),
                a.EdgeRecord(delta=self.v(0, h)),
                a.EdgeRecord(delta=self.v(-w, 0)),
                a.EdgeRecord(delta=self.v(0, -h)))
        return self.shape(sid, recs, [a.SolidFill(color=color)],
                          bounds=a.Rect(x, x + w, y, y + h))

    def random_shape(self, rng, sid, kinds=("solid", "linear", "radial",
                                            "focal", "bitmap")):
        """Fills of every kind, two stroked sub-paths, a mid-record
        new-styles change and curved edges."""
        a = self.ast
        fills = [self.fill(rng, k) for k in kinds]
        lines = [self.line(rng), self.line(rng)]
        recs = []
        for i, _ in enumerate(fills):
            recs += self.polygon_records(
                rng, int(rng.integers(-2000, 2000)),
                int(rng.integers(-2000, 2000)), int(rng.integers(200, 1500)),
                int(rng.integers(3, 12)), fill=i + 1,
                line=(i % 2) + 1 if i < 2 else None)
        new = a.ShapeStyles(fill=(self.fill(rng, "solid"),),
                            line=(self.line(rng),))
        recs.append(a.StyleChangeRecord(new_styles=new, left_fill=1,
                                        line_style=1))
        recs += self.polygon_records(rng, 500, 500, 400, 6, fill=1,
                                     line=1)[1:]
        return self.shape(sid, recs, fills, lines)

    def morph_line(self, rng):
        a = self.ast
        caps = ("round", "none", "square")
        joins = ({"type": "round"}, {"type": "bevel"},
                 {"type": "miter", "limit": float(int(rng.integers(1, 16)))
                  / 4.0 + 1.0})
        return a.MorphLineStyle(
            width=int(rng.integers(0, 400)),
            morph_width=int(rng.integers(0, 400)),
            start_cap=caps[int(rng.integers(0, 3))],
            end_cap=caps[int(rng.integers(0, 3))],
            join=joins[int(rng.integers(0, 3))],
            no_h_scale=bool(rng.integers(0, 2)),
            no_v_scale=bool(rng.integers(0, 2)),
            no_close=bool(rng.integers(0, 2)),
            pixel_hinting=bool(rng.integers(0, 2)),
            fill=a.MorphSolidFill(color=self.rand_rgba(rng),
                                  morph_color=self.rand_rgba(rng)))

    def random_morph(self, rng, extended=False):
        """tests/test_swf_binary.py::_random_morph, plus gradient and
        bitmap fill pairs when ``extended``."""
        a = self.ast
        n_fills = int(rng.integers(1, 4))
        n_lines = int(rng.integers(0, 3))
        fills = [a.MorphSolidFill(color=self.rand_rgba(rng),
                                  morph_color=self.rand_rgba(rng))
                 for _ in range(n_fills)]
        if extended:
            for kind in ("linear", "radial", "bitmap"):
                start = self.fill(rng, kind)
                end = (dataclasses.replace(start, matrix=self.mat(
                    10, 30, 0.5, -0.5, 100, -100)) if kind == "bitmap"
                    else self.fill(rng, kind))
                fills.append(a.MorphExtendedFill(start=start, end=end))
            n_fills = len(fills)
        styles = a.MorphShapeStyles(
            fill=tuple(fills),
            line=tuple(self.morph_line(rng) for _ in range(n_lines)))
        records = []
        for _ in range(int(rng.integers(1, 4))):
            records.append(a.MorphStyleChangeRecord(
                move_to=self.v(*rng.integers(-3000, 3000, 2)),
                morph_move_to=self.v(*rng.integers(-3000, 3000, 2)),
                left_fill=int(rng.integers(0, n_fills + 1)),
                right_fill=int(rng.integers(0, n_fills + 1)),
                line_style=(int(rng.integers(1, n_lines + 1))
                            if n_lines and rng.random() < 0.5 else None)))
            for _ in range(int(rng.integers(1, 6))):
                def ctrl():
                    if rng.random() < 0.5:
                        return None
                    return self.v(*rng.integers(-900, 900, 2))
                records.append(a.MorphEdgeRecord(
                    delta=self.v(*rng.integers(-900, 900, 2)),
                    morph_delta=self.v(*rng.integers(-900, 900, 2)),
                    control_delta=ctrl(), morph_control_delta=ctrl()))
        return a.DefineMorphShape(
            id=int(rng.integers(1, 1000)),
            bounds=a.Rect(-4000, 4000, -4000, 4000),
            morph_bounds=a.Rect(-4000, 4000, -4000, 4000),
            has_non_scaling_strokes=bool(rng.integers(0, 2)),
            has_scaling_strokes=bool(rng.integers(0, 2)),
            shape=a.MorphShapeBody(initial_styles=styles,
                                   records=tuple(records)))

    def morph_polygon(self, sid, n, r0, r1, color0, color1, cx=0, cy=0):
        """A fills-only morph between two ``n``-gons of radius r0 / r1
        (the second turned by half an edge), edges straight."""
        a = self.ast

        def pts(r, turn):
            return [(int(round(cx + r * math.cos(2 * math.pi * (i + turn)
                                                 / n))),
                     int(round(cy + r * math.sin(2 * math.pi * (i + turn)
                                                 / n))))
                    for i in range(n)]

        p0, p1 = pts(r0, 0.0), pts(r1, 0.5)
        recs = [a.MorphStyleChangeRecord(move_to=self.v(*p0[0]),
                                         morph_move_to=self.v(*p1[0]),
                                         left_fill=1)]
        for i in range(n):
            j = (i + 1) % n
            recs.append(a.MorphEdgeRecord(
                delta=self.v(p0[j][0] - p0[i][0], p0[j][1] - p0[i][1]),
                morph_delta=self.v(p1[j][0] - p1[i][0],
                                   p1[j][1] - p1[i][1])))
        r = int(max(r0, r1)) + 20
        return a.DefineMorphShape(
            id=sid, bounds=a.Rect(cx - r, cx + r, cy - r, cy + r),
            morph_bounds=a.Rect(cx - r, cx + r, cy - r, cy + r),
            shape=a.MorphShapeBody(
                initial_styles=a.MorphShapeStyles(
                    fill=(a.MorphSolidFill(color=color0,
                                           morph_color=color1),),
                    line=()),
                records=tuple(recs)))

    def all_filters(self):
        """One of each of the eight PlaceObject3 filter kinds, with
        values the wire carries exactly."""
        f = self.filters
        c = (1.0, 0.2, 0.4, 0.6)
        return (
            f.DropShadowFilter(color=c, blur_x=4.0, blur_y=2.5, angle=0.75,
                               distance=3.0, strength=1.5, inner=True,
                               passes=2),
            f.BlurFilter(blur_x=2.0, blur_y=3.5, passes=3),
            f.GlowFilter(color=(0.0, 1.0, 0.0, 1.0), blur_x=6.0,
                         blur_y=6.0, strength=2.0, knockout=True),
            f.BevelFilter(shadow_color=(0.0, 0.0, 0.0, 1.0),
                          highlight_color=(1.0, 1.0, 1.0, 1.0), blur_x=3.0,
                          blur_y=3.0, angle=0.5, distance=2.0, on_top=True),
            f.GradientGlowFilter(colors=((1.0, 0.0, 0.0, 0.0),
                                         (1.0, 1.0, 0.0, 1.0)),
                                 ratios=(0.0, 1.0), blur_x=4.0, blur_y=4.0,
                                 angle=0.25, distance=1.0),
            f.ConvolutionFilter(matrix_x=3, matrix_y=2,
                                matrix=(0.0, 1.0, 0.0, 1.0, -4.0, 1.0),
                                divisor=2.0, bias=8.0,
                                default_color=(0.2, 0.4, 0.6, 0.8),
                                clamp=False, preserve_alpha=True),
            f.ColorMatrixFilter(matrix=tuple(float(i) / 8 for i in
                                             range(20))),
            f.GradientBevelFilter(colors=((0.0, 0.0, 0.0, 1.0),
                                          (0.0, 0.0, 0.0, 0.0),
                                          (1.0, 1.0, 1.0, 1.0)),
                                  ratios=(0.0, 128 / 255, 1.0), blur_x=2.0,
                                  blur_y=2.0, inner=True, passes=1),
        )

    def lossless(self, rng, bid, w, h, kind):
        """A lossless bitmap tag of one payload family."""
        a = self.ast
        if kind == "bmp":            # tag 20, format 3 (RGB palette)
            pal = rng.integers(0, 256, (5, 3), np.uint8)
            idx = rng.integers(0, 5, (h, w), np.uint8)
            stride = (w + 3) & ~3
            rows = np.zeros((h, stride), np.uint8)
            rows[:, :w] = idx
            data = (bytes([3]) + struct.pack("<HH", w, h) + bytes([4])
                    + zlib.compress(pal.tobytes() + rows.tobytes()))
            return a.DefineBitmap(id=bid, width=w, height=h,
                                  media_type="image/x-swf-bmp", data=data)
        if kind == "full24":         # tag 20, format 5
            data = self.bmp.encode_x_swf_bmp_pix24(
                rng.integers(0, 256, (h, w, 3), np.uint8))
            return a.DefineBitmap(id=bid, width=w, height=h,
                                  media_type="image/x-swf-bmp-full",
                                  data=data)
        if kind == "full15":         # tag 20, format 4
            data = self.bmp.encode_x_swf_bmp_pix15(
                rng.integers(0, 256, (h, w, 3), np.uint8))
            return a.DefineBitmap(id=bid, width=w, height=h,
                                  media_type="image/x-swf-bmp-full",
                                  data=data)
        if kind == "argb":           # tag 36, format 5
            data = self.bmp.encode_x_swf_bmp2_argb(
                rng.integers(0, 256, (h, w, 4), np.uint8))
        else:                        # tag 36, format 3 (RGBA palette)
            data = self.bmp.encode_x_swf_bmp2_colormapped(
                rng.integers(0, 256, (7, 4), np.uint8),
                rng.integers(0, 7, (h, w), np.uint8))
        return a.DefineBitmap(id=bid, width=w, height=h,
                              media_type="image/x-swf-bmp2", data=data)


KITS = {}


def kit(pkg) -> Kit:
    if pkg not in KITS:
        KITS[pkg] = Kit(pkg)
    return KITS[pkg]


def both(build, seed=SEED):
    """``build(kit, rng)`` once per package, each with its own generator
    of the same seed: (JAX result, port result)."""
    return tuple(build(kit(pkg), np.random.default_rng(seed))
                 for pkg in (JAX, PORT))


def tag_body(blob):
    """(code, body) of one emitted tag record."""
    head = int.from_bytes(blob[:2], "little")
    off = 2 + (4 if (head & 0x3F) == 0x3F else 0)
    return head >> 6, blob[off:]


def fake_jpeg(w, h, quirk=False):
    """The header of a baseline JPEG (SOI, an APP0 segment, SOF0 with
    the geometry, EOI): what ``image_dimensions`` reads.  Not decoded
    here (PIL is not needed for parse and emit)."""
    app0 = b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00" + bytes(9)
    sof = (b"\xff\xc0" + struct.pack(">HBHHB", 11, 8, h, w, 1)
           + bytes((1, 0x11, 0)))
    body = b"\xff\xd8" + app0 + sof + b"\xff\xd9"
    return (b"\xff\xd9\xff\xd8" + body) if quirk else body


# ---------------------------------------------------------------------------
# Tags: emit in both packages, equal bytes; parse, equal plain forms
# ---------------------------------------------------------------------------


def _emit_parse(emit, parse, **parse_kw):
    def run(obj):
        blob = emit(obj)
        return blob, parse(tag_body(blob)[1], **parse_kw)
    return run


def case_shape3(k, rng):
    return _emit_parse(k.sb.emit_define_shape, k.sb.parse_define_shape_tag)(
        k.random_shape(rng, 7))


def case_shape3_edge_widths(k, rng):
    a = k.ast
    recs = (a.StyleChangeRecord(move_to=k.v(-1, 1), right_fill=1),
            a.EdgeRecord(delta=k.v(1, 0)), a.EdgeRecord(delta=k.v(0, -1)),
            a.EdgeRecord(delta=k.v(32767, -32768)),
            a.EdgeRecord(delta=k.v(-5, 7), control_delta=k.v(-2, 3)))
    tag = k.shape(7, recs, [a.SolidFill(color=k.rgba(1, 2, 3, 4))],
                  bounds=a.Rect(-40000, 40000, -1, 1))
    return _emit_parse(k.sb.emit_define_shape,
                       k.sb.parse_define_shape_tag)(tag)


def case_shape4(k, rng):
    a = k.ast
    lines = [k.line(rng), k.line(rng)]
    recs = [a.StyleChangeRecord(move_to=k.v(10, 10), left_fill=1,
                                line_style=1),
            a.EdgeRecord(delta=k.v(500, 0)),
            a.StyleChangeRecord(line_style=2),
            a.EdgeRecord(delta=k.v(0, 500))]
    tag = k.shape(5, recs, [k.fill(rng, "solid")], lines,
                  has_fill_winding=True, has_non_scaling_strokes=True)
    return _emit_parse(k.sb.emit_define_shape4,
                       k.sb.parse_define_shape4_tag)(tag)


def case_shape12_legacy_rgb(k, rng):
    """DefineShape / DefineShape2 RGB bodies (tests/test_swf_binary.py::
    test_legacy_defineshape_rgb_parse), written with each package's own
    bit writer."""
    a, sb = k.ast, k.sb
    records = (a.StyleChangeRecord(move_to=k.v(20, 20), left_fill=1,
                                   line_style=1),
               a.EdgeRecord(delta=k.v(400, 0)),
               a.EdgeRecord(delta=k.v(0, 400)),
               a.EdgeRecord(delta=k.v(-400, -400),
                            control_delta=k.v(-300, -50)))
    body = bytearray(struct.pack("<H", 7))
    w = k.bits.BitWriter()
    sb._write_rect(w, a.Rect(0, 440, 0, 440))
    body.extend(w.bytes())
    body += bytes((1, 0x00, 10, 200, 30, 1)) + struct.pack("<H", 40)
    body += bytes((1, 2, 3))
    body.extend(sb._emit_record_stream(records, k.bits.ubits_for(1),
                                       k.bits.ubits_for(1)))
    return bytes(body), sb.parse_define_shape12_tag(bytes(body))


def case_morph1(k, rng):
    tags = [k.random_morph(rng) for _ in range(6)]
    out = [_emit_parse(lambda t: k.sb.emit_define_morph_shape(t, shape2=False),
                       k.sb.parse_define_morph_shape_tag)(t) for t in tags]
    return b"".join(b for b, _ in out), [p for _, p in out]


def case_morph2(k, rng):
    tags = [k.random_morph(rng, extended=i % 2 == 1) for i in range(6)]
    out = [_emit_parse(lambda t: k.sb.emit_define_morph_shape(t, shape2=True),
                       k.sb.parse_define_morph_shape2_tag)(t) for t in tags]
    return b"".join(b for b, _ in out), [p for _, p in out]


def case_bits_lossless(k, rng):
    out = []
    for kind, tag_id in (("bmp", 20), ("full24", 21), ("full15", 22)):
        bmp = k.lossless(rng, tag_id, 13, 7, kind)
        out.append(_emit_parse(k.sb.emit_define_bits_lossless,
                               k.sb.parse_define_bits_lossless_tag)(bmp))
    for kind, tag_id in (("argb", 23), ("cmap", 24)):
        bmp = k.lossless(rng, tag_id, 9, 11, kind)
        out.append(_emit_parse(k.sb.emit_define_bits_lossless2,
                               k.sb.parse_define_bits_lossless2_tag)(bmp))
    out.append((k.sb.emit_define_bitmap(bmp), None))
    return b"".join(b for b, _ in out), [p for _, p in out]


def case_bits_jpeg(k, rng):
    a, sb = k.ast, k.sb
    jpeg = a.DefineBitmap(id=30, width=33, height=17,
                          media_type="image/jpeg", data=fake_jpeg(33, 17))
    b2, p2 = _emit_parse(sb.emit_define_bits_jpeg2,
                         sb.parse_define_bits_jpeg2_tag)(jpeg)
    quirk = sb.parse_define_bits_jpeg2_tag(
        struct.pack("<H", 31) + fake_jpeg(8, 6, quirk=True))
    png = b"\x89PNG\r\n\x1a\n" + struct.pack(">I4sII", 13, b"IHDR", 5, 4)
    gif = b"GIF89a" + struct.pack("<HH", 7, 3)
    alpha = zlib.compress(bytes(range(33 * 17 % 256)) * 3)
    j3data = struct.pack("<I", len(jpeg.data)) + jpeg.data + alpha
    j3 = a.DefineBitmap(id=32, width=33, height=17,
                        media_type="image/x-swf-jpeg3", data=j3data)
    b3, p3 = _emit_parse(sb.emit_define_bits_jpeg3,
                         sb.parse_define_bits_jpeg3_tag)(j3)
    j4body = (struct.pack("<HI", 33, len(jpeg.data)) + b"\x01\x00"
              + jpeg.data + alpha)
    p4 = sb.parse_define_bits_jpeg4_tag(j4body)
    v1 = sb._define_bits_v1_jpeg(fake_jpeg(4, 4),
                                 struct.pack("<H", 34) + fake_jpeg(12, 9))
    return (b2 + b3 + sb.emit_define_bitmap(jpeg),
            [p2, quirk, p3, p4, v1, sb.image_dimensions(png),
             sb.image_dimensions(gif)])


def _placements(k):
    P = k.sb.Placement
    ct = ((0.5, 0.75, 1.0, 0.5), (0.1, 0.0, 0.2, 0.0))
    return [
        P(depth=1, character_id=3, matrix=k.rot(0.4, 1.5, 300, -200),
          color_transform=ct, ratio=0.25, name="hero", clip_depth=4),
        P(depth=2, move=True, matrix=k.mat(2.0, 0.5, 0.1, -0.3, 7, 9)),
        P(depth=3, move=True, character_id=5),
        P(depth=4, character_id=6, blend="multiply", visible=False),
        P(depth=5, character_id=6, filters=k.all_filters(), blend="add",
          visible=True, matrix=k.mat(tx=100, ty=50)),
        P(depth=6, character_id=6, blend="layer"),
        P(depth=7, character_id=3, legacy=True, matrix=k.mat(tx=40, ty=60),
          color_transform=((0.5, 1.0, 0.25, 1.0), (0.1, 0.0, 0.0, 0.0))),
        P(depth=8, character_id=3, legacy=True),
    ]


def case_place_objects(k, rng):
    sb = k.sb
    parsers = {sb.TAG_PLACE_OBJECT: sb._parse_place_object,
               sb.TAG_PLACE_OBJECT2: sb._parse_place_object2,
               sb.TAG_PLACE_OBJECT3: sb._parse_place_object3}
    blobs, parsed = [], []
    for p in _placements(k):
        blob = sb._emit_place_object2(p)
        code, body = tag_body(blob)
        blobs.append(blob)
        parsed.append((code, parsers[code](body)))
    ops = sb._emit_display_ops([sb.RemoveObject(depth=3),
                                sb.RemoveObject(depth=2, character_id=5)])
    return b"".join(blobs) + ops, parsed


def case_filter_list(k, rng):
    blob = k.sb._emit_filter_list(k.all_filters())
    return blob, k.sb._parse_filter_list(blob, 0)


def case_buttons(k, rng):
    sb = k.sb
    R = sb.ButtonRecord
    button = sb.Button(id=9, records=(
        R(character_id=2, depth=1, matrix=k.mat(), states=0x09),
        R(character_id=3, depth=2, matrix=k.rot(0.3, 1.0, 400, 0),
          states=0x06, color_transform=((0.5, 1.0, 0.25, 1.0),
                                        (0.2, 0.0, 0.2, 0.0))),
        R(character_id=2, depth=3, matrix=k.mat(tx=100, ty=100),
          states=0x02, filters=(k.filters.BlurFilter(2.0, 2.0, 1),),
          blend="screen"),
        R(character_id=3, depth=4, matrix=None, states=0x08),
    ))
    b2, p2 = _emit_parse(sb.emit_define_button2,
                         sb.parse_define_button2_tag)(button)
    # SWF1 DefineButton: records without colour transforms, then actions.
    v1 = bytearray(struct.pack("<H", 10))
    for rec in button.records[:2]:
        v1.append(rec.states)
        v1 += struct.pack("<HH", rec.character_id, rec.depth)
        w = k.bits.BitWriter()
        sb._write_matrix(w, rec.matrix)
        v1 += w.bytes()
    v1 += b"\x00\x07\x00"      # end of records, an action, ActionEnd
    slots = (None, (4, k.sound.SoundInfo(loops=2)),
             (4, k.sound.SoundInfo(in_point=100, out_point=400)),
             (4, k.sound.SoundInfo(stop=True, no_multiple=True)))
    bs = sb.emit_define_button_sound(9, slots)
    bct = ((0.5, 1.0, 0.25, 1.0), (0.2, 0.0, 0.2, 0.0))
    bc = sb.emit_define_button_cxform(9, bct)
    return (b2 + bytes(v1) + bs + bc,
            [p2, sb.parse_define_button_tag(bytes(v1)),
             sb.parse_define_button_sound_tag(tag_body(bs)[1]),
             sb.parse_define_button_cxform_tag(tag_body(bc)[1]),
             p2.state_records(0x02)])


TRI = ((0, 0), (900, 0), (-450, -900), (-450, 900))


def glyphs(k):
    a = k.ast
    tri = (a.StyleChangeRecord(move_to=k.v(0, 0), left_fill=1),
           a.EdgeRecord(delta=k.v(900, 0)),
           a.EdgeRecord(delta=k.v(-450, -900)),
           a.EdgeRecord(delta=k.v(-450, 900)))
    sq = (a.StyleChangeRecord(move_to=k.v(100, -800), left_fill=1),
          a.EdgeRecord(delta=k.v(700, 0)),
          a.EdgeRecord(delta=k.v(0, 800)),
          a.EdgeRecord(delta=k.v(-700, 0)),
          a.EdgeRecord(delta=k.v(0, -800), control_delta=k.v(-200, -400)))
    return tri, sq


def case_fonts(k, rng):
    sb = k.sb
    tri, sq = glyphs(k)
    f1 = sb.Font(id=1, glyphs=(tri, sq))
    f2 = sb.Font(id=2, glyphs=(tri, sq), name="Tri", code_table=(65, 66),
                 ascent=900, descent=200, leading=60, advances=(1000, 850))
    f3 = sb.Font(id=3, glyphs=(sq, ()), divisor=20, name="S",
                 code_table=(83, 32))
    b1, p1 = _emit_parse(sb.emit_define_font, sb.parse_define_font_tag)(f1)
    b2, p2 = _emit_parse(sb.emit_define_font2,
                         sb.parse_define_font2_tag)(f2)
    b3, p3 = _emit_parse(sb.emit_define_font2, sb.parse_define_font2_tag,
                         font3=True)(f3)
    i1 = sb.emit_define_font_info(1, "TriFont", (65, 66))
    i2 = sb.emit_define_font_info(1, "TriFont2", (97, 98), info2=True)
    return (b1 + b2 + b3 + i1 + i2,
            [p1, p2, p3, sb.parse_define_font_info_tag(tag_body(i1)[1]),
             sb.parse_define_font_info_tag(tag_body(i2)[1], info2=True),
             p2.glyph_for_code(66), p2.glyph_shape(1)])


def text_runs(k):
    T = k.sb.TextRun
    return (T(glyphs=((0, 1100), (1, -200), (0, 950)), font_id=1,
              height=2048, color=k.rgba(200, 30, 30), x_offset=100,
              y_offset=1000),
            T(glyphs=((1, 800),), color=k.rgba(1, 2, 3)),
            T(glyphs=((0, 600),), font_id=2, height=1024, x_offset=40))


def case_texts(k, rng):
    sb = k.sb
    text = sb.Text(id=5, bounds=k.ast.Rect(0, 4000, 0, 2400),
                   matrix=k.mat(1.5, 1.5, tx=300), runs=text_runs(k))
    b1, p1 = _emit_parse(sb.emit_define_text, sb.parse_define_text_tag)(text)
    text2 = dataclasses.replace(text, runs=(sb.TextRun(
        glyphs=((1, 900),), font_id=1, height=1024,
        color=k.rgba(20, 40, 220, 128), x_offset=0, y_offset=900),))
    b2, p2 = _emit_parse(lambda t: sb.emit_define_text(t, text2=True),
                         sb.parse_define_text_tag, text2=True)(text2)
    field = sb.EditText(id=6, bounds=k.ast.Rect(0, 4000, 0, 2400),
                        font_id=1, height=1024, color=k.rgba(10, 10, 10),
                        text="AB A", use_outlines=True, word_wrap=True,
                        multiline=True, align=2, left_margin=80,
                        right_margin=40, indent=20, leading=100,
                        var_name="score")
    b3, p3 = _emit_parse(sb.emit_define_edit_text,
                         sb.parse_define_edit_text_tag)(field)
    bare = sb.EditText(id=7, bounds=k.ast.Rect(-20, 200, -20, 200))
    b4, p4 = _emit_parse(sb.emit_define_edit_text,
                         sb.parse_define_edit_text_tag)(bare)
    return b1 + b2 + b3 + b4, [p1, p2, p3, p4]


def case_sprite(k, rng):
    sb, P = k.sb, k.sb.Placement
    stream = k.sound.SoundStream(format=k.sound.FORMAT_UNCOMPRESSED_LE,
                                 rate=11025, bits=16, channels=1,
                                 samples_per_frame=64)
    stream.blocks[1] = bytes(rng.integers(0, 256, 128, np.uint8))
    frames = [[P(depth=1, character_id=1, matrix=k.mat())],
              [P(depth=1, move=True, matrix=k.mat(tx=400))],
              [P(depth=2, character_id=11), sb.RemoveObject(depth=1)],
              []]
    blob = sb.emit_define_sprite(10, frames, stream)
    plain = sb.emit_define_sprite(11, frames[:2])
    return blob + plain, [sb.parse_define_sprite(tag_body(blob)[1]),
                          sb.parse_define_sprite(tag_body(plain)[1])]


def case_sounds(k, rng):
    sb, snd = k.sb, k.sound
    pcm = rng.uniform(-0.6, 0.6, (300, 2)).astype(np.float32)
    sounds = [
        snd.Sound(id=3, format=snd.FORMAT_ADPCM, rate=11025, bits=16,
                  channels=2, sample_count=300, data=snd.encode_adpcm(pcm)),
        snd.Sound(id=4, format=snd.FORMAT_UNCOMPRESSED_LE, rate=44100,
                  bits=8, channels=1, sample_count=300,
                  data=snd.encode_uncompressed(pcm[:, :1], 8)),
        snd.Sound(id=5, format=snd.FORMAT_MP3, rate=22050, bits=16,
                  channels=1, sample_count=1152,
                  data=b"\x00\x00" + bytes(rng.integers(0, 256, 40,
                                                        np.uint8))),
    ]
    out = [_emit_parse(sb.emit_define_sound, sb.parse_define_sound_tag)(s)
           for s in sounds]
    infos = [snd.SoundInfo(), snd.SoundInfo(loops=3, in_point=100,
                                            out_point=700),
             snd.SoundInfo(stop=True, no_multiple=True)]
    out += [_emit_parse(lambda i: sb.emit_start_sound(3, i),
                        sb.parse_start_sound_tag)(i) for i in infos]
    # An envelope (flag 0x08) is consumed, not modelled.
    env = struct.pack("<HB", 3, 0x08) + bytes((2,)) + bytes(16)
    streams = []
    for fmt, head2 in ((snd.FORMAT_ADPCM, None), (snd.FORMAT_MP3, None),
                       (snd.FORMAT_UNCOMPRESSED_LE, None),
                       (snd.FORMAT_ADPCM, True)):
        st = snd.SoundStream(format=fmt, rate=5512, bits=16, channels=2,
                             samples_per_frame=551)
        blob = sb.emit_sound_stream_head(st, head2)
        streams.append((blob, (tag_body(blob)[0],
                               sb.parse_sound_stream_head_tag(
                                   tag_body(blob)[1]))))
    out += streams
    return (b"".join(b for b, _ in out),
            [p for _, p in out] + [sb.parse_start_sound_tag(env)])


def case_video(k, rng):
    sb = k.sb
    f0 = rng.integers(0, 256, (23, 37, 3), np.uint8)
    f1 = f0.copy()
    f1[4:12, 6:20] = rng.integers(0, 256, (8, 14, 3), np.uint8)
    stream = sb.VideoStream(id=5, width=37, height=23, smoothing=False)
    b1, p1 = _emit_parse(sb.emit_define_video_stream,
                         sb.parse_define_video_stream_tag)(stream)
    key = k.sv.encode_screen_video_packet(f0, block=16)
    inter = k.sv.encode_screen_video_packet(f1, prev=f0, block=32)
    fr = [sb.emit_video_frame(5, i, p) for i, p in enumerate((key, inter))]
    return (b1 + b"".join(fr),
            [p1] + [sb.parse_video_frame_tag(tag_body(b)[1]) for b in fr])


def case_assets_and_labels(k, rng):
    sb = k.sb
    grid = sb.emit_define_scaling_grid(10, k.ast.Rect(800, 1200, -40, 1200))
    exp = sb.emit_export_assets({"hero": 3, "ünï": 9})
    imp = (b"lib.swf\x00" + struct.pack("<HH", 2, 3) + b"a\x00"
           + struct.pack("<H", 4) + b"bb\x00")
    imp2 = b"lib2.swf\x00" + b"\x01\x00" + struct.pack("<HH", 1, 7) + b"c\x00"
    # DefineSceneAndFrameLabelData: EncodedU32 counts and offsets (one
    # offset of 200 takes two bytes).
    scenes = (b"\x02" + b"\x00Scene 1\x00" + b"\xc8\x01Two\x00"
              + b"\x01" + b"\x05five\x00")
    return (grid + exp,
            [sb.parse_define_scaling_grid_tag(tag_body(grid)[1]),
             sb.parse_export_assets_tag(tag_body(exp)[1]),
             sb.parse_import_assets_tag(imp),
             sb.parse_import_assets_tag(imp2, assets2=True),
             sb.parse_scene_frame_label_tag(scenes)])


def case_bits(k, rng):
    bits = k.bits
    w = bits.BitWriter()
    vals = []
    for _ in range(200):
        n = int(rng.integers(1, 32))
        if rng.random() < 0.5:
            v = int(rng.integers(0, 1 << n))
            w.write_ub(v, n)
            vals.append(("u", n, v))
        else:
            v = int(rng.integers(-(1 << (n - 1)), 1 << (n - 1))) if n > 1 \
                else 0
            w.write_sb(v, n)
            vals.append(("s", n, v))
    data = w.bytes()
    r = bits.BitReader(data)
    back = [r.read_ub(n) if kind == "u" else r.read_sb(n)
            for kind, n, _ in vals]
    widths = [(bits.sbits_for(int(v), int(u)), bits.ubits_for(abs(int(v))))
              for v, u in rng.integers(-70000, 70000, (50, 2))]
    return data, [back, widths, bits.sbits_for(0), bits.ubits_for(0)]


TAG_CASES = {name[5:]: fn for name, fn in sorted(globals().items())
             if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(TAG_CASES))
def test_tag_emitters_and_parsers_agree(name):
    (bj, pj), (bt, pt) = both(TAG_CASES[name])
    assert isinstance(bt, bytes) and bt == bj
    assert to_plain(pt) == to_plain(pj)


def test_port_parsers_round_trip_their_emitters():
    """The port's parse of its own bytes emits those bytes again, and
    gives back the tag where the wire carries every field (the
    reference's round-trip pins, on the port)."""
    k = kit(PORT)
    rng = np.random.default_rng(SEED)
    blob = k.sb.emit_define_shape(k.random_shape(rng, 7))
    assert k.sb.emit_define_shape(k.sb.parse_define_shape_tag(
        tag_body(blob)[1])) == blob
    for _ in range(5):
        m = k.random_morph(rng, extended=True)
        assert k.sb.parse_define_morph_shape2_tag(tag_body(
            k.sb.emit_define_morph_shape(m, shape2=True))[1]) == m
    assert k.sb._parse_filter_list(
        k.sb._emit_filter_list(k.all_filters()), 0)[0] == k.all_filters()


# ---------------------------------------------------------------------------
# Whole movies
# ---------------------------------------------------------------------------


def kitchen_sink(k, rng):
    """One movie of every tag kind the front end emits: lossless
    bitmaps, shapes (a random one with every fill kind, rectangles),
    morphs, fonts 1-3 with text and edit text, buttons with sounds and
    a colour transform, sprites with a sound stream, a scaling grid,
    video, sounds with start events and a stream, exports, metadata and
    frame labels; five frames of PlaceObject2 / 3 and RemoveObject2."""
    sb, a, P = k.sb, k.ast, k.sb.Placement
    bitmaps = [k.lossless(rng, 50, 16, 8, "argb"),
               k.lossless(rng, 51, 5, 3, "bmp")]
    shapes = [k.random_shape(rng, 7),
              k.rect_shape(2, 800, 600, k.rgba(200, 30, 30)),
              k.rect_shape(3, 800, 600, k.rgba(10, 10, 200))]
    morphs = [k.random_morph(rng, extended=True)]
    morphs = [dataclasses.replace(morphs[0], id=40)]
    tri, sq = glyphs(k)
    fonts = [sb.Font(id=60, glyphs=(tri, sq)),
             sb.Font(id=61, glyphs=(tri, sq), name="AB",
                     code_table=(65, 66), ascent=900, descent=200,
                     leading=60, advances=(1000, 850))]
    texts = [sb.Text(id=62, bounds=a.Rect(0, 4000, 0, 2400),
                     matrix=k.mat(), runs=(sb.TextRun(
                         glyphs=((0, 1000), (1, 900)), font_id=60,
                         height=1024, color=k.rgba(20, 40, 220, 128),
                         x_offset=0, y_offset=1000),)),
             sb.EditText(id=63, bounds=a.Rect(0, 4000, 0, 2400),
                         font_id=61, height=1024, text="AB BA",
                         use_outlines=True)]
    button = sb.Button(id=70, records=(
        sb.ButtonRecord(character_id=2, depth=1, matrix=k.mat(),
                        states=0x01),
        sb.ButtonRecord(character_id=3, depth=2, matrix=k.mat(tx=400),
                        states=0x06)))
    snd = k.sound
    pcm = rng.uniform(-0.5, 0.5, (200, 1)).astype(np.float32)
    sounds = [snd.Sound(id=80, format=snd.FORMAT_ADPCM, rate=11025,
                        bits=16, channels=1, sample_count=200,
                        data=snd.encode_adpcm(pcm))]
    stream = snd.SoundStream(format=snd.FORMAT_UNCOMPRESSED_LE, rate=11025,
                             bits=16, channels=1, samples_per_frame=100)
    stream.blocks[0] = snd.encode_uncompressed(pcm[:100], 16)
    stream.blocks[2] = snd.encode_uncompressed(pcm[100:], 16)
    video = sb.VideoStream(id=90, width=20, height=12, smoothing=False)
    f0 = rng.integers(0, 256, (12, 20, 3), np.uint8)
    video.frames[0] = k.sv.encode_screen_video_packet(f0, block=16)
    sprite = (100, [[P(depth=1, character_id=2)],
                    [P(depth=1, move=True, matrix=k.mat(tx=200))]])
    frames = [
        [P(depth=1, character_id=7, matrix=k.rot(0.3, 0.5, 2000, 2000)),
         P(depth=2, character_id=40, ratio=0.25, matrix=k.mat(tx=3000)),
         P(depth=3, character_id=62, matrix=k.mat(tx=100, ty=1500)),
         P(depth=4, character_id=70, filters=k.all_filters()[:2],
           blend="multiply"),
         P(depth=5, character_id=100, clip_depth=6),
         P(depth=6, character_id=63, visible=True),
         P(depth=7, character_id=90)],
        [P(depth=1, move=True, matrix=k.rot(0.6, 0.5, 2100, 2000)),
         P(depth=2, move=True, ratio=0.5)],
        [sb.RemoveObject(depth=3), P(depth=4, move=True, character_id=3)],
        [P(depth=3, character_id=2, legacy=True)],
        [],
    ]
    return sb.emit_movie_timeline(
        frames, shapes=shapes, morphs=morphs, bitmaps=bitmaps,
        background=k.rgba(12, 34, 56), frame_rate=12.5, shape4=True,
        morph2=True, stage_rect=a.Rect(0, 9600, 0, 5400),
        sprites=[sprite], frame_labels={0: "start", 3: "end"},
        fonts=fonts, texts=texts, buttons=[button],
        button_sounds={70: (None, (80, snd.SoundInfo()), None, None)},
        button_cxforms={70: ((0.5, 1.0, 1.0, 1.0), (0.0,) * 4)},
        scaling_grids=[(100, a.Rect(20, 180, 20, 180))], videos=[video],
        sounds=sounds, sound_events={1: [(80, snd.SoundInfo(loops=2))]},
        sound_stream=stream, exports={"hero": 7},
        metadata="<rdf:RDF/>")


def test_kitchen_sink_movie_agrees_in_every_container():
    mj, mt = both(kitchen_sink)
    assert mt == mj and mt[:3] == b"FWS" and mt[3] == 8
    kj, kt = kit(JAX), kit(PORT)
    pt = kt.sb.parse_movie(mt)
    assert to_plain(pt) == to_plain(kj.sb.parse_movie(mj))
    assert len(pt.frames) == 5 and pt.frame_labels == {0: "start", 3: "end"}
    for sig in ("CWS", "ZWS"):
        ct = kt.sb.compress_movie(mt, sig)
        assert ct == kj.sb.compress_movie(mj, sig) and ct[:3] == sig.encode()
        dt = kt.sb.decompress_movie(ct)
        assert dt == kj.sb.decompress_movie(ct)
        assert dt[:3] == b"FWS" and dt[4:] == mt[4:]
        assert to_plain(kt.sb.parse_movie(ct)) == to_plain(pt)
    for fn in ("parse_movie_shapes", "parse_movie_morph_shapes",
               "parse_movie_bitmaps"):
        assert to_plain(getattr(kt.sb, fn)(mt)) == to_plain(
            getattr(kj.sb, fn)(mj))


def test_emit_movie_agrees():
    def build(k, rng):
        a = k.ast
        shapes = [k.random_shape(rng, 7, kinds=("solid", "linear")),
                  k.rect_shape(8, 400, 300, k.rgba(1, 2, 3))]
        morph = k.morph_polygon(9, 12, 500, 300, k.rgba(200, 0, 0),
                                k.rgba(0, 0, 200))
        bmp = k.lossless(rng, 50, 6, 6, "full24")
        return [k.sb.emit_movie(
            shapes, morphs=[(morph, 0.5)], bitmaps=[bmp],
            shape_matrices=[k.mat(tx=4000, ty=4000), None],
            morph_matrices=[k.rot(0.2, tx=600, ty=600)],
            shape_color_transforms=[None, ((1.0, 0.5, 0.5, 1.0),
                                           (0.0, 0.1, 0.0, 0.0))],
            shape4=s4, morph2=m2, frame_rate=30.0)
            for s4, m2 in ((False, False), (True, True))] + [
            k.sb.emit_movie([], stage_rect=a.Rect(400, 2000, 800, 1600))]

    mj, mt = both(build)
    assert mt == mj
    for j, t in zip(mj, mt):
        assert to_plain(kit(PORT).sb.parse_movie(t)) == to_plain(
            kit(JAX).sb.parse_movie(j))


def test_random_timelines_parse_alike():
    """tests/test_swf_binary.py::test_timeline_fuzz_against_state_oracle
    on shapes built in code: random place / move-modify / move-replace /
    remove sequences parse to the same snapshots in both packages."""
    def build(k, rng):
        sb = k.sb
        tags = [k.rect_shape(1, 300, 300, k.rgba(9, 9, 9)),
                k.rect_shape(2, 200, 500, k.rgba(90, 9, 9))]
        movies = []
        for _ in range(12):
            frames, live = [], set()
            for _f in range(int(rng.integers(1, 6))):
                ops = []
                for _o in range(int(rng.integers(0, 4))):
                    depth = int(rng.integers(1, 4))
                    kind = rng.random()
                    matrix = (None if rng.random() < 0.5 else k.mat(
                        tx=int(rng.integers(-2000, 2000)),
                        ty=int(rng.integers(-2000, 2000))))
                    ratio = (None if rng.random() < 0.7
                             else int(rng.integers(0, 65536)) / 65536.0)
                    if kind < 0.35 and depth not in live:
                        ops.append(sb.Placement(
                            depth=depth, character_id=int(
                                rng.integers(1, 3)), matrix=matrix,
                            ratio=ratio))
                        live.add(depth)
                    elif kind < 0.7 and depth in live:
                        cid = (None if rng.random() < 0.6
                               else int(rng.integers(1, 3)))
                        ops.append(sb.Placement(
                            depth=depth, character_id=cid, matrix=matrix,
                            ratio=ratio, move=True))
                    elif kind >= 0.7 and depth in live:
                        ops.append(sb.RemoveObject(depth=depth))
                        live.discard(depth)
                frames.append(ops)
            movies.append(sb.emit_movie_timeline(
                frames, shapes=tags,
                stage_rect=k.ast.Rect(0, 4000, 0, 4000)))
        return movies

    mj, mt = both(build)
    assert mt == mj
    for j, t in zip(mj, mt):
        assert to_plain(kit(PORT).sb.parse_movie(t)) == to_plain(
            kit(JAX).sb.parse_movie(j))


def _refusals(k):
    """Each refusal as (exception type name, message) or None."""
    sb, a, P = k.sb, k.ast, k.sb.Placement

    def grab(fn):
        try:
            fn()
        except Exception as exc:  # the types are compared
            return type(exc).__name__, str(exc)
        return None

    shape = k.rect_shape(3, 400, 400, k.rgba(10, 20, 200))
    bad_remove = sb.emit_movie_timeline(
        [[P(depth=1, character_id=3, legacy=True)],
         [sb.RemoveObject(depth=1, character_id=9)]], shapes=[shape])
    move_empty = sb.emit_movie_timeline(
        [[P(depth=1, ratio=0.5, move=True)]],
        stage_rect=a.Rect(0, 200, 0, 200))
    occupied = sb.emit_movie_timeline(
        [[P(depth=1, character_id=3), P(depth=1, character_id=3)]],
        shapes=[shape])
    sprite_define = sb._tag(sb.TAG_DEFINE_SPRITE, struct.pack(
        "<HH", 5, 1) + sb.emit_define_shape(shape) + sb._tag(0, b""))
    return [
        grab(lambda: sb.parse_movie_shapes(b"XWS" + b"\x00" * 16)),
        grab(lambda: sb.compress_movie(b"XWS" + b"\x00" * 16)),
        grab(lambda: sb.compress_movie(b"FWS\x06" + b"\x00" * 16, "QWS")),
        grab(lambda: sb.parse_movie(b"XWS" + b"\x00" * 16)),
        grab(lambda: sb._emit_place_object2(P(depth=1))),
        grab(lambda: sb.parse_movie(bad_remove)),
        grab(lambda: sb.parse_movie(move_empty)),
        grab(lambda: sb.parse_movie(occupied)),
        grab(lambda: sb.parse_define_sprite(tag_body(sprite_define)[1])),
        grab(lambda: sb.emit_define_bits_lossless(a.DefineBitmap(
            id=1, width=2, height=2, media_type="image/png",
            data=b"\x89PNG"))),
        grab(lambda: sb.emit_define_bits_lossless(a.DefineBitmap(
            id=1, width=9, height=9, media_type="image/x-swf-bmp",
            data=b"\x03\x02\x00\x02\x00\x00"))),
        grab(lambda: sb.emit_define_bits_jpeg2(a.DefineBitmap(
            id=1, width=9, height=9, media_type="image/jpeg",
            data=fake_jpeg(8, 8)))),
        grab(lambda: sb.image_dimensions(b"\xff\xd8\xff\xd9")),
        grab(lambda: sb.image_dimensions(b"BM\x00\x00")),
        grab(lambda: sb.emit_define_button_cxform(
            9, ((1.0, 1.0, 1.0, 0.5), (0.0,) * 4))),
        grab(lambda: sb.emit_define_button_sound(9, ((0, None),) * 4)),
        grab(lambda: sb._emit_filter_list(("blur",))),
        grab(lambda: sb._emit_place_object2(P(depth=1, character_id=2,
                                               blend="nope"))),
        grab(lambda: sb._parse_place_object2(b"\x80\x01\x00")),
        grab(lambda: sb.parse_define_bits_lossless_tag(b"\x01\x00\x07"
                                                       + bytes(5))),
    ]


def test_refusals_agree():
    rj, rt = both(lambda k, rng: _refusals(k))
    assert all(r is not None for r in rt), rt
    assert rt == rj


# ---------------------------------------------------------------------------
# convert.to_plain
# ---------------------------------------------------------------------------


def test_to_plain_tells_trees_apart_and_keeps_float_bits():
    k = kit(PORT)
    a = k.ast
    one = k.rect_shape(1, 100, 100, k.rgba(1, 2, 3))
    assert to_plain(one) == to_plain(k.rect_shape(1, 100, 100,
                                                  k.rgba(1, 2, 3)))
    # A field, a class, a container kind, an array's dtype, shape or
    # bytes: each makes a different form.
    assert to_plain(one) != to_plain(k.rect_shape(1, 100, 100,
                                                  k.rgba(1, 2, 4)))
    assert to_plain(a.Vector2D(1, 2)) != to_plain(k.v(2, 1))
    assert to_plain(k.sb.RemoveObject(depth=1)) != to_plain(
        k.sb.Placement(depth=1))
    assert to_plain((1, 2)) != to_plain([1, 2])
    x = np.arange(6, dtype=np.float32)
    assert to_plain(x) != to_plain(x.astype(np.float64))
    assert to_plain(x) != to_plain(x.reshape(2, 3))
    assert to_plain(x) != to_plain(x[::-1].copy())
    assert to_plain({1: "a"}) != to_plain({1: "b"})
    assert to_plain(a.GradientSpread.PAD) != to_plain(a.GradientSpread.REPEAT)
    # Floats compare by their bits: NaN equals itself, -0.0 is not 0.0.
    nan = float("nan")
    assert to_plain(nan) == to_plain(float("nan"))
    assert to_plain(-0.0) != to_plain(0.0)
    assert to_plain((0.1 + 0.2,)) != to_plain((0.3,))
    assert to_plain(np.float32(-0.0)) != to_plain(np.float32(0.0))
    assert to_plain(np.array([nan, -0.0])) == to_plain(np.array([nan, -0.0]))
    assert to_plain(np.array([-0.0])) != to_plain(np.array([0.0]))
    # A compare=False cache is no part of the tree (Font._shape_defs).
    tri, sq = glyphs(k)
    f = k.sb.Font(id=1, glyphs=(tri, sq))
    before = to_plain(f)
    f.glyph_shape(0)
    assert to_plain(f) == before
    with pytest.raises(TypeError, match="no plain form"):
        to_plain(object())
