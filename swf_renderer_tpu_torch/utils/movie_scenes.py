"""SWF movies built in code, each with the stages it should load to.

Each builder takes a namespace of one package's modules (``ast``,
``fixed`` — the ``Sfixed16P16`` class —, ``sb`` — ``models.swf_binary``
—, ``display`` and ``bmp`` — ``runtime.bitmap_service``), so the same
movie and the same hand-built stages come out of this package and of
any other with those modules; random content is drawn from
``np.random.default_rng(seed)`` in a fixed order.  The frame RECT is
whole pixels, so a timeline stays eligible for the sweep routes.

- ``anim_movie``: 8 DefineShape3 polygons and stars (16-48 edges, some
  curved; 6 solid fills, 2 linear gradients) placed by PlaceObject2 at 8
  depths and moved every frame by PlaceFlagMove (rotation and
  translation); the top one fades through its colour transform.
- ``morph_movie``: one fills-only DefineMorphShape2 (24-edge start and
  end outlines) at 3 depths, its ratio track running 0 to 65535 while the
  matrices move.
- ``still_movie``: one frame of SetBackgroundColor, a DefineBitsLossless2
  bitmap fill under a rotated matrix, a DefineSprite of two shapes under
  a colour transform, a sprite with DefineScalingGrid under a
  non-uniform scale, and a DefineFont2 + DefineText line of glyphs.
- ``sound_movie``: ``morph_movie``'s timeline at 24 fps with a
  soundtrack: an MP3 SoundStreamHead / SoundStreamBlock stream (MPEG-1
  Layer III, 44.1 kHz, joint stereo, one block a frame), an ADPCM and an
  MP3 DefineSound at 22.05 kHz (the MP3 one's frames at 24 kHz), their
  StartSounds (one with in / out points and loops, one stop).

``mp3_frames`` / ``mp3_stream`` make the MP3 bytes: valid Layer III
frame headers, side information drawn field by field, and seeded main
data (no recorded audio; the decoder reads whatever the bits say).
"""

from __future__ import annotations

import importlib
import math
import types

import numpy as np


def port_mods():
    """This package's modules in the namespace the builders take."""
    def mod(name):
        return importlib.import_module(f"{__package__.rsplit('.', 1)[0]}."
                                       f"{name}")

    return types.SimpleNamespace(
        ast=mod("models.ast"), fixed=mod("utils.fixed").Sfixed16P16,
        sb=mod("models.swf_binary"), display=mod("models.display"),
        bmp=mod("runtime.bitmap_service"), sound=mod("models.sound"))


def _matrix(m, sx=1.0, sy=1.0, r0=0.0, r1=0.0, tx=0, ty=0):
    f = m.fixed.from_value
    return m.ast.Matrix(scale_x=f(sx), scale_y=f(sy), rotate_skew0=f(r0),
                        rotate_skew1=f(r1), translate_x=int(round(tx)),
                        translate_y=int(round(ty)))


def _rotation(m, th, s, tx, ty):
    c, n = math.cos(th) * s, math.sin(th) * s
    return _matrix(m, c, c, n, -n, tx, ty)


def _rgba(m, r, g, b, a=255):
    return m.ast.StraightSRgba8(int(r), int(g), int(b), int(a))


def _outline(m, rng, n, radius, star, curved):
    """Edge records of a closed ``n``-gon (or star) centred on the
    origin, a share ``curved`` of its edges quadratic."""
    a = m.ast
    pts = []
    for i in range(n):
        th = 2 * math.pi * i / n
        r = radius * (0.55 if star and i % 2 else 1.0)
        pts.append((int(round(r * math.cos(th))),
                    int(round(r * math.sin(th)))))
    recs = [a.StyleChangeRecord(move_to=a.Vector2D(*pts[0]), left_fill=1)]
    for i in range(n):
        x0, y0 = pts[i]
        x1, y1 = pts[(i + 1) % n]
        if rng.random() < curved:
            mx, my = (x0 + x1) // 2, (y0 + y1) // 2
            cdx = mx + int(round(mx * 0.12)) - x0
            cdy = my + int(round(my * 0.12)) - y0
            recs.append(a.EdgeRecord(
                delta=a.Vector2D(x1 - x0 - cdx, y1 - y0 - cdy),
                control_delta=a.Vector2D(cdx, cdy)))
        else:
            recs.append(a.EdgeRecord(delta=a.Vector2D(x1 - x0, y1 - y0)))
    return tuple(recs)


def _shape(m, sid, records, fill, half):
    a = m.ast
    return a.DefineShape(
        id=sid, bounds=a.Rect(-half, half, -half, half),
        shape=a.ShapeBody(initial_styles=a.ShapeStyles(fill=(fill,),
                                                        line=()),
                          records=records))


def _stage(m, width, height, background, children):
    return m.display.Stage(width=width, height=height,
                           background_color=background,
                           children=tuple(children),
                           exact_width=float(width),
                           exact_height=float(height))


def anim_movie(m, width, height, frames=60, seed=11):
    """(movie bytes, the ``frames`` stages it loads to)."""
    a, sb, P = m.ast, m.sb, m.sb.Placement
    rng = np.random.default_rng(seed)
    tw, th = width * 20, height * 20
    base = min(tw, th)
    shapes = []
    for i in range(8):
        radius = int(base * rng.uniform(0.08, 0.16))
        recs = _outline(m, rng, int(rng.integers(8, 25)) * 2, radius,
                        star=i % 2 == 1, curved=0.3)
        if i < 6:
            fill = a.SolidFill(color=_rgba(m, *rng.integers(30, 256, 3),
                                           int(rng.integers(160, 256))))
        else:
            s = radius * 2 / 32768
            fill = a.LinearGradientFill(
                matrix=_rotation(m, float(rng.uniform(0, math.pi)), s, 0, 0),
                gradient=a.Gradient(
                    spread=a.GradientSpread.PAD,
                    color_space=a.ColorSpace.S_RGB,
                    colors=tuple(a.GradientStop(
                        ratio=r, color=_rgba(m, *rng.integers(0, 256, 3)))
                        for r in (0, 128, 255))))
        shapes.append(_shape(m, 10 + i, recs, fill, radius + 20))
    starts = rng.uniform(0.2, 0.8, (8, 2)) * (tw, th)
    vel = rng.uniform(-0.004, 0.004, (8, 2)) * (tw, th)
    spin = rng.uniform(-0.08, 0.08, 8)
    scale = rng.uniform(0.7, 1.3, 8)
    background = _rgba(m, 250, 246, 235)

    def mat(i, f):
        x, y = starts[i] + vel[i] * f
        return _rotation(m, float(spin[i] * f), float(scale[i]), x, y)

    def fade(f):   # alpha multiplier k / 256, exact on the wire
        k = 256 - int(round(200 * f / max(frames - 1, 1)))
        return ((1.0, 1.0, 1.0, k / 256.0), (0.0, 0.0, 0.0, 0.0))

    ops, stages = [], []
    for f in range(frames):
        if f == 0:
            ops.append([P(depth=i + 1, character_id=s.id, matrix=mat(i, 0),
                          color_transform=fade(0) if i == 7 else None)
                        for i, s in enumerate(shapes)])
        else:
            ops.append([P(depth=i + 1, move=True, matrix=mat(i, f),
                          color_transform=fade(f) if i == 7 else None)
                        for i in range(8)])
        stages.append(_stage(m, width, height, background, [
            m.display.ShapeInstance(
                definition=s, matrix=mat(i, f),
                color_transform=(m.display.ColorTransform(*fade(f))
                                 if i == 7 else None))
            for i, s in enumerate(shapes)]))
    movie = sb.emit_movie_timeline(
        ops, shapes=shapes, background=background, frame_rate=30.0,
        stage_rect=a.Rect(0, tw, 0, th))
    return movie, stages


def _morph_outline(m, n, r0, r1):
    a = m.ast

    def pts(r, turn, squash):
        return [(int(round(r * math.cos(2 * math.pi * (i + turn) / n))),
                 int(round(r * squash
                           * math.sin(2 * math.pi * (i + turn) / n))))
                for i in range(n)]

    p0, p1 = pts(r0, 0.0, 1.0), pts(r1, 0.5, 0.6)
    recs = [a.MorphStyleChangeRecord(move_to=a.Vector2D(*p0[0]),
                                     morph_move_to=a.Vector2D(*p1[0]),
                                     left_fill=1)]
    for i in range(n):
        j = (i + 1) % n
        recs.append(a.MorphEdgeRecord(
            delta=a.Vector2D(p0[j][0] - p0[i][0], p0[j][1] - p0[i][1]),
            morph_delta=a.Vector2D(p1[j][0] - p1[i][0],
                                   p1[j][1] - p1[i][1])))
    return tuple(recs)


def _morph_timeline(m, width, height, frames, seed):
    """-> (the morph tag, the per-frame ops, the stages, the background,
    the frame RECT) of ``morph_movie``."""
    a, P = m.ast, m.sb.Placement
    rng = np.random.default_rng(seed)
    tw, th = width * 20, height * 20
    r0, r1 = int(min(tw, th) * 0.22), int(min(tw, th) * 0.3)
    half = max(r0, r1) + 20
    tag = a.DefineMorphShape(
        id=5, bounds=a.Rect(-half, half, -half, half),
        morph_bounds=a.Rect(-half, half, -half, half),
        shape=a.MorphShapeBody(
            initial_styles=a.MorphShapeStyles(
                fill=(a.MorphSolidFill(color=_rgba(m, 220, 40, 40),
                                       morph_color=_rgba(m, 40, 60, 220,
                                                         200)),),
                line=()),
            records=_morph_outline(m, 24, r0, r1)))
    starts = rng.uniform(0.3, 0.7, (3, 2)) * (tw, th)
    vel = rng.uniform(-0.01, 0.01, (3, 2)) * (tw, th)
    scale = (1.0, 0.6, 0.35)
    background = _rgba(m, 255, 255, 255)

    def mat(i, f):
        x, y = starts[i] + vel[i] * f
        return _rotation(m, 0.05 * f * (i + 1), scale[i], x, y)

    def ratio(f):   # u16 / 65536, exact on the wire; 0 .. 65535
        return int(round(65535 * f / max(frames - 1, 1))) / 65536.0

    ops, stages = [], []
    for f in range(frames):
        ops.append([P(depth=i + 1, character_id=None if f else 5,
                      move=f > 0, matrix=mat(i, f), ratio=ratio(f))
                    for i in range(3)])
        stages.append(_stage(m, width, height, background, [
            m.display.MorphShapeInstance(definition=tag, ratio=ratio(f),
                                         matrix=mat(i, f))
            for i in range(3)]))
    return tag, ops, stages, background, a.Rect(0, tw, 0, th)


def morph_movie(m, width, height, frames=16, seed=12):
    """(movie bytes, the ``frames`` stages it loads to)."""
    tag, ops, stages, background, rect = _morph_timeline(m, width, height,
                                                         frames, seed)
    movie = m.sb.emit_movie_timeline(
        ops, morphs=[tag], background=background, frame_rate=30.0,
        morph2=True, stage_rect=rect)
    return movie, stages


# The Huffman tables a Layer III encoder may select (4 and 14 are unused).
_MP3_TABLES = tuple(t for t in range(32) if t not in (4, 14))


def _side_info(rng, lsf, nch, main_data_begin, part2_3):
    """One frame's side information, every field drawn from ``rng`` but
    ``main_data_begin`` and the granules' ``part2_3`` bit lengths."""
    fields = [(main_data_begin, 8 if lsf else 9)]
    fields.append((0, (1 if nch == 1 else 2) if lsf else
                   (5 if nch == 1 else 3)))
    if not lsf:
        fields += [(int(rng.integers(0, 2)), 1) for _ in range(4 * nch)]
    for length in part2_3:
        fields += [(length, 12), (int(rng.integers(0, 289)), 9),
                   (int(rng.integers(100, 161)), 8),
                   (int(rng.integers(0, 512 if lsf else 16)),
                    9 if lsf else 4)]
        if rng.random() < 0.3:            # window switching
            block_type = int(rng.integers(1, 4))
            fields += [(1, 1), (block_type, 2),
                       (int(block_type == 2 and rng.random() < 0.3), 1)]
            fields += [(int(rng.choice(_MP3_TABLES)), 5) for _ in range(2)]
            fields += [(int(rng.integers(0, 8)), 3) for _ in range(3)]
        else:
            fields += [(0, 1)]
            fields += [(int(rng.choice(_MP3_TABLES)), 5) for _ in range(3)]
            fields += [(int(rng.integers(0, 16)), 4),
                       (int(rng.integers(0, 8)), 3)]
        fields += [(int(rng.integers(0, 2)), 1)
                   for _ in range(2 if lsf else 3)]
    acc, nbits = 0, 0
    for value, width in fields:
        acc = (acc << width) | value
        nbits += width
    return acc.to_bytes(nbits // 8, "big")


def mp3_frames(n, version=3, mode=1, crc=False, bitrate_index=9,
               rate_index=0, seed=0):
    """``n`` MPEG Layer III frames of one stream, as a list of bytes:
    ``version`` 3 / 2 / 0 (MPEG-1 / 2 / 2.5), ``mode`` 0 stereo, 1 joint
    (each frame's mode extension drawn), 2 dual, 3 mono; ``crc`` adds the
    16-bit check word (drawn, as the decoder reads none).  Each frame's
    main data are seeded bytes; ``main_data_begin`` reaches back into the
    previous frames' main data (the bit reservoir) from the second frame
    on, and the granules' bit budgets split what it can reach."""
    from ..models import mp3

    rng = np.random.default_rng(seed)
    lsf = version != 3
    nch = 1 if mode == 3 else 2
    ngran = 1 if lsf else 2
    side_len = (9 if nch == 1 else 17) if lsf else (17 if nch == 1 else 32)
    kbps = (mp3.BITRATES_V2 if lsf else mp3.BITRATES_V1)[bitrate_index]
    rate = mp3._SR_BASE[version][rate_index]
    out, prev_main = [], 0
    for _ in range(n):
        padding = int(rng.integers(0, 2))
        frame_bytes = (72 if lsf else 144) * kbps * 1000 // rate + padding
        header = bytes((0xFF, 0xE0 | version << 3 | 1 << 1 | int(not crc),
                        bitrate_index << 4 | rate_index << 2 | padding << 1,
                        mode << 6 | int(rng.integers(0, 4)) << 4 | 0x4))
        main = frame_bytes - 4 - 2 * crc - side_len
        begin = int(rng.integers(0, min(prev_main, 255 if lsf else 511)
                                 + 1))
        budget = (begin + main) * 8
        cuts = np.sort(rng.integers(0, budget + 1, ngran * nch))
        part2_3 = [min(int(b - a), 4095)
                   for a, b in zip(np.concatenate([[0], cuts[:-1]]), cuts)]
        frame = (header + (rng.bytes(2) if crc else b"")
                 + _side_info(rng, lsf, nch, begin, part2_3)
                 + rng.bytes(main))
        assert len(frame) == frame_bytes
        out.append(frame)
        prev_main = main
    return out


def mp3_stream(n, id3=False, seed=0, **kw):
    """``mp3_frames`` joined, after a 10-byte ID3v2 header and its
    seeded body when ``id3``."""
    frames = b"".join(mp3_frames(n, seed=seed, **kw))
    if not id3:
        return frames
    size = 37 + seed % 64
    head = b"ID3\x03\x00\x00" + bytes(
        (size >> 21 & 0x7F, size >> 14 & 0x7F, size >> 7 & 0x7F,
         size & 0x7F))
    return head + np.random.default_rng(seed).bytes(size) + frames


SOUND_FPS = 24.0


def sound_movie(m, width, height, frames=60, seed=14):
    """(movie bytes, the ``frames`` stages it loads to): ``morph_movie``'s
    timeline at ``SOUND_FPS`` with a soundtrack (the module docstring).
    The stream's blocks hold the MPEG frames that cover their timeline
    frame (1837.5 samples a frame at 44.1 kHz, 1152 an MPEG frame); the
    first block skips 576 samples (SeekSamples)."""
    snd, sb = m.sound, m.sb
    rng = np.random.default_rng(seed)
    tag, ops, stages, background, rect = _morph_timeline(
        m, width, height, frames, seed)
    spf = 44100 / SOUND_FPS
    ends = [int(math.ceil((f + 1) * spf / 1152)) for f in range(frames)]
    mpeg = mp3_frames(ends[-1], version=3, mode=1, seed=seed + 1)
    stream = snd.SoundStream(format=snd.FORMAT_MP3, rate=44100, bits=16,
                             channels=2, samples_per_frame=int(round(spf)))
    start = 0
    for f, end in enumerate(ends):
        stream.blocks[f] = ((end - start) * 1152).to_bytes(2, "little") \
            + (576 if f == 0 else 0).to_bytes(2, "little", signed=True) \
            + b"".join(mpeg[start:end])
        start = end
    t = np.arange(8820) / 22050.0
    tone = (0.4 * np.sin(2 * np.pi * 330.0 * t)
            + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
    adpcm = snd.Sound(id=30, format=snd.FORMAT_ADPCM, rate=22050, bits=16,
                      channels=1, sample_count=tone.shape[0],
                      data=snd.encode_adpcm(tone))
    # 24 MPEG-2 frames at 24 kHz (576 samples each), declared 22.05 kHz:
    # decode_sound resamples them to 22.05 kHz, the mixer to 44.1 kHz.
    mp3 = snd.Sound(id=31, format=snd.FORMAT_MP3, rate=22050, bits=16,
                    channels=1, sample_count=12000,
                    data=(100).to_bytes(2, "little", signed=True)
                    + mp3_stream(24, version=2, mode=3, rate_index=1,
                                 bitrate_index=8, seed=seed + 2))
    info = snd.SoundInfo
    at = (0, max(1, frames // 6), max(2, frames // 3),
          max(3, 2 * frames // 3))
    events = {at[0]: [(30, info())],
              at[1]: [(31, info())],
              at[2]: [(30, info(in_point=500, out_point=4000, loops=3))],
              at[3]: [(31, info(stop=True))]}
    movie = sb.emit_movie_timeline(
        ops, morphs=[tag], background=background, frame_rate=SOUND_FPS,
        morph2=True, stage_rect=rect, sounds=(adpcm, mp3),
        sound_events=events, sound_stream=stream)
    return movie, stages


def _glyphs(m, em=1024):
    a = m.ast
    tri = (a.StyleChangeRecord(move_to=a.Vector2D(0, 0), left_fill=1),
           a.EdgeRecord(delta=a.Vector2D(900, 0)),
           a.EdgeRecord(delta=a.Vector2D(-450, -900)),
           a.EdgeRecord(delta=a.Vector2D(-450, 900)))
    sq = (a.StyleChangeRecord(move_to=a.Vector2D(100, -800), left_fill=1),
          a.EdgeRecord(delta=a.Vector2D(700, 0)),
          a.EdgeRecord(delta=a.Vector2D(0, 800)),
          a.EdgeRecord(delta=a.Vector2D(-700, 0)),
          a.EdgeRecord(delta=a.Vector2D(0, -800),
                       control_delta=a.Vector2D(-200, -400)))
    ring = _outline(m, np.random.default_rng(0), 12, 420, False, 1.0)
    ring = (a.StyleChangeRecord(move_to=a.Vector2D(ring[0].move_to.x + 450,
                                                   ring[0].move_to.y - 450),
                                left_fill=1),) + ring[1:]
    return tri, sq, ring


def still_movie(m, width, height, seed=13, texture=64):
    """(movie bytes, the stage its one frame loads to, the bitmaps)."""
    a, sb, P, d = m.ast, m.sb, m.sb.Placement, m.display
    rng = np.random.default_rng(seed)
    tw, th = width * 20, height * 20
    u = min(tw, th) / 100.0     # one hundredth of the short side, twips
    background = _rgba(m, 236, 242, 250)
    # The bitmap: random straight RGBA texels (partly translucent).
    texels = rng.integers(0, 256, (texture, texture, 4), np.uint8)
    texels[..., 3] = np.where(texels[..., 3] < 64, 255, texels[..., 3])
    bitmap = a.DefineBitmap(
        id=40, width=texture, height=texture,
        media_type="image/x-swf-bmp2",
        data=m.bmp.encode_x_swf_bmp2_argb(texels))
    side = int(36 * u)
    fill_scale = side / texture / 2.0      # the texture tiles twice
    tex_fill = a.BitmapFill(
        bitmap_id=40, matrix=_rotation(m, 0.5, fill_scale, 0, 0),
        repeating=True, smoothed=True)
    tex_recs = (a.StyleChangeRecord(move_to=a.Vector2D(0, 0), left_fill=1),
                a.EdgeRecord(delta=a.Vector2D(side, 0)),
                a.EdgeRecord(delta=a.Vector2D(0, side)),
                a.EdgeRecord(delta=a.Vector2D(-side, 0)),
                a.EdgeRecord(delta=a.Vector2D(0, -side)))
    textured = a.DefineShape(
        id=41, bounds=a.Rect(0, side, 0, side),
        shape=a.ShapeBody(initial_styles=a.ShapeStyles(fill=(tex_fill,),
                                                        line=()),
                          records=tex_recs))
    r = int(9 * u)
    star = _shape(m, 42, _outline(m, rng, 20, r, True, 0.3),
                  a.SolidFill(color=_rgba(m, 230, 120, 20)), r + 20)
    disc = _shape(m, 43, _outline(m, rng, 32, r, False, 0.5),
                  a.SolidFill(color=_rgba(m, 30, 140, 90, 200)), r + 20)
    g = int(10 * u)
    panel = a.DefineShape(
        id=44, bounds=a.Rect(0, 3 * g, 0, 3 * g),
        shape=a.ShapeBody(
            initial_styles=a.ShapeStyles(
                fill=(a.SolidFill(color=_rgba(m, 60, 60, 170)),), line=()),
            records=(a.StyleChangeRecord(move_to=a.Vector2D(0, 0),
                                         left_fill=1),
                     a.EdgeRecord(delta=a.Vector2D(3 * g, 0)),
                     a.EdgeRecord(delta=a.Vector2D(0, 3 * g)),
                     a.EdgeRecord(delta=a.Vector2D(-3 * g, 0)),
                     a.EdgeRecord(delta=a.Vector2D(0, -3 * g),
                                  control_delta=a.Vector2D(-g, -g)))))
    tri, sq, ring = _glyphs(m)
    font = sb.Font(id=50, glyphs=(tri, sq, ring), name="TSR",
                   code_table=(84, 83, 82), ascent=900, descent=200,
                   leading=60, advances=(1000, 900, 1000))
    height_tw = int(12 * u)
    adv = int(height_tw * 1.05)
    ink = _rgba(m, 20, 30, 60)
    run = sb.TextRun(glyphs=tuple((i % 3, adv) for i in range(7)),
                     font_id=50, height=height_tw, color=ink,
                     x_offset=0, y_offset=height_tw)
    text = sb.Text(id=51, bounds=a.Rect(0, 8 * adv, 0, 2 * height_tw),
                   matrix=_matrix(m), runs=(run,))
    sprite_frames = [[P(depth=1, character_id=42, matrix=_matrix(
        m, tx=r, ty=r)), P(depth=2, character_id=43, matrix=_matrix(
            m, tx=2.2 * r, ty=1.4 * r))]]
    grid_frames = [[P(depth=1, character_id=44)]]
    grid_rect = a.Rect(g, 2 * g, g, 2 * g)
    tint = ((0.75, 1.0, 0.5, 1.0), (0.2, 0.0, 0.0, 0.0))
    m_tex = _rotation(m, -0.35, 1.0, 8 * u, 30 * u)
    m_sprite = _matrix(m, tx=55 * u, ty=8 * u)
    m_grid = _matrix(m, 2.0, 0.75, tx=100 * u, ty=55 * u)
    m_text = _matrix(m, tx=8 * u, ty=68 * u)
    movie = sb.emit_movie_timeline(
        [[P(depth=1, character_id=41, matrix=m_tex),
          P(depth=2, character_id=60, matrix=m_sprite,
            color_transform=tint),
          P(depth=3, character_id=61, matrix=m_grid),
          P(depth=4, character_id=51, matrix=m_text)]],
        shapes=[textured, star, disc, panel], bitmaps=[bitmap],
        sprites=[(60, sprite_frames), (61, grid_frames)],
        scaling_grids=[(61, grid_rect)], fonts=[font], texts=[text],
        background=background, frame_rate=30.0,
        stage_rect=a.Rect(0, tw, 0, th))
    glyph_children = []
    x = 0
    scale = m.fixed.from_value(height_tw / 1024.0)
    zero = m.fixed.from_value(0)
    tint_ink = d.ColorTransform(mult=(ink.r / 255.0, ink.g / 255.0,
                                      ink.b / 255.0, ink.a / 255.0))
    for gi, step in run.glyphs:
        glyph_children.append(d.ShapeInstance(
            definition=font.glyph_shape(gi),
            matrix=a.Matrix(scale_x=scale, scale_y=scale, rotate_skew0=zero,
                            rotate_skew1=zero, translate_x=x,
                            translate_y=height_tw),
            color_transform=tint_ink))
        x += step
    children = [
        d.ShapeInstance(definition=textured, matrix=m_tex),
        d.Container(children=tuple(
            d.ShapeInstance(definition=s, matrix=p.matrix)
            for s, p in zip((star, disc), sprite_frames[0])),
            matrix=m_sprite, color_transform=d.ColorTransform(*tint)),
        d.ScaleGridGroup(children=(d.ShapeInstance(definition=panel),),
                         grid=(float(g), float(g), float(2 * g),
                               float(2 * g)),
                         bounds=(0.0, 0.0, float(3 * g), float(3 * g)),
                         matrix=m_grid),
        d.Container(children=(d.Container(children=tuple(glyph_children),
                                          matrix=text.matrix),),
                    matrix=m_text),
    ]
    return movie, _stage(m, width, height, background, children), [bitmap]
