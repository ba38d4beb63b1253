"""Movie loading: a ``.swf`` file (FWS, zlib CWS, or LZMA ZWS) -> Stage
-> pixels.

The reverse of ``models.swf_binary.emit_movie`` and a capability the
reference never had — its entry points deserialize ``ast.json`` tags only
(reference ts/src/main/main.ts:1-10 is an unimplemented stub;
rs/bin/src/main.rs:16-19 reads one DefineShape from JSON).  Here a real
Flash movie file round-trips: the define tags become definitions, the
first frame's PlaceObject2 records become display objects (matrix, morph
ratio, color transform), SetBackgroundColor becomes the stage clear color,
and the header frame RECT fixes the raster size the way the player does
(``ceil(twips / 20)``, exact fractional extent kept for stage clipping).
"""

from __future__ import annotations

import math
import pathlib
from typing import List, Tuple, Union

import numpy as np

from ..models import ast, display
from ..models.swf_binary import Movie, parse_movie  # noqa: F401

MovieSource = Union[bytes, str, pathlib.Path]


def _movie_bytes(src: MovieSource) -> bytes:
    if isinstance(src, bytes):
        return src
    return pathlib.Path(src).read_bytes()


def _placement_child(p, movie: Movie, frame_idx: int = 0,
                     button_bit: int = 0x01) -> display.DisplayObject:
    ct = None
    if p.color_transform is not None:
        ct = display.ColorTransform(mult=tuple(p.color_transform[0]),
                                    add=tuple(p.color_transform[1]))
    blend = getattr(p, "blend", None)
    filters = tuple(getattr(p, "filters", ()) or ())
    if p.character_id in movie.shapes:
        return display.ShapeInstance(
            definition=movie.shapes[p.character_id], matrix=p.matrix,
            color_transform=ct, blend_mode=blend, filters=filters)
    if p.character_id in movie.morph_shapes:
        return display.MorphShapeInstance(
            definition=movie.morph_shapes[p.character_id],
            ratio=float(p.ratio or 0.0), matrix=p.matrix,
            color_transform=ct, blend_mode=blend, filters=filters)
    if p.character_id in movie.texts:
        return _text_container(movie, movie.texts[p.character_id],
                               p.matrix, ct, blend, filters)
    if p.character_id in movie.edit_texts:
        return _edit_text_container(
            movie, movie.edit_texts[p.character_id], p.matrix, ct, blend,
            filters)
    if p.character_id in movie.buttons:
        # Buttons render one selected state (UP unless the loader asked
        # for over/down/hit) — records become a depth-ordered container
        # (interactivity is out of scope).  SWF8 per-record filter and
        # blend trailers ride the record's Placement like PlaceObject3.
        from ..models.swf_binary import Placement

        button = movie.buttons[p.character_id]
        identity_ct = ((1.0,) * 4, (0.0,) * 4)
        children = tuple(
            _placement_child(Placement(
                depth=rec.depth, character_id=rec.character_id,
                matrix=rec.matrix,
                color_transform=(rec.color_transform
                                 if rec.color_transform not in
                                 (None, identity_ct) else None),
                blend=rec.blend, filters=tuple(rec.filters)),
                movie, frame_idx, button_bit)
            for rec in sorted(button.state_records(button_bit),
                              key=lambda r: r.depth))
        bct = movie.button_cxforms.get(p.character_id)
        if bct is not None and bct != identity_ct:
            # DefineButtonCxform tints the button's records; it nests
            # INSIDE the placement's own transform (Flash composition
            # semantics — same nesting as sprite-internal cts).
            children = (display.Container(
                children=children,
                color_transform=display.ColorTransform(
                    mult=tuple(bct[0]), add=tuple(bct[1]))),)
        grid = movie.scaling_grids.get(p.character_id)
        if grid is not None:
            # DefineScalingGrid names buttons too (SWF spec v19): the
            # selected state's record union is the sliced bounds.
            bounds = _placements_bounds(movie, [
                Placement(depth=rec.depth, character_id=rec.character_id,
                          matrix=rec.matrix)
                for rec in button.state_records(button_bit)])
            if bounds is not None:
                return display.ScaleGridGroup(
                    children=children,
                    grid=(float(grid.x_min), float(grid.y_min),
                          float(grid.x_max), float(grid.y_max)),
                    bounds=bounds, matrix=p.matrix, color_transform=ct,
                    blend_mode=blend, filters=filters)
        return display.Container(children=children, matrix=p.matrix,
                                 color_transform=ct, blend_mode=blend,
                                 filters=filters)
    if p.character_id in movie.sprites:
        # A sprite instance replays its timeline, looping, phased from
        # the frame it was placed (player semantics: a MovieClip starts
        # playing when it appears and loops at its last frame).  The
        # phase is a pure function of the containing timeline's frame
        # index, so nested sprites derive their clocks recursively —
        # a resolved-snapshot approximation of the player's
        # free-running per-instance clocks (it diverges only when an
        # OUTER loop resets mid-inner-loop).
        sprite = movie.sprites[p.character_id]
        if not sprite.frames:
            return display.Container(children=(), matrix=p.matrix,
                                     color_transform=ct, blend_mode=blend,
                                     filters=filters)
        phase = (frame_idx - p.placed_frame) % len(sprite.frames)
        children = tuple(_children_from_placements(
            sprite.frames[phase], movie, phase, button_bit))
        grid = movie.scaling_grids.get(p.character_id)
        if grid is not None:
            bounds = _placements_bounds(movie, sprite.frames[phase])
            if bounds is not None:
                # DefineScalingGrid: the sprite renders 9-sliced against
                # its own bounds (this phase's subtree union — the
                # player uses the clip's current bounds too).
                return display.ScaleGridGroup(
                    children=children,
                    grid=(float(grid.x_min), float(grid.y_min),
                          float(grid.x_max), float(grid.y_max)),
                    bounds=bounds, matrix=p.matrix, color_transform=ct,
                    blend_mode=blend, filters=filters)
        return display.Container(children=children, matrix=p.matrix,
                                 color_transform=ct, blend_mode=blend,
                                 filters=filters)
    if p.character_id in movie.videos:
        # The stream's clock starts when the placement appears (same
        # phase rule as sprites); a RATIO seeks absolutely.
        local_frame = frame_idx - getattr(p, "placed_frame", 0)
        return display.ShapeInstance(
            definition=_video_shape(movie, movie.videos[p.character_id],
                                    local_frame, p.ratio),
            matrix=p.matrix, color_transform=ct, blend_mode=blend,
            filters=filters)
    raise KeyError(
        f"PlaceObject2 references undefined character {p.character_id}")


def _ensure_video_frames(movie: Movie) -> None:
    """Materialize every Screen Video stream's frames as synthetic
    bitmap characters (decoded once per Movie; VideoStream.decoded /
    frame_bitmap_ids cache in place).  Non-codec-3 streams (H.263,
    VP6) are left undecoded — placing one raises, like any other
    unsupported media type."""
    from ..models.screenvideo import decode_screen_video_packet
    from .bitmap_service import encode_x_swf_bmp2_argb

    next_id = 1 + max(
        [0, *movie.shapes, *movie.morph_shapes, *movie.bitmaps,
         *movie.sprites, *movie.fonts, *movie.texts, *movie.edit_texts,
         *movie.buttons, *movie.videos])
    for stream in movie.videos.values():
        if stream.codec != 3 or not stream.frames or stream.decoded:
            continue
        prev = None
        for num in sorted(stream.frames):
            prev = decode_screen_video_packet(stream.frames[num], prev)
            stream.decoded[num] = prev
            rgba = np.dstack([prev, np.full(prev.shape[:2], 255,
                                            np.uint8)])
            movie.bitmaps[next_id] = ast.DefineBitmap(
                id=next_id, width=stream.width, height=stream.height,
                media_type="image/x-swf-bmp2",
                data=encode_x_swf_bmp2_argb(rgba))
            stream.frame_bitmap_ids[num] = next_id
            next_id += 1


def _video_shape(movie: Movie, stream, frame_idx: int,
                 ratio) -> ast.DefineShape:
    """The synthetic shape one video placement draws: a stream-sized
    rect filled with the selected frame's bitmap (fill matrix scale 20
    — one texel per stage pixel, the SWF bitmap-fill convention).

    Frame selection follows the player: the PlaceObject RATIO names the
    video frame (embedded-video seek semantics); without one the stream
    advances with the timeline.  Missing numbers hold the latest
    earlier frame (dropped-frame behavior)."""
    if not stream.frame_bitmap_ids:
        raise NotImplementedError(
            f"NotImplemented: Support for video codec {stream.codec}")
    target = (int(round(ratio * 65536)) if ratio is not None
              else frame_idx)
    nums = sorted(stream.frame_bitmap_ids)
    shown = nums[0]
    for n in nums:
        if n <= target:
            shown = n
    cache_key = ("shape", shown)
    hit = stream.decoded.get(cache_key)
    if hit is not None:
        return hit
    from ..utils.fixed import Sfixed16P16

    w_tw = stream.width * 20
    h_tw = stream.height * 20
    fill = ast.BitmapFill(
        bitmap_id=stream.frame_bitmap_ids[shown],
        matrix=ast.Matrix(
            scale_x=Sfixed16P16.from_value(20),
            scale_y=Sfixed16P16.from_value(20),
            rotate_skew0=Sfixed16P16.from_value(0),
            rotate_skew1=Sfixed16P16.from_value(0),
            translate_x=0, translate_y=0),
        repeating=False, smoothed=stream.smoothing)
    tag = ast.DefineShape(
        id=stream.frame_bitmap_ids[shown],
        bounds=ast.Rect(0, w_tw, 0, h_tw),
        shape=ast.ShapeBody(
            initial_styles=ast.ShapeStyles(fill=(fill,), line=()),
            records=(
                ast.StyleChangeRecord(move_to=ast.Vector2D(0, 0),
                                      left_fill=1),
                ast.EdgeRecord(delta=ast.Vector2D(w_tw, 0)),
                ast.EdgeRecord(delta=ast.Vector2D(0, h_tw)),
                ast.EdgeRecord(delta=ast.Vector2D(-w_tw, 0)),
                ast.EdgeRecord(delta=ast.Vector2D(0, -h_tw)))))
    stream.decoded[cache_key] = tag
    return tag


def _character_bounds_rect(movie: Movie, cid: int):
    """A character's untransformed bounds in twips as (x0, y0, x1, y1),
    or None when not derivable (texts/buttons — their extents are
    layout-dependent; scale-9 wrapping simply stays off for them)."""
    if cid in movie.shapes:
        b = movie.shapes[cid].bounds
        return (float(b.x_min), float(b.y_min),
                float(b.x_max), float(b.y_max))
    if cid in movie.morph_shapes:
        m = movie.morph_shapes[cid]
        return (float(min(m.bounds.x_min, m.morph_bounds.x_min)),
                float(min(m.bounds.y_min, m.morph_bounds.y_min)),
                float(max(m.bounds.x_max, m.morph_bounds.x_max)),
                float(max(m.bounds.y_max, m.morph_bounds.y_max)))
    if cid in movie.sprites:
        sprite = movie.sprites[cid]
        if sprite.frames:
            return _placements_bounds(movie, sprite.frames[0])
    if cid in movie.videos:
        v = movie.videos[cid]
        return (0.0, 0.0, float(v.width * 20), float(v.height * 20))
    if cid in movie.texts:
        b = movie.texts[cid].bounds
        return (float(b.x_min), float(b.y_min),
                float(b.x_max), float(b.y_max))
    if cid in movie.edit_texts:
        b = movie.edit_texts[cid].bounds
        return (float(b.x_min), float(b.y_min),
                float(b.x_max), float(b.y_max))
    if cid in movie.buttons:
        from ..models.swf_binary import Placement as _P

        return _placements_bounds(movie, [
            _P(depth=r.depth, character_id=r.character_id,
               matrix=r.matrix)
            for r in movie.buttons[cid].state_records(0x01)])
    return None


def _placements_bounds(movie: Movie, placements):
    """Union of the placements' transformed character bounds (twips) —
    the sprite-bounds approximation the scale-9 wrapper slices against."""
    from ..models.geometry import Affine

    box = None
    for p in placements:
        local = _character_bounds_rect(movie, p.character_id)
        if local is None:
            continue
        x0, y0, x1, y1 = local
        pts = np.array([[x0, y0], [x1, y0], [x0, y1], [x1, y1]],
                       dtype=np.float64)
        if p.matrix is not None:
            pts = Affine.from_swf_matrix(p.matrix).apply(pts)
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        if box is None:
            box = [lo[0], lo[1], hi[0], hi[1]]
        else:
            box = [min(box[0], lo[0]), min(box[1], lo[1]),
                   max(box[2], hi[0]), max(box[3], hi[1])]
    return None if box is None else tuple(float(v) for v in box)


def _text_container(movie: Movie, text, matrix, ct, blend,
                    filters=()) -> display.Container:
    """Expand a DefineText/2 into glyph ShapeInstances.

    Glyphs are white-filled shapes on the font's em square; each
    instance scales by height / (1024 * divisor), translates to the pen
    position (TEXTRECORD x/y offsets set it absolutely, advances move
    it), and takes the run color as a pure-MULT color transform
    (white * c == c exactly).  The layout rides the text matrix inside
    the placement matrix; definitions are identity-cached on the Font,
    so repeated frames hit the renderer's draw caches and moving text
    rides the transform sweep like any shape hierarchy."""
    from ..utils.fixed import Sfixed16P16

    zero = Sfixed16P16.from_value(0)
    children = []
    font = None
    height = 1024
    color = ast.StraightSRgba8(0, 0, 0, 255)
    x = y = 0
    for run in text.runs:
        if run.font_id is not None:
            font = movie.fonts.get(run.font_id)
            if font is None:
                raise KeyError(f"FontNotFound: {run.font_id}")
            height = run.height
        if run.color is not None:
            color = run.color
        if run.x_offset is not None:
            x = run.x_offset
        if run.y_offset is not None:
            y = run.y_offset
        if run.glyphs and font is None:
            raise ValueError("text record places glyphs with no font set")
        scale = Sfixed16P16.from_value(height / (1024.0 * font.divisor)) \
            if run.glyphs else None
        tint = display.ColorTransform(
            mult=(color.r / 255.0, color.g / 255.0, color.b / 255.0,
                  color.a / 255.0))
        for gi, adv in run.glyphs:
            m = ast.Matrix(scale_x=scale, scale_y=scale,
                           rotate_skew0=zero, rotate_skew1=zero,
                           translate_x=x, translate_y=y)
            children.append(display.ShapeInstance(
                definition=font.glyph_shape(gi), matrix=m,
                color_transform=tint))
            x += adv
    inner = display.Container(children=tuple(children),
                              matrix=text.matrix)
    return display.Container(children=(inner,), matrix=matrix,
                             color_transform=ct, blend_mode=blend,
                             filters=tuple(filters))


_EDIT_TEXT_GUTTER = 40  # the player's 2 px text-field gutter, twips


def _edit_text_container(movie: Movie, field, matrix, ct, blend,
                         filters=()) -> display.Container:
    """Lay out a DefineEditText's INITIAL text with its embedded font.

    Player-model layout: a 2 px gutter inside the bounds, pen starting
    at left_margin + indent, baseline at the font ascent, greedy word
    wrap at the right margin when word_wrap is set, '\\n'/'\\r' breaks
    when multiline, line height = (ascent + descent) * scale + leading.
    Alignment 1/2 right/center-shifts each laid line; 3 justifies
    wrapped lines by stretching word gaps (last line of each paragraph
    left-set).  Needs the font's layout block (advances)."""
    from ..utils.fixed import Sfixed16P16

    font = movie.fonts.get(field.font_id)
    if font is None:
        raise KeyError(f"FontNotFound: {field.font_id}")
    if not font.advances:
        raise ValueError(
            "EditText needs a DefineFont2/3 layout block (advances)")
    em = 1024.0 * font.divisor
    scale = field.height / em
    zero = Sfixed16P16.from_value(0)
    sfx = Sfixed16P16.from_value(scale)
    b = field.bounds
    x0 = b.x_min + _EDIT_TEXT_GUTTER + field.left_margin
    x_right = b.x_max - _EDIT_TEXT_GUTTER - field.right_margin
    line_height = ((font.ascent + font.descent) / em * field.height
                   + field.leading)
    tint = display.ColorTransform(
        mult=(field.color.r / 255.0, field.color.g / 255.0,
              field.color.b / 255.0, field.color.a / 255.0))

    def glyph_entries(chars):
        out = []
        for ch in chars:
            gi = font.glyph_for_code(ord(ch))
            if gi is None:
                continue  # unmapped characters drop (player behavior)
            out.append((gi, font.advances[gi] * scale, ch == " "))
        return out

    paragraphs = (field.text.replace("\r\n", "\n").replace("\r", "\n")
                  .split("\n") if field.multiline else
                  [field.text.replace("\r", " ").replace("\n", " ")])
    lines = []  # (indent, entries, is_last_line_of_paragraph)
    for para in paragraphs:
        if field.word_wrap:
            cur = []
            cur_w = 0.0
            indent = field.indent
            for word in para.split(" "):
                entries = glyph_entries(word + " ")
                w_word = sum(a for _, a, _ in entries)
                if cur and x0 + indent + cur_w + w_word > x_right:
                    lines.append((indent, cur, False))
                    cur, cur_w, indent = [], 0.0, 0
                cur.extend(entries)
                cur_w += w_word
            lines.append((indent, cur, True))
        else:
            lines.append((field.indent, glyph_entries(para), True))

    children = []
    y = b.y_min + _EDIT_TEXT_GUTTER + font.ascent / em * field.height
    for indent, entries, last_line in lines:
        width = sum(a for _, a, _ in entries)
        x = x0 + indent
        stretch = 0.0
        if field.align == 1:      # right
            x = x_right - width
        elif field.align == 2:    # center
            x = x0 + indent + (x_right - x0 - indent - width) / 2.0
        elif field.align == 3 and not last_line:
            # Justify: wrapped (non-final) lines stretch their word
            # gaps to fill the margin box; the paragraph's last line
            # stays left-set (player layout).
            while entries and entries[-1][2]:
                entries = entries[:-1]      # trailing space off the edge
            n_gaps = sum(1 for _, _, sp in entries if sp)
            w_line = sum(a for _, a, _ in entries)
            slack = x_right - x - w_line
            if n_gaps and slack > 0:
                stretch = slack / n_gaps
        for gi, adv, is_space in entries:
            m = ast.Matrix(scale_x=sfx, scale_y=sfx,
                           rotate_skew0=zero, rotate_skew1=zero,
                           translate_x=int(round(x)),
                           translate_y=int(round(y)))
            children.append(display.ShapeInstance(
                definition=font.glyph_shape(gi), matrix=m,
                color_transform=tint))
            x += adv + (stretch if is_space else 0.0)
        y += line_height
    return display.Container(children=tuple(children), matrix=matrix,
                             color_transform=ct, blend_mode=blend,
                             filters=tuple(filters))


def _children_from_placements(placements, movie: Movie, frame_idx: int,
                              button_bit: int = 0x01):
    """Depth-ordered placements -> display children, folding clip-depth
    placements into MaskedGroups over the depths they cover
    ((depth, clip_depth]; nesting recurses)."""
    out = []
    ps = list(placements)
    i = 0
    while i < len(ps):
        p = ps[i]
        if p.clip_depth is not None and p.clip_depth > p.depth:
            j = i + 1
            while j < len(ps) and ps[j].depth <= p.clip_depth:
                j += 1
            out.append(display.MaskedGroup(
                mask=_placement_child(p, movie, frame_idx, button_bit),
                children=tuple(_children_from_placements(
                    ps[i + 1 : j], movie, frame_idx, button_bit))))
            i = j
        else:
            # PlaceObject3 HasVisible=0 keeps the depth slot but draws
            # nothing (masks above still clip regardless of visibility).
            if getattr(p, "visible", None) is not False:
                out.append(_placement_child(p, movie, frame_idx,
                                            button_bit))
            i += 1
    return out


def _button_bit(button_state: str) -> int:
    from ..models.swf_binary import BUTTON_STATE_BITS

    try:
        return BUTTON_STATE_BITS[button_state]
    except KeyError:
        raise ValueError(
            f"unknown button state {button_state!r}; expected one of "
            f"{sorted(BUTTON_STATE_BITS)}") from None


def _frame_stage(movie: Movie, placements, frame_idx: int = 0,
                 button_bit: int = 0x01) -> display.Stage:
    rect = movie.frame_rect
    span_x = rect.x_max - rect.x_min
    span_y = rect.y_max - rect.y_min
    _ensure_video_frames(movie)
    children = tuple(_children_from_placements(placements, movie,
                                               frame_idx, button_bit))
    if rect.x_min or rect.y_min:
        from ..utils.fixed import Sfixed16P16

        shift = ast.Matrix(
            scale_x=Sfixed16P16.from_value(1),
            scale_y=Sfixed16P16.from_value(1),
            rotate_skew0=Sfixed16P16.from_value(0),
            rotate_skew1=Sfixed16P16.from_value(0),
            translate_x=-rect.x_min, translate_y=-rect.y_min)
        children = (display.Container(children=children, matrix=shift),)
    return display.Stage(
        width=math.ceil(span_x / 20),
        height=math.ceil(span_y / 20),
        background_color=movie.background,
        children=children,
        exact_width=span_x / 20,
        exact_height=span_y / 20,
    )


def load_movie_stage(src: MovieSource, button_state: str = "up"
                     ) -> Tuple[display.Stage, List[ast.DefineBitmap]]:
    """Parse a movie into (first-frame Stage, bitmaps to register).

    Placements stack in depth order (the SWF display list is keyed by
    depth; painter's order = ascending depth).  A nonzero frame-RECT
    origin shifts the children like the player's stage origin.
    ``button_state`` selects which records buttons draw
    (up/over/down/hit)."""
    movie = parse_movie(_movie_bytes(src))
    return _frame_stage(movie, movie.placements, 0,
                        _button_bit(button_state)), list(
        movie.bitmaps.values())


def load_movie_timeline(
        src: MovieSource, button_state: str = "up"
) -> Tuple[List[display.Stage], List[ast.DefineBitmap]]:
    """Parse a movie into one Stage per ShowFrame (resolved timeline:
    PlaceFlagMove modifications and RemoveObject2 applied)."""
    movie = parse_movie(_movie_bytes(src))
    bit = _button_bit(button_state)
    return [_frame_stage(movie, f, i, bit)
            for i, f in enumerate(movie.frames)], list(
        movie.bitmaps.values())


def render_movie(src: MovieSource, button_state: str = "up",
                 **renderer_kwargs) -> np.ndarray:
    """Load a movie and rasterize its first frame.

    ``renderer_kwargs`` go to ``TorchRenderer`` (``device="cpu"`` runs
    the plain versions; with no device the render runs on the card and
    raises when there is none)."""
    from .renderer import TorchRenderer

    stage, bitmaps = load_movie_stage(src, button_state)
    renderer = TorchRenderer(stage.width, stage.height, **renderer_kwargs)
    for bmp in bitmaps:
        renderer.add_bitmap(bmp)
    return renderer.render(stage)


def render_movie_timeline(src: MovieSource, button_state: str = "up",
                          **renderer_kwargs) -> np.ndarray:
    """Rasterize every frame of a movie as ONE device batch.

    The stages feed ``TorchRenderer.render_batch``, so a timeline whose
    frames move matrices (the PlaceFlagMove form) auto-routes to the
    on-device transform sweep — a real .swf animation plays through
    the same kernels as the framework's native timeline tracks.
    Returns (frames, H, W, 4) uint8."""
    from .renderer import TorchRenderer

    stages, bitmaps = load_movie_timeline(src, button_state)
    if not stages:
        raise ValueError("movie has no frames")
    renderer = TorchRenderer(stages[0].width, stages[0].height,
                           **renderer_kwargs)
    for bmp in bitmaps:
        renderer.add_bitmap(bmp)
    return renderer.render_batch(stages)
