"""Movies through the port on the CPU (``runtime/movie.py``, the sound and
screen-video codecs, ``utils/png.py`` / ``utils/pam.py``) against the JAX
package.

The movies come from one builder per case, run once per package on that
package's modules (``tests.test_torch_swf_binary.Kit``; the chip check's
scenes from ``swf_renderer_tpu_torch/utils/movie_scenes.py``).  What
holds:

- ``load_movie_stage`` (every button state) and ``load_movie_timeline``
  give equal ``convert.to_plain`` forms in both packages, for the cases
  of the reference's tests/test_movie_loader.py, test_sprites.py,
  test_text.py, test_scale9.py and test_video.py built in code; the
  scene builders' movies load to exactly their hand-built stages;
- the loaders refuse the same inputs with the same exception types and
  messages;
- the codecs give equal arrays and bytes (MP3 through the decoder);
- ``render_movie`` / ``render_movie_timeline(device="cpu")`` against the
  JAX package's (Pallas in interpret mode): the same
  ``last_stats.path``, premultiplied bytes within 1 level, straight
  bytes pinned at their measured envelope (ROADMAP.md queue C); and
  each equal to the port's render of the hand-built stages.
"""

import types

import numpy as np
import pytest
import torch

from swf_renderer_tpu_torch.convert import to_plain
from swf_renderer_tpu_torch.utils import movie_scenes
from tests.test_torch_masks import levels
from tests.test_torch_swf_binary import JAX, PORT, both, kit

W, H = 96, 64


def mods(k):
    return types.SimpleNamespace(ast=k.ast, fixed=k.fixed, sb=k.sb,
                                 display=k.display, bmp=k.bmp)


# ---------------------------------------------------------------------------
# Loader: equal plain forms in both packages
# ---------------------------------------------------------------------------


def _tl(k, tx, ty):
    return k.mat(tx=tx, ty=ty)


def movie_nonzero_origin(k, rng):
    sq = k.rect_shape(1, 600, 400, k.rgba(200, 30, 30))
    return k.sb.emit_movie([sq], shape_matrices=[_tl(k, 400 + 100,
                                                     800 + 60)],
                           stage_rect=k.ast.Rect(400, 400 + 1920,
                                                 800, 800 + 1280))


def movie_buttons(k, rng):
    """Every state selects its records; a scale-9 button and a
    colour-transformed one beside (test_text.py, test_scale9.py)."""
    sb, R = k.sb, k.sb.ButtonRecord
    red = k.rect_shape(2, 800, 600, k.rgba(200, 30, 30))
    blue = k.rect_shape(3, 800, 600, k.rgba(10, 10, 200))
    b1 = sb.Button(id=9, records=(
        R(character_id=2, depth=1, matrix=k.mat(), states=0x09),
        R(character_id=3, depth=2, matrix=_tl(k, 400, 0), states=0x06),
        R(character_id=2, depth=3, matrix=_tl(k, 0, 600), states=0x02,
          filters=(k.filters.BlurFilter(2.0, 2.0, 1),), blend="add"),
        R(character_id=3, depth=4, matrix=_tl(k, 800, 600), states=0x08,
          color_transform=((0.5, 1.0, 1.0, 1.0), (0.0, 0.2, 0.0, 0.0)))))
    b2 = sb.Button(id=20, records=(
        R(character_id=2, depth=1, matrix=None, states=0x01),
        R(character_id=3, depth=2, matrix=_tl(k, 1800, 1800),
          states=0x01)))
    return sb.emit_movie_timeline(
        [[sb.Placement(depth=1, character_id=9),
          sb.Placement(depth=2, character_id=20, matrix=k.mat(2.0, 1.5)),
          sb.Placement(depth=3, character_id=9, matrix=_tl(k, 0, 1200))]],
        shapes=[red, blue], buttons=[b1, b2],
        button_cxforms={9: ((0.5, 1.0, 0.25, 1.0), (0.2, 0.0, 0.2, 0.0))},
        scaling_grids=[(20, k.ast.Rect(200, 600, 200, 400))],
        stage_rect=k.ast.Rect(0, 1920, 0, 1280))


def movie_sprites(k, rng):
    """Sprite timelines: looping phase from the placement frame, nested
    sprites, move keeps phase and replace restarts (test_sprites.py)."""
    sb, P = k.sb, k.sb.Placement
    shapes = [k.rect_shape(1, 200, 200, k.rgba(10, 20, 200)),
              k.rect_shape(2, 100, 300, k.rgba(200, 20, 10))]
    step = (10, [[P(depth=1, character_id=1, matrix=_tl(k, 0, 0))],
                 [P(depth=1, move=True, matrix=_tl(k, 400, 0))],
                 [P(depth=1, move=True, matrix=_tl(k, 800, 0))]])
    outer = (11, [[P(depth=1, character_id=10)],
                  [P(depth=2, character_id=2, matrix=_tl(k, 0, 300))]])
    frames = [[P(depth=1, character_id=10)],
              [P(depth=2, character_id=11, matrix=_tl(k, 0, 400),
                 color_transform=((1.0, 0.5, 0.5, 1.0), (0.0,) * 4))],
              [P(depth=1, move=True, matrix=_tl(k, 50, 50))],
              [P(depth=1, move=True, character_id=10)],
              [sb.RemoveObject(depth=2)], []]
    return sb.emit_movie_timeline(frames, shapes=shapes,
                                  sprites=[step, outer, (12, [])],
                                  stage_rect=k.ast.Rect(0, 1200, 0, 1200))


def movie_move_remove_replace(k, rng):
    """PlaceFlagMove keeps what it leaves unset, RemoveObject2 clears a
    depth, a move with a character id replaces and keeps the matrix
    (test_movie_loader.py)."""
    sb, P = k.sb, k.sb.Placement
    tri = k.shape(1, k.polygon_records(rng, 300, 300, 250, 3),
                  [k.ast.SolidFill(color=k.rgba(20, 200, 30))])
    sq = k.rect_shape(2, 400, 400, k.rgba(20, 30, 200))
    ct = ((0.5, 0.5, 0.5, 1.0), (0.0, 0.0, 0.0, 0.0))
    frames = [
        [P(depth=1, character_id=1, matrix=_tl(k, 100, 100),
           color_transform=ct, name="hero"),
         P(depth=2, character_id=2, matrix=k.rot(0.3, 1.0, 800, 200))],
        [P(depth=1, move=True, matrix=_tl(k, 500, 200))],
        [P(depth=2, move=True, character_id=1),
         P(depth=1, move=True, ratio=0.5, name="villain")],
        [sb.RemoveObject(depth=1)],
        [P(depth=1, character_id=2, legacy=True, matrix=_tl(k, 40, 60))],
        [sb.RemoveObject(depth=1, character_id=2)],
    ]
    return sb.emit_movie_timeline(frames, shapes=[tri, sq],
                                  stage_rect=k.ast.Rect(0, 1920, 0, 1280))


def movie_video(k, rng):
    """Screen video: advancing with the timeline, placed mid-timeline,
    seeking by ratio (test_video.py)."""
    sb, P = k.sb, k.sb.Placement
    f0 = rng.integers(0, 256, (23, 37, 3), np.uint8)
    f1 = f0.copy()
    f1[4:12, 6:20] = rng.integers(0, 256, (8, 14, 3), np.uint8)
    stream = sb.VideoStream(id=5, width=37, height=23, smoothing=False)
    stream.frames[0] = k.sv.encode_screen_video_packet(f0, block=16)
    stream.frames[1] = k.sv.encode_screen_video_packet(f1, prev=f0,
                                                       block=16)
    frames = [[P(depth=1, character_id=5)],
              [P(depth=2, character_id=5, matrix=_tl(k, 740, 0))],
              [P(depth=3, character_id=5, ratio=1.0 / 65536,
                 matrix=_tl(k, 0, 460))]]
    return sb.emit_movie_timeline(frames, videos=(stream,),
                                  stage_rect=k.ast.Rect(0, 1480, 0, 920))


def movie_texts(k, rng):
    """DefineText runs and DefineEditText layouts: word wrap,
    alignment, justify, unmapped characters (test_text.py)."""
    sb, a, P = k.sb, k.ast, k.sb.Placement
    from tests.test_torch_swf_binary import glyphs, text_runs

    tri, sq = glyphs(k)
    fonts = [sb.Font(id=1, glyphs=(tri, sq, ()), name="AB ",
                     code_table=(65, 66, 32), ascent=900, descent=200,
                     leading=60, advances=(1000, 850, 500)),
             sb.Font(id=2, glyphs=(sq,), divisor=20, name="S",
                     code_table=(83,))]
    text = sb.Text(id=5, bounds=a.Rect(0, 4000, 0, 2400),
                   matrix=k.mat(1.5, 1.5, tx=300), runs=text_runs(k))
    fields = [sb.EditText(id=6 + i, bounds=a.Rect(0, 2200, 0, 2400),
                          font_id=1, height=512, text=txt,
                          use_outlines=True, word_wrap=True,
                          multiline=True, align=align, left_margin=80,
                          indent=20, leading=40)
              for i, (txt, align) in enumerate((
                  ("AB AB AB AB", 3), ("AB\nBA Z", 1), ("ABBA", 2)))]
    return sb.emit_movie_timeline(
        [[P(depth=1, character_id=5)]
         + [P(depth=2 + i, character_id=f.id, matrix=_tl(k, 0, 800 * i))
            for i, f in enumerate(fields)]],
        fonts=fonts, texts=[text] + fields,
        stage_rect=a.Rect(0, 4000, 0, 2400))


def movie_clips_blends(k, rng):
    """Clip depths fold into masked groups (nested), PlaceObject3 blend
    modes, filters and visibility."""
    sb, P = k.sb, k.sb.Placement
    shapes = [k.rect_shape(1, 800, 800, k.rgba(200, 30, 30)),
              k.rect_shape(2, 400, 1200, k.rgba(30, 200, 30, 180)),
              k.rect_shape(3, 1200, 300, k.rgba(30, 30, 200))]
    frames = [[P(depth=1, character_id=1, clip_depth=4),
               P(depth=2, character_id=2, matrix=_tl(k, 200, 0),
                 clip_depth=3),
               P(depth=3, character_id=3, blend="multiply"),
               P(depth=4, character_id=3, matrix=_tl(k, 0, 400),
                 filters=k.all_filters()[:3]),
               P(depth=5, character_id=2, visible=False),
               P(depth=6, character_id=1, matrix=_tl(k, 900, 0),
                 blend="screen")]]
    return sb.emit_movie_timeline(frames, shapes=shapes,
                                  stage_rect=k.ast.Rect(0, 1920, 0, 1280))


def movie_kitchen_sink(k, rng):
    from tests.test_torch_swf_binary import kitchen_sink

    return kitchen_sink(k, rng)


def movie_anim(k, rng):
    return movie_scenes.anim_movie(mods(k), W, H, frames=6)[0]


def movie_morph(k, rng):
    return movie_scenes.morph_movie(mods(k), W, H, frames=6)[0]


def movie_still(k, rng):
    return movie_scenes.still_movie(mods(k), W, H)[0]


MOVIES = {name[6:]: fn for name, fn in sorted(globals().items())
          if name.startswith("movie_") and callable(fn)}


@pytest.mark.parametrize("name", sorted(MOVIES))
def test_loaders_agree(name):
    mj, mt = both(MOVIES[name])
    assert mt == mj
    kj, kt = kit(JAX), kit(PORT)
    for state in ("up", "over", "down", "hit"):
        sj = kj.movie.load_movie_stage(mj, button_state=state)
        st = kt.movie.load_movie_stage(mt, button_state=state)
        assert to_plain(st) == to_plain(sj), state
    tj = kj.movie.load_movie_timeline(mj)
    tt = kt.movie.load_movie_timeline(mt)
    assert len(tt[0]) == len(kt.sb.parse_movie(mt).frames)
    assert to_plain(tt) == to_plain(tj)


@pytest.mark.parametrize("scene", ["anim", "morph", "still"])
def test_scene_builders_load_to_their_stages(scene):
    """The chip check's movies load, in both packages, to exactly the
    stages built by hand beside them; their shapes survive the wire."""
    fn = {"anim": lambda m: movie_scenes.anim_movie(m, W, H, frames=6),
          "morph": lambda m: movie_scenes.morph_movie(m, W, H, frames=6),
          "still": lambda m: movie_scenes.still_movie(m, W, H)}[scene]
    port = fn(movie_scenes.port_mods())
    assert port[0] == fn(mods(kit(PORT)))[0]
    ref = fn(mods(kit(JAX)))
    assert ref[0] == port[0]
    for k, built in ((kit(PORT), port), (kit(JAX), ref)):
        if scene == "still":
            stage, bitmaps = k.movie.load_movie_stage(built[0])
            assert to_plain(stage) == to_plain(built[1])
            assert to_plain(bitmaps) == to_plain(built[2])
        else:
            stages, _ = k.movie.load_movie_timeline(built[0])
            assert to_plain(stages) == to_plain(built[1])


def _loader_refusals(k):
    sb, a, P, mv = k.sb, k.ast, k.sb.Placement, k.movie

    def grab(fn):
        try:
            fn()
        except Exception as exc:  # the types are compared
            return type(exc).__name__, str(exc)
        return None

    empty = sb.emit_movie([], stage_rect=a.Rect(0, 200, 0, 200))
    place = sb._emit_place_object2(P(depth=1, character_id=99))
    end = empty.rindex(b"\x40\x00")
    dangling = empty[:end] + place + empty[end:]
    dangling = dangling[:4] + len(dangling).to_bytes(4, "little") \
        + dangling[8:]
    bad_ops = sb.emit_movie_timeline(
        [[P(depth=1, ratio=0.5, move=True)]],
        stage_rect=a.Rect(0, 200, 0, 200))
    text = sb.Text(id=5, bounds=a.Rect(0, 400, 0, 400), matrix=k.mat(),
                   runs=(sb.TextRun(glyphs=((0, 100),), font_id=7,
                                    height=200),))
    no_font = sb.emit_movie_timeline(
        [[P(depth=1, character_id=5)]], texts=[text],
        stage_rect=a.Rect(0, 400, 0, 400))
    no_font_set = sb.emit_movie_timeline(
        [[P(depth=1, character_id=5)]], texts=[sb.Text(
            id=5, bounds=a.Rect(0, 400, 0, 400), matrix=k.mat(),
            runs=(sb.TextRun(glyphs=((0, 100),)),))],
        stage_rect=a.Rect(0, 400, 0, 400))
    button = sb.emit_movie_timeline(
        [[P(depth=1, character_id=9)]],
        shapes=[k.rect_shape(2, 100, 100, k.rgba(1, 2, 3))],
        buttons=[sb.Button(id=9, records=(sb.ButtonRecord(
            character_id=2, depth=1, matrix=None, states=1),))],
        stage_rect=a.Rect(0, 400, 0, 400))
    return [
        grab(lambda: mv.load_movie_stage(dangling)),
        grab(lambda: mv.load_movie_timeline(dangling)),
        grab(lambda: mv.load_movie_timeline(bad_ops)),
        grab(lambda: mv.load_movie_stage(no_font)),
        grab(lambda: mv.load_movie_stage(no_font_set)),
        grab(lambda: mv.load_movie_stage(button, button_state="hover")),
        grab(lambda: mv.render_movie(button, button_state="hover",
                                     **({"device": "cpu"}
                                        if k.pkg == PORT else {}))),
        grab(lambda: mv.render_movie_timeline(
            sb.emit_movie_timeline([], stage_rect=a.Rect(0, 40, 0, 40)),
            **({"device": "cpu"} if k.pkg == PORT else {}))),
    ]


def test_loader_refusals_agree():
    rj, rt = both(lambda k, rng: _loader_refusals(k))
    assert all(r is not None for r in rt), rt
    assert [r[0] for r in rt] == ["KeyError", "KeyError", "ValueError",
                                  "KeyError", "ValueError", "ValueError",
                                  "ValueError", "ValueError"]
    assert rt == rj


def test_movie_entry_points_need_a_card_or_the_cpu(monkeypatch):
    from swf_renderer_tpu_torch.runtime import movie

    data = movie_scenes.still_movie(movie_scenes.port_mods(), 32, 24)[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        movie.render_movie(data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        movie.render_movie_timeline(data)
    assert movie.render_movie(data, device="cpu").shape == (24, 32, 4)


# ---------------------------------------------------------------------------
# Sound, video, PNG and PAM
# ---------------------------------------------------------------------------


def test_sound_codecs_agree():
    def build(k, rng):
        snd = k.sound
        out = []
        for bits in (8, 16):
            for ch in (1, 2):
                data = bytes(rng.integers(0, 256, 240 * ch, np.uint8))
                out.append(snd.decode_uncompressed(data, bits, ch))
                pcm = rng.uniform(-1.1, 1.1, (97, ch)).astype(np.float32)
                out.append(snd.encode_uncompressed(pcm, bits))
        for nbits in (2, 3, 4, 5):
            for ch in (1, 2):
                raw = bytearray(rng.integers(0, 256, 700 * ch, np.uint8))
                raw[0] = (raw[0] & 0x3F) | ((nbits - 2) << 6)
                out.append(snd.decode_adpcm(bytes(raw), ch))
        for ch in (1, 2):
            pcm = rng.uniform(-0.8, 0.8, (5000, ch)).astype(np.float32)
            enc = snd.encode_adpcm(pcm)
            out += [enc, snd.decode_adpcm(enc, ch),
                    snd.decode_sound(snd.FORMAT_ADPCM, enc, 16, ch,
                                     sample_count=4321)]
        out.append(snd.decode_sound(snd.FORMAT_UNCOMPRESSED, bytes(range(64)),
                                    16, 2))
        return out

    oj, ot = both(build)
    assert to_plain(ot) == to_plain(oj)


def test_sound_refusals():
    """MP3 decodes as the reference's (SeekSamples, the resample to the
    declared rate); Nellymoser refuses as the reference does."""
    payload = (64).to_bytes(2, "little") + movie_scenes.mp3_stream(
        6, version=2, mode=1, rate_index=1, seed=1)
    pj, pt = both(lambda k, rng: k.sound.decode_sound(
        k.sound.FORMAT_MP3, payload, 16, 2, declared_rate=22050))
    assert pt.dtype == pj.dtype and pt.shape == pj.shape
    assert np.array_equal(pt, pj)
    rj, rt = both(lambda k, rng: [
        _grab(lambda: k.sound.decode_sound(k.sound.FORMAT_NELLYMOSER,
                                           b"\x00", 16, 1))])
    assert rt == rj and rt[0][0] == "NotImplementedError"


def _grab(fn):
    try:
        fn()
    except Exception as exc:  # the types are compared
        return type(exc).__name__, str(exc)
    return None


def test_screen_video_agrees():
    def build(k, rng):
        f0 = rng.integers(0, 256, (23, 37, 3), np.uint8)
        f1 = f0.copy()
        f1[4:12, 6:20] = rng.integers(0, 256, (8, 14, 3), np.uint8)
        key = k.sv.encode_screen_video_packet(f0, block=16)
        inter = k.sv.encode_screen_video_packet(f1, prev=f0, block=16)
        wide = k.sv.encode_screen_video_packet(f1, block=48)
        return [key, inter, wide, k.sv.decode_screen_video_packet(key),
                k.sv.decode_screen_video_packet(inter, f0),
                k.sv.decode_screen_video_packet(wide),
                _grab(lambda: k.sv.decode_screen_video_packet(inter))]

    oj, ot = both(build)
    assert to_plain(ot) == to_plain(oj)
    assert ot[6][0] == "ValueError"
    assert np.array_equal(ot[4][4:12, 6:20], ot[5][4:12, 6:20])


def test_png_and_pam_agree(tmp_path):
    from swf_renderer_tpu_torch.utils import pam, png
    from swf_renderer_tpu.utils import pam as jpam
    from swf_renderer_tpu.utils import png as jpng

    rng = np.random.default_rng(5)
    for shape in ((1, 1, 4), (17, 23, 4), (64, 96, 4)):
        img = rng.integers(0, 256, shape, np.uint8)
        data = png.encode_png(img)
        assert data == jpng.encode_png(img)
        assert np.array_equal(png.read_png(data), img)
        assert np.array_equal(jpng.read_png(data), img)
        assert pam.rgba_to_pam(img) == jpam.rgba_to_pam(img)
        assert np.array_equal(pam.pam_to_rgba(pam.rgba_to_pam(img)), img)
        png.write_png(tmp_path / "a.png", img)
        assert np.array_equal(png.read_png(tmp_path / "a.png"), img)
        assert np.array_equal(png.read_png(str(tmp_path / "a.png")), img)
    with pytest.raises(ValueError):
        pam.rgba_to_pam(np.zeros((2, 2, 3), np.uint8))


# ---------------------------------------------------------------------------
# Renders against the JAX package
# ---------------------------------------------------------------------------


def _ct_timeline(k, rng):
    """Five frames of two shapes: one fading and tinting through its
    colour transform, the other still."""
    sb, P = k.sb, k.sb.Placement
    star = k.shape(1, k.polygon_records(rng, 0, 0, 500, 16, star=True),
                   [k.ast.SolidFill(color=k.rgba(230, 120, 20))])
    disc = k.shape(2, k.polygon_records(rng, 0, 0, 400, 24),
                   [k.fill(rng, "radial")])
    frames = [[P(depth=1, character_id=2, matrix=_tl(k, 700, 600)),
               P(depth=2, character_id=1, matrix=_tl(k, 1100, 650),
                 color_transform=((1.0,) * 4, (0.0,) * 4))]]
    for f in range(1, 5):
        frames.append([P(depth=2, move=True, color_transform=(
            (1.0 - 0.125 * f, 1.0, 0.5 + 0.0625 * f, 1.0 - 0.1875 * f),
            (0.0, f / 255.0, 0.0, 0.0)))])
    return sb.emit_movie_timeline(frames, shapes=[star, disc],
                                  background=k.rgba(240, 240, 255),
                                  stage_rect=k.ast.Rect(0, W * 20, 0, H * 20))


def _render(k, data, timeline):
    """(frames, last_stats.path) through the package's own renderer,
    and the entry point's frames."""
    mv = k.movie
    if k.pkg == PORT:
        from swf_renderer_tpu_torch.runtime.renderer import TorchRenderer

        make = lambda w, h: TorchRenderer(w, h, device="cpu")  # noqa: E731
        entry = dict(device="cpu")
    else:
        from swf_renderer_tpu.runtime.renderer import TpuRenderer

        make, entry = TpuRenderer, {}
    if timeline:
        stages, bitmaps = mv.load_movie_timeline(data)
        r = make(stages[0].width, stages[0].height)
        for b in bitmaps:
            r.add_bitmap(b)
        out = r.render_batch(stages)
        return out, r.last_stats.path, mv.render_movie_timeline(data, **entry)
    stage, bitmaps = mv.load_movie_stage(data)
    r = make(stage.width, stage.height)
    for b in bitmaps:
        r.add_bitmap(b)
    out = r.render(stage)
    return out, r.last_stats.path, mv.render_movie(data, **entry)


# scene -> (built on the port's modules, timeline?, path, the straight
# envelope: max level, share of differing bytes), measured on the CPU
# against the JAX package (ROADMAP.md queue C).
RENDERS = {
    "still": (lambda k: movie_scenes.still_movie(mods(k), W, H), False,
              "flatblock", (1, 2.9e-4)),
    "affine": (lambda k: movie_scenes.anim_movie(mods(k), W, H, frames=6),
               True, "transform-sweep", (0, 0.0)),
    "morph": (lambda k: movie_scenes.morph_movie(mods(k), W, H, frames=6),
              True, "transform-sweep", (0, 0.0)),
    "ct": (lambda k: (_ct_timeline(k, np.random.default_rng(3)),), True,
           "transform-sweep", (0, 0.0)),
}


@pytest.mark.parametrize("scene", sorted(RENDERS))
def test_movie_renders_match_the_jax_package(scene):
    build, timeline, path, (max_level, share) = RENDERS[scene]
    data = build(kit(PORT))[0]
    assert build(kit(JAX))[0] == data
    got, got_path, got_entry = _render(kit(PORT), data, timeline)
    want, want_path, _ = _render(kit(JAX), data, timeline)
    assert got_path == want_path == path
    assert np.array_equal(got_entry, got)
    straight, premul, differing = levels(want, got)
    assert premul <= 1, (straight, premul, differing)
    assert straight <= max_level and differing <= share, (
        straight, premul, differing)
    if scene != "ct":   # the scene builders' hand-built stages
        built = build(movie_scenes.port_mods())
        from swf_renderer_tpu_torch.runtime.renderer import TorchRenderer

        r = TorchRenderer(W, H, device="cpu")
        for b in (built[2] if len(built) > 2 else ()):
            r.add_bitmap(b)
        hand = r.render_batch(built[1]) if timeline else r.render(built[1])
        assert np.array_equal(hand, got)
