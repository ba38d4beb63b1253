"""The animation slice as a whole, on the CPU: ``TorchRenderer(...,
device="cpu").render_batch`` of moving, fading and morphing stages and
``render_shape_animation`` against the JAX package's ``TpuRenderer`` /
``render_shape_animation`` (Pallas interpret mode) on the same stages
built in code.

Tolerance against the JAX package: the same route (``"transform-sweep"``),
at most 1 u8 level in the premultiplied bytes, straight bytes pinned per
scene (the reasons are those of tests/test_torch_sweep.py).  Against the
port's own per-frame ``render(stage)``: at most 2 levels, share of bytes
more than 1 level apart below 1e-3 — the reference's own bound between
its sweep and its per-frame path (tests/test_transform_sweep.py).
"""

import dataclasses

import numpy as np
import pytest

from swf_renderer_tpu.models import ast as jast
from swf_renderer_tpu.models import display as jdisplay
from swf_renderer_tpu.runtime import renderer as jrenderer
from swf_renderer_tpu.utils.fixed import Sfixed16P16 as JFixed
from swf_renderer_tpu_torch.models import ast as tast
from swf_renderer_tpu_torch.models import display as tdisplay
from swf_renderer_tpu_torch.runtime import renderer as trenderer
from swf_renderer_tpu_torch.utils.fixed import Sfixed16P16 as TFixed

JAX = (jast, jdisplay, JFixed)
PORT = (tast, tdisplay, TFixed)
W, H = 120, 96


def premul(x):
    """The premultiplied bytes the pipeline rounded (int32)."""
    x = x.astype(np.int32)
    return np.concatenate(
        [(x[..., :3] * x[..., 3:] + 127) // 255, x[..., 3:]], -1)


def levels(want, got):
    d = np.abs(want.astype(np.int32) - got.astype(np.int32))
    return (int(d.max()), int(np.abs(premul(want) - premul(got)).max()),
            float((d != 0).mean()))


def assert_matches_reference(want, got, straight, share=1e-3):
    assert want.shape == got.shape and got.dtype == np.uint8
    assert got[..., 3].max() > 150
    smax, pmax, differing = levels(want, got)
    assert pmax <= 1 and smax <= straight and differing <= share, (
        smax, pmax, differing)


def assert_matches_per_frame(renderer_factory, stages, got, max_level=2):
    for i, stage in enumerate(stages):
        want = renderer_factory().render(stage)
        diff = np.abs(got[i].astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= max_level, (i, diff.max())
        assert (diff > 1).mean() < 1e-3, i


def _matrix(mods, th=0.0, scale=1.0, cx=1200.0, cy=960.0, tx=0, ty=0):
    """Rotate by ``th`` and scale about (cx, cy) twips, then translate."""
    ast, _, fixed = mods
    a, b = scale * np.cos(th), scale * np.sin(th)
    return ast.Matrix(
        scale_x=fixed.from_value(a), scale_y=fixed.from_value(a),
        rotate_skew0=fixed.from_value(b), rotate_skew1=fixed.from_value(-b),
        translate_x=int(round(cx - a * cx + b * cy)) + tx,
        translate_y=int(round(cy - b * cx - a * cy)) + ty)


def _shape(mods, shape_id, fill, points, winding=False):
    ast = mods[0]
    records = [ast.StyleChangeRecord(
        left_fill=None, right_fill=1, line_style=None,
        move_to=ast.Vector2D(x=points[0][0], y=points[0][1]),
        new_styles=None)]
    for (x0, y0), (x1, y1) in zip(points, points[1:] + points[:1]):
        records.append(ast.EdgeRecord(delta=ast.Vector2D(x=x1 - x0,
                                                         y=y1 - y0)))
    xs, ys = [p[0] for p in points], [p[1] for p in points]
    return ast.DefineShape(
        id=shape_id,
        bounds=ast.Rect(x_min=min(xs), x_max=max(xs), y_min=min(ys),
                        y_max=max(ys)),
        shape=ast.ShapeBody(
            initial_styles=ast.ShapeStyles(fill=[fill], line=[]),
            records=records),
        has_fill_winding=winding)


BOX = [(500, 400), (1900, 460), (1840, 1500), (560, 1440)]
STAR = [(1200 + int(800 * np.cos(a)), 960 + int(700 * np.sin(a)))
        for a in np.linspace(0, 4 * np.pi, 5, endpoint=False)]


def _gradient(mods, color_space="S_RGB"):
    ast = mods[0]
    return ast.Gradient(
        spread=ast.GradientSpread.PAD,
        color_space=getattr(ast.ColorSpace, color_space),
        colors=[ast.GradientStop(0, ast.StraightSRgba8(255, 0, 0, 255)),
                ast.GradientStop(100, ast.StraightSRgba8(0, 255, 0, 180)),
                ast.GradientStop(255, ast.StraightSRgba8(0, 0, 255, 255))])


def _solid(mods, shape_id=1, color=(200, 40, 90, 220), points=STAR,
           winding=False):
    ast = mods[0]
    return _shape(mods, shape_id, ast.SolidFill(ast.StraightSRgba8(*color)),
                  points, winding)


def _fill_matrix(mods):
    ast, _, fixed = mods
    s, z = fixed.from_value(0.05), fixed.from_value(0.0)
    return ast.Matrix(scale_x=s, scale_y=s, rotate_skew0=z, rotate_skew1=z,
                      translate_x=1200, translate_y=960)


def _linear(mods, shape_id=2, color_space="S_RGB"):
    return _shape(mods, shape_id, mods[0].LinearGradientFill(
        matrix=_fill_matrix(mods), gradient=_gradient(mods, color_space)),
        BOX)


def _focal(mods, shape_id=3):
    return _shape(mods, shape_id, mods[0].FocalGradientFill(
        matrix=_fill_matrix(mods), gradient=_gradient(mods),
        focal_point_epsilons=90), BOX)


def _ct(mods, alpha, add_red=0.0):
    return mods[1].ColorTransform(mult=(1.0, 1.0, 1.0, alpha),
                                  add=(add_red, 0.0, 0.0, 0.0))


def _morph(mods):
    ast = mods[0]

    def v(x, y):
        return ast.Vector2D(x=x, y=y)

    fill = ast.MorphSolidFill(color=ast.StraightSRgba8(255, 30, 0, 255),
                              morph_color=ast.StraightSRgba8(0, 60, 255, 140))
    return ast.DefineMorphShape(
        id=7, bounds=ast.Rect(0, 1600, 0, 1600),
        morph_bounds=ast.Rect(0, 1600, 0, 1600),
        shape=ast.MorphShapeBody(
            initial_styles=ast.MorphShapeStyles(fill=(fill,), line=()),
            records=(
                ast.MorphStyleChangeRecord(
                    right_fill=1, move_to=v(200, 200),
                    morph_move_to=v(500, 300)),
                ast.MorphEdgeRecord(delta=v(1400, 0),
                                    morph_delta=v(800, 100)),
                ast.MorphEdgeRecord(delta=v(0, 1300),
                                    morph_delta=v(100, 900)),
                ast.MorphEdgeRecord(delta=v(-1400, -1300),
                                    morph_delta=v(-900, -1000)))))


def _stages(mods, name, frames=4):
    """The named animation as a list of stages of ``mods``' package."""
    ast, display, _ = mods
    stages = []
    if name in ("rotating-fading", "constant-ct", "linear-rgb"):
        solid = _solid(mods)
        if name == "linear-rgb":
            grads = [_linear(mods, 2, "LINEAR_RGB")]
        else:
            grads = [_linear(mods), _focal(mods)]
        for i in range(frames):
            th = 2 * np.pi * i / 11
            fade = 1.0 if name == "constant-ct" else 1.0 - 0.2 * i
            children = [display.ShapeInstance(
                definition=g, matrix=_matrix(mods, th * (k + 1), 1.0 + 0.1 * k),
                color_transform=_ct(mods, 0.8 if name == "constant-ct"
                                    else fade))
                for k, g in enumerate(grads)]
            children.append(display.ShapeInstance(
                definition=solid, matrix=_matrix(mods, -th, 0.9, tx=40 * i),
                color_transform=_ct(mods, fade, 0.1 * i)))
            stages.append(display.Stage(width=W, height=H,
                                        children=children))
    elif name == "mixed-rules":
        tags = [_solid(mods, 1, (250, 200, 0, 255), winding=True),
                _solid(mods, 2, (0, 90, 250, 200), winding=False)]
        for i in range(frames):
            stages.append(display.Stage(width=W, height=H, children=[
                display.ShapeInstance(
                    definition=tag,
                    matrix=_matrix(mods, 0.3 * i * (k + 1), tx=300 * k))
                for k, tag in enumerate(tags)]))
    elif name == "container":
        inner = display.ShapeInstance(definition=_solid(mods),
                                      matrix=_matrix(mods, 0.2, 0.6))
        for i in range(frames):
            group = display.Container(
                children=(inner,),
                matrix=_matrix(mods, 0.25 * i, tx=60 * i, ty=30 * i),
                color_transform=_ct(mods, 1.0 - 0.15 * i))
            stages.append(display.Stage(
                width=W, height=H, children=[group],
                background_color=ast.StraightSRgba8(30, 60, 90, 200)))
    elif name in ("morph-ratio", "morph-and-static"):
        tag = _morph(mods)
        solid = _solid(mods, 9, (20, 200, 120, 200))
        for i in range(frames):
            children = [display.MorphShapeInstance(
                definition=tag, ratio=i / (frames - 1.0),
                matrix=_matrix(mods, 0.2 * i, cx=800.0, cy=800.0,
                               tx=120 * i, ty=40 * i))]
            if name == "morph-and-static":
                children.append(display.ShapeInstance(
                    definition=solid, matrix=_matrix(mods, -0.3 * i)))
            stages.append(display.Stage(width=W, height=H,
                                        children=children))
    else:
        raise KeyError(name)
    return stages


def _render_both(name, **kwargs):
    want_r = jrenderer.TpuRenderer(W, H, **kwargs)
    want = want_r.render_batch(_stages(JAX, name))
    got_r = trenderer.TorchRenderer(W, H, device="cpu", **kwargs)
    stages = _stages(PORT, name)
    got = got_r.render_batch(stages)
    return want_r, want, got_r, got, stages


# name -> (renderer kwargs, straight-byte envelope against the reference)
ANIMATIONS = {
    "rotating-fading": ({}, 2),
    "constant-ct": ({}, 2),
    "linear-rgb": ({}, 2),
    "mixed-rules": ({"honor_fill_winding": True}, 5),
    "container": ({}, 2),
}


@pytest.mark.parametrize("name", sorted(ANIMATIONS))
def test_render_batch_sweep_matches_reference_and_per_frame(name):
    kwargs, straight = ANIMATIONS[name]
    want_r, want, got_r, got, stages = _render_both(name, **kwargs)
    assert want_r.last_stats.path == "transform-sweep"
    assert got_r.last_stats.path == "transform-sweep"
    assert got_r.last_stats.draws == want_r.last_stats.draws
    assert got_r.last_stats.edges == want_r.last_stats.edges
    assert_matches_reference(want, got, straight)
    assert_matches_per_frame(
        lambda: trenderer.TorchRenderer(W, H, device="cpu", **kwargs),
        stages, got)


@pytest.mark.parametrize("name,straight", [("morph-ratio", 0),
                                           ("morph-and-static", 0)])
def test_render_batch_morph_timeline_matches_reference(name, straight):
    """A ratio + matrix timeline rides the morph-affine sweep.  Against
    per-frame renders the reference's own bound applies, here in
    premultiplied bytes: the sweep lerps LOCAL f32 pieces then transforms,
    the per-frame path lerps twips commands in f64 then flattens (a few
    u8 steps at AA edges; a pixel of alpha 1 has an arbitrary straight
    colour on both sides, in the reference too)."""
    want_r, want, got_r, got, stages = _render_both(name)
    assert want_r.last_stats.path == "transform-sweep"
    assert got_r.last_stats.path == "transform-sweep"
    assert_matches_reference(want, got, straight)
    for i, stage in enumerate(stages):
        frame = trenderer.TorchRenderer(W, H, device="cpu").render(stage)
        diff = np.abs(premul(got[i]) - premul(frame))
        assert diff.max() <= 8, (i, diff.max())
        assert (diff > 2).mean() < 1e-3, i


def test_morph_timeline_launch_goes_through_the_morph_affine_wrapper(
        monkeypatch):
    from swf_renderer_tpu_torch.ops import transform as tsweep

    calls = []
    real = tsweep.render_morph_affine_sweep

    def spy(*args, **kwargs):
        calls.append(args[1].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tsweep, "render_morph_affine_sweep", spy)
    r = trenderer.TorchRenderer(W, H, device="cpu")
    r.render_batch(_stages(PORT, "morph-ratio"))
    assert calls == [(4,)] and r.last_stats.path == "transform-sweep"


@pytest.mark.parametrize("kind", ["swf-matrices", "device-affines"])
def test_render_shape_animation_matches_reference(kind):
    def mats_for(mods):
        if kind == "swf-matrices":
            return [_matrix(mods, 2 * np.pi * i / 9, 1.0 + 0.1 * i)
                    for i in range(4)]
        th = np.linspace(0.0, 1.2, 4)
        a, b = 1.1 * np.cos(th), 1.1 * np.sin(th)
        return np.stack([a, b, -b, a, 60 - a * 60 + b * 48,
                         48 - b * 60 - a * 48], 1).astype(np.float32)

    want = jrenderer.render_shape_animation(_focal(JAX), mats_for(JAX), W, H)
    got = trenderer.render_shape_animation(_focal(PORT), mats_for(PORT), W,
                                           H, device="cpu")
    assert got.shape == (4, H, W, 4)
    assert_matches_reference(
        want, got, {"swf-matrices": 4, "device-affines": 15}[kind])
    solid = trenderer.render_shape_animation(_solid(PORT), mats_for(PORT), W,
                                             H, quality="flash", device="cpu")
    want = jrenderer.render_shape_animation(_solid(JAX), mats_for(JAX), W, H,
                                            quality="flash")
    assert_matches_reference(want, solid, 1)


def test_render_shape_animation_needs_a_card_or_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trenderer.render_shape_animation(_solid(PORT), [_matrix(PORT)], W, H)


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------


def _port_renderer():
    return trenderer.TorchRenderer(W, H, device="cpu")


def test_different_definitions_take_the_batched_styled_route():
    stages = _stages(PORT, "mixed-rules")
    other = _solid(PORT, 1, (250, 200, 0, 255), winding=True)
    child = dataclasses.replace(stages[2].children[0], definition=other)
    stages[2] = dataclasses.replace(
        stages[2], children=[child, stages[2].children[1]])
    r = _port_renderer()
    got = r.render_batch(stages)
    assert r.last_stats.path == "batched-styled"
    assert np.array_equal(got[1], _port_renderer().render(stages[1]))


def test_identical_frames_take_the_batched_styled_route():
    stages = [_stages(PORT, "mixed-rules")[1]] * 3
    r = _port_renderer()
    r.render_batch(stages)
    assert r.last_stats.path == "batched-styled"


@pytest.mark.parametrize("gate", ["stage-size", "exact-clip"])
def test_stage_gates_keep_the_fused_route(gate):
    stages = _stages(PORT, "mixed-rules")
    if gate == "stage-size":
        stages = [dataclasses.replace(s, width=W - 8) for s in stages]
    else:
        stages = [dataclasses.replace(s, exact_width=W - 0.5,
                                      exact_height=float(H))
                  for s in stages]
    r = _port_renderer()
    assert r._transform_animation_plan(stages) is None
    r.render_batch(stages)
    assert r.last_stats.path == "batched-styled"


def test_blend_group_fails_the_gate_and_keeps_its_route():
    """A blend group never rides the sweep; the port's fused route then
    renders the batch through the masked program, as the reference
    does."""
    stages = _stages(PORT, "mixed-rules")
    stages = [dataclasses.replace(s, children=[
        dataclasses.replace(s.children[0], blend_mode="multiply"),
        s.children[1]]) for s in stages]
    r = _port_renderer()
    assert r._transform_animation_plan(stages) is None
    got = r.render_batch(stages)
    assert r.last_stats.path == "batched-styled"
    # The reference gates the same batch off its sweep, onto the same
    # route.
    jstages = _stages(JAX, "mixed-rules")
    jstages = [dataclasses.replace(s, children=[
        dataclasses.replace(s.children[0], blend_mode="multiply"),
        s.children[1]]) for s in jstages]
    jr = jrenderer.TpuRenderer(W, H)
    assert jr._transform_animation_plan(jstages) is None
    want = jr.render_batch(jstages)
    assert jr.last_stats.path == "batched-styled"
    assert got.shape == want.shape and got[..., 3].max() > 0
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, d.max()


def _bitmap_stages(mods, angles, smoothed=True):
    from swf_renderer_tpu_torch.runtime.bitmap_service import (
        encode_x_swf_bmp2_argb,
    )

    ast, display, fixed = mods
    img = np.random.default_rng(6).integers(0, 256, (12, 20, 4)).astype(
        np.uint8)
    bitmap = ast.DefineBitmap(
        id=9, width=20, height=12, media_type="image/x-swf-bmp2",
        data=encode_x_swf_bmp2_argb(img))
    s, z = fixed.from_value(30.0), fixed.from_value(0.0)
    tag = _shape(mods, 4, ast.BitmapFill(
        bitmap_id=9, matrix=ast.Matrix(
            scale_x=s, scale_y=s, rotate_skew0=z, rotate_skew1=z,
            translate_x=300, translate_y=200),
        repeating=True, smoothed=smoothed), BOX)
    mats = [_matrix(mods, th, tx=40 * i) for i, th in enumerate(angles)]
    stages = [display.Stage(width=W, height=H, children=[
        display.ShapeInstance(definition=tag, matrix=m)]) for m in mats]
    return tag, bitmap, mats, stages


def test_rotating_bitmap_layer_in_a_sweep_raises_naming_its_item():
    """Formerly a refusal: a rotating bitmap layer now bakes its field
    planes (the separable stack for the axis-aligned frame 0, the texfield
    kernel for the rest) and rides the sweep, in render_batch and in
    render_shape_animation, as in the JAX package."""
    angles = [0.0, 0.2, 0.4]
    jtag, jbitmap, jmats, jstages = _bitmap_stages(JAX, angles)
    tag, bitmap, mats, stages = _bitmap_stages(PORT, angles)
    jr = jrenderer.TpuRenderer(W, H)
    jr.add_bitmap(jbitmap)
    r = _port_renderer()
    r.add_bitmap(bitmap)
    want = jr.render_batch(jstages)
    got = r.render_batch(stages)
    assert r.last_stats.path == jr.last_stats.path == "transform-sweep"
    assert_matches_reference(want, got, 6)
    want = jrenderer.render_shape_animation(jtag, jmats, W, H,
                                            bitmaps=[jbitmap])
    got = trenderer.render_shape_animation(tag, mats, W, H, bitmaps=[bitmap],
                                           device="cpu")
    assert_matches_reference(want, got, 6)


def test_axis_aligned_bitmap_batch_keeps_the_fused_route():
    """Formerly kept off the sweep: a static bitmap under a moving solid
    now rides the sweep (the bitmap's one unique inverse bakes once
    through the separable stack and broadcasts), like the JAX package's
    batch, and matches the port's per-frame renders."""
    def stages_of(mods):
        _tag, bitmap, _mats, stages = _bitmap_stages(mods, [0.0])
        star = _solid(mods)
        return bitmap, [dataclasses.replace(stages[0], children=[
            stages[0].children[0],
            mods[1].ShapeInstance(definition=star,
                                  matrix=_matrix(mods, 0.3 * i, tx=50 * i))])
            for i in range(3)]

    jbitmap, jstages = stages_of(JAX)
    bitmap, stages = stages_of(PORT)
    jr = jrenderer.TpuRenderer(W, H)
    jr.add_bitmap(jbitmap)
    r = _port_renderer()
    r.add_bitmap(bitmap)
    want = jr.render_batch(jstages)
    got = r.render_batch(stages)
    assert r.last_stats.path == jr.last_stats.path == "transform-sweep"
    assert_matches_reference(want, got, 2)

    def one():
        fresh = _port_renderer()
        fresh.add_bitmap(bitmap)
        return fresh

    assert_matches_per_frame(one, stages, got)
