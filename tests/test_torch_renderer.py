"""TorchRenderer (plain kernel versions on the CPU) against TpuRenderer
(Pallas interpret mode) on DefineShapes built in code.

Tolerance: at most 1 u8 level per channel in the PREMULTIPLIED bytes the
pipeline rounds (pm8 = round(rgb8 * a8 / 255) recovers them exactly), on
at most 3e-3 of the bytes.  A premultiplied byte can move by 1 because
the two sides round paint values differently in their last bits: XLA on
the CPU contracts the focal solve's multiply-adds into FMAs (the port
computes op by op, as on the card), and the bitmap field's two float32
contractions sum in another order; a rotated or unsmoothed bitmap
samples through the reference's MXU kernel (3-pass bf16 split, ~1e-4)
against the port's gather.  Un-premultiplying scales a 1-level step by
255 / alpha, so on low-alpha AA edges the straight bytes can move
further; their envelope is pinned per stage at what was measured: 3
levels (focal field, rotated bitmap), 2 (axis-aligned bitmap), 85 (the
unsmoothed clipped bitmap: one AA pixel of alpha 3), 0 elsewhere (the
solid, linear, mixed-rule, morph, background and in-kernel gradient
stages are byte-equal).
"""

import logging

import numpy as np
import pytest

from swf_renderer_tpu.models import ast as jast
from swf_renderer_tpu.models import display as jdisplay
from swf_renderer_tpu.runtime import bitmap_service as jbitmaps
from swf_renderer_tpu.runtime.renderer import TpuRenderer
from swf_renderer_tpu.utils.fixed import Sfixed16P16 as JFixed
from swf_renderer_tpu_torch.models import ast as tast
from swf_renderer_tpu_torch.models import display as tdisplay
from swf_renderer_tpu_torch.runtime import bitmap_service as tbitmaps
from swf_renderer_tpu_torch.runtime.renderer import (
    TorchRenderer, render_morph_shape, render_shape,
)
from swf_renderer_tpu_torch.utils.fixed import Sfixed16P16 as TFixed

JAX = (jast, jdisplay, JFixed, jbitmaps)
PORT = (tast, tdisplay, TFixed, tbitmaps)
W, H = 160, 64


def levels(want, got):
    a = want.astype(np.int32)
    b = got.astype(np.int32)

    def premul(x):
        return np.concatenate(
            [(x[..., :3] * x[..., 3:] + 127) // 255, x[..., 3:]], -1)

    d = np.abs(a - b)
    return (int(d.max()), int(np.abs(premul(a) - premul(b)).max()),
            float((d != 0).mean()))


def assert_close(want, got, straight=1):
    assert want.shape == got.shape and got.dtype == np.uint8
    smax, pmax, share = levels(want, got)
    assert pmax <= 1 and smax <= straight and share <= 3e-3, (
        smax, pmax, share)


def _matrix(mods, tx=0, ty=0, scale=1.0, rot=0.0):
    ast, _, fixed, _ = mods
    return ast.Matrix(scale_x=fixed.from_value(scale),
                      scale_y=fixed.from_value(scale),
                      rotate_skew0=fixed.from_value(rot),
                      rotate_skew1=fixed.from_value(-rot),
                      translate_x=tx, translate_y=ty)


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


def _gradient(mods, spread="PAD"):
    ast = mods[0]
    return ast.Gradient(
        spread=getattr(ast.GradientSpread, spread),
        color_space=ast.ColorSpace.S_RGB,
        colors=[ast.GradientStop(0, ast.StraightSRgba8(255, 0, 0, 255)),
                ast.GradientStop(100, ast.StraightSRgba8(0, 255, 0, 180)),
                ast.GradientStop(255, ast.StraightSRgba8(0, 0, 255, 255))])


BOX = [(100, 100), (3000, 140), (2900, 1200), (160, 1100)]
STAR = [(1600 + int(900 * np.cos(a)), 640 + int(560 * np.sin(a)))
        for a in np.linspace(0, 4 * np.pi, 5, endpoint=False)]


def _solid(mods, shape_id=1, color=(200, 40, 90, 220), points=BOX,
           winding=False):
    ast = mods[0]
    return _shape(mods, shape_id, ast.SolidFill(ast.StraightSRgba8(*color)),
                  points, winding)


def _linear(mods, shape_id=2, spread="PAD", tx=1500, scale=0.08):
    return _shape(mods, shape_id, mods[0].LinearGradientFill(
        matrix=_matrix(mods, tx, 600, scale), gradient=_gradient(mods, spread)),
        BOX)


def _focal(mods, shape_id=3, spread="REFLECT", focal=120, tx=1700):
    return _shape(mods, shape_id, mods[0].FocalGradientFill(
        matrix=_matrix(mods, tx, 650, 0.05), gradient=_gradient(mods, spread),
        focal_point_epsilons=focal), BOX)


def _bitmap_tag(mods):
    ast, _, _, bitmaps = mods
    img = np.random.default_rng(6).integers(0, 256, (12, 20, 4)).astype(
        np.uint8)
    return ast.DefineBitmap(id=9, width=20, height=12,
                            media_type="image/x-swf-bmp2",
                            data=bitmaps.encode_x_swf_bmp2_argb(img))


def _bitmap(mods, rot=0.0, repeating=True, smoothed=True):
    return _shape(mods, 4, mods[0].BitmapFill(
        bitmap_id=9, matrix=_matrix(mods, 300, 200, 30.0, rot),
        repeating=repeating, smoothed=smoothed), BOX)


def _stage(mods, children, bg=None):
    ast, display = mods[0], mods[1]
    kw = {} if bg is None else {
        "background_color": ast.StraightSRgba8(*bg)}
    return display.Stage(width=W, height=H, children=[
        display.ShapeInstance(definition=tag, matrix=m)
        for tag, m in children], **kw)


def _morph(mods):
    ast = mods[0]
    records = (
        ast.MorphStyleChangeRecord(
            move_to=ast.Vector2D(100, 100),
            morph_move_to=ast.Vector2D(400, 200), left_fill=1),
        ast.MorphEdgeRecord(delta=ast.Vector2D(2400, 0),
                            morph_delta=ast.Vector2D(2000, 300)),
        ast.MorphEdgeRecord(delta=ast.Vector2D(0, 1000),
                            morph_delta=ast.Vector2D(-300, 700)),
        ast.MorphEdgeRecord(delta=ast.Vector2D(-2400, -1000),
                            morph_delta=ast.Vector2D(-1700, -1000)),
    )
    fill = ast.MorphSolidFill(color=ast.StraightSRgba8(10, 200, 120, 255),
                              morph_color=ast.StraightSRgba8(250, 20, 60, 90))
    return ast.DefineMorphShape(
        id=7, bounds=ast.Rect(0, 3000, 0, 1200),
        morph_bounds=ast.Rect(0, 3000, 0, 1200),
        shape=ast.MorphShapeBody(
            initial_styles=ast.MorphShapeStyles(fill=(fill,), line=()),
            records=records))


def _scene(mods, name):
    """(stage, renderer kwargs, bitmaps) of one named test stage."""
    if name == "solid-background":
        return _stage(mods, [(_solid(mods), None)], bg=(30, 60, 90, 200)), {}
    if name == "linear":
        return _stage(mods, [(_linear(mods), None)]), {}
    if name == "focal":
        return _stage(mods, [(_focal(mods), None)]), {}
    if name == "bitmap":
        return _stage(mods, [(_bitmap(mods), None)]), {}
    if name == "bitmap-rotated":
        return _stage(mods, [(_bitmap(mods, rot=12.0), None)]), {}
    if name == "bitmap-nearest":
        return _stage(mods, [(_bitmap(mods, rot=9.0, repeating=False,
                                      smoothed=False), None)]), {}
    if name == "mixed-rules":
        return _stage(mods, [
            (_solid(mods, 1, (250, 200, 0, 255), STAR, winding=True),
             _matrix(mods, -800, 0)),
            (_solid(mods, 2, (0, 90, 250, 200), STAR, winding=False),
             _matrix(mods, 700, 0))]), {"honor_fill_winding": True}
    if name == "morph":
        ast, display = mods[0], mods[1]
        return display.Stage(width=W, height=H, children=[
            display.MorphShapeInstance(definition=_morph(mods), ratio=0.4)]), {}
    if name == "in-kernel-gradients":
        return _stage(mods, [
            (_linear(mods, 10 + i, ("PAD", "REPEAT", "REFLECT")[i % 3],
                     tx=900 + 300 * i, scale=0.05 + 0.01 * i), None)
            for i in range(3)] + [
            (_focal(mods, 20 + i, ("PAD", "REPEAT")[i], focal=-60 + 90 * i,
                    tx=1200 + 500 * i), None)
            for i in range(2)]), {}
    raise KeyError(name)


STRAIGHT_ENVELOPE = {"focal": 3, "bitmap": 2, "bitmap-rotated": 3,
                     "bitmap-nearest": 85}
SCENES = ["solid-background", "linear", "focal", "bitmap", "bitmap-rotated",
          "bitmap-nearest", "mixed-rules", "morph", "in-kernel-gradients"]


@pytest.mark.parametrize("name", SCENES)
def test_render_matches_tpu_renderer(name):
    jstage, kw = _scene(JAX, name)
    tstage, _ = _scene(PORT, name)
    jr = TpuRenderer(W, H, **kw)
    tr = TorchRenderer(W, H, device="cpu", **kw)
    if name.startswith("bitmap"):
        jr.add_bitmap(_bitmap_tag(JAX))
        tr.add_bitmap(_bitmap_tag(PORT))
    want = jr.render(jstage)
    got = tr.render(tstage)
    assert tr.last_stats.path == jr.last_stats.path == "flatblock"
    assert tr.last_stats.draws == jr.last_stats.draws
    assert tr.last_stats.edges == jr.last_stats.edges
    assert got[..., 3].max() > 0
    assert_close(want, got, STRAIGHT_ENVELOPE.get(name, 1))


def test_render_batch_matches_tpu_renderer_batched_styled():
    """Frames whose geometry differs (other definitions, same layer
    structure): the JAX side batches through the fused styled kernel
    rather than the transform sweep, like the port."""
    def stages(mods):
        return [_stage(mods, [
            (_linear(mods), None),
            (_solid(mods, 30 + f, (40 * f, 200, 90, 230),
                    [(x + 300 * f, y + 100 * f) for x, y in STAR]), None)])
            for f in range(2)]

    jr = TpuRenderer(W, H)
    tr = TorchRenderer(W, H, device="cpu")
    want = jr.render_batch(stages(JAX))
    got = tr.render_batch(stages(PORT))
    assert jr.last_stats.path == tr.last_stats.path == "batched-styled"
    assert got.shape == (2, H, W, 4)
    assert_close(want, got)
    assert np.array_equal(got[0], tr.render(stages(PORT)[0]))


def test_non_uniform_batch_renders_stage_by_stage(caplog):
    tr = TorchRenderer(W, H, device="cpu")
    uneven = [_stage(PORT, [(_solid(PORT), None)]),
              _stage(PORT, [(_solid(PORT), None), (_linear(PORT), None)])]
    with caplog.at_level(logging.WARNING, logger="swf_renderer_tpu_torch"):
        out = tr.render_batch(uneven)
    assert out.shape == (2, H, W, 4)
    assert tr.last_stats.path.startswith("per-stage:non-uniform")
    assert np.array_equal(out[1], tr.render(uneven[1]))


def test_draws_from_numpy_carries_compiled_draws():
    """JAX-compiled draw lists, carried across by convert.draws_from_numpy,
    render like the port's own compilation."""
    from swf_renderer_tpu.runtime.scene import SceneCompiler
    from swf_renderer_tpu.runtime.bitmap_service import BitmapService
    from swf_renderer_tpu_torch.convert import draws_from_numpy

    jstage, _ = _scene(JAX, "linear")
    draws = SceneCompiler(BitmapService(), {}, {}).compile_stage(jstage)
    tr = TorchRenderer(W, H, device="cpu")
    carried = tr.execute(draws_from_numpy(draws))
    own = tr.render(_scene(PORT, "linear")[0])
    assert np.array_equal(carried, own)


def test_one_shot_helpers():
    tag = _solid(PORT, points=[(0, 0), (900, 40), (500, 700)])
    frame = render_shape(tag, device="cpu")
    assert frame.shape == (35, 45, 4) and frame[..., 3].max() == 220
    morph = render_morph_shape(_morph(PORT), 0.5, device="cpu")
    assert morph.shape == (60, 150, 4) and morph[..., 3].max() > 0


@pytest.mark.parametrize("kwargs,item", [
    ({"backend": "scanline"}, "scanline/direct"),
    ({"backend": "direct"}, "scanline/direct"),
    ({"quality": "flash-pointaa"}, "pointaa"),
    ({"validate": True}, "scanline/direct"),
])
def test_out_of_slice_backends_raise(kwargs, item):
    """The routes that raised before the layered backends were ported
    (ROADMAP.md queue A ``item``) now render, through the layered path,
    what the reference renders (more scenes: test_torch_layered.py)."""
    path = {"scanline/direct": kwargs.get("backend", "scanline"),
            "pointaa": "pointaa"}[item]
    jstage, _ = _scene(JAX, "mixed-rules")
    tstage, kw = _scene(PORT, "mixed-rules")
    jr = TpuRenderer(W, H, **kwargs, **kw)
    tr = TorchRenderer(W, H, device="cpu", **kwargs, **kw)
    want = jr.render(jstage)
    got = tr.render(tstage)
    assert jr.last_stats.path == tr.last_stats.path == path
    assert got[..., 3].max() > 0
    assert_close(want, got, 0)


def test_out_of_slice_scenes_raise():
    """Scenes that raised before the masked program and multi-pass were
    ported — a clip group, 17 layers — now render what the reference
    renders (more scenes: test_torch_masks.py, test_torch_multipass.py),
    and so do frames wider than 8191 px."""
    tr = TorchRenderer(W, H, device="cpu")
    jr = TpuRenderer(W, H)

    def masked(mods):
        display = mods[1]
        return display.Stage(width=W, height=H, children=[
            display.MaskedGroup(
                mask=display.ShapeInstance(definition=_solid(mods)),
                children=[display.ShapeInstance(
                    definition=_linear(mods))])])

    def deep(mods):
        display = mods[1]
        return display.Stage(width=W, height=H, children=[
            display.ShapeInstance(definition=_solid(mods, i))
            for i in range(17)])

    for build in (masked, deep):
        got = tr.render(build(PORT))
        assert tr.last_stats.path == "flatblock"
        assert got[..., 3].max() > 0
        assert_close(jr.render(build(JAX)), got, 1)
    batch = tr.render_batch([masked(PORT), masked(PORT)])
    assert tr.last_stats.path == "batched-styled"
    np.testing.assert_array_equal(batch[1], tr.render(masked(PORT)))
    # Frames wider than 8191 px render through the layered backends (auto:
    # scanline coverage), as in the reference.
    wide_pts = [(100, 20), (163000, 60), (162000, 140), (60, 150)]

    def wide_stage(mods):
        return mods[1].Stage(width=8200, height=8, children=[
            mods[1].ShapeInstance(definition=_solid(mods, points=wide_pts))])

    want = TpuRenderer(8200, 8).render(wide_stage(JAX))
    wide = TorchRenderer(8200, 8, device="cpu")
    got = wide.render(wide_stage(PORT))
    assert wide.last_stats.path == "scanline"
    assert got.shape == (8, 8200, 4) and got[:, 8000:, 3].max() > 0
    # XLA's cumsum adds in another order (coverage 2.5e-7 apart): one
    # low-alpha AA pixel moves 18 straight levels (share 1.9e-5), pinned.
    assert_close(want, got, 18)
