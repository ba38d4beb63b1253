"""Clip groups (display.MaskedGroup) through the port's masked program on
the CPU, against the JAX package's TpuRenderer (Pallas interpret mode)
and against the port's own layered compositor.

The scenes are tests/test_masks.py's, built in code with each package's
own models.  What holds, per scene:

- the reference's semantics on the port's frames (masks are not painted,
  strokes and colour transforms of the mask do nothing, nesting
  intersects, siblings after the group are not clipped);
- port fused (``backend="auto"``, path "flatblock") against port layered
  (``backend="scanline"``): byte-equal where the reference pins equality
  (single-pass groups: the chain form and the group plane algebra are
  the layered compositor's operations), within 1 level where its passes
  regroup f32 operations (deep content, deep masks, random trees);
- port against the JAX package, same backend: at most 1 premultiplied
  level; differing straight bytes pinned per scene at what was measured
  (the port sums the cross-chunk carry in fixed point, the reference in
  f32, so a winding can differ in its last bit).
"""

import numpy as np
import pytest

from swf_renderer_tpu.models import ast as jast
from swf_renderer_tpu.models import display as jdisplay
from swf_renderer_tpu.runtime.renderer import TpuRenderer
from swf_renderer_tpu.utils.fixed import Sfixed16P16 as JFixed
from swf_renderer_tpu_torch.models import ast as tast
from swf_renderer_tpu_torch.models import display as tdisplay
from swf_renderer_tpu_torch.ops import pipeline as tpl
from swf_renderer_tpu_torch.runtime.renderer import TorchRenderer
from swf_renderer_tpu_torch.runtime.scene import build_mask_tree
from swf_renderer_tpu_torch.utils.fixed import Sfixed16P16 as TFixed

JAX = (jast, jdisplay, JFixed)
PORT = (tast, tdisplay, TFixed)


def levels(want, got):
    """(straight max, premultiplied max, differing straight share)."""
    a = want.astype(np.int32)
    b = got.astype(np.int32)

    def premul(x):
        return np.concatenate(
            [(x[..., :3] * x[..., 3:] + 127) // 255, x[..., 3:]], -1)

    d = np.abs(a - b)
    return (int(d.max()), int(np.abs(premul(a) - premul(b)).max()),
            float((d != 0).mean()))


class Scene:
    """Shape and stage constructors over one package's models."""

    def __init__(self, mods):
        self.ast, self.display, self.fixed = mods

    def tl(self, tx, ty):
        one, zero = self.fixed.from_value(1), self.fixed.from_value(0)
        return self.ast.Matrix(scale_x=one, scale_y=one, rotate_skew0=zero,
                               rotate_skew1=zero, translate_x=tx,
                               translate_y=ty)

    def rgba(self, r, g, b, a=255):
        return self.ast.StraightSRgba8(int(r), int(g), int(b), int(a))

    def rect(self, sid, w, h, color, line=None):
        ast = self.ast
        records = (
            ast.StyleChangeRecord(move_to=ast.Vector2D(0, 0), left_fill=1,
                                  line_style=(1 if line else None)),
            ast.EdgeRecord(delta=ast.Vector2D(w, 0)),
            ast.EdgeRecord(delta=ast.Vector2D(0, h)),
            ast.EdgeRecord(delta=ast.Vector2D(-w, 0)),
            ast.EdgeRecord(delta=ast.Vector2D(0, -h)),
        )
        lines = ()
        if line:
            lines = (ast.LineStyle(
                width=line, start_cap="round", end_cap="round",
                join={"type": "round"}, no_h_scale=False, no_v_scale=False,
                no_close=False, pixel_hinting=False,
                fill=ast.SolidFill(color=self.rgba(255, 0, 0))),)
        return self.shape(sid, w, h, color, records, lines)

    def shape(self, sid, w, h, color, records, lines=()):
        ast = self.ast
        return ast.DefineShape(
            id=sid, bounds=ast.Rect(0, w, 0, h),
            shape=ast.ShapeBody(
                initial_styles=ast.ShapeStyles(
                    fill=(ast.SolidFill(color=color),), line=lines),
                records=records))

    def inst(self, definition, tx=0, ty=0, **kw):
        return self.display.ShapeInstance(definition=definition,
                                          matrix=self.tl(tx, ty), **kw)

    def masked(self, mask, children):
        return self.display.MaskedGroup(mask=mask, children=tuple(children))

    def stage(self, children, w=40, h=30):
        return self.display.Stage(width=w, height=h,
                                  background_color=self.rgba(0, 0, 0, 0),
                                  children=tuple(children))

    @property
    def full(self):
        return self.rect(1, 800, 600, self.rgba(0, 0, 255))

    @property
    def half(self):
        return self.rect(2, 400, 600, self.rgba(0, 200, 0))


def scene_clip(s):
    return s.stage([s.masked(s.inst(s.half), [s.inst(s.full)])])


def scene_moved_mask(s):
    return s.stage([s.masked(s.inst(s.half, 400, 0), [s.inst(s.full)])])


def scene_stroked_mask(s):
    fat = s.rect(3, 400, 600, s.rgba(0, 200, 0), line=200)
    return s.stage([s.masked(s.inst(fat), [s.inst(s.full)])])


def scene_ct_mask(s):
    ct = s.display.ColorTransform(mult=(1.0, 1.0, 1.0, 0.0),
                                  add=(0.0, 0.0, 0.0, 0.0))
    return s.stage([s.masked(s.inst(s.half, color_transform=ct),
                             [s.inst(s.full)])])


def scene_nested(s):
    top = s.rect(4, 800, 300, s.rgba(0, 200, 0))
    inner = s.masked(s.inst(top), [s.inst(s.full)])
    return s.stage([s.masked(s.inst(s.half), [inner])])


def scene_sibling(s):
    return s.stage([s.masked(s.inst(s.half), [s.inst(s.full)]),
                    s.inst(s.rect(5, 800, 600, s.rgba(255, 0, 0)))])


def scene_empty_mask(s):
    return s.stage([s.masked(s.display.Container(children=()),
                             [s.inst(s.full)])])


def scene_overlap(s):
    """Nesting, overlapping translucent content, unmasked siblings."""
    blue50 = s.rect(6, 700, 500, s.rgba(0, 0, 255, 128))
    red50 = s.rect(7, 700, 500, s.rgba(255, 0, 0, 128))
    top = s.rect(8, 800, 340, s.rgba(0, 200, 0))
    inner = s.masked(s.inst(top), [s.inst(blue50, 30, 20),
                                   s.inst(red50, 130, 90)])
    return s.stage([s.inst(s.rect(9, 800, 600, s.rgba(0, 200, 0))),
                    s.masked(s.inst(s.half, 50, 30), [inner]),
                    s.inst(s.rect(10, 300, 200, s.rgba(255, 0, 0)), 450,
                           350)])


def scene_deep_content(s):
    """18 content layers: passes chain inside the group."""
    layers = [s.inst(s.rect(20 + i, 400, 300,
                            s.rgba(10 * i, 255 - 10 * i, 40, 200)),
                     15 * i, 10 * i) for i in range(18)]
    return s.stage([s.masked(s.inst(s.half), layers)])


def scene_deep_mask(s):
    """A mask of 18 fills: chained white passes."""
    tiles = tuple(s.inst(s.rect(30 + i, 140, 700, s.rgba(0, 200, 0)),
                         120 * (i % 6), 60 * (i // 6)) for i in range(18))
    return s.stage([s.masked(s.display.Container(children=tiles),
                             [s.inst(s.full)])])


def scene_random(s, seed):
    """Random mask trees (rects and triangles, translucent colours,
    optional nesting and siblings): tests/test_masks.py's fuzz."""
    rng = np.random.default_rng(7000 + seed)
    sid = [1]

    def rand_shape():
        sid[0] += 1
        w = int(rng.integers(100, 700))
        h = int(rng.integers(100, 500))
        color = s.rgba(*rng.integers(0, 256, 3), int(rng.integers(60, 256)))
        if rng.uniform() < 0.5:
            return s.rect(sid[0], w, h, color)
        ast = s.ast
        records = (
            ast.StyleChangeRecord(move_to=ast.Vector2D(0, 0), left_fill=1),
            ast.EdgeRecord(delta=ast.Vector2D(w, int(rng.integers(0, h)))),
            ast.EdgeRecord(delta=ast.Vector2D(-int(rng.integers(0, w)), h)),
            ast.EdgeRecord(delta=ast.Vector2D(
                -w + int(rng.integers(0, w)),
                -h - int(rng.integers(0, h)))),
        )
        return s.shape(sid[0], w, h, color, records)

    def inst():
        d = rand_shape()
        return s.inst(d, int(rng.integers(0, 400)),
                      int(rng.integers(0, 300)))

    def rand_items(depth):
        items = []
        for _ in range(int(rng.integers(1, 4))):
            if depth < 2 and rng.uniform() < 0.4:
                items.append(s.masked(inst(), rand_items(depth + 1)))
            else:
                items.append(inst())
        return items

    return s.stage(rand_items(0))


# name -> (scene function, fused vs layered straight levels, port vs JAX
# differing straight share: measured 0 everywhere but deep_content, where
# one byte of 4800 moves one straight level)
SCENES = {
    "clip": (scene_clip, 0, 0.0),
    "moved_mask": (scene_moved_mask, 0, 0.0),
    "stroked_mask": (scene_stroked_mask, 0, 0.0),
    "ct_mask": (scene_ct_mask, 0, 0.0),
    "nested": (scene_nested, 0, 0.0),
    "sibling": (scene_sibling, 0, 0.0),
    "empty_mask": (scene_empty_mask, 0, 0.0),
    "overlap": (scene_overlap, 0, 0.0),
    "deep_content": (scene_deep_content, 1, 2.1e-4),
    "deep_mask": (scene_deep_mask, 1, 0.0),
}


def render(mods, build, backend="auto"):
    stage = build(Scene(mods))
    if mods is PORT:
        r = TorchRenderer(stage.width, stage.height, backend=backend,
                          device="cpu")
    else:
        r = TpuRenderer(stage.width, stage.height, backend=backend)
    return r.render(stage), r


@pytest.mark.parametrize("name", sorted(SCENES))
def test_masked_scene_fused_matches_layered_and_reference(name):
    build, envelope, share = SCENES[name]
    fused, r = render(PORT, build)
    assert r._exec_path == "flatblock"
    layered, _ = render(PORT, build, "scanline")
    diff = np.abs(fused.astype(np.int32) - layered.astype(np.int32))
    assert diff.max() <= envelope, diff.max()
    want, jr = render(JAX, build)
    assert jr._exec_path == "flatblock"
    smax, pmax, got_share = levels(want, fused)
    assert pmax <= 1 and got_share <= share, (smax, pmax, got_share)


def test_mask_semantics_on_the_port():
    """tests/test_masks.py's assertions, on the port's fused frames."""
    got = {name: render(PORT, SCENES[name][0])[0] for name in (
        "clip", "moved_mask", "stroked_mask", "ct_mask", "nested",
        "sibling", "empty_mask")}
    unmasked = render(PORT, lambda s: s.stage([s.inst(s.full)]))[0]
    clip = got["clip"]
    np.testing.assert_array_equal(clip[:, :19], unmasked[:, :19])
    assert (clip[:, 21:] == 0).all() and (clip[..., 1] == 0).all()
    assert (got["moved_mask"][:, :19] == 0).all()
    assert (got["moved_mask"][:, 21:39, 2] == 255).all()
    np.testing.assert_array_equal(got["stroked_mask"], clip)
    assert (got["ct_mask"][:, :19, 2] == 255).all()
    nested = got["nested"]
    assert (nested[:14, :19, 2] == 255).all()
    assert (nested[16:] == 0).all() and (nested[:, 21:] == 0).all()
    assert (got["sibling"][:, :, 0] == 255).all()
    assert (got["empty_mask"] == 0).all()


@pytest.mark.parametrize("seed", range(4))
def test_random_mask_trees(seed):
    """Fused against layered within one level (exactly, single-pass; the
    envelope covers pass-boundary regrouping), and against the JAX
    package within 1 premultiplied level."""
    def build(s):
        return scene_random(s, seed)

    fused, r = render(PORT, build)
    assert r._exec_path == "flatblock"
    layered, _ = render(PORT, build, "scanline")
    diff = np.abs(fused.astype(np.int32) - layered.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    want, _ = render(JAX, build)
    smax, pmax, share = levels(want, fused)
    assert pmax <= 1 and share <= 0.0, (smax, pmax, share)


def test_direct_backend_agrees_with_scanline():
    a, ra = render(PORT, scene_clip, "scanline")
    b, rb = render(PORT, scene_clip, "direct")
    assert (ra._exec_path, rb._exec_path) == ("scanline", "direct")
    np.testing.assert_array_equal(a, b)


def test_uniform_masked_timeline_rides_batched_path():
    """Frames sharing one clip-group structure batch through the masked
    program and match per-stage renders; a batch whose group structure
    changes goes stage by stage."""
    s = Scene(PORT)
    stages = [s.stage([s.masked(s.inst(s.half), [s.inst(s.full, 60 * k)])])
              for k in range(4)]
    r = TorchRenderer(40, 30, device="cpu")
    out = r.render_batch(stages)
    assert r.last_stats.path == "batched-styled"
    for k, stage in enumerate(stages):
        np.testing.assert_array_equal(out[k], r.render(stage))
    mixed = [stages[0], s.stage([s.inst(s.full), s.masked(
        s.inst(s.half), [s.inst(s.full)])])]
    out = r.render_batch(mixed)
    assert r.last_stats.path.startswith("per-stage:")
    assert "non-uniform" in r.last_stats.path
    np.testing.assert_array_equal(out[0], r.render(stages[0]))


def test_plan_masked_program_matches_reference():
    """The port's plan of a nested tree (deep content, deep mask, a blend
    group) equals the reference's, segment for segment."""
    from swf_renderer_tpu.ops import pipeline as jpl
    from swf_renderer_tpu.ops import style as jstyle
    from swf_renderer_tpu_torch.ops import style as tstyle

    tree = [("draw", 0),
            ("mask", list(range(1, 19)), [("draw", i) for i in
                                          range(19, 21)]),
            ("blend", "multiply", [("draw", i) for i in range(21, 40)]),
            ("mask", [40], [("draw", 41)])]
    rules = tuple(i % 3 == 0 for i in range(42))
    rules = tuple(int(r) for r in rules)
    colors = [(i / 50, 0.5, 1 - i / 50, 0.9) for i in range(42)]
    jsegs, jprog, jfinal = jpl.plan_masked_program(
        tree, [jstyle.solid_paint(c) for c in colors], rules)
    tsegs, tprog, tfinal = tpl.plan_masked_program(
        tree, [tstyle.solid_paint(c) for c in colors], rules)
    assert (tprog, tfinal) == (jprog, jfinal)
    assert [(i, r, w) for i, _, r, w in tsegs] == [
        (i, r, w) for i, _, r, w in jsegs]
    assert [[p.color for p in ps] for _, ps, _, _ in tsegs] == [
        [p.color for p in ps] for _, ps, _, _ in jsegs]
    for step in tprog:
        if step[0] == "mask":
            assert tpl._fusible_mask_step(step) == jpl._fusible_mask_step(
                step)
            if tpl._fusible_mask_step(step):
                t = tpl.build_fused_mask_pair(tsegs, step[2][0][1][0],
                                              tuple(step[1]))
                j = jpl.build_fused_mask_pair(jsegs, step[2][0][1][0],
                                              tuple(step[1]))
                assert (t is None) == (j is None)
                if t is not None:
                    assert (t[0], t[2], t[3]) == (j[0], j[2], j[3])


def test_mask_tree_of_compiled_draws():
    """The renderer hands the compiled draws' group tree to the masked
    program: one mask node over its content for the clip scene."""
    s = Scene(PORT)
    r = TorchRenderer(40, 30, device="cpu")
    draws = r._compiler().compile_stage(scene_overlap(s))
    tree = build_mask_tree(draws)
    assert [item[0] for item in tree] == ["draw", "mask", "draw"]
    assert tree[1][2][0][0] == "mask"
