"""Bitmap fills under any matrix, on the CPU: the port's texfield path
(``ops/texfield.py``, ``style.paint_field``, ``transform.
bake_sweep_fields``) and the single-frame interactive sweep of
``TorchRenderer.render`` against the JAX package, on numpy inputs made
from a seed.

Tolerances:
* ``texfield_plain`` (the CUDA kernel's arithmetic) against the JAX
  gather ``style.paint_field_traced`` on XLA:CPU: smoothed fields within
  2e-6.  Nearest sampling picks one texel per subsample, so a coordinate
  whose last bit differs can cross a texel border; the share of such
  pixels is pinned at what was measured (ROADMAP.md queue C).
* Against the JAX kernel ``bitmap_field_planes`` (Pallas, interpret
  mode): 2e-4 for its default 3-pass bf16 contraction and 5e-6 for
  ``dot_mode="highest"`` — the JAX package's own tolerances between its
  kernel and its gather (tests/test_texfield.py).
* Frames: at most 1 u8 level in the premultiplied bytes, straight bytes
  pinned per scene, as in tests/test_torch_animation.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swf_renderer_tpu.models import ast as jast
from swf_renderer_tpu.models import display as jdisplay
from swf_renderer_tpu.ops import style as jstyle
from swf_renderer_tpu.ops import texfield as jtex
from swf_renderer_tpu.ops import transform as jsweep
from swf_renderer_tpu.runtime.bitmap_service import Bitmap as JBitmap
from swf_renderer_tpu.runtime.renderer import TpuRenderer
from swf_renderer_tpu.utils.fixed import Sfixed16P16 as JFixed
from swf_renderer_tpu_torch import convert
from swf_renderer_tpu_torch.models import ast as tast
from swf_renderer_tpu_torch.models import display as tdisplay
from swf_renderer_tpu_torch.ops import pipeline as tpipeline
from swf_renderer_tpu_torch.ops import style as tstyle
from swf_renderer_tpu_torch.ops import texfield as ttex
from swf_renderer_tpu_torch.ops import transform as tsweep
from swf_renderer_tpu_torch.runtime.bitmap_service import Bitmap as TBitmap
from swf_renderer_tpu_torch.runtime.renderer import TorchRenderer
from swf_renderer_tpu_torch.utils.fixed import Sfixed16P16 as TFixed

JAX = (jast, jdisplay, JFixed, JBitmap, TpuRenderer)
PORT = (tast, tdisplay, TFixed, TBitmap, TorchRenderer)
MODES = {"repeat": (True, "flash"), "clamp": (False, "flash"),
         "canvas": (False, "canvas")}


def _texture(shape, seed):
    img = np.random.default_rng(seed).integers(0, 256, (*shape, 4)).astype(
        np.uint8)
    img[0, :2, 3] = 0     # transparent texels: the un-premultiply guard
    return img


def _invs(kind):
    """Two device->texel inverses of one kind, offsets across the edge."""
    if kind == "rotated":
        th = np.asarray([0.35, 2.2])
        a, b = 0.3 * np.cos(th), 0.3 * np.sin(th)
        rows = np.stack([a, b, -b, a, [-2.5, 9.0], [3.0, -1.5]], 1)
    elif kind == "skewed":
        rows = [(0.25, 0.11, -0.07, 0.31, -4.0, 1.0),
                (0.42, -0.2, 0.15, 0.18, 2.0, -6.5)]
    else:   # far zoom out and far in, far from the texture
        rows = [(3.0, 0.5, -0.5, 3.0, -40.0, 25.0),
                (0.011, 0.002, -0.001, 0.013, 4.0, 4.0)]
    return np.asarray(rows, np.float32)


def _jax_gather(img, invs, height, width, repeating, smoothed, edge_mode, n):
    p = jstyle.Paint(kind=jstyle.PAINT_BITMAP, image=img,
                     repeating=repeating, smoothed=smoothed,
                     edge_mode=edge_mode, supersample=n)
    return np.stack([np.asarray(jstyle.paint_field_traced(
        p, jnp.asarray(iv), height, width)) for iv in invs])


def _plain(img, invs, height, width, repeating, smoothed, edge_mode, n):
    return ttex.texfield_plain(torch.as_tensor(img), torch.as_tensor(invs),
                               height, width, n, repeating, smoothed,
                               edge_mode).numpy()


def _assert_fields(want, got, smoothed, flipped_share=0.0):
    assert want.shape == got.shape
    d = np.abs(got - want)
    if smoothed:
        assert d.max() <= 2e-6, d.max()
    else:
        assert float((d.max(-1) > 2e-6).mean()) <= flipped_share


# ---------------------------------------------------------------------------
# The plain version against the JAX package's gather and its kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rotated", "skewed", "zoomed"])
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("smoothed", [True, False],
                         ids=["smoothed", "nearest"])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_matches_jax_gather(mode, smoothed, n, kind):
    repeating, edge_mode = MODES[mode]
    img = _texture((11, 13), n)
    invs = _invs(kind)
    want = _jax_gather(img, invs, 18, 26, repeating, smoothed, edge_mode, n)
    got = _plain(img, invs, 18, 26, repeating, smoothed, edge_mode, n)
    _assert_fields(want, got, smoothed)
    assert float(got[..., 3].std()) > 0.01


@pytest.mark.parametrize("mode,smoothed,n", [
    ("repeat", True, 2), ("canvas", False, 1), ("clamp", True, 1)])
def test_plain_matches_jax_gather_above_the_tpu_texel_cap(mode, smoothed, n):
    """A 300 x 260 texture: beyond the reference kernel's 256 x 256 cap
    the JAX package takes its gather; the port keeps its one kernel.  The
    port's gather twin ``paint_field_traced`` is its plain version."""
    repeating, edge_mode = MODES[mode]
    img = _texture((300, 260), 7)
    assert img.shape[0] * img.shape[1] > jtex.MAX_KERNEL_TEXELS
    invs = np.asarray([(1.9, 0.6, -0.5, 2.1, 20.0, -15.0)], np.float32)
    want = _jax_gather(img, invs, 24, 30, repeating, smoothed, edge_mode, n)
    got = tstyle.paint_field_traced(tstyle.Paint(
        kind=tstyle.PAINT_BITMAP, image=img, repeating=repeating,
        smoothed=smoothed, edge_mode=edge_mode, supersample=n),
        torch.as_tensor(invs), 24, 30).numpy()
    _assert_fields(want, got, smoothed)
    assert np.array_equal(got, _plain(img, invs, 24, 30, repeating,
                                      smoothed, edge_mode, n))


@pytest.mark.parametrize("mode,smoothed,n,dot_mode,tol", [
    ("repeat", True, 2, "split3", 2e-4),
    ("clamp", True, 2, "split3", 2e-4),
    ("canvas", False, 2, "split3", 2e-4),
    ("repeat", False, 1, "split3", 2e-4),
    ("repeat", True, 2, "highest", 5e-6),
])
def test_plain_matches_jax_kernel(mode, smoothed, n, dot_mode, tol):
    repeating, edge_mode = MODES[mode]
    img = _texture((11, 13), 5)
    invs = np.concatenate([_invs("rotated"), _invs("skewed")])
    want = np.asarray(jtex.bitmap_field_planes(
        img, invs, 20, 28, supersample=n, repeating=repeating,
        smoothed=smoothed, edge_mode=edge_mode, dot_mode=dot_mode))
    got = ttex.bitmap_field_planes(img, invs, 20, 28, supersample=n,
                                   repeating=repeating, smoothed=smoothed,
                                   edge_mode=edge_mode, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=tol)


# ---------------------------------------------------------------------------
# paint_field and bake_sweep_fields
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["rotated", "nearest", "large"])
def test_paint_field_matches_jax(name):
    """``paint_field`` of a rotated, an unsmoothed and a large-texture
    bitmap fill.  The JAX side samples the first two through its kernel
    (2e-4) and the large one through its gather (2e-6)."""
    shape = (300, 260) if name == "large" else (11, 13)
    inv = (0.27, 0.09, -0.12, 0.3, -2.0, 1.5)
    if name == "large":
        inv = (1.9, 0.6, -0.5, 2.1, 20.0, -15.0)
    kw = dict(kind=jstyle.PAINT_BITMAP, image=_texture(shape, 2),
              inv_matrix=inv, repeating=name != "nearest",
              smoothed=name != "nearest", edge_mode="canvas", supersample=2)
    want = np.asarray(jstyle.paint_field(jstyle.Paint(**kw), 22, 30))
    got = tstyle.paint_field(tstyle.Paint(**kw), 22, 30, device="cpu")
    assert tuple(got.shape) == (22, 30, 4)
    tol = 2e-6 if name == "large" else 2e-4
    np.testing.assert_allclose(got.numpy(), want, atol=tol)


def _bake_specs(mod_sweep, mod_style, case):
    img = _texture((9, 14), 4)
    scale = 1.6 if case == "all-separable" else 0.4   # downscaled: box
    th = {"all-separable": [0.0, 0.0, 0.0],
          "none-separable": [0.2, 0.9, 2.5],
          "mixed-through-0": [-0.3, 0.0, 0.3, 0.6],
          "dedup": [0.5, 0.1, 0.5, 0.5]}[case]
    th = np.asarray(th)
    invs = np.stack([scale * np.cos(th), scale * np.sin(th),
                     -scale * np.sin(th), scale * np.cos(th),
                     1.5 + 2.0 * th, -0.5 * th], 1)
    if case == "all-separable":
        invs[:, 3] *= 0.7
        invs[:, 4] += np.arange(th.size)
    paint = mod_style.Paint(kind=mod_style.PAINT_BITMAP, image=img,
                            repeating=True, supersample=2)
    return [mod_sweep.SweepFieldSpec(1, paint, invs.astype(np.float32))]


@pytest.mark.parametrize("case", ["all-separable", "none-separable",
                                  "mixed-through-0", "dedup"])
def test_bake_sweep_fields_bitmaps_match_jax(case):
    """Bitmap layers of the sweeps: axis-aligned frames bake through the
    separable weights (both sides float32 contractions: 2e-6), the others
    through the texfield kernel (the JAX kernel's 2e-4); a repeated
    inverse bakes once."""
    want = np.asarray(jsweep.bake_sweep_fields(
        _bake_specs(jsweep, jstyle, case), 16, 22))
    got = tsweep.bake_sweep_fields(_bake_specs(tsweep, tstyle, case), 16,
                                   22, device="cpu")
    assert tuple(got.shape) == want.shape
    tol = 2e-6 if case == "all-separable" else 2e-4
    assert np.abs(got.numpy() - want).max() <= tol
    if case == "dedup":
        assert torch.equal(got[0, 0], got[0, 2])
        assert torch.equal(got[0, 0], got[0, 3])
    if case == "mixed-through-0":
        sep = _bake_specs(tsweep, tstyle, case)[0]
        alone = tstyle.separable_field_stack(sep.paint, sep.invs[1:2], 16,
                                             22, device="cpu")
        assert torch.equal(got[0, 1], alone[0])


# ---------------------------------------------------------------------------
# The wrapper and the device rule
# ---------------------------------------------------------------------------


def test_bitmap_field_planes_checks_its_inputs():
    img = _texture((5, 6), 1)
    inv = _invs("rotated")[0]
    before = ttex.bitmap_field_planes.launches
    out = ttex.bitmap_field_planes(img, inv, 4, 5, device="cpu")
    assert tuple(out.shape) == (1, 4, 5, 4)
    assert ttex.bitmap_field_planes.launches == before   # plain, no launch
    with pytest.raises(ValueError, match="edge_mode"):
        ttex.bitmap_field_planes(img, inv, 4, 5, edge_mode="wrap",
                                 device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        ttex.bitmap_field_planes(img.astype(np.float32), inv, 4, 5,
                                 device="cpu")
    with pytest.raises(ValueError, match=r"\(F, 6\)"):
        ttex.bitmap_field_planes(img, np.zeros((2, 5), np.float32), 4, 5,
                                 device="cpu")
    with pytest.raises(ValueError, match="supersample"):
        ttex.bitmap_field_planes(img, inv, 4, 5, supersample=0,
                                 device="cpu")


@pytest.mark.parametrize("entry", ["bitmap_field_planes", "paint_field",
                                   "kernel_paints_for", "bake_sweep_fields",
                                   "sweep_table_to_device"])
def test_entry_points_need_a_card_or_the_cpu(monkeypatch, entry):
    """Without ``device`` the entry points run on the card; with no card
    they raise instead of quietly taking the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = _texture((4, 4), 0)
    paint = tstyle.Paint(kind=tstyle.PAINT_BITMAP, image=img,
                         inv_matrix=(0.3, 0.1, -0.1, 0.3, 0.0, 0.0))
    calls = {
        "bitmap_field_planes": lambda: ttex.bitmap_field_planes(
            img, _invs("rotated"), 8, 8),
        "paint_field": lambda: tstyle.paint_field(paint, 8, 8),
        "kernel_paints_for": lambda: tpipeline.kernel_paints_for(
            [paint], 8, 8),
        "bake_sweep_fields": lambda: tsweep.bake_sweep_fields(
            [tsweep.SweepFieldSpec(0, paint, _invs("rotated"))], 8, 8),
        "sweep_table_to_device": lambda: convert.sweep_table_to_device(
            np.zeros((1, 4, 1, 8), np.float32)),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


# ---------------------------------------------------------------------------
# The single-frame interactive sweep: render() call sequences
# ---------------------------------------------------------------------------


def _premul(x):
    x = x.astype(np.int32)
    return np.concatenate(
        [(x[..., :3] * x[..., 3:] + 127) // 255, x[..., 3:]], -1)


def _assert_frames(want, got, straight, flipped):
    """Premultiplied bytes within 1 level and straight bytes within the
    pin, except on a share ``flipped`` of pixels where a nearest sample
    crossed a texel border."""
    assert want.shape == got.shape and got.dtype == np.uint8
    assert got[..., 3].max() > 100
    d = np.abs(want.astype(np.int32) - got.astype(np.int32)).max(-1)
    far = np.abs(_premul(want) - _premul(got)).max(-1) > 1
    assert far.mean() <= flipped and d[~far].max() <= straight, (
        far.mean(), d[~far].max())


def _rot_matrix(mods, th, scale, pivot):
    ast, fixed = mods[0], mods[2]
    a, b = scale * np.cos(th), scale * np.sin(th)
    return ast.Matrix(
        scale_x=fixed.from_value(a), scale_y=fixed.from_value(a),
        rotate_skew0=fixed.from_value(b), rotate_skew1=fixed.from_value(-b),
        translate_x=int(round(pivot - a * pivot + b * pivot)),
        translate_y=int(round(pivot - b * pivot - a * pivot)))


def _checker_bitmap(n=12):
    img = np.zeros((n, n, 4), np.uint8)
    img[::2, ::2] = (230, 40, 30, 255)
    img[1::2, 1::2] = (20, 200, 90, 255)
    img[img[..., 3] == 0] = (30, 60, 220, 160)
    return img


def _box_records(ast, x, y, size, fill):
    return [ast.StyleChangeRecord(move_to=ast.Vector2D(x, y), left_fill=fill),
            ast.EdgeRecord(delta=ast.Vector2D(size, 0)),
            ast.EdgeRecord(delta=ast.Vector2D(0, size)),
            ast.EdgeRecord(delta=ast.Vector2D(-size, 0)),
            ast.EdgeRecord(delta=ast.Vector2D(0, -size))]


def _bitmap_tag(mods, smoothed=True):
    """A bitmap-filled square (upscaled checker texels) under a linear-RGB
    gradient square: tests/test_transform_sweep.py's interactive scene."""
    ast, fixed = mods[0], mods[2]

    def mat(scale):
        s, z = fixed.from_value(scale), fixed.from_value(0)
        return ast.Matrix(scale_x=s, scale_y=s, rotate_skew0=z,
                          rotate_skew1=z, translate_x=0, translate_y=0)

    grad = ast.Gradient(
        spread=ast.GradientSpread.PAD, color_space=ast.ColorSpace.LINEAR_RGB,
        colors=(ast.GradientStop(0, ast.StraightSRgba8(255, 0, 0, 200)),
                ast.GradientStop(255, ast.StraightSRgba8(0, 0, 255, 120))))
    fills = (ast.BitmapFill(bitmap_id=9, matrix=mat(120.0), repeating=False,
                            smoothed=smoothed),
             ast.LinearGradientFill(matrix=mat(0.05), gradient=grad))
    return ast.DefineShape(
        id=1, bounds=ast.Rect(0, 1600, 0, 1600),
        shape=ast.ShapeBody(
            initial_styles=ast.ShapeStyles(fill=fills, line=()),
            records=tuple(_box_records(ast, 120, 120, 1400, 1)
                          + _box_records(ast, 400, 400, 700, 2))))


def _solid_tag(mods, color):
    ast = mods[0]
    return ast.DefineShape(
        id=1, bounds=ast.Rect(0, 700, 0, 700),
        shape=ast.ShapeBody(
            initial_styles=ast.ShapeStyles(
                fill=[ast.SolidFill(color=ast.StraightSRgba8(*color))],
                line=[]),
            records=[
                ast.StyleChangeRecord(right_fill=1,
                                      move_to=ast.Vector2D(x=60, y=80)),
                ast.EdgeRecord(delta=ast.Vector2D(x=500, y=40)),
                ast.EdgeRecord(delta=ast.Vector2D(x=-180, y=430)),
                ast.EdgeRecord(delta=ast.Vector2D(x=-320, y=-470))]))


def _loop(case, mods):
    """(renderer, stages) of one interactive call sequence."""
    ast, display, _fixed, bitmap_cls, renderer_cls = mods
    if case in ("bitmap-overlay", "bitmap-nearest"):
        size, pivot = 88, 800.0
        tag = _bitmap_tag(mods, smoothed=case == "bitmap-overlay")
        phase = 0.0 if case == "bitmap-overlay" else 0.4
        track = [(phase + 2 * np.pi * i / 15, 1.0, None) for i in range(5)]
    else:
        size, pivot = 64, 350.0
        tag = _solid_tag(mods, (200, 40, 90, 255))
        if case == "zoom":
            track = [(0.15 * i, sc, None)
                     for i, sc in enumerate([1.0, 1.1, 1.3, 2.4, 3.1])]
        elif case == "spin":
            track = [(2 * np.pi * i / 12, 1.0, None) for i in range(14)]
        else:   # ct-fade
            track = [(0.2 * i, 1.0, display.ColorTransform(
                mult=(1.0, 1.0, 1.0, 1.0 - 0.2 * i), add=(0, 0, 0, 0)))
                for i in range(4)]
    stages = [display.Stage(width=size, height=size, children=[
        display.ShapeInstance(definition=tag,
                              matrix=_rot_matrix(mods, th, sc, pivot),
                              color_transform=ct)])
        for th, sc, ct in track]
    kw = {} if renderer_cls is TpuRenderer else {"device": "cpu"}
    r = renderer_cls(size, size, **kw)
    img = _checker_bitmap()
    r.bitmap_service._bitmaps[9] = bitmap_cls(
        width=img.shape[1], height=img.shape[0], rgba=img)
    return r, stages


@pytest.mark.parametrize("case,straight,flipped", [
    ("bitmap-overlay", 2, 0.0), ("bitmap-nearest", 16, 2e-4),
    ("zoom", 0, 0.0), ("spin", 0, 0.0), ("ct-fade", 0, 0.0)])
def test_interactive_loop_matches_jax_renderer(case, straight, flipped):
    """The same render() call sequence through both renderers: the same
    routes (the first call normal, every later one the F = 1 sweep) and
    frames within the stated tolerance; the spin keeps one piece table.
    The unsmoothed bitmap loop flips one nearest sample of 38,720 pixels
    (frame 1: the reference kernel's coordinate rounds across a texel
    border), measured and pinned."""
    jr, jstages = _loop(case, JAX)
    tr, tstages = _loop(case, PORT)
    paths, tabs = [], set()
    for js, ts in zip(jstages, tstages):
        want = jr.render(js)
        got = tr.render(ts)
        assert tr.last_stats.path == jr.last_stats.path
        paths.append(tr.last_stats.path)
        if paths[-1] == "transform-sweep-1f":
            tabs.add(id(tr._frame_sweep_state[1]["tab"]))
        _assert_frames(want, got, straight, flipped)
    assert paths[0] != "transform-sweep-1f"
    assert paths[1:] == ["transform-sweep-1f"] * (len(paths) - 1)
    if case == "spin":
        assert len(tabs) == 1, "piece table was re-split mid-spin"


@pytest.mark.parametrize("layers", [14, 15])
def test_interactive_layer_gate_matches_reference(layers):
    """The reference's layer-size gate: at 1088 rows its F = 1 sweep takes
    at most 14 layers; both packages build (or refuse) the same state."""
    def leaves_of(mods):
        ast, display = mods[0], mods[1]
        fills = [ast.SolidFill(color=ast.StraightSRgba8(20 * i, 90, 200, 255))
                 for i in range(layers)]
        records = []
        for i in range(layers):
            records += _box_records(ast, 40 * i, 0, 300, i + 1)
        tag = ast.DefineShape(
            id=1, bounds=ast.Rect(0, 900, 0, 900),
            shape=ast.ShapeBody(
                initial_styles=ast.ShapeStyles(fill=tuple(fills), line=()),
                records=tuple(records)))
        stage = display.Stage(width=64, height=1088, children=[
            display.ShapeInstance(definition=tag,
                                  matrix=_rot_matrix(mods, 0.3, 1.0, 450.0))])
        kw = {} if mods is JAX else {"device": "cpu"}
        r = mods[4](64, 1088, **kw)
        return r, r._stage_leaves(stage)

    jr, jleaves = leaves_of(JAX)
    tr, tleaves = leaves_of(PORT)
    want = jr._build_frame_sweep_state(("k",), jleaves)
    got = tr._build_frame_sweep_state(("k",), tleaves)
    assert (got is None) == (want is None) == (layers > 14)
    if got is not None:
        assert tuple(got["tab"].shape) == tuple(np.asarray(want["tab"]).shape)
        assert got["layer_counts"] == want["layer_counts"]
