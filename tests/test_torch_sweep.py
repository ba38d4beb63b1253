"""The port's animation sweeps (ops/transform.py, ops/morph.py) against
the JAX package's, on the CPU.

Host stages (piece tables, counts, sweep paints) must be byte-equal.
Pixels: the port's plain versions (the CUDA kernels' arithmetic) against
the Pallas kernels in interpret mode, at most 1 u8 level in the
PREMULTIPLIED bytes.  The two sides sum each pixel's ramps in different
orders (the port exactly, in 32.32 fixed point, rounded once; the
reference in f32 through its chunked products), and XLA on the CPU
contracts the affine's and the lerp's multiply-adds into FMAs, which the
port and its kernels (``-fmad=false``) do not: a transformed coordinate
can differ in its last bit, coverage by ~1e-6.  The straight bytes are
pinned per scene at the measured envelope (ROADMAP.md queue C).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swf_renderer_tpu.ops import coverage as jcov
from swf_renderer_tpu.ops import morph as jmorph
from swf_renderer_tpu.ops import style as jstyle
from swf_renderer_tpu.ops import transform as jsweep
from swf_renderer_tpu_torch import convert
from swf_renderer_tpu_torch.ops import coverage as tcov
from swf_renderer_tpu_torch.ops import flatblock as tfb
from swf_renderer_tpu_torch.ops import morph as tmorph
from swf_renderer_tpu_torch.ops import style as tstyle
from swf_renderer_tpu_torch.ops import transform as tsweep


def _star_edges(cx, cy, r_out, r_in, points=7):
    ang = np.linspace(0, 2 * np.pi, 2 * points, endpoint=False)
    rad = np.where(np.arange(2 * points) % 2 == 0, r_out, r_in)
    pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)],
                   1).astype(np.float32)
    closed = np.concatenate([pts, pts[:1]])
    return np.concatenate([closed[:-1], closed[1:]], axis=1)


def _rotation_mats(frames, cx, cy, scale=1.0, phase=0.0):
    mats = []
    for i in range(frames):
        th = 2 * np.pi * i / frames + phase
        a, b = np.cos(th) * scale, np.sin(th) * scale
        mats.append((a, b, -b, a, cx - a * cx + b * cy,
                     cy - b * cx - a * cy))
    return np.asarray(mats, np.float32)


def levels(want, got):
    """(max straight level, max premultiplied level, share of differing
    straight bytes) between two (..., 4) u8 frame stacks."""
    a = want.astype(np.int32)
    b = got.astype(np.int32)

    def premul(x):
        return np.concatenate(
            [(x[..., :3] * x[..., 3:] + 127) // 255, x[..., 3:]], -1)

    d = np.abs(a - b)
    return (int(d.max()), int(np.abs(premul(a) - premul(b)).max()),
            float((d != 0).mean()))


def assert_close(want, got, straight, share=1e-4):
    assert want.shape == got.shape and got.dtype == np.uint8
    assert got[..., 3].max() > 150    # the scene is really there
    smax, pmax, differing = levels(want, got)
    assert pmax <= 1 and smax <= straight and differing <= share, (
        smax, pmax, differing)


def t(x):
    return None if x is None else torch.as_tensor(np.asarray(x, np.float32))


def j(x):
    return None if x is None else jnp.asarray(x)


# ---------------------------------------------------------------------------
# Host stages: byte-equal
# ---------------------------------------------------------------------------

TABLES = [_star_edges(60.0, 48.0, 40.0, 18.0),
          _star_edges(55.0, 50.0, 22.0, 9.0, points=5)]
COLORS = [(0.9, 0.2, 0.1, 0.9), (0.1, 0.4, 0.95, 0.8)]
SHEAR_MATS = np.asarray([
    (1.0, 0.0, 0.0, 1.0, 0.0, 0.0),
    (2.0, 0.5, -0.3, 1.7, 4.0, -2.0),
    (0.5, -0.2, 0.1, 0.4, 10.0, 12.0)], np.float32)
PER_LAYER_MATS = np.stack([_rotation_mats(6, 60.0, 48.0),
                           _rotation_mats(6, 50.0, 50.0, 1.3, 0.4)], 1)


def _pairs(seed=5, layers=2):
    rng = np.random.default_rng(seed)
    pairs = []
    for lyr in range(layers):
        start = _star_edges(40.0 + 20 * lyr, 40.0, 30.0 - 8 * lyr, 12.0,
                            points=5 + lyr)
        end = (start * 0.7 + np.float32(12.0)
               + rng.uniform(-6, 6, start.shape).astype(np.float32))
        pairs.append((start, end.astype(np.float32),
                      tuple(rng.uniform(0.2, 1, 4)),
                      tuple(rng.uniform(0.2, 1, 4))))
    return pairs


@pytest.mark.parametrize("name,mats,kwargs", [
    ("rotation", _rotation_mats(6, 60.0, 48.0), {}),
    ("scale-shear", SHEAR_MATS, {}),
    ("per-layer", PER_LAYER_MATS, {}),
    ("margin-floors", SHEAR_MATS, {
        "split_margin": 1.5, "e_multiple": 64,
        "min_splits": [np.full(14, 3), None]}),
])
def test_affine_pieces_equal_reference(name, mats, kwargs):
    tab, subxy, colarr, splits = jsweep.affine_pieces(
        TABLES, COLORS, mats, return_splits=True, **kwargs)
    got_tab, got_colors, got_splits = tsweep.affine_pieces(
        TABLES, COLORS, mats, return_splits=True, **kwargs)
    assert got_tab.dtype == np.float32 and got_tab.tobytes() == tab.tobytes()
    assert got_colors.tobytes() == colarr.tobytes()
    assert all(np.array_equal(a, b) for a, b in zip(splits, got_splits))
    # The reference's sublane copy holds the same values.
    dev = convert.sweep_table_to_device(tab, subxy, device="cpu")
    assert dev.shape == tab.shape and np.array_equal(dev.numpy(), got_tab)
    assert (tsweep.layer_piece_counts(got_tab)
            == jsweep.layer_piece_counts(tab))
    assert (tsweep.layer_piece_counts(got_tab, multiple=32)
            == jsweep.layer_piece_counts(tab, multiple=32))


@pytest.mark.parametrize("mats", [_rotation_mats(4, 50.0, 40.0, 1.2),
                                  PER_LAYER_MATS[:4]],
                         ids=["global", "per-layer"])
def test_morph_affine_pieces_equal_reference(mats):
    pairs = _pairs()
    ts, ss, te, se, cs, ce = jsweep.morph_affine_pieces(pairs, mats)
    got = tsweep.morph_affine_pieces(pairs, mats)
    for want, have in zip((ts, te, cs, ce), got):
        assert have.dtype == np.float32
        assert have.tobytes() == np.asarray(want).tobytes()
    convert.sweep_table_to_device(ts, ss, device="cpu")
    convert.sweep_table_to_device(te, se, device="cpu")


def test_morph_pieces_equal_reference():
    pairs = _pairs(seed=8, layers=3)
    ts, te, ys, ye, cs, ce = jmorph.morph_pieces(pairs)
    got = tmorph.morph_pieces(pairs)
    for want, have in zip((ts, te, cs, ce), got):
        assert have.tobytes() == np.asarray(want).tobytes()
    # suby holds the y0, y1 channels of the same table.
    convert.sweep_table_to_device(ts, ys, device="cpu")
    with pytest.raises(ValueError, match="disagrees"):
        convert.sweep_table_to_device(ts, ye + 1.0, device="cpu")


def _gradient_paints(mod, color_space="s-rgb"):
    """solid, linear (reflect), focal (repeat) Paints of ``mod``."""
    ratios = np.array([0.0, 0.35, 1.0], np.float32)
    stops = np.array([[1, 0.2, 0, 1], [0, 1, 0.5, 0.6], [0.2, 0, 1, 1]],
                     np.float32)
    return [
        mod.solid_paint((0.9, 0.3, 0.1, 0.8)),
        mod.Paint(kind=mod.PAINT_LINEAR,
                  inv_matrix=(400.0, 30.0, -20.0, 380.0, -26000.0, -19000.0),
                  stop_ratios=ratios, stop_colors=stops, spread=1,
                  color_space=color_space),
        mod.Paint(kind=mod.PAINT_FOCAL,
                  inv_matrix=(500.0, 0.0, 0.0, 520.0, -28000.0, -25000.0),
                  stop_ratios=ratios[[0, 2]], stop_colors=stops[[0, 2]],
                  focal_point=0.4, spread=2),
    ]


@pytest.mark.parametrize("allow_fields", [False, True])
def test_sweep_paints_equal_reference(allow_fields):
    mats = np.stack([_rotation_mats(5, 60.0, 48.0, 1.1)] * 3, 1)
    mats[:, 2] = _rotation_mats(5, 40.0, 40.0, 0.8, 0.3)
    space = "linear-rgb" if allow_fields else "s-rgb"
    want = jsweep.sweep_paints(_gradient_paints(jstyle, space), mats,
                               allow_fields=allow_fields)
    got = tsweep.sweep_paints(_gradient_paints(tstyle, space), mats,
                              allow_fields=allow_fields)
    assert got[0] == convert.kernel_paints_from_numpy(want[0])
    assert [p.kind for p in got[0]] == [
        tfb.KPAINT_COLOR,
        tfb.KPAINT_FIELD if allow_fields else tfb.KPAINT_LINEAR,
        tfb.KPAINT_FOCAL]
    assert got[1].tobytes() == np.asarray(want[1]).tobytes()
    if allow_fields:
        assert len(got[2]) == len(want[2]) == 1
        assert got[2][0].layer == want[2][0].layer == 1
        assert got[2][0].invs.tobytes() == want[2][0].invs.tobytes()
    else:
        with pytest.raises(ValueError, match="solid or sRGB"):
            tsweep.sweep_paints(_gradient_paints(tstyle, "linear-rgb"),
                                mats)


def test_edge_contribution_matches_reference():
    """The trapezoid ramp every sweep evaluates per piece: the port's torch
    version against the reference's (XLA:CPU may contract
    ``x0 + t0 * dx`` into an FMA: <= 2e-6 of a pixel's area)."""
    rng = np.random.default_rng(2)
    n = 4000
    x0, x1 = rng.uniform(-3, 20, (2, n)).astype(np.float32)
    y0 = rng.uniform(0, 8, n).astype(np.float32)
    y1 = (y0 + rng.uniform(-1, 1, n)).astype(np.float32)
    px = rng.integers(-2, 20, n).astype(np.float32)
    py = np.floor(np.minimum(y0, y1)) + rng.integers(0, 2, n)
    py = py.astype(np.float32)
    x1[:50] = x0[:50]          # vertical pieces: the thin-span branch
    y1[50:80] = y0[50:80]      # horizontal pieces: dy == 0
    want = np.asarray(jcov.edge_contribution(
        *(jnp.asarray(v) for v in (x0, y0, x1, y1, px, py))))
    got = tcov.edge_contribution(
        *(torch.as_tensor(v) for v in (x0, y0, x1, y1, px, py))).numpy()
    assert np.abs(want).max() > 0.5
    assert np.abs(got - want).max() <= 2e-6
    assert np.array_equal(got[50:80], np.zeros(30, np.float32))
    h = tcov._h01(torch.tensor([-1.0, 0.0, 0.5, 1.0, 3.0]))
    assert h.tolist() == [0.0, 0.0, 0.125, 0.5, 2.5]


# ---------------------------------------------------------------------------
# Fields baked for the sweep
# ---------------------------------------------------------------------------


def _field_specs(mod_sweep, mod_style, frames=5, repeat=False):
    paint = _gradient_paints(mod_style, "linear-rgb")[1]
    mats = np.stack([_rotation_mats(frames, 40.0, 30.0, 1.1)] * 3, 1)
    if repeat:
        mats[3] = mats[1]
    _, _, specs = mod_sweep.sweep_paints(
        [mod_style.solid_paint((1, 1, 1, 1)), paint,
         mod_style.solid_paint((0, 0, 1, 1))], mats, allow_fields=True)
    return specs


@pytest.mark.parametrize("case", ["static", "fading", "repeated-matrix"])
def test_bake_sweep_fields_matches_reference(case):
    """Linear-RGB gradient planes under per-frame matrices (the traced
    gradient branch, batched over frames): values within 2e-5 of the
    reference's (FMA contraction of the gradient-space affine and pow)."""
    height, width, frames = 40, 56, 5
    tracks = None
    if case == "fading":
        base = np.asarray(_gradient_paints(tstyle)[1].stop_colors)
        fade = np.linspace(1.0, 0.3, frames, dtype=np.float32)
        tracks = [base[None] * fade[:, None, None]]
    repeat = case == "repeated-matrix"
    want = np.asarray(jsweep.bake_sweep_fields(
        _field_specs(jsweep, jstyle, frames, repeat), height, width,
        stop_tracks=tracks))
    got = tsweep.bake_sweep_fields(
        _field_specs(tsweep, tstyle, frames, repeat), height, width,
        stop_tracks=tracks, frame_chunk=2, device="cpu")
    assert tuple(got.shape) == (1, frames, height, width, 4) == want.shape
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 2e-5
    assert float(got.std()) > 0.05
    if repeat:
        assert torch.equal(got[0, 3], got[0, 1])


def test_bake_sweep_fields_refuses_bitmaps():
    """Formerly a refusal: a bitmap spec now bakes — its axis-aligned
    frame through the separable stack, the rotated ones through the
    texfield kernel's plain version — within the reference kernel's own
    tolerance (2e-4, its 3-pass bf16 split) of the JAX bake."""
    img = np.random.default_rng(3).integers(0, 256, (9, 7, 4)).astype(
        np.uint8)
    th = np.asarray([0.0, 0.3, 1.1], np.float32)
    invs = np.stack([0.4 * np.cos(th), 0.4 * np.sin(th), -0.4 * np.sin(th),
                     0.4 * np.cos(th), 1.5 + th, -0.5 * th], 1)
    specs = [mod_sweep.SweepFieldSpec(0, mod_style.Paint(
        kind=mod_style.PAINT_BITMAP, image=img, repeating=True,
        supersample=2), invs.astype(np.float32))
        for mod_sweep, mod_style in ((jsweep, jstyle), (tsweep, tstyle))]
    want = np.asarray(jsweep.bake_sweep_fields(specs[:1], 20, 24))
    got = tsweep.bake_sweep_fields(specs[1:], 20, 24, device="cpu")
    assert tuple(got.shape) == want.shape == (1, 3, 20, 24, 4)
    assert np.abs(got.numpy() - want).max() <= 2e-4
    assert float(got[0, 1:].std()) > 0.05


# ---------------------------------------------------------------------------
# Plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _affine_scene(name):
    """(height, width, tables, mats, colors, sweep kwargs) -> both sides."""
    if name == "scale-shear":
        return (64, 64, [_star_edges(32.0, 32.0, 12.0, 5.0)], SHEAR_MATS,
                np.asarray([(0.2, 0.8, 0.3, 1.0)], np.float32), {})
    height, width = 96, 120
    mats = _rotation_mats(6, 60.0, 48.0)
    colors = np.asarray(COLORS, np.float32)
    kw = {}
    if name == "per-layer":
        mats = PER_LAYER_MATS
    elif name == "per-frame-colors":
        fade = np.linspace(1.0, 0.2, 6, dtype=np.float32)
        colors = colors[None] * fade[:, None, None]
    elif name == "evenodd":
        kw = {"fill_rule": 1}
    elif name == "mixed-rules":
        kw = {"fill_rule": (1, 0)}
    return height, width, TABLES, mats, colors, kw


@pytest.mark.parametrize("name,straight", [
    ("rotation", 0), ("scale-shear", 0), ("per-layer", 1),
    ("per-frame-colors", 0), ("evenodd", 0), ("mixed-rules", 0)])
def test_affine_sweep_plain_matches_jax_kernel(name, straight):
    height, width, tables, mats, colors, kw = _affine_scene(name)
    tab, subxy, _ = jsweep.affine_pieces(tables, [(0,) * 4] * len(tables),
                                         mats)
    counts = jsweep.layer_piece_counts(tab, multiple=128)
    want = jmorph.morph_frames_to_u8(jsweep.render_affine_sweep(
        j(mats), j(tab), j(subxy), j(colors), height, width,
        layer_counts=counts, **kw), height, width)
    got = tmorph.morph_frames_to_u8(tsweep.render_affine_sweep(
        t(mats), convert.sweep_table_to_device(tab, subxy, device="cpu"),
        t(colors),
        height, width, layer_counts=counts, **kw), height, width)
    assert got.shape == (mats.shape[0], height, width, 4)
    assert_close(want, got, straight)


def _styled_scene(name):
    """Three layers: solid star, linear star, focal star; per-layer
    rotation tracks."""
    frames = 4
    tables = [_star_edges(60.0, 48.0, 40.0, 18.0),
              _star_edges(50.0, 50.0, 30.0, 14.0, points=5),
              _star_edges(70.0, 40.0, 24.0, 10.0, points=6)]
    mats = np.stack([_rotation_mats(frames, 60.0, 48.0),
                     _rotation_mats(frames, 50.0, 50.0, 1.2, 0.3),
                     _rotation_mats(frames, 70.0, 40.0, 0.9, 1.0)], 1)
    colors = np.zeros((3, 4), np.float32)
    colors[0] = (0.9, 0.3, 0.1, 0.8)
    space = "linear-rgb" if name == "field" else "s-rgb"
    stop_colors = None
    if name == "fading-stops":
        stop_colors = np.zeros((frames, 3, 3, 4), np.float32)
        fade = np.linspace(1.0, 0.4, frames, dtype=np.float32)
        for lyr, p in enumerate(_gradient_paints(tstyle)):
            if p.stop_colors is not None:
                k = len(p.stop_ratios)
                stop_colors[:, lyr, :k] = (np.asarray(p.stop_colors)[None]
                                           * fade[:, None, None])
    return tables, mats, colors, space, stop_colors


@pytest.mark.parametrize("name,straight", [
    ("linear-focal", 1), ("fading-stops", 1), ("field", 3)])
def test_styled_affine_sweep_plain_matches_jax_kernel(name, straight):
    """In-kernel LINEAR and FOCAL layers under per-frame ``grad_mats``,
    per-frame ``stop_colors``, and a FIELD layer from bake_sweep_fields
    (each side bakes its own planes)."""
    height, width = 96, 120
    tables, mats, colors, space, stop_colors = _styled_scene(name)
    tab, subxy, _ = jsweep.affine_pieces(tables, [(0,) * 4] * 3, mats)
    jk, jgm, jspecs = jsweep.sweep_paints(
        _gradient_paints(jstyle, space), mats, allow_fields=True)
    tk, tgm, tspecs = tsweep.sweep_paints(
        _gradient_paints(tstyle, space), mats, allow_fields=True)
    jfields = (jsweep.bake_sweep_fields(jspecs, height, width)
               if jspecs else None)
    tfields = (tsweep.bake_sweep_fields(tspecs, height, width,
                                        device="cpu")
               if tspecs else None)
    assert (tfields is not None) == (name == "field")
    want = jmorph.morph_frames_to_u8(jsweep.render_affine_sweep(
        j(mats), j(tab), j(subxy), j(colors), height, width,
        fill_rule=(0, 1, 0), paints=jk, grad_mats=j(jgm),
        stop_colors=j(stop_colors), fields=jfields), height, width)
    got = tmorph.morph_frames_to_u8(tsweep.render_affine_sweep(
        t(mats), t(tab), t(colors), height, width, fill_rule=(0, 1, 0),
        paints=tk, grad_mats=t(tgm), stop_colors=t(stop_colors),
        fields=tfields), height, width)
    assert_close(want, got, straight)


RATIOS = np.asarray([0.0, 0.25, 0.6, 1.0], np.float32)


@pytest.mark.parametrize("name,straight", [("global", 0), ("per-layer", 15)])
def test_morph_affine_sweep_plain_matches_jax_kernel(name, straight):
    height, width = 80, 100
    pairs = _pairs()
    mats = (_rotation_mats(4, 50.0, 40.0, 1.1) if name == "global"
            else PER_LAYER_MATS[:4])
    ts, ss, te, se, cs, ce = jsweep.morph_affine_pieces(pairs, mats)
    counts = tuple(max(a, b) for a, b in zip(
        jsweep.layer_piece_counts(ts), jsweep.layer_piece_counts(te)))
    want = jmorph.morph_frames_to_u8(jsweep.render_morph_affine_sweep(
        j(mats), j(RATIOS), j(ts), j(ss), j(te), j(se), j(cs), j(ce),
        height, width, fill_rule=(0, 1), layer_counts=counts),
        height, width)
    got = tmorph.morph_frames_to_u8(tsweep.render_morph_affine_sweep(
        t(mats), t(RATIOS),
        convert.sweep_table_to_device(ts, ss, device="cpu"),
        convert.sweep_table_to_device(te, se, device="cpu"), t(cs), t(ce),
        height, width,
        fill_rule=(0, 1), layer_counts=counts), height, width)
    assert_close(want, got, straight)


@pytest.mark.parametrize("rule,straight", [(0, 0), (1, 0), ((1, 0, 1), 0)],
                         ids=["nonzero", "evenodd", "mixed"])
def test_morph_sweep_plain_matches_jax_kernel(rule, straight):
    height, width = 72, 110
    pairs = _pairs(seed=8, layers=3)
    ts, te, ys, ye, cs, ce = jmorph.morph_pieces(pairs)
    want = jmorph.morph_frames_to_u8(jmorph.render_morph_sweep(
        j(RATIOS), j(ts), j(te), j(ys), j(ye), j(cs), j(ce), height, width,
        fill_rule=rule), height, width)
    got = tmorph.morph_frames_to_u8(tmorph.render_morph_sweep(
        t(RATIOS), convert.sweep_table_to_device(ts, ys, device="cpu"),
        convert.sweep_table_to_device(te, ye, device="cpu"), t(cs), t(ce),
        height, width,
        fill_rule=rule), height, width)
    assert_close(want, got, straight)


def test_pieces_outside_the_frame_are_clipped_like_the_reference():
    """Rows above and below the frame drop; pieces left of x = 0 still
    add their dy to every column; padding pieces transform to the point
    (e, f) outside the frame and add nothing."""
    height, width = 40, 48
    tables = [_star_edges(24.0, 20.0, 30.0, 12.0)]   # overhangs every side
    mats = np.asarray([(1.0, 0.0, 0.0, 1.0, -500.0, -500.0),  # all outside
                       (1.3, 0.2, -0.2, 1.3, -8.0, -6.0),
                       (1.0, 0.0, 0.0, 1.0, 20.0, 15.0)], np.float32)
    colors = np.asarray([(0.3, 0.6, 0.9, 1.0)], np.float32)
    tab, subxy, _ = jsweep.affine_pieces(tables, [(0,) * 4], mats)
    want = jmorph.morph_frames_to_u8(jsweep.render_affine_sweep(
        j(mats), j(tab), j(subxy), j(colors), height, width), height, width)
    got = tmorph.morph_frames_to_u8(tsweep.render_affine_sweep(
        t(mats), t(tab), t(colors), height, width), height, width)
    assert not got[0].any() and not want[0].any()
    assert_close(want, got, 0)


# ---------------------------------------------------------------------------
# What the wrappers refuse
# ---------------------------------------------------------------------------


def _tiny():
    mats = _rotation_mats(2, 10.0, 10.0)
    tab, _ = tsweep.affine_pieces([_star_edges(10.0, 10.0, 8.0, 3.0)],
                                  [(1, 0, 0, 1)], mats)
    return t(mats), t(tab), t([(1, 0, 0, 1)])


@pytest.mark.parametrize("kwargs,item", [({"x_shift": 3.0}, "A9")])
def test_reference_tilings_raise_naming_their_item(kwargs, item):
    """The multi-device renderer's tile-shard origin (ROADMAP.md A9) is
    ported: each column sweep renders columns 3.. of the global grid,
    equal to those columns of the unshifted frame; the other tilings
    refuse it, as the reference's do.  (``row_grid=True`` and
    ``compact_counts=`` run: see tests/test_torch_sweep_tilings.py.)"""
    mats, tab, colors = _tiny()
    ratios = t([0.0, 1.0])
    calls = (
        lambda w, **kw: tsweep.render_affine_sweep(mats, tab, colors, 20, w,
                                                   **kw),
        lambda w, **kw: tsweep.render_morph_affine_sweep(
            mats, ratios, tab, tab, colors, colors, 20, w, **kw),
        lambda w, **kw: tmorph.render_morph_sweep(ratios, tab, tab, colors,
                                                  colors, 20, w, **kw))
    for call in calls:
        full = call(20)
        assert (full != 0).any()
        assert torch.equal(call(17, **kwargs), full[..., 3:]), item
    with pytest.raises(ValueError, match="column-grid"):
        tsweep.render_affine_sweep(mats, tab, colors, 20, 17, row_grid=True,
                                   **kwargs)
    with pytest.raises(ValueError, match="column-grid"):
        tsweep.render_morph_affine_sweep(mats, ratios, tab, tab, colors,
                                         colors, 20, 17, row_grid=True,
                                         **kwargs)


def test_sweep_wrappers_validate_their_inputs():
    mats, tab, colors = _tiny()
    field = torch.zeros((1, 2, 20, 20, 4))
    with pytest.raises(ValueError, match="without any FIELD paint"):
        tsweep.render_affine_sweep(mats, tab, colors, 20, 20, fields=field)
    with pytest.raises(ValueError, match="fields, got"):
        tsweep.render_affine_sweep(mats, tab, colors, 20, 20,
                                   paints=(tfb.KernelPaint.field(0),),
                                   fields=field[:, :1])
    grad = tfb.KernelPaint.gradient(tfb.KPAINT_LINEAR, (), (0.0, 1.0),
                                    np.ones((2, 4), np.float32))
    with pytest.raises(ValueError, match="grad_mats"):
        tsweep.render_affine_sweep(mats, tab, colors, 20, 20, paints=(grad,))
    with pytest.raises(ValueError, match="stop_colors K=1"):
        tsweep.render_affine_sweep(
            mats, tab, colors, 20, 20, paints=(grad,),
            grad_mats=torch.zeros((2, 1, 6)),
            stop_colors=torch.zeros((2, 1, 1, 4)))
    with pytest.raises(ValueError, match="layer_counts"):
        tsweep.render_affine_sweep(mats, tab, colors, 20, 20,
                                   layer_counts=(128, 128))
    with pytest.raises(ValueError, match="colors"):
        tsweep.render_affine_sweep(mats, tab, colors[:, :3], 20, 20)
    deep = tab.expand(17, 4, 1, tab.shape[-1]).contiguous()
    with pytest.raises(ValueError, match="17 layers"):
        tsweep.render_affine_sweep(mats, deep, colors.expand(17, 4), 20, 20)


def test_sweep_wrappers_refuse_tensors_they_cannot_launch():
    """A wrapper takes its plain version only for CPU tensors; any other
    device launches the kernel or raises (here: the meta device), and no
    launch is counted."""
    mats, tab, colors = (x.to("meta") for x in _tiny())
    ratios = torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsweep.render_affine_sweep(mats, tab, colors, 20, 20)
    with pytest.raises(ValueError, match="unsupported device"):
        tsweep.render_morph_affine_sweep(mats, ratios, tab, tab, colors,
                                         colors, 20, 20)
    with pytest.raises(ValueError, match="unsupported device"):
        tmorph.render_morph_sweep(ratios, tab, tab, colors, colors, 20, 20)
    with pytest.raises(ValueError, match="span devices"):
        tsweep.render_affine_sweep(mats, _tiny()[1], colors, 20, 20)
    assert tsweep.render_affine_sweep.launches == 0
    assert tsweep.render_morph_affine_sweep.launches == 0
    assert tmorph.render_morph_sweep.launches == 0


def test_anim_scene_equals_the_benchmark_generator():
    """utils/scenes.py::anim_scene is the JAX package's benchmark scene
    (bench.py), value for value."""
    import bench
    from swf_renderer_tpu_torch.utils.scenes import anim_scene

    want = bench.anim_scene(256, 320, 5)
    got = anim_scene(256, 320, 5)
    assert all(np.array_equal(a, b) for a, b in zip(want[0], got[0]))
    assert np.array_equal(np.asarray(want[1]), np.asarray(got[1]))
    assert got[2].dtype == np.float32 and np.array_equal(want[2], got[2])
    assert not np.array_equal(anim_scene(256, 320, 5, seed=10)[0][0],
                              got[0][0])


def test_render_morph_sweep_places_host_arrays_on_the_asked_device(
        monkeypatch):
    """``render_morph_sweep`` is an entry point of its own: it takes
    morph_pieces' arrays as they are, runs them on ``device``, and without
    a device or a card it raises."""
    pairs = _pairs(seed=8, layers=2)
    ts, te, cs, ce = tmorph.morph_pieces(pairs)
    got = tmorph.render_morph_sweep(RATIOS, ts, te, cs, ce, 40, 60,
                                    device="cpu")
    want = tmorph.render_morph_sweep(t(RATIOS), t(ts), t(te), t(cs), t(ce),
                                     40, 60)
    assert got.device.type == "cpu" and torch.equal(got, want)
    assert got.any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmorph.render_morph_sweep(RATIOS, ts, te, cs, ce, 40, 60)
