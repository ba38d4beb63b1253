"""The sweep's two other tilings in the port (ops/transform.py): the
compacted sweep with its host plan and pre-pass, and the row-band sweep,
against the JAX package's compacted and row-grid kernels on the CPU.

Host plan: the dict must equal the reference's.  Pixels: a tiling changes
only how the work is cut, and the port sums every pixel's ramps exactly
(32.32 fixed point), so its compacted and row-band frames must equal its
column frames byte for byte; against the Pallas kernels (interpret mode)
at most 1 premultiplied level, with the straight bytes pinned per scene
at the measured envelope (the reference sums in f32 in another order and
XLA:CPU contracts the affine into FMAs; ROADMAP.md queue C).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swf_renderer_tpu.ops import morph as jmorph
from swf_renderer_tpu.ops import style as jstyle
from swf_renderer_tpu.ops import transform as jsweep
from swf_renderer_tpu_torch.ops import flatblock as tfb
from swf_renderer_tpu_torch.ops import morph as tmorph
from swf_renderer_tpu_torch.ops import style as tstyle
from swf_renderer_tpu_torch.ops import transform as tsweep
from swf_renderer_tpu_torch.utils.scenes import anim_scene

from test_torch_sweep import (
    _pairs, _rotation_mats, _star_edges, assert_close, j, t,
)


# ---------------------------------------------------------------------------
# The scenes of the reference's own compacted-sweep tests
# (tests/test_transform_sweep.py:725-834)
# ---------------------------------------------------------------------------


def _gradient_layer(mod, height, width):
    return mod.Paint(
        kind=mod.PAINT_LINEAR,
        inv_matrix=(2.0 * 16384.0 / width, 0.0, 0.0, 2.0 * 16384.0 / width,
                    -16384.0, -16384.0 * height / width),
        stop_ratios=np.array([0.0, 1.0], np.float32),
        stop_colors=np.array([[1, 0, 0, 1], [0, 0, 1, 1]], np.float32))


def _compact_scene(name):
    """(height, width, tables, colors, mats, sweep kwargs of each side,
    paints of each side or None, stop colours or None)."""
    if name == "three-layers":
        tables = [_star_edges(200.0, 50.0, 45.0, 20.0),
                  _star_edges(900.0, 55.0, 40.0, 18.0, points=5),
                  _star_edges(600.0, 45.0, 38.0, 15.0, points=9)]
        colors = [(0.9, 0.2, 0.1, 0.9), (0.2, 0.8, 0.3, 0.8),
                  (0.1, 0.3, 0.9, 1.0)]
        return 100, 1200, tables, colors, _rotation_mats(5, 600.0, 50.0), None
    if name == "blocks-per-step":
        tables = [_star_edges(300.0, 45.0, 40.0, 16.0),
                  _star_edges(1200.0, 50.0, 42.0, 20.0, points=5)]
        colors = [(0.8, 0.3, 0.2, 1.0), (0.2, 0.4, 0.9, 0.7)]
        return 90, 1536, tables, colors, _rotation_mats(4, 768.0, 45.0), None
    height, width, frames = 100, 1200, 4
    tables = [_star_edges(200.0, 50.0, 45.0, 20.0),
              _star_edges(900.0, 55.0, 40.0, 18.0, points=5)]
    base = _rotation_mats(frames, 600.0, 50.0)
    still = np.tile(np.array([1, 0, 0, 1, 0, 0], np.float32), (frames, 1))
    mats = np.stack([base, still], axis=1)  # (F, L, 6) per-layer
    colors = [(0.9, 0.2, 0.1, 1.0), (0, 0, 0, 0)]
    stop_colors = np.zeros((frames, 2, 2, 4), np.float32)
    stop_colors[:, 1] = np.array([[1, 0, 0, 1], [0, 0, 1, 1]], np.float32)
    stop_colors[:, 1, :, 3] *= np.linspace(1.0, 0.5, frames)[:, None]
    return height, width, tables, colors, mats, stop_colors


SCENES = ["three-layers", "blocks-per-step", "gradient-per-layer"]


@pytest.mark.parametrize("name", SCENES + ["single-block", "anim1080"])
def test_plan_compact_sweep_equals_reference(name):
    """Host only: the plan dict, key for key (None when one column block
    is all there is)."""
    if name == "single-block":
        tables = [_star_edges(30.0, 48.0, 20.0, 9.0)]
        mats = _rotation_mats(3, 30.0, 48.0)
        height, width = 96, 64
    elif name == "anim1080":
        height, width = 1088, 1920
        tables, _, mats = anim_scene(height, width, 60)
    else:
        height, width, tables, _, mats, _ = _compact_scene(name)
    tab, _, _ = jsweep.affine_pieces(tables, [(0,) * 4] * len(tables), mats)
    got_tab, _ = tsweep.affine_pieces(tables, [(0,) * 4] * len(tables), mats)
    want = jsweep.plan_compact_sweep(mats, tab, height, width)
    got = tsweep.plan_compact_sweep(mats, got_tab, height, width)
    assert got == want
    assert (got is None) == (name == "single-block")
    if name == "anim1080":
        assert got["wblock"] == 128 and len(got["compact_counts"]) == 3
    for wblock, bps in ((64, None), (128, 3), (256, 1)):
        assert (tsweep.plan_compact_sweep(mats, got_tab, height, width,
                                          wblock=wblock,
                                          blocks_per_step=bps)
                == jsweep.plan_compact_sweep(mats, tab, height, width,
                                             wblock=wblock,
                                             blocks_per_step=bps))


@pytest.mark.parametrize("name,straight,share", [
    ("three-layers", 21, 2e-5), ("blocks-per-step", 0, 0.0),
    ("gradient-per-layer", 0, 0.0)])
def test_compact_sweep_matches_column_and_jax_kernel(name, straight, share):
    """``render_affine_sweep(**plan)`` on the scene's first 2 frames:
    compact_pre + sweep_compact_plain equal the port's column frames; the
    reference's compacted kernel within 1 premultiplied level."""
    height, width, tables, colors, mats, stop_colors = _compact_scene(name)
    mats = mats[:2]
    if stop_colors is not None:
        stop_colors = stop_colors[:2]
    colarr = np.asarray(colors, np.float32)
    tab, subxy, _ = jsweep.affine_pieces(tables, colors, mats)
    plan = jsweep.plan_compact_sweep(mats, tab, height, width)
    kw_j, kw_t = {}, {}
    if stop_colors is not None:
        paints_j = [jstyle.solid_paint(colors[0]),
                    _gradient_layer(jstyle, height, width)]
        paints_t = [tstyle.solid_paint(colors[0]),
                    _gradient_layer(tstyle, height, width)]
        kp_j, gm_j = jsweep.sweep_paints(paints_j, mats)
        kp_t, gm_t = tsweep.sweep_paints(paints_t, mats)
        kw_j = dict(paints=kp_j, grad_mats=j(gm_j), stop_colors=j(stop_colors))
        kw_t = dict(paints=kp_t, grad_mats=t(gm_t), stop_colors=t(stop_colors))
    want = jmorph.morph_frames_to_u8(jsweep.render_affine_sweep(
        j(mats), j(tab), j(subxy), j(colarr), height, width, **plan, **kw_j),
        height, width)
    before = tsweep.render_affine_sweep.compact_launches
    got = tsweep.render_affine_sweep(t(mats), t(tab), t(colarr), height,
                                     width, **plan, **kw_t)
    column = tsweep.render_affine_sweep(t(mats), t(tab), t(colarr), height,
                                        width, **kw_t)
    assert tsweep.render_affine_sweep.compact_launches == before  # CPU
    assert torch.equal(got, column)
    assert_close(want, tmorph.morph_frames_to_u8(got, height, width),
                 straight, share)


def test_compact_pre_tables_and_capacity():
    """compact_pre on the three-layer scene: every crossing piece fits the
    plan's capacities (the plan covers the exact device mask), gathered
    slots hold device-space pieces in table order, empty chunks carry the
    +-3e38 bounds; with capacities below the crossing counts the extra
    pieces drop inside the table (no write past its end) and the frames
    change."""
    height, width, tables, colors, mats, _ = _compact_scene("three-layers")
    tab, colarr = tsweep.affine_pieces(tables, colors, mats)
    plan = tsweep.plan_compact_sweep(mats, tab, height, width)
    pre = tsweep.compact_pre(t(mats), t(tab), plan["compact_counts"],
                             plan["wblock"], height, width)
    caps = torch.tensor(plan["compact_counts"], dtype=torch.int32)
    frames, nb, layers = pre.counts.shape
    assert (frames, nb, layers) == (5, -(-width // plan["wblock"]), 3)
    assert pre.cap == max(plan["compact_counts"])
    assert (pre.crossing <= caps).all() and torch.equal(pre.counts,
                                                        pre.crossing)
    assert int(pre.crossing.max()) > 100
    # Slot 0 of a bin is its first crossing piece in device space.
    f, b, lyr = (int(i) for i in (pre.counts == pre.counts.max()).nonzero()[0])
    m = mats[f]
    x0 = m[0] * tab[lyr, 0, 0] + m[2] * tab[lyr, 1, 0] + m[4]
    assert np.float32(pre.tab[f, b, lyr, 0, 0]) in x0
    n = int(pre.counts[f, b, lyr])
    assert not pre.tab[f, b, lyr, :, n:].any()
    assert float(pre.bounds[..., 0].min()) < 1e3
    assert float(pre.bounds[..., 0].max()) == pytest.approx(3e38)

    small = tuple(max(64, c // 4) for c in plan["compact_counts"])
    cut = tsweep.compact_pre(t(mats), t(tab), small, plan["wblock"], height,
                             width)
    assert cut.cap == max(small)
    assert (cut.counts <= torch.tensor(small, dtype=torch.int32)).all()
    assert torch.equal(cut.crossing, pre.crossing)
    dropped = tsweep.render_affine_sweep(t(mats), t(tab), t(colarr), height,
                                         width, compact_counts=small,
                                         wblock=plan["wblock"])
    full = tsweep.render_affine_sweep(t(mats), t(tab), t(colarr), height,
                                      width)
    assert not torch.equal(dropped, full)


# ---------------------------------------------------------------------------
# The row-band tiling
# ---------------------------------------------------------------------------


def _row_scene():
    """tests/test_transform_sweep.py::test_row_grid_matches_column_grid:
    two stars, 300x520 (three 128-row blocks there), under the second of
    its 5 rotations."""
    tables = [_star_edges(180.0, 150.0, 140.0, 60.0, points=9),
              _star_edges(350.0, 120.0, 90.0, 35.0, points=5)]
    colors = [(0.8, 0.3, 0.2, 0.9), (0.1, 0.6, 0.9, 0.7)]
    return 300, 520, tables, colors, _rotation_mats(5, 260.0, 150.0)[1:2]


@pytest.mark.parametrize("form,wchunk,straight,share", [
    ("solid", 256, 3, 2e-5), ("styled", 256, 2, 1e-5)])
def test_row_grid_sweep_matches_column_and_jax_kernel(form, wchunk, straight,
                                                      share):
    """``render_affine_sweep(row_grid=True)``: byte-equal to the port's
    column frames, within 1 premultiplied level of the reference's
    row-grid kernel (solid, and a linear gradient layer with per-frame
    stops)."""
    height, width, tables, colors, mats = _row_scene()
    colarr = np.asarray(colors, np.float32)
    tab, subxy, _ = jsweep.affine_pieces(tables, colors, mats)
    kw_j, kw_t = {}, {}
    if form == "styled":
        stops = np.zeros((1, 2, 2, 4), np.float32)
        stops[:, 1] = np.array([[1, 0, 0, 1], [0, 0, 0.5, 0.7]], np.float32)
        kp_j, gm_j = jsweep.sweep_paints(
            [jstyle.solid_paint(colors[0]),
             _gradient_layer(jstyle, height, width)], mats)
        kp_t, gm_t = tsweep.sweep_paints(
            [tstyle.solid_paint(colors[0]),
             _gradient_layer(tstyle, height, width)], mats)
        kw_j = dict(paints=kp_j, grad_mats=j(gm_j), stop_colors=j(stops))
        kw_t = dict(paints=kp_t, grad_mats=t(gm_t), stop_colors=t(stops))
    want = jmorph.morph_frames_to_u8(jsweep.render_affine_sweep(
        j(mats), j(tab), j(subxy), j(colarr), height, width, row_grid=True,
        wchunk=wchunk, **kw_j), height, width)
    got = tsweep.render_affine_sweep(t(mats), t(tab), t(colarr), height,
                                     width, row_grid=True, wchunk=wchunk,
                                     **kw_t)
    assert torch.equal(got, tsweep.render_affine_sweep(
        t(mats), t(tab), t(colarr), height, width, **kw_t))
    assert_close(want, tmorph.morph_frames_to_u8(got, height, width),
                 straight, share)


def test_row_grid_morph_affine_sweep_matches_column_and_jax_kernel():
    height, width = 80, 300
    pairs = _pairs()
    mats = _rotation_mats(4, 50.0, 40.0, 1.1)
    ratios = np.asarray([0.0, 0.25, 0.6, 1.0], np.float32)
    ts, ss, te, se, cs, ce = jsweep.morph_affine_pieces(pairs, mats)
    want = jmorph.morph_frames_to_u8(jsweep.render_morph_affine_sweep(
        j(mats), j(ratios), j(ts), j(ss), j(te), j(se), j(cs), j(ce),
        height, width, fill_rule=(0, 1), row_grid=True, wchunk=128),
        height, width)
    args = (t(mats), t(ratios), t(ts), t(te), t(cs), t(ce), height, width)
    got = tsweep.render_morph_affine_sweep(*args, fill_rule=(0, 1),
                                           row_grid=True, wchunk=128)
    assert torch.equal(got, tsweep.render_morph_affine_sweep(
        *args, fill_rule=(0, 1)))
    assert_close(want, tmorph.morph_frames_to_u8(got, height, width), 0)


# ---------------------------------------------------------------------------
# What the tilings refuse, as the reference does
# ---------------------------------------------------------------------------


def _tiny():
    mats = _rotation_mats(2, 10.0, 10.0)
    tab, _ = tsweep.affine_pieces([_star_edges(10.0, 10.0, 8.0, 3.0)],
                                  [(1, 0, 0, 1)], mats)
    return t(mats), t(tab), t([(1, 0, 0, 1)])


def test_tilings_raise_the_reference_errors():
    mats, tab, colors = _tiny()
    field = torch.zeros((1, 2, 20, 20, 4))
    with pytest.raises(ValueError, match="column-grid sweep kernel"):
        tsweep.render_affine_sweep(mats, tab, colors, 20, 20, row_grid=True,
                                   paints=(tfb.KernelPaint.field(0),),
                                   fields=field)
    with pytest.raises(ValueError, match="2 compact_counts for 1 layers"):
        tsweep.render_affine_sweep(mats, tab, colors, 20, 20,
                                   compact_counts=(256, 256))
    with pytest.raises(ValueError, match="wchunk=64"):
        tsweep.render_affine_sweep(mats, tab, colors, 20, 20, row_grid=True,
                                   wchunk=64)
    with pytest.raises(ValueError, match="wblock=512"):
        tsweep.render_affine_sweep(mats, tab, colors, 20, 20,
                                   compact_counts=(256,), wblock=512)
    with pytest.raises(ValueError, match="compacted sweep"):
        tsweep.render_affine_sweep(mats, tab, colors, 20, 20, wblock=64)
    with pytest.raises(ValueError, match="column-grid non-compact"):
        tsweep.render_affine_sweep(mats, tab, colors, 20, 20,
                                   compact_counts=(256,), x_shift=3.0)


def test_tilings_refuse_tensors_they_cannot_launch():
    """Meta tensors: neither tiling takes the plain version or counts a
    launch."""
    mats, tab, colors = (x.to("meta") for x in _tiny())
    before = (tsweep.render_affine_sweep.row_launches,
              tsweep.render_affine_sweep.compact_launches,
              tsweep.render_morph_affine_sweep.row_launches)
    with pytest.raises(ValueError, match="unsupported device"):
        tsweep.render_affine_sweep(mats, tab, colors, 20, 20, row_grid=True)
    with pytest.raises(ValueError, match="unsupported device"):
        tsweep.render_affine_sweep(mats, tab, colors, 20, 20,
                                   compact_counts=(256,))
    with pytest.raises(ValueError, match="unsupported device"):
        tsweep.render_morph_affine_sweep(
            mats, torch.zeros(2, device="meta"), tab, tab, colors, colors,
            20, 20, row_grid=True)
    assert before == (tsweep.render_affine_sweep.row_launches,
                      tsweep.render_affine_sweep.compact_launches,
                      tsweep.render_morph_affine_sweep.row_launches)
