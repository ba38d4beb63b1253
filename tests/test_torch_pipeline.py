"""End-to-end batch pipelines of the port against the JAX package's, on
the CPU (plain kernel versions vs Pallas interpret mode).

Tolerance: at most 1 u8 level per channel, on at most 1e-4 of the
bytes; the premultiplied bytes the pipeline rounds are checked too.  Why
a level can move: XLA on the CPU contracts multiply-adds of the gradient
evaluation into FMAs and the port does not, so a paint value can differ
in its last bits.  Measured on these scenes: both pipelines byte-equal
(the solid test pins exactly that).
"""

import numpy as np
import pytest

from swf_renderer_tpu.ops import pipeline as jpl
from swf_renderer_tpu.ops import style as jstyle
from swf_renderer_tpu.runtime.cache import PackedSceneCache as JaxCache
from swf_renderer_tpu_torch.convert import paint_from_numpy
from swf_renderer_tpu_torch.ops import pipeline as tpl
from swf_renderer_tpu_torch.runtime.cache import PackedSceneCache
from swf_renderer_tpu_torch.utils.scenes import build_scene_edges


def levels(want, got):
    """(straight max, premultiplied max, differing share) of two
    (..., 4) u8 frame arrays."""
    a = want.astype(np.int32)
    b = got.astype(np.int32)

    def premul(x):
        return np.concatenate(
            [(x[..., :3] * x[..., 3:] + 127) // 255, x[..., 3:]], -1)

    d = np.abs(a - b)
    return (int(d.max()), int(np.abs(premul(a) - premul(b)).max()),
            float((d != 0).mean()))


def test_render_batch_flatblock_matches_jax_with_cache_hits():
    height, width = 48, 200
    tables, colors = build_scene_edges(2, 3, height, width,
                                       shapes_per_layer=6, seed=5)
    want = jpl.render_batch_flatblock(tables, colors, height, width,
                                      cache=JaxCache())
    cache = PackedSceneCache()
    got = tpl.render_batch_flatblock(tables, colors, height, width,
                                     cache=cache, device="cpu")
    assert got.shape == want.shape == (2, height, width, 4)
    assert got.dtype == np.uint8
    assert levels(want, got) == (0, 0, 0.0)
    assert (cache.hits, cache.misses) == (0, 1)
    again = tpl.render_batch_flatblock(tables, colors * 0.5, height, width,
                                       cache=cache, device="cpu")
    assert (cache.hits, cache.misses) == (1, 1)
    want2 = jpl.render_batch_flatblock(tables, colors * 0.5, height, width)
    assert levels(want2, again) == (0, 0, 0.0)


def _paints():
    rng = np.random.default_rng(4)
    stops_r = np.array([0.0, 0.4, 1.0], np.float32)
    stops_c = np.array([[1, 0, 0, 1], [0, 1, 0, 0.8], [0, 0, 1, 1]],
                       np.float32)
    img = rng.integers(0, 256, (13, 17, 4)).astype(np.uint8)
    return [
        jstyle.solid_paint((0.3, 0.6, 0.9, 0.8)),
        jstyle.Paint(kind=jstyle.PAINT_LINEAR,
                     inv_matrix=(140.0, 0.0, 0.0, 140.0, -16384.0, -8000.0),
                     stop_ratios=stops_r, stop_colors=stops_c,
                     spread=jstyle.SPREAD_PAD),
        jstyle.Paint(kind=jstyle.PAINT_FOCAL,
                     inv_matrix=(160.0, 20.0, -10.0, 160.0, -12000.0,
                                 -9000.0),
                     stop_ratios=stops_r, stop_colors=stops_c,
                     focal_point=0.4, spread=jstyle.SPREAD_REFLECT,
                     color_space="linear-rgb"),
        jstyle.Paint(kind=jstyle.PAINT_BITMAP,
                     inv_matrix=(0.25, 0.0, 0.0, 0.3, -2.0, -1.5),
                     image=img, repeating=True, smoothed=True,
                     edge_mode="canvas"),
    ]


@pytest.mark.parametrize("width", [200, 256])
def test_render_batch_styled_matches_jax(width):
    height = 40
    tables, colors = build_scene_edges(2, 4, height, width,
                                       shapes_per_layer=5, seed=width)
    jpaints = _paints()
    rules = (0, 1, 0, 1)
    want = jpl.render_batch_styled(tables, jpaints, height, width,
                                   colors=colors, fill_rule=rules)
    cache = PackedSceneCache()
    tpaints = [paint_from_numpy(p) for p in jpaints]
    got = tpl.render_batch_styled(tables, tpaints, height, width,
                                  colors=colors, fill_rule=rules,
                                  cache=cache, device="cpu")
    smax, pmax, share = levels(want, got)
    assert pmax <= 1 and smax <= 1 and share <= 1e-4, (smax, pmax, share)
    again = tpl.render_batch_styled(tables, tpaints, height, width,
                                    colors=colors, fill_rule=rules,
                                    cache=cache, device="cpu")
    assert cache.hits == 1
    assert np.array_equal(again, got)


def test_pipeline_out_of_slice_routes_raise():
    """Frames wider than 8191 px now take the layered routes (the solid
    pipeline through the resolve kernel, the styled one through scanline
    coverage) and match the reference; a masked scene that wide still
    raises, as in the reference; deep and masked lists of narrow frames
    now render (multi-pass and the masked program) as the reference
    does."""
    edges = np.array([[1.0, 1.0, 8195.0, 1.5], [8195.0, 1.5, 8190.5, 7.0],
                      [8190.5, 7.0, 1.0, 6.5], [1.0, 6.5, 1.0, 1.0]],
                     np.float32)
    jsolid = jstyle.solid_paint((0.0, 0.5, 1.0, 0.9))
    solid = paint_from_numpy(jsolid)
    want = jpl.render_batch_styled([[edges]], [jsolid], 8, 8200)
    got = tpl.render_batch_styled([[edges]], [solid], 8, 8200, device="cpu")
    assert got.shape == (1, 8, 8200, 4) and got[0, :, 8100, 3].max() > 0
    assert levels(want, got)[1] <= 1
    colors = np.full((1, 1, 4), 0.8, np.float32)
    want = jpl.render_batch_flatblock([[edges]], colors, 8, 8200)
    got = tpl.render_batch_flatblock([[edges]], colors, 8, 8200,
                                     device="cpu")
    assert levels(want, got)[1] <= 1
    with pytest.raises(ValueError, match="masked scenes wider"):
        tpl.render_batch_styled([[edges]], [solid], 8, 8200,
                                mask_tree=[("draw", 0)], device="cpu")
    small = edges * np.float32(0.002)
    deep = tpl.render_batch_styled([[small] * 17], [solid] * 17, 8, 32,
                                   device="cpu")
    want = jpl.render_batch_styled([[small] * 17], [jsolid] * 17, 8, 32)
    assert deep[..., 3].max() > 0 and levels(want, deep)[1] <= 1
    masked = tpl.render_batch_styled([[small]], [solid], 8, 32,
                                     mask_tree=[("draw", 0)], device="cpu")
    want = jpl.render_batch_styled([[small]], [jsolid], 8, 32,
                                   mask_tree=[("draw", 0)])
    assert masked[..., 3].max() > 0 and levels(want, masked)[1] <= 1
