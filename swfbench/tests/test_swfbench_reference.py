"""The plain reference: exact areas, agreement with the program's CPU
route on every mix at a tiny size, and the movie entry's composition."""

import numpy as np
import pytest
import torch

from swfbench import check, entries, gen, harness, port, swfwrite
from swfbench.reference import frames as ref
from swfbench.reference.raster import coverage

from .conftest import CHECK, TINY

SEED = 4242424242


def _poly(points):
    p = torch.tensor(points, dtype=torch.float64)
    return torch.cat([p, torch.roll(p, -1, 0)], 1)


def test_rectangle_and_triangle_areas():
    rect = _poly([[1.25, 1.5], [5.75, 1.5], [5.75, 4.0], [1.25, 4.0]])
    tri = _poly([[0.0, 0.0], [8.0, 0.0], [0.0, 6.0]])
    cov = coverage(torch.cat([rect, tri]),
                   torch.tensor([0] * 4 + [1] * 3), 2, 8, 10)
    assert cov[0].sum().item() == pytest.approx(4.5 * 2.5)
    assert cov[0][2, 3].item() == 1.0 and cov[0][1, 1].item() == 0.375
    assert cov[1].sum().item() == pytest.approx(24.0)


def test_overhang_and_winding():
    """A square half off the left edge covers its part in the frame; two
    squares with one winding direction stay at coverage 1."""
    sq = _poly([[-4.0, 0.0], [2.0, 0.0], [2.0, 3.0], [-4.0, 3.0]])
    cov = coverage(torch.cat([sq, sq]), torch.zeros(8, dtype=torch.long),
                   1, 4, 4)
    assert cov.sum().item() == pytest.approx(6.0)
    assert cov.max().item() == 1.0


@pytest.mark.parametrize("name", ["export1080.tween", "export1080.keyframes",
                                  "export1080.morph"])
def test_reference_matches_program_cpu_route(bench, name):
    cell = harness.Cell(bench, name)
    cfg = dict(cell.config, width=CHECK[0], height=CHECK[1],
               frames_per_call=CHECK[2])
    entry = entries.load(cell.mix["entry"], "cpu")
    clip = gen.make_clip(cfg, cell.mix, SEED, 0)
    got = entry.call(entry.build(entry.prepare(clip)))
    lim = check.limits(name)
    tally = check.Tally(check.levels(lim))
    for f in range(len(clip.frames)):
        tally.add(got[f], ref.frame(clip, f))
    ok, shown = tally.verdict(lim)
    assert ok, shown


@pytest.mark.parametrize("traffic", ["tween", "morph"])
def test_load_then_render_batch_is_render_movie_timeline(bench, traffic):
    import swf_renderer_tpu_torch as swf
    from swf_renderer_tpu_torch.runtime.movie import load_movie_timeline

    name = f"export1080.{traffic}"
    cell = harness.Cell(bench, name)
    cfg = dict(cell.config, width=TINY[0], height=TINY[1],
               frames_per_call=TINY[2])
    movie = swfwrite.movie_bytes(gen.make_clip(cfg, cell.mix, SEED, 1))
    stages, bitmaps = load_movie_timeline(movie)
    renderer = swf.TorchRenderer(stages[0].width, stages[0].height,
                                 device="cpu")
    composed = renderer.render_batch(stages)
    whole = swf.render_movie_timeline(movie, device="cpu")
    assert not bitmaps
    np.testing.assert_array_equal(composed, whole)


def test_stage_builder_matches_the_movie(bench):
    """The stage builder's stages (``port.stages``, for entries that take
    stages) and the movie of the same clip give the same frames."""
    import swf_renderer_tpu_torch as swf

    cell = harness.Cell(bench, "export1080.tween")
    cfg = dict(cell.config, width=TINY[0], height=TINY[1],
               frames_per_call=TINY[2])
    clip = gen.make_clip(cfg, cell.mix, SEED, 2)
    a = swf.render_movie_timeline(swfwrite.movie_bytes(clip), device="cpu")
    r = swf.TorchRenderer(clip.width, clip.height, device="cpu")
    np.testing.assert_array_equal(a, r.render_batch(port.stages(clip)))
