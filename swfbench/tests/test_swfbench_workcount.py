"""The least-work count: a function of the content alone."""

import pytest

from swfbench import gen, harness, workcount
from swfbench.reference import frames as ref

from .conftest import TINY


def _work(bench, name, seed, size=TINY):
    cell = harness.Cell(bench, name)
    cfg = dict(cell.config, width=size[0], height=size[1],
               frames_per_call=size[2])
    clip = gen.make_clip(cfg, cell.mix, seed, 0)
    covered = [ref.covered_pixels(clip, f) for f in range(len(clip.frames))]
    return clip, workcount.clip_work(clip, covered)


@pytest.mark.parametrize("name", ["export1080.tween", "export1080.keyframes",
                                  "export1080.morph"])
def test_same_content_same_count(bench, name):
    clip, a = _work(bench, name, 11)
    _, b = _work(bench, name, 11)
    assert a == b
    nbytes, ops = a
    pixels = len(clip.frames) * clip.width * clip.height
    assert nbytes > 4 * pixels and ops > 21 * pixels


def test_more_frames_more_work(bench):
    _, small = _work(bench, "export1080.tween", 3, (96, 64, 2))
    _, large = _work(bench, "export1080.tween", 3, (96, 64, 4))
    assert large[0] > small[0] and large[1] > small[1]


def test_peaks_table():
    bps, ops = workcount.peaks("NVIDIA H100 80GB HBM3")
    assert bps == 3.35e12 and ops == 67e12
    assert workcount.peaks("cpu") is None
    assert workcount.bound_seconds(3.35e12, 0, (bps, ops)) == 1.0
