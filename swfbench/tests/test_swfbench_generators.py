"""The generator and the SWF writer: the same seed gives the same
content and bytes, every call of a run distinct content, and the movie
the program parses is the content the reference reads."""

import dataclasses

import numpy as np
import pytest

from swfbench import gen, harness, swfwrite

from .conftest import TINY

SEED = 2 ** 31 + 12345   # larger than 32 signed bits hold


def _cell(bench, traffic):
    name = next(c["name"] for c in bench["workloads"]
                if c["traffic"] == traffic)
    cell = harness.Cell(bench, name)
    cfg = dict(cell.config, width=TINY[0], height=TINY[1],
               frames_per_call=TINY[2])
    return cfg, cell.mix


def _plain(x):
    """Every number of a content object, arrays as lists."""
    if dataclasses.is_dataclass(x):
        return [type(x).__name__] + [_plain(getattr(x, f.name))
                                     for f in dataclasses.fields(x)]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _numbers(clip):
    out = [clip.width, clip.height, *clip.background]
    for row in clip.frames:
        for inst in row:
            out += [inst.depth, inst.matrix, inst.cxform, inst.ratio,
                    _plain(inst.char)]
    return repr(out)


TRAFFIC = ["tween", "keyframes", "morph"]


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_same_seed_same_content(bench, traffic):
    cfg, mix = _cell(bench, traffic)
    a = gen.make_clip(cfg, mix, SEED, 3)
    b = gen.make_clip(cfg, mix, SEED, 3)
    assert _numbers(a) == _numbers(b)
    if mix["entry"] == "movie_timeline":
        assert swfwrite.movie_bytes(a) == swfwrite.movie_bytes(b)


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_every_call_distinct(bench, traffic):
    cfg, mix = _cell(bench, traffic)
    seen = {_numbers(gen.make_clip(cfg, mix, SEED, i))
            for i in range(mix["pool"])}
    seen.add(_numbers(gen.make_clip(cfg, mix, SEED, -1)))
    seen.add(_numbers(gen.make_clip(cfg, mix, SEED + 1, 0)))
    assert len(seen) == mix["pool"] + 2


@pytest.mark.parametrize("traffic", ["tween", "keyframes", "morph"])
def test_movie_parses_to_the_content(bench, traffic):
    """The program's parser reads back every frame's placements: the same
    characters, matrices, colour transforms and ratios."""
    from swf_renderer_tpu_torch.runtime.movie import load_movie_timeline

    cfg, mix = _cell(bench, traffic)
    clip = gen.make_clip(cfg, mix, SEED, 0)
    stages, _ = load_movie_timeline(swfwrite.movie_bytes(clip))
    assert len(stages) == len(clip.frames)
    for stage, row in zip(stages, clip.frames):
        assert (stage.width, stage.height) == (clip.width, clip.height)
        assert (stage.background_color.r, stage.background_color.g,
                stage.background_color.b) == tuple(clip.background[:3])
        assert len(stage.children) == len(row)
        for child, inst in zip(stage.children, row):
            m = child.matrix
            assert (m.scale_x.epsilons, m.scale_y.epsilons,
                    m.rotate_skew0.epsilons, m.rotate_skew1.epsilons,
                    m.translate_x, m.translate_y) == inst.matrix
            assert child.definition.id == inst.char.cid
            if inst.ratio is not None:
                assert child.ratio == inst.ratio / 65536.0
            if inst.cxform is not None:
                assert child.color_transform.mult == tuple(
                    v / 256.0 for v in inst.cxform[0])


def test_bits_and_widths():
    assert [swfwrite.sbits(v) for v in (0, 1, -1, 2, -2, 38400)] == [
        1, 2, 1, 3, 2, 17]
    w = swfwrite.Bits()
    w.ub(5, 3)
    w.sb(-1, 2)
    assert w.align() == bytes([0b10111000])
    with pytest.raises(ValueError):
        w.sb(4, 3)
