"""The port's last host utilities against the JAX package's, on the CPU:
``utils.jsjson`` (JSON.stringify), ``utils.imagediff`` (pixelmatch) and
``runtime.cache.save_draws`` / ``load_draws``, whose ``.npz`` files load
in the other package both ways.

Tolerance: exact — the same strings, the same counts and diff images,
and draw lists equal under ``convert.to_plain``.
"""

import math

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from swf_renderer_tpu.ops import style as jstyle
from swf_renderer_tpu.runtime import cache as jcache
from swf_renderer_tpu.runtime.scene import Draw as JDraw
from swf_renderer_tpu.utils import imagediff as jdiff
from swf_renderer_tpu.utils import jsjson as jjson
from swf_renderer_tpu_torch.convert import to_plain
from swf_renderer_tpu_torch.ops import style as tstyle
from swf_renderer_tpu_torch.runtime import cache as tcache
from swf_renderer_tpu_torch.runtime.scene import Draw as TDraw
from swf_renderer_tpu_torch.utils import imagediff as tdiff
from swf_renderer_tpu_torch.utils import jsjson as tjson

NUMBERS = [0, -0.0, 0.0, 1, -1, 1.0, 2.5, -3.75, 1e21, 1e20, 1e-7, 1.5e-7,
           123456789012345680000.0, 0.1 + 0.2, 5e-324, 1.7976931348623157e308,
           math.nan, math.inf, -math.inf, 2 ** 53, -(2 ** 63), True, False,
           0.30000000000000004, 100.0, 1e100]


@pytest.mark.parametrize("x", NUMBERS, ids=repr)
def test_format_number_matches_reference(x):
    assert tjson.format_number(x) == jjson.format_number(x)


def _tree(rng, depth=0):
    kind = rng.integers(0, 8 if depth < 4 else 5)
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:
        return float(rng.choice([-0.0, rng.normal() * 10.0 ** rng.integers(
            -9, 25), float(rng.integers(-1000, 1000))]))
    if kind == 3:
        return int(rng.integers(-10 ** 6, 10 ** 6))
    if kind == 4:
        return "".join(chr(c) for c in rng.integers(0, 200, rng.integers(
            0, 8)))
    if kind == 5:
        return [_tree(rng, depth + 1) for _ in range(rng.integers(0, 4))]
    if kind == 6:
        return tuple(_tree(rng, depth + 1)
                     for _ in range(rng.integers(0, 3)))
    return {f"k{i}\n\"": _tree(rng, depth + 1)
            for i in range(rng.integers(0, 4))}


@pytest.mark.parametrize("seed", range(6))
def test_stringify_matches_reference_on_seeded_trees(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        tree = _tree(rng)
        for indent in (2, 0, 4):
            assert tjson.stringify(tree, indent) == jjson.stringify(
                tree, indent)


JSON = st.recursive(
    st.none() | st.booleans() | st.integers() | st.text(max_size=6)
    | st.floats(allow_nan=True, allow_infinity=True),
    lambda kids: st.lists(kids, max_size=4)
    | st.dictionaries(st.text(max_size=4), kids, max_size=4),
    max_leaves=20)


@settings(max_examples=150, deadline=None)
@given(JSON)
def test_stringify_matches_reference_on_any_tree(tree):
    assert tjson.stringify(tree) == jjson.stringify(tree)


def test_stringify_refuses_what_the_reference_refuses():
    for mod in (tjson, jjson):
        with pytest.raises(TypeError, match="cannot stringify"):
            mod.stringify({"x": object()})
        with pytest.raises(TypeError, match="not a number"):
            mod.format_number("1")


def _image_pair(seed):
    """An RGBA image of soft gradients and hard edges, and a copy with
    noise, a moved edge and a few flipped pixels."""
    rng = np.random.default_rng(seed)
    h, w = 40, 56
    y, x = np.mgrid[0:h, 0:w]
    a = np.zeros((h, w, 4), np.uint8)
    a[..., 0] = (x * 4) % 256
    a[..., 1] = (y * 6) % 256
    a[..., 2] = np.where((x - 28) ** 2 + (y - 20) ** 2 < 150, 220, 30)
    a[..., 3] = np.where(x > 10, 255, rng.integers(0, 256, (h, w)))
    b = a.copy()
    noise = rng.integers(-3, 4, a.shape)
    b = np.clip(b.astype(int) + noise, 0, 255).astype(np.uint8)
    b[5:9, 30:50] = rng.integers(0, 256, (4, 20, 4))
    b[..., 2] = np.where((x - 29) ** 2 + (y - 20) ** 2 < 150, 220, 30)
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("threshold,include_aa", [(0.1, False),
                                                  (0.05, False),
                                                  (0.0, True)])
def test_pixelmatch_matches_reference(seed, threshold, include_aa):
    a, b = _image_pair(seed)
    want = jdiff.pixelmatch(a, b, threshold=threshold,
                            include_aa=include_aa)
    got = tdiff.pixelmatch(a, b, threshold=threshold, include_aa=include_aa)
    assert (got.diff_count, got.aa_count, got.max_channel_diff, got.total) \
        == (want.diff_count, want.aa_count, want.max_channel_diff,
            want.total)
    assert got.diff_ratio == want.diff_ratio
    np.testing.assert_array_equal(got.diff_image, want.diff_image)
    np.testing.assert_array_equal(tdiff.color_delta(a, b),
                                  jdiff.color_delta(a, b))
    assert got.diff_count > 0


def test_pixelmatch_refuses_images_of_other_sizes():
    a, b = _image_pair(0)
    with pytest.raises(ValueError, match="image sizes differ"):
        tdiff.pixelmatch(a, b[:-1])


def _draws(style, draw_cls, rng):
    """One draw of each paint kind, with per-draw rules (the fields
    save_draws keeps)."""
    img = rng.integers(0, 256, (6, 9, 4)).astype(np.uint8)
    stops_r = np.array([0.0, 0.4, 1.0], np.float32)
    stops_c = rng.uniform(0, 1, (3, 4)).astype(np.float32)
    paints = [
        style.solid_paint((0.9, 0.2, 0.1, 0.7)),
        style.Paint(kind=style.PAINT_LINEAR, inv_matrix=(2.0, 0.1, -0.1,
                                                         2.0, -30.0, 4.0),
                    stop_ratios=stops_r, stop_colors=stops_c,
                    spread=style.SPREAD_REFLECT),
        style.Paint(kind=style.PAINT_FOCAL, inv_matrix=(1.0, 0, 0, 1.0, 0, 0),
                    stop_ratios=stops_r, stop_colors=stops_c,
                    focal_point=-0.4),
        style.Paint(kind=style.PAINT_BITMAP, inv_matrix=(0.5, 0, 0, 0.5, 1, 2),
                    image=img, repeating=True, smoothed=False,
                    supersample=2, edge_mode="canvas"),
    ]
    return [draw_cls(edges=rng.uniform(-5, 60, (7 + i, 4)).astype(
                np.float32), paint=p, fill_rule=i % 2)
            for i, p in enumerate(paints)]


def test_saved_draws_load_in_the_other_package(tmp_path):
    """Port -> JAX package and back: the .npz format and version are
    shared; the loaded lists equal the saved ones under to_plain."""
    port_draws = _draws(tstyle, TDraw, np.random.default_rng(4))
    jax_draws = _draws(jstyle, JDraw, np.random.default_rng(4))
    assert to_plain(port_draws) == to_plain(jax_draws)
    tcache.save_draws(tmp_path / "port.npz", port_draws)
    jcache.save_draws(tmp_path / "jax.npz", jax_draws)
    for path in ("port.npz", "jax.npz"):
        by_port = tcache.load_draws(tmp_path / path)
        by_jax = jcache.load_draws(tmp_path / path)
        assert to_plain(by_port) == to_plain(port_draws)
        assert to_plain(by_jax) == to_plain(jax_draws)
        assert all(isinstance(d, TDraw) for d in by_port)


def test_load_draws_refuses_other_versions(tmp_path):
    tcache.save_draws(tmp_path / "d.npz",
                      _draws(tstyle, TDraw, np.random.default_rng(1)))
    with np.load(tmp_path / "d.npz") as data:
        arrays = dict(data)
    arrays["__meta__"] = np.frombuffer(b'{"version": 2, "draws": []}',
                                       np.uint8)
    np.savez(tmp_path / "v2.npz", **arrays)
    for mod in (tcache, jcache):
        with pytest.raises(ValueError, match="unsupported cache version"):
            mod.load_draws(tmp_path / "v2.npz")
