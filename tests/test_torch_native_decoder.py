"""The native shape decoder's Python surface in the port
(``swf_renderer_tpu_torch/native/bindings.py``: ``encode_records``,
``decode_shape_native``, ``format_rs_log``, ``native_available``)
against the JAX package's on the CPU.

The reference's golden corpus (``shape.rs.log`` beside each flat-shapes
sample) is not in the repo, so the tags are built in code, once per
package on that package's ``models.ast`` (``tests.test_torch_swf_binary
.Kit``): lines and curves, ``new_styles`` layers, line styles with every
cap and join, solid / linear / radial / focal / bitmap fills, and seeded
random record streams.  Both packages compile the same C++ source
(``native/src/shape_decoder.cc``), the port's into its own build
directory.  Every comparison is exact: equal bytes, equal paths (kinds,
layers, style indices, verbs, f32 points), equal strings, or the same
exception type and message (``format_rs_log`` formats solid fills only,
as the reference does).
"""

import dataclasses

import numpy as np
import pytest

from swf_renderer_tpu.native import bindings as jnative
from swf_renderer_tpu_torch.native import bindings as tnative
from tests.test_torch_mp3 import _grab
from tests.test_torch_swf_binary import JAX, PORT, both, kit

NATIVE = {JAX: jnative, PORT: tnative}
CAPS = ("round", "none", "square")
JOINS = ({"type": "round"}, {"type": "bevel"},
         {"type": "miter", "limit": 2.5})


def surface(k, tag):
    """Every result of the decoder surface on one tag."""
    nat = NATIVE[k.pkg]
    paths = _grab(lambda: nat.decode_shape_native(tag))
    if isinstance(paths, list):
        paths = [dataclasses.astuple(p) for p in paths]
    return [nat.encode_records(tag), paths,
            _grab(lambda: nat.format_rs_log(tag))]


def assert_surfaces_equal(build, seed=1607):
    want, got = both(lambda k, rng: surface(k, build(k, rng)), seed)
    assert got == want
    return got


def test_native_available_in_both():
    assert tnative.native_available() and jnative.native_available()


def triangle(k, rng):
    """The corpus triangle's geometry: one closed path under fill id 5."""
    a = k.ast
    fills = [a.SolidFill(color=k.rgba(10 * i, 20, 30)) for i in range(5)]
    recs = [a.StyleChangeRecord(move_to=k.v(380, 6839), left_fill=5),
            a.EdgeRecord(delta=k.v(6000, 0)),
            a.EdgeRecord(delta=k.v(-3000, -5000)),
            a.EdgeRecord(delta=k.v(-3000, 5000))]
    return k.shape(1, recs, fills)


def test_native_paths_structure():
    """The reference's structure assertions (tests/test_native_decoder.py)
    on the triangle, in both packages."""
    got = assert_surfaces_equal(triangle)
    paths = tnative.decode_shape_native(triangle(kit(PORT), None))
    assert len(paths) == 1
    assert paths[0].style_kind == 0
    assert paths[0].style_index == 4
    assert paths[0].verbs[0] == 0 and all(v == 1 for v in paths[0].verbs[1:])
    assert paths[0].points[0] == (380.0, 6839.0)
    assert got[2].startswith("Shape {\n    paths: [\n        StyledPath {")


def lines_and_curves(k, rng):
    """Straight and curved edges under a solid fill and a stroke."""
    return k.shape(2, k.polygon_records(rng, 0, 0, 1500, 9, curved=0.5,
                                        line=1),
                   [k.ast.SolidFill(color=k.rand_rgba(rng))], [k.line(rng)])


def new_styles_layers(k, rng):
    """Three layers: the initial styles and two ``new_styles`` records,
    each with fills and strokes, left and right fills."""
    a = k.ast
    recs = k.polygon_records(rng, -800, -800, 600, 5, line=1)
    for layer in range(2):
        new = a.ShapeStyles(
            fill=tuple(a.SolidFill(color=k.rand_rgba(rng))
                       for _ in range(2)),
            line=(k.line(rng),))
        body = k.polygon_records(rng, 700 * layer, 300, 500, 6 + layer,
                                 fill=2, line=1)
        recs.append(a.StyleChangeRecord(new_styles=new, left_fill=2,
                                        right_fill=1, line_style=1,
                                        move_to=body[0].move_to))
        recs += body[1:]
    return k.shape(3, recs, [a.SolidFill(color=k.rand_rgba(rng))],
                   [k.line(rng)])


def every_cap_and_join(k, rng):
    """One stroked sub-path for each (start cap, end cap, join) triple."""
    a = k.ast
    lines, recs = [], []
    for i, (sc, ec, join) in enumerate(
            (s, e, j) for s in CAPS for e in CAPS for j in JOINS):
        lines.append(a.LineStyle(
            width=20 + 10 * i, start_cap=sc, end_cap=ec, join=join,
            no_h_scale=bool(i & 1), no_v_scale=bool(i & 2),
            no_close=bool(i & 4), pixel_hinting=bool(i & 8),
            fill=a.SolidFill(color=k.rand_rgba(rng))))
        recs += k.polygon_records(rng, 300 * (i % 6), 300 * (i // 6), 120,
                                  3 + i % 4, fill=None, line=i + 1)
    return k.shape(4, recs, [], lines)


@pytest.mark.parametrize("fill", ["solid", "linear", "radial", "focal",
                                  "bitmap"])
def test_fill_kinds_agree(fill):
    """Each fill kind alone and as a stroke's fill: paths equal;
    ``format_rs_log`` formats the solid one and refuses the others with
    the reference's NotImplementedError."""
    def build(k, rng):
        style = k.fill(rng, fill)
        return k.shape(5, k.polygon_records(rng, 0, 0, 900, 7, line=1),
                       [style], [k.line(rng, fill=style)])

    got = assert_surfaces_equal(build)
    assert isinstance(got[1], list) and len(got[1]) == 2
    if fill == "solid":
        assert isinstance(got[2], str)
    else:
        assert got[2][0] == "NotImplementedError"


@pytest.mark.parametrize("case", [lines_and_curves, new_styles_layers,
                                  every_cap_and_join],
                         ids=lambda f: f.__name__)
def test_coded_shapes_agree(case):
    got = assert_surfaces_equal(case)
    assert isinstance(got[2], str) and len(got[1]) >= 1


def test_every_fill_kind_and_layer_in_one_shape():
    """The kit's shape with fills of every kind, strokes and a
    ``new_styles`` layer."""
    got = assert_surfaces_equal(lambda k, rng: k.random_shape(rng, 6))
    assert len(got[1]) > 5 and got[2][0] == "NotImplementedError"


def random_records(k, rng):
    """A random record stream: moves, straight and curved edges, fill and
    line selections (index 0 = none), and new-styles layers; solid fills
    only, so the rs-log formats."""
    a = k.ast
    n_fill, n_line = int(rng.integers(1, 4)), int(rng.integers(0, 3))

    def solids(n):
        return tuple(a.SolidFill(color=k.rand_rgba(rng)) for _ in range(n))

    def lines(n):
        return tuple(k.line(rng) for _ in range(n))

    fills, strokes = solids(n_fill), lines(n_line)
    recs = []
    for _ in range(int(rng.integers(4, 40))):
        r = rng.random()
        if r < 0.55:
            recs.append(a.EdgeRecord(delta=k.v(*rng.integers(-900, 900, 2))))
        elif r < 0.8:
            recs.append(a.EdgeRecord(
                delta=k.v(*rng.integers(-900, 900, 2)),
                control_delta=k.v(*rng.integers(-900, 900, 2))))
        else:
            new = None
            if rng.random() < 0.25:
                n_fill, n_line = (int(rng.integers(1, 4)),
                                  int(rng.integers(0, 3)))
                new = a.ShapeStyles(fill=solids(n_fill), line=lines(n_line))
            pick = rng.random(4) < 0.6
            recs.append(a.StyleChangeRecord(
                move_to=(k.v(*rng.integers(-3000, 3000, 2))
                         if pick[0] or new is not None else None),
                left_fill=(int(rng.integers(0, n_fill + 1))
                           if pick[1] else None),
                right_fill=(int(rng.integers(0, n_fill + 1))
                            if pick[2] else None),
                line_style=(int(rng.integers(0, n_line + 1))
                            if pick[3] else None),
                new_styles=new))
    recs.insert(0, a.StyleChangeRecord(move_to=k.v(0, 0), left_fill=1))
    return k.shape(7, recs, fills, strokes)


@pytest.mark.parametrize("seed", range(32))
def test_random_record_streams_agree(seed):
    got = assert_surfaces_equal(random_records, seed=seed)
    assert isinstance(got[0], bytes) and got[0][:4] == b"DFWS"
    if isinstance(got[1], list):
        for kind, _layer, _style, verbs, points in got[1]:
            assert kind in (0, 1) and len(verbs) == len(points)


def test_encode_records_refuses_unknown_records():
    """A record that is neither an edge nor a style change raises the
    reference's ValueError."""
    def build(k, rng):
        tag = triangle(k, rng)
        bad = dataclasses.replace(tag.shape, records=tag.shape.records + (
            "bogus",))
        return _grab(lambda: NATIVE[k.pkg].encode_records(
            dataclasses.replace(tag, shape=bad)))

    want, got = both(build)
    assert got == want and got[0] == "ValueError"


def test_layer_lookup_refuses_missing_layers():
    def build(k, rng):
        tag = new_styles_layers(k, np.random.default_rng(3))
        nat = NATIVE[k.pkg]
        return [nat._layer_styles(tag, 2) == tag.shape.records[
            [i for i, r in enumerate(tag.shape.records)
             if getattr(r, "new_styles", None) is not None][1]].new_styles,
                _grab(lambda: nat._layer_styles(tag, 3)),
                [nat._f32_debug(v) for v in (0.0, 1.0, -2.5, 1e21, 3.25e-5,
                                             float(np.float32(0.1)))]]

    want, got = both(build)
    assert got == want
    assert got[0] is True and got[1][0] == "IndexError"
