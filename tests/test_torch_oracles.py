"""The port's f64 numpy oracles (``ops/coverage.py`` ``coverage_numpy``,
``ops/scanline.py`` ``coverage_scanline_numpy`` and
``coverage_flash4x4_numpy``) against the JAX package's on the CPU, and
the port's coverage kernels' plain versions against ``coverage_numpy``.

The oracles are host numpy with the reference's arithmetic in its order,
on the port's own ``edges_to_cells`` / ``edges_to_point_cells``: equal
arrays (dtype and shape too) on seeded edge tables under both fill
rules.  ``coverage_plain`` (the reference's ``coverage_xla``) and the
banded and tiled plain versions are within 1e-5 of ``coverage_numpy``
on the reference's STAR and TRIANGLE cases (tests/test_coverage.py),
as the reference's own XLA formulation is.
"""

import numpy as np
import pytest
import torch

from swf_renderer_tpu.ops import coverage as jcov
from swf_renderer_tpu.ops import scanline as jscan
from swf_renderer_tpu_torch.ops import coverage as tcov
from swf_renderer_tpu_torch.ops import scanline as tscan

ORACLES = {
    "coverage_numpy": (tcov.coverage_numpy, jcov.coverage_numpy),
    "coverage_scanline_numpy": (tscan.coverage_scanline_numpy,
                                jscan.coverage_scanline_numpy),
    "coverage_flash4x4_numpy": (tscan.coverage_flash4x4_numpy,
                                jscan.coverage_flash4x4_numpy),
}


def closed_polygon_edges(points):
    pts = np.asarray(points, dtype=np.float32)
    closed = np.concatenate([pts, pts[:1]], axis=0)
    return np.concatenate([closed[:-1], closed[1:]], axis=1)


TRIANGLE = closed_polygon_edges([(2.3, 1.7), (13.2, 4.1), (5.5, 12.8)])
STAR = closed_polygon_edges([(8, 1), (11, 13), (2, 5.5), (14, 5.5), (5, 13)])


def seeded_edges(seed, height, width):
    """Closed random polygons reaching past the viewport on every side,
    with a horizontal edge, a vertical one and a degenerate one."""
    rng = np.random.default_rng(seed)
    tables = [closed_polygon_edges(
        rng.uniform((-0.2 * width, -0.2 * height),
                    (1.2 * width, 1.2 * height), (int(n), 2)))
        for n in rng.integers(3, 12, 3)]
    tables.append(np.asarray([[1.5, 2.0, width - 2.5, 2.0],
                              [3.0, 1.0, 3.0, height - 1.0],
                              [4.0, 4.0, 4.0, 4.0]], np.float32))
    return np.concatenate(tables).astype(np.float32)


CASES = [(0, 16, 16), (1, 23, 37), (2, 40, 24), (3, 9, 64)]


@pytest.mark.parametrize("rule", [0, 1], ids=["nonzero", "evenodd"])
@pytest.mark.parametrize("seed,height,width", CASES)
@pytest.mark.parametrize("name", list(ORACLES))
def test_oracles_equal_the_references(name, seed, height, width, rule):
    port, ref = ORACLES[name]
    edges = seeded_edges(seed, height, width)
    got, want = port(edges, height, width, rule), ref(edges, height, width,
                                                       rule)
    assert got.dtype == want.dtype == np.float64
    assert got.shape == want.shape == (height, width)
    assert np.array_equal(got, want)
    assert 0 < got.max() <= 1


@pytest.mark.parametrize("name", list(ORACLES))
def test_oracles_on_the_references_shapes(name):
    """STAR and TRIANGLE, both rules, and the reference's exact checks
    (the star's centre: winding 2)."""
    port, ref = ORACLES[name]
    for edges in (STAR, TRIANGLE, np.zeros((0, 4), np.float32)):
        for rule in (0, 1):
            got, want = port(edges, 16, 16, rule), ref(edges, 16, 16, rule)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    nz, eo = port(STAR, 16, 16, 0), port(STAR, 16, 16, 1)
    assert nz[7, 8] == pytest.approx(1.0, abs=1e-6)
    assert eo[7, 8] == pytest.approx(0.0, abs=1e-6)


def _table(edges, n=128):
    t = np.zeros((1, 4, n), np.float32)
    t[0, :, :len(edges)] = edges.T
    return torch.from_numpy(t)


@pytest.mark.parametrize("rule", [0, 1], ids=["nonzero", "evenodd"])
@pytest.mark.parametrize("edges", [STAR, TRIANGLE], ids=["star", "triangle"])
def test_plain_versions_match_coverage_numpy(edges, rule):
    """The reference's ``test_xla_matches_numpy`` tolerance (1e-5) for the
    port's ``coverage_plain`` and the banded and tiled kernels' plain
    versions (the CPU route of ``coverage``)."""
    want = tcov.coverage_numpy(edges, 16, 16, rule)
    table = _table(edges)
    for got in (tcov.coverage_plain(table, 16, 16, rule),
                tcov.coverage_banded(table, 16, 16, rule, device="cpu"),
                tcov.coverage_tiled(_table(edges, 2176), 16, 16, rule,
                                    device="cpu")):
        assert isinstance(got, torch.Tensor) and got.shape == (1, 16, 16)
        np.testing.assert_allclose(got[0].numpy(), want, atol=1e-5)
