"""Scanline coverage of the port (ops/scanline.py) against the JAX
package, on the CPU.

The host half (cell splitting, point cells, packing) is a numpy copy and
matches exactly.  The device half is a scatter-add and a row ``cumsum``
in both packages (no Pallas kernel): the port scatters with
``index_put_(accumulate=True)`` in update order, as XLA's CPU scatter
does, but XLA's ``cumsum`` adds in another order than PyTorch's, so the
analytic coverage matches within 1e-5 (measured 2.5e-7); the
point-sampled coverage — sums of crossing signs, exact in f32 — matches
exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swf_renderer_tpu.ops import scanline as js
from swf_renderer_tpu_torch.ops import scanline as ts
from tests.test_torch_coverage import random_edges, star_planes

H, W = 30, 70


def tables(seed, planes=3, n=60):
    """Per-draw (E, 4) edge tables of closed paths."""
    t = random_edges(np.random.default_rng(seed), planes, n, 128, H, W)
    return [p[:, np.any(p != 0, axis=0)].T.copy() for p in t]


@pytest.mark.parametrize("seed", [1, 2])
def test_cells_and_packing_match_reference(seed):
    draws = tables(seed)
    for e in draws:
        for a, b in zip(js.edges_to_cells(e, H, W), ts.edges_to_cells(e, H, W)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(js.edges_to_point_cells(e, H, W),
                        ts.edges_to_point_cells(e, H, W)):
            assert np.array_equal(a, b)
    for a, b in zip(js.lower_draws_to_cells(draws, H, W),
                    ts.lower_draws_to_cells(draws, H, W)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    empty = np.zeros((0, 4), np.float32)
    assert all(x.size == 0 for x in ts.edges_to_cells(empty, H, W))
    with pytest.raises(ValueError, match="non-finite"):
        ts.edges_to_cells(np.full((1, 4), np.nan), H, W)


@pytest.mark.parametrize("rule", [0, 1, (0, 1, 0)])
def test_coverage_scanline_matches_reference(rule):
    draws = tables(3)
    packed = js.lower_draws_to_cells(draws, H, W)
    want = np.asarray(js.coverage_scanline(*(jnp.asarray(x) for x in packed),
                                           H, W, rule))
    got = ts.coverage_scanline(*packed, H, W, rule, device="cpu")
    assert got.shape == (3, H, W)
    assert np.abs(want - got.numpy()).max() <= 1e-5
    again = ts.coverage_scanline(*packed, H, W, rule, device="cpu")
    assert torch.equal(got, again)


@pytest.mark.parametrize("rule", [0, 1, (1, 0)])
def test_coverage_points_match_reference(rule):
    t = star_planes(H, W, 128)
    draws = [p[:, np.any(p != 0, axis=0)].T.copy() for p in t]
    cells = [js.edges_to_point_cells(e, H, W) for e in draws]
    n = 512
    rows = np.zeros((2, n), np.int32)
    cols = np.zeros((2, n), np.int32)
    delta = np.zeros((2, n), np.float32)
    for i, (r, c, d) in enumerate(cells):
        rows[i, :len(r)], cols[i, :len(r)], delta[i, :len(r)] = r, c, d
    want = np.asarray(js.coverage_scanline_points(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(delta), H, W,
        rule))
    got = ts.coverage_scanline_points(rows, cols, delta, H, W, rule,
                                      device="cpu")
    assert np.array_equal(want, got.numpy())
    assert set(np.unique(want * 16)) <= set(range(17))


def test_render_scanline_batch_matches_reference():
    frames = [tables(10 + f, planes=2) for f in range(2)]
    packed = [ts.lower_draws_to_cells(d, H, W) for d in frames]
    n = max(p[0].shape[1] for p in packed)
    arrs = [np.stack([np.pad(p[k], ((0, 0), (0, n - p[k].shape[1])))
                      for p in packed]) for k in range(4)]
    colors = np.random.default_rng(4).uniform(0.1, 1, (2, 2, 4)).astype(
        np.float32)
    want = np.asarray(js.render_scanline_batch(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(colors), H, W, 1))
    got = ts.render_scanline_batch(*arrs, colors, H, W, 1, device="cpu")
    assert got.shape == (2, H, W, 4) and got.dtype == np.uint8
    assert np.abs(want.astype(int) - got.astype(int)).max() <= 1
    assert got[..., 3].max() > 0
