"""Direct coverage of the port (ops/coverage.py) against the JAX package,
on the CPU.

The banded kernel's plain version is held against ``coverage_banded`` in
Pallas interpret mode, the tiled kernel's against ``coverage_pallas``
with ``scalar_loop=True`` (the body the TPU runs; the default interpret
body sums ``edge_contribution`` in chunks of 8 instead), and
``coverage_plain`` against ``coverage_xla``.  Tolerance 1e-5 in coverage:
XLA on the CPU contracts ``x0 + t * dx`` and the ramp's multiply-adds
into FMAs and the port computes op by op (as its kernels do on the
card); measured at most 4.3e-6 (banded) and 3.9e-6 (tiled) here.  The
host steps (stable sort, band windows, block bounds) match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swf_renderer_tpu.ops import coverage as jc
from swf_renderer_tpu_torch.ops import coverage as tc
from swf_renderer_tpu_torch.utils.scenes import (
    closed_edge_planes, polygon_edges,
)

TOL = 1e-5


def random_edges(rng, planes, n, e_pad, height, width):
    return closed_edge_planes(rng, planes, n, e_pad, height, width)


def star_planes(height, width, e_pad):
    """Two closed polygons (a self-intersecting star and a square) as
    planes: the fill rules differ on the star's core."""
    cx, cy, r = width / 2, height / 2, min(height, width) * 0.45
    ang = np.linspace(0, 4 * np.pi, 5, endpoint=False) - np.pi / 2
    star = polygon_edges(np.stack([cx + r * np.cos(ang),
                                   cy + r * np.sin(ang)], 1))
    square = polygon_edges([(3.3, 2.7), (width - 4.1, 3.2),
                            (width - 5.5, height - 2.2), (2.6, height - 3.9)])
    t = np.zeros((2, 4, e_pad), np.float32)
    t[0, :, :star.shape[0]] = star.T
    t[1, :, :square.shape[0]] = square.T
    return t


CASES = [  # (planes, edges, padded, height, width)
    (2, 3, 128, 37, 150), (2, 200, 256, 37, 150), (1, 700, 768, 40, 130),
]


@pytest.mark.parametrize("rule", [0, 1])
@pytest.mark.parametrize("planes,n,e_pad,height,width", CASES)
def test_banded_plain_matches_pallas_banded(planes, n, e_pad, height, width,
                                            rule):
    t = random_edges(np.random.default_rng(n), planes, n, e_pad, height,
                     width)
    want = np.asarray(jc.coverage_banded(jnp.asarray(t), height, width, rule,
                                         interpret=True))
    got = tc.coverage_banded(torch.from_numpy(t), height, width, rule)
    assert got.shape == (planes, height, width)
    assert np.abs(want - got.numpy()).max() <= TOL


@pytest.mark.parametrize("rule", [0, 1])
@pytest.mark.parametrize("planes,n,e_pad,height,width", CASES)
def test_tiled_plain_matches_pallas_scalar_loop(planes, n, e_pad, height,
                                                width, rule):
    t = random_edges(np.random.default_rng(n + 1), planes, n, e_pad, height,
                     width)
    want = np.asarray(jc.coverage_pallas(jnp.asarray(t), height, width, rule,
                                         interpret=True, scalar_loop=True))
    got = tc.coverage_tiled(torch.from_numpy(t), height, width, rule)
    assert np.abs(want - got.numpy()).max() <= TOL


@pytest.mark.parametrize("rule", [0, 1])
def test_closed_shapes_through_every_route(rule):
    """A star and a square: banded, tiled, the plain XLA form and the
    reference's own routes agree; the rules differ on the star's core."""
    height, width = 48, 70
    t = star_planes(height, width, 128)
    got_b = tc.coverage_banded(torch.from_numpy(t), height, width, rule)
    got_t = tc.coverage_tiled(torch.from_numpy(t), height, width, rule)
    got_x = tc.coverage_plain(torch.from_numpy(t), height, width, rule)
    want = np.asarray(jc.coverage_xla(jnp.asarray(t), height, width, rule))
    for got in (got_b, got_t, got_x):
        assert np.abs(want - got.numpy()).max() <= TOL
    other = tc.coverage_banded(torch.from_numpy(t), height, width, 1 - rule)
    assert float((other[0] - got_b[0]).abs().max()) > 0.9   # star core
    assert float((other[1] - got_b[1]).abs().max()) <= 1e-6  # square


def test_coverage_plain_matches_coverage_xla():
    t = random_edges(np.random.default_rng(3), 2, 60, 128, 30, 90)
    for rule in (0, 1):
        want = np.asarray(jc.coverage_xla(jnp.asarray(t), 30, 90, rule))
        got = tc.coverage_plain(torch.from_numpy(t), 30, 90, rule)
        assert np.abs(want - got.numpy()).max() <= TOL


def test_host_steps_match_reference():
    """The stable sort keeps tied edges (and the padding) in table order;
    band windows and block bounds equal the reference's."""
    rng = np.random.default_rng(5)
    t = random_edges(rng, 3, 300, 384, 60, 90)
    t[:, :, 50:90] = np.round(t[:, :, 50:90])   # many tied ymin keys
    tt = torch.from_numpy(t)
    edges_sorted, key, pad = tc.sort_edges(tt)
    jt = jnp.asarray(t)
    ymin = jnp.minimum(jt[:, 1], jt[:, 3])
    jkey = jnp.where(jnp.all(jt == 0.0, axis=1), jnp.float32(3e38), ymin)
    order = np.asarray(jnp.argsort(jkey, axis=-1))
    assert np.array_equal(edges_sorted.numpy(),
                          np.take_along_axis(t, order[:, None, :], -1))
    jsorted, jbounds = jc._sort_and_bound_edges(jt)
    assert np.array_equal(np.asarray(jsorted), edges_sorted.numpy())
    assert np.array_equal(np.asarray(jbounds)[:, :, 0],
                          tc.block_bounds(edges_sorted, key, pad).numpy())
    key_sorted = np.asarray(jnp.take_along_axis(jkey, jnp.asarray(order), -1))
    max_ext = np.abs(t[:, 3] - t[:, 1]).max(-1)
    band_y0 = np.arange(4, dtype=np.float32) * 16
    lo = [np.searchsorted(k, band_y0 - m) for k, m in zip(key_sorted,
                                                         max_ext)]
    hi = [np.searchsorted(k, band_y0 + 16) for k in key_sorted]
    ranges = tc.band_ranges(tt, key, 60).numpy()
    assert np.array_equal(ranges[..., 0], np.asarray(lo))
    assert np.array_equal(ranges[..., 1], np.asarray(hi))


def test_fill_rules_match_reference():
    x = np.array([-3.7, -2.0, -1.5, -1.0, -0.25, -0.0, 0.0, 0.3, 1.0, 1.5,
                  2.0, 2.5, 5.25], np.float32)
    for rule in (0, 1):
        want = np.asarray(jc.apply_fill_rule(jnp.asarray(x), rule))
        got = tc.apply_fill_rule(torch.from_numpy(x), rule).numpy()
        assert np.array_equal(want, got)
    with pytest.raises(ValueError):
        tc.apply_fill_rule(torch.from_numpy(x), 2)


def test_dispatch_follows_the_reference():
    """``coverage`` takes the banded kernel up to SMEM_EDGE_CAP padded edges
    and the tiled kernel above (2176 = 17 blocks), as the reference's
    dispatcher does; the banded kernel refuses more."""
    rng = np.random.default_rng(9)
    small = torch.from_numpy(random_edges(rng, 1, 100, 2048, 20, 40))
    big = torch.from_numpy(random_edges(rng, 1, 2100, 2176, 20, 40))
    assert torch.equal(tc.coverage(small, 20, 40),
                       tc.coverage_banded(small, 20, 40))
    assert torch.equal(tc.coverage(big, 20, 40),
                       tc.coverage_tiled(big, 20, 40))
    with pytest.raises(ValueError, match="at most 2048"):
        tc.coverage_banded(big, 20, 40)
    with pytest.raises(ValueError, match="multiple of 128"):
        tc.coverage_tiled(big[:, :, :2100], 20, 40)
    launches = (tc.coverage_banded.launches, tc.coverage_tiled.launches)
    assert launches == (0, 0)   # CPU tensors never launch a kernel


def test_numpy_input_needs_a_device():
    t = random_edges(np.random.default_rng(2), 1, 10, 128, 8, 8)
    assert tc.coverage_banded(t, 8, 8, device="cpu").shape == (1, 8, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tc.coverage_banded(t, 8, 8)
