"""Grouped coverage (B11) in the port (ops/coverage.py coverage_grouped,
grouped_plain) against the JAX package's ``coverage_grouped`` (Pallas,
interpret mode) on the CPU, and against the port's other two coverage
formulations.

Tolerance 1e-5 of coverage, as for B9/B10 (tests/test_torch_coverage.py):
the reference reduces each 8-edge group in its own order and XLA:CPU
contracts ``x0 + t * dx`` into an FMA; the port sums ``((c0 + c1) + (c2 +
c3)) + ((c4 + c5) + (c6 + c7))`` op by op.  Where a pixel lies far right
of a near-horizontal edge, the ramp takes the difference of two clamp
integrals near the pixel's distance (~200 here), so the contraction's
one-ulp move of ``x`` moves coverage by one ulp of 200 (1.5e-5): pinned
per case at its measured envelope (ROADMAP.md queue C); with the
contraction emulated the port agrees to 1.2e-7.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swf_renderer_tpu.ops import coverage as jcov
from swf_renderer_tpu_torch.ops import coverage as tcov
from swf_renderer_tpu_torch.utils.scenes import closed_edge_planes

COV_TOL = 1e-5


@pytest.mark.parametrize("planes,height,width,n,e_pad,rule,fma,share", [
    (1, 37, 300, 100, 128, 0, 1.6e-5, 2e-4),   # nonzero, ragged tiles
    (2, 37, 300, 100, 128, 1, COV_TOL, 0.0),   # even-odd
    (4, 100, 150, 500, 512, 0, COV_TOL, 0.0),  # several planes, 4 blocks
    (3, 64, 260, 250, 384, 1, COV_TOL, 0.0),
], ids=["nonzero", "evenodd", "planes-nonzero", "planes-evenodd"])
def test_grouped_plain_matches_jax_kernel(planes, height, width, n, e_pad,
                                          rule, fma, share):
    rng = np.random.default_rng(n + e_pad + rule)
    t = closed_edge_planes(rng, planes, n, e_pad, height, width)
    want = np.asarray(jcov.coverage_grouped(jnp.asarray(t), height, width,
                                            rule, interpret=True))
    got = tcov.coverage_grouped(torch.as_tensor(t), height, width, rule)
    assert got.shape == (planes, height, width) and got.dtype == torch.float32
    diff = np.abs(got.numpy() - want)
    assert diff.max() <= fma and (diff > COV_TOL).mean() <= share
    assert float(got.std()) > 0.1
    # The three formulations compute one function.
    tiled = tcov.coverage_tiled(torch.as_tensor(t), height, width, rule)
    assert float((got - tiled).abs().max()) <= COV_TOL
    if e_pad <= tcov.SMEM_EDGE_CAP:
        banded = tcov.coverage_banded(torch.as_tensor(t), height, width,
                                      rule)
        assert float((got - banded).abs().max()) <= COV_TOL


def test_grouped_divergence_is_the_fma_contraction(monkeypatch):
    """The nonzero case's 1.53e-5: with ``x0 + t * dx`` fused (the f64
    product and sum rounded once to f32, as XLA:CPU's FMA) the port's
    grouped coverage meets the reference's within 2e-7."""
    def fused_terms(edges, py):
        x0, y0, x1, y1 = edges
        dyd = y1 - y0
        safe = torch.where(torch.abs(dyd) < 1e-9, torch.ones_like(dyd), dyd)
        inv_dyd = tcov.true_div(1.0, safe)
        dx = (x1 - x0).double()
        sy0 = y0 - py
        cy0 = torch.clamp(sy0, 0.0, 1.0)
        cy1 = torch.clamp(y1 - py, 0.0, 1.0)
        xa = (x0.double() + ((cy0 - sy0) * inv_dyd).double() * dx).float()
        xb = (x0.double() + ((cy1 - sy0) * inv_dyd).double() * dx).float()
        xmn, xmx = torch.minimum(xa, xb), torch.maximum(xa, xb)
        span = xmx - xmn
        return cy1 - cy0, xmn, xmx, span, tcov.true_div(
            1.0, torch.where(span < 1e-9, torch.ones_like(span), span))

    rng = np.random.default_rng(228)       # the nonzero case's scene
    t = closed_edge_planes(rng, 1, 100, 128, 37, 300)
    want = np.asarray(jcov.coverage_grouped(jnp.asarray(t), 37, 300, 0,
                                            interpret=True))
    monkeypatch.setattr(tcov, "grouped_row_terms", fused_terms)
    got = tcov.coverage_grouped(torch.as_tensor(t), 37, 300, 0).numpy()
    assert np.abs(got - want).max() <= 2e-7


def test_grouped_plain_sums_groups_in_order():
    """A strip's sum is the block partials in block order, each partial the
    16 group sums in group order: equal to the same sums written out."""
    rng = np.random.default_rng(5)
    t = torch.as_tensor(closed_edge_planes(rng, 1, 200, 256, 16, 128))
    es, key, pad = tcov.sort_edges(t)
    bounds = tcov.block_bounds(es, key, pad)
    got = tcov.grouped_plain(es, bounds, 16, 128, 0)
    px = torch.arange(128, dtype=torch.float32)
    acc = torch.zeros((16, 128))
    for blk in range(2):
        edges = es[0, :, blk * 128:(blk + 1) * 128, None, None]
        for r0 in (0, 8):
            if not (bounds[0, blk, 1] > r0 and bounds[0, blk, 0] < r0 + 8):
                continue
            py = torch.arange(r0, r0 + 8, dtype=torch.float32)[:, None]
            c = tcov.grouped_contribution(*tcov.grouped_row_terms(edges, py),
                                          px)
            part = torch.zeros((8, 128))
            for g in range(16):
                e = c[8 * g:8 * g + 8]
                part = part + (((e[0] + e[1]) + (e[2] + e[3]))
                               + ((e[4] + e[5]) + (e[6] + e[7])))
            acc[r0:r0 + 8] = acc[r0:r0 + 8] + part
    assert torch.equal(got[0], tcov.apply_fill_rule(acc, 0))


def test_coverage_grouped_validates_and_places_its_inputs():
    rng = np.random.default_rng(9)
    t = closed_edge_planes(rng, 1, 100, 128, 20, 40)
    with pytest.raises(ValueError, match="not a multiple of 128"):
        tcov.coverage_grouped(torch.as_tensor(t[..., :100]), 20, 40)
    with pytest.raises(ValueError, match="unknown fill rule"):
        tcov.coverage_grouped(torch.as_tensor(t), 20, 40, 2)
    # numpy input goes to the asked device; a 2-D table is one plane.
    got = tcov.coverage_grouped(t[0], 20, 40, device="cpu")
    assert got.shape == (1, 20, 40)
    assert torch.equal(got, tcov.coverage_grouped(torch.as_tensor(t), 20, 40))
    # Neither the plain version nor a count for tensors it cannot launch.
    with pytest.raises(ValueError, match="unsupported device"):
        tcov.coverage_grouped(torch.as_tensor(t).to("meta"), 20, 40)
    assert tcov.coverage_grouped.launches == 0
