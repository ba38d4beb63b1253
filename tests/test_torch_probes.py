"""The port's probe tools (``tools/exp_bw.py``, ``tools/exp_scatter.py``)
against restatements of the reference's functions, on the CPU.

The reference's probe kernels are closures inside ``main()`` and
``exp_D()`` (``passthrough.<locals>.kernel``: ``x + 1.0``; ``kernel4``:
the sum over L; ``exp_D.<locals>.kernel``: ``x + 1.0``), which cannot be
called alone, so their bodies are restated here in numpy.  The plain
versions of the port's probes (what the wrappers run on the CPU) are
held to them: equal for ``x + 1`` and the left-to-right sum over L,
within 1e-6 of numpy's own sum.  Experiment A/B's scatter is held to
``jax.ops.segment_sum`` (within 1e-6: the sum order) and E's three-pass
bf16 product to a ``jnp`` restatement of the reference's ``dot_3``
(within 1e-6 relative to the products' scale: f32 sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swf_renderer_tpu_torch.tools import exp_bw, exp_scatter

SHAPE = (2, 4, 3, 128, 128)   # F, L, NS (the reference's layout "lns")


def _planes(seed=0):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(
        np.float32)


@pytest.mark.parametrize("layout", exp_bw.LAYOUTS)
def test_passthrough_plain_is_the_reference_body(layout):
    x = _planes()
    if layout == "nsl":
        x = np.ascontiguousarray(np.moveaxis(x, 1, 2))
    got = exp_bw.passthrough(torch.from_numpy(x), layout)
    assert torch.equal(got, torch.from_numpy(x + np.float32(1.0)))
    assert exp_bw.passthrough.launches == 0   # CPU: plain version


def test_read_sum_plain_is_the_reference_body():
    x_t = np.ascontiguousarray(np.moveaxis(_planes(1), 1, 2))  # (F, NS, L)
    got = exp_bw.read_sum(torch.from_numpy(x_t))
    acc = x_t[:, :, 0].copy()
    for lyr in range(1, x_t.shape[2]):
        acc = acc + x_t[:, :, lyr]
    assert got.shape == (2, 3, 128, 128)
    assert torch.equal(got, torch.from_numpy(acc))
    np.testing.assert_allclose(got.numpy(), x_t.sum(axis=2), rtol=0,
                               atol=1e-6)
    assert exp_bw.read_sum.launches == 0


def test_step_probe_plain_is_the_reference_body():
    x = np.random.default_rng(2).standard_normal((64, 8, 128)).astype(
        np.float32)
    got = exp_scatter.step_probe(torch.from_numpy(x))
    assert torch.equal(got, torch.from_numpy(x + np.float32(1.0)))
    assert exp_scatter.step_probe.launches == 0


def test_probe_geometry_covers_each_layout_once():
    """Every float of the array lies in exactly one (f, s, l) tile of the
    kernels' grid, in either layout."""
    for layout, shape in (("lns", SHAPE), ("nsl", (2, 3, 4, 128, 128)),
                          ("nsl", (1, 64, 1, 8, 128))):
        n_f, n_s, n_l, tile, sf, ss, sl = exp_bw.geometry(shape, layout)
        starts = np.array([f * sf + s * ss + lyr * sl for f in range(n_f)
                           for s in range(n_s) for lyr in range(n_l)])
        assert n_f * n_s * n_l * tile == int(np.prod(shape))
        assert sorted(starts.tolist()) == list(range(0, int(np.prod(shape)),
                                                     tile))


def test_probes_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="layout"):
        exp_bw.passthrough(torch.zeros(SHAPE), "sln")
    with pytest.raises(ValueError, match="float32"):
        exp_bw.read_sum(torch.zeros(SHAPE, dtype=torch.float64))
    with pytest.raises(ValueError, match="16-byte"):
        exp_bw.read_sum(torch.zeros((1, 2, 3, 3, 3)))
    with pytest.raises(ValueError, match=r"\(steps, 8, 128\)"):
        exp_scatter.step_probe(torch.zeros((4, 16, 128)))


@pytest.mark.parametrize("unique", [False, True])
def test_segment_sum_matches_jax(unique):
    """Experiment A (sorted indices, with repeats) and B (unique indices)
    on 4096 seeded updates into 20,000 segments."""
    rng = np.random.default_rng(5)
    n, segments = 4096, 20000
    if unique:
        idx = np.sort(rng.choice(segments, n, replace=False))
    else:
        idx = np.sort(rng.integers(0, segments, n))
    vals = rng.standard_normal(n).astype(np.float32)
    want = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(idx, jnp.int32),
                               num_segments=segments,
                               indices_are_sorted=True,
                               unique_indices=unique)
    got = exp_scatter.segment_sum(torch.from_numpy(vals),
                                  torch.from_numpy(idx).long(), segments,
                                  unique)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert unique or len(np.unique(idx)) < n   # A really repeats indices


def _dot_3_jax(a1, p1):
    """The reference's ``dot_3`` (tools/exp_scatter.py, exp_E), restated."""
    hi = a1.astype(jnp.bfloat16)
    mid = (a1 - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    lo = (a1 - hi.astype(jnp.float32) - mid.astype(jnp.float32)).astype(
        jnp.bfloat16)
    pb = p1.astype(jnp.bfloat16)

    def d(x):
        return jax.lax.dot_general(x, pb, (((2,), (2,)), ((0,), (0,))),
                                   preferred_element_type=jnp.float32)
    return d(hi) + d(mid) + d(lo)


def test_dot_3_matches_the_reference_split():
    """E's three bf16 products (f32 accumulation) on 64 bins, against the
    reference's split and against the f32 product."""
    a, p = exp_scatter.one_hot_inputs("cpu", bins=64)
    want = np.asarray(_dot_3_jax(jnp.asarray(a.numpy()),
                                 jnp.asarray(p.numpy())))
    got = exp_scatter.dot_3(a, p).numpy()
    scale = np.abs(a.numpy()).sum(-1).max()
    assert got.dtype == np.float32 and got.shape == (64, 8, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(got, exp_scatter.dot_h(a, p).numpy(), rtol=0,
                               atol=1e-6 * scale)
