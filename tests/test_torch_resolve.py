"""The scanline resolve of the port (ops/resolve.py) against the JAX
package, on the CPU.

``resolve_plain`` (the resolve kernel's arithmetic) keeps the reference
kernel's prefix order — a Hillis-Steele ladder per 128-column chunk, then
the running carry — and so equals ``resolve_frames`` in interpret mode
bit for bit wherever XLA cannot contract: one layer over a transparent
frame (``c * ca + 0 * keep``).  From the second layer on XLA:CPU fuses
``c * ca + acc * keep`` into an FMA and the port does not: premultiplied
planes within 2.4e-7 (measured 1.2e-7), frames within one level.

The reference resolves a per-layer rule tuple as even-odd for EVERY
layer (``_resolve_kernel`` tests ``fill_rule == NONZERO`` on the tuple);
the port reads one rule per layer, as the fused kernels do (ROADMAP.md
queue C): ``test_mixed_rules_resolve_per_layer`` shows both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swf_renderer_tpu.ops import pipeline as jpl
from swf_renderer_tpu.ops import resolve as jr
from swf_renderer_tpu.ops import scanline as js
from swf_renderer_tpu_torch.ops import pipeline as tpl
from swf_renderer_tpu_torch.ops import resolve as tr
from tests.test_torch_coverage import random_edges


def planes(seed, f, l, h, s):
    rng = np.random.default_rng(seed)
    d = rng.normal(0, 0.4, (f, l, h, s)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.6] = 0.0
    c = rng.uniform(0, 1, (f, l, 4)).astype(np.float32)
    c[0, 0, 3] = 0.0
    c[-1, -1, 3] = 1.0
    return d, c


@pytest.mark.parametrize("rule", [0, 1])
def test_one_layer_equals_reference_bit_for_bit(rule):
    """L = 1, three chunks: the ladder and the carry reproduce the
    reference's f32 order exactly."""
    d, c = planes(1, 2, 1, 16, 384)
    want = np.asarray(jr.resolve_frames(jnp.asarray(d), jnp.asarray(c), rule,
                                        interpret=True))
    got = tr.resolve_frames(torch.from_numpy(d), torch.from_numpy(c), rule)
    assert got.shape == (2, 4, 16, 384)
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("layers,rule", [(4, 0), (4, 1), (16, 1)])
def test_layers_match_reference(layers, rule):
    d, c = planes(layers, 1, layers, 8, 256)
    want = np.asarray(jr.resolve_frames(jnp.asarray(d), jnp.asarray(c), rule,
                                        interpret=True))
    got = tr.resolve_frames(torch.from_numpy(d), torch.from_numpy(c), rule)
    assert np.abs(want - got.numpy()).max() <= 2.4e-7


def test_lane_prefix_is_the_ladder():
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (5, 128)).astype(np.float32))
    got = tr.lane_prefix(x)
    assert torch.allclose(got, torch.cumsum(x, dim=-1), atol=1e-5)
    want = x.clone()
    for s in tr.LADDER:   # the reference's roll-and-mask form
        rolled = torch.roll(want, s, dims=-1)
        lanes = torch.arange(128)
        want = want + torch.where(lanes >= s, rolled, torch.zeros(()))
    assert torch.equal(got, want)


def test_resolve_frame_matches_reference():
    rng = np.random.default_rng(7)
    area = rng.normal(0, 0.3, (2, 8, 256)).astype(np.float32)
    cover = rng.normal(0, 0.3, (2, 8, 256)).astype(np.float32)
    colors = rng.uniform(0, 1, (2, 4)).astype(np.float32)
    want = np.asarray(jr.resolve_frame(jnp.asarray(area), jnp.asarray(cover),
                                       jnp.asarray(colors), 1,
                                       interpret=True))
    got = tr.resolve_frame(torch.from_numpy(area), torch.from_numpy(cover),
                           torch.from_numpy(colors), 1)
    assert np.abs(want - got.numpy()).max() <= 2.4e-7


def test_bad_planes_raise():
    d, c = planes(2, 1, 1, 8, 200)
    with pytest.raises(ValueError, match="multiple"):
        tr.resolve_frames(torch.from_numpy(d), torch.from_numpy(c))
    d, c = planes(2, 1, 1, 8, 256)
    with pytest.raises(ValueError, match="colors"):
        tr.resolve_frames(torch.from_numpy(d), torch.from_numpy(c[:, :, :3]))


def _tables(frames, layers, height, width, seed):
    return [[p[:, np.any(p != 0, axis=0)].T.copy()
             for p in random_edges(np.random.default_rng(seed + f), layers,
                                   40, 128, height, width)]
            for f in range(frames)]


def _levels(want, got):
    a, b = want.astype(np.int32), got.astype(np.int32)

    def premul(x):
        return np.concatenate(
            [(x[..., :3] * x[..., 3:] + 127) // 255, x[..., 3:]], -1)

    return int(np.abs(a - b).max()), int(np.abs(premul(a) - premul(b)).max())


@pytest.mark.parametrize("rule", [0, 1])
def test_render_scanline_updates_matches_reference(rule):
    height, width = 20, 300
    tabs = _tables(3, 2, height, width, 11)
    colors = np.random.default_rng(2).uniform(0.1, 1, (3, 2, 4)).astype(
        np.float32)
    flat = [u for per in tpl.lower_update_lists(tabs, height, width)
            for u in per]
    jflat = [u for per in jpl.lower_update_lists(tabs, height, width)
             for u in per]
    packed = tr.pack_updates(flat)
    for a, b in zip(packed, jr.pack_updates(jflat)):
        assert np.array_equal(a, b)
    arrs = [x.reshape(3, 2, -1) for x in packed]
    want = np.asarray(jr.render_scanline_updates(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(colors), height, width,
        rule, interpret=True))
    got = tr.render_scanline_updates(*arrs, colors, height, width, rule,
                                     device="cpu")
    assert got.shape == (3, height, width, 4) and got.dtype == np.uint8
    assert _levels(want, got)[1] <= 1


def test_render_scanline_fused_matches_reference():
    height, width = 20, 300
    tabs = _tables(2, 2, height, width, 21)
    packed = [js.lower_draws_to_cells(per, height, width) for per in tabs]
    n = max(p[0].shape[1] for p in packed)
    arrs = [np.stack([np.pad(p[k], ((0, 0), (0, n - p[k].shape[1])))
                      for p in packed]) for k in range(4)]
    colors = np.random.default_rng(5).uniform(0.1, 1, (2, 2, 4)).astype(
        np.float32)
    want = np.asarray(jr.render_scanline_fused(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(colors), height, width,
        0, interpret=True))
    got = tr.render_scanline_fused(*arrs, colors, height, width, 0,
                                   device="cpu")
    assert _levels(want, got)[1] <= 1
    assert got[..., 3].max() > 0


def test_mixed_rules_resolve_per_layer():
    """A tuple of rules: the reference resolves every layer even-odd (its
    output equals the all-even-odd one); the port resolves layer by layer
    and matches the reference's scanline pipeline, which honours the
    tuple."""
    height, width = 16, 256
    tabs = _tables(1, 2, height, width, 31)
    colors = np.array([[[0.9, 0.2, 0.1, 0.8], [0.1, 0.3, 0.9, 0.7]]],
                      np.float32)
    flat = [u for per in tpl.lower_update_lists(tabs, height, width)
            for u in per]
    arrs = [x.reshape(1, 2, -1) for x in tr.pack_updates(flat)]

    def ref(rule):
        return np.asarray(jr.render_scanline_updates(
            *(jnp.asarray(a) for a in arrs), jnp.asarray(colors), height,
            width, rule, interpret=True))

    assert np.array_equal(ref((0, 1)), ref(1))
    assert not np.array_equal(ref(0), ref(1))
    got = tr.render_scanline_updates(*arrs, colors, height, width, (0, 1),
                                     device="cpu")
    packed = js.lower_draws_to_cells(tabs[0], height, width)
    honours = np.asarray(js.render_scanline_batch(
        *(jnp.asarray(x[None]) for x in packed), jnp.asarray(colors),
        height, width, (0, 1)))
    assert _levels(honours, got)[1] <= 1
    assert not np.array_equal(got, ref(1))
