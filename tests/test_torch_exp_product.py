"""The port's ``tools/exp_int8.py``, ``exp_k3.py``, ``exp_lmask.py`` and
``exp_dmamerge.py`` against the reference tools of the same names, on
the CPU.

The reference tools are loaded by path; their Pallas kernels run in
interpret mode through a wrapper of ``pallas_call`` that sets
``interpret=True`` on every call for the test's duration
(``tools/exp_lmask.py:121`` passes ``interpret=False`` itself, which a
``functools.partial`` default would not override; the tools are
unchanged).  Both sides take the same packed arrays (the port's native
grouped packer, group 6) of 2 frames x 40x200 at 1, 2, 4 and 16 layers:
the product forms at one strip a plane, exp_dmamerge at the scene's own
strips per plane (5); and exp_dmamerge's ``tiny`` config (8 strips a
plane) under the even-odd and a mixed rule.

Tolerance: byte-equal words on the visited strips [:, :NS] at 1, 2 and
4 layers; at 16 layers within B1's pinned envelope (ROADMAP.md queue C,
order of the winding sums: premultiplied bytes 1 level, straight bytes
5 levels on a share under 1e-4) — measured byte-equal at every layer
count for every tool, int8 included (its plain version sums the
quantized values exactly, as the reference's integer accumulator and
f32 ladder of exact multiples of 2^-20 do).  ``limbs_of`` and the bf16
split are bit-equal to the reference's.
"""

import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from swf_renderer_tpu_torch.tools import (
    exp_dmamerge, exp_int8, exp_k3, exp_lmask, exp_split,
)
from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

REPO = pathlib.Path(__file__).resolve().parent.parent
FRAMES, HEIGHT, WIDTH, GROUP = 2, 40, 200, 6
LAYERS = (1, 2, 4, 16)
SHARE_ENVELOPE = 1e-4


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def ref():
    return {name: _load(name) for name in ("exp_int8", "exp_k3", "exp_lmask",
                                           "exp_dmamerge")}


@pytest.fixture
def interpret(monkeypatch):
    """``pallas_call`` with ``interpret=True`` forced over the caller's
    own keyword."""
    original = pl.pallas_call

    def forced(*args, **kwargs):
        kwargs["interpret"] = True
        return original(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", forced)


@functools.lru_cache(maxsize=None)
def _scene(layers):
    tables, colors = build_scene_edges(FRAMES, layers, HEIGHT, WIDTH,
                                       shapes_per_layer=4, seed=layers + 30)
    return exp_split.pack(tables, HEIGHT, WIDTH, "cpu"), colors


def _args(layers):
    d, colors = _scene(layers)
    port = tuple(d[k] for k in ("sidx", "flags", "lays", "urc", "ucm",
                                "uval")) + (torch.as_tensor(colors),)
    jax_args = tuple(jnp.asarray(t.numpy()) for t in port)
    geo = (FRAMES, layers, d["ns"], d["nc"])
    return port, jax_args, geo, d["ns"]


def _compare(want_u32, got_i32, ns, layers):
    """Straight words byte-equal; at 16 layers within B1's envelope."""
    a = np.asarray(want_u32)[:, :ns].view(np.uint8).astype(np.int32)
    b = got_i32.numpy()[:, :ns].view(np.uint8).astype(np.int32)
    assert b.any()
    d = np.abs(a - b)
    if layers < 16:
        assert d.max() == 0, (int(d.max()), float((d != 0).mean()))
        return
    assert d.max() <= 5 and (d != 0).mean() <= SHARE_ENVELOPE
    pa, pb = (np.concatenate([(x.reshape(-1, 4)[:, :3] * x.reshape(
        -1, 4)[:, 3:] + 127) // 255, x.reshape(-1, 4)[:, 3:]], 1)
        for x in (a, b))
    assert np.abs(pa - pb).max() <= 1


# -- exp_int8 -----------------------------------------------------------------


def _half_quanta(rng):
    """Values at exact half quanta k + 1/2 of 2^-20 (np.round's ties),
    both signs, small and near the +-4 range."""
    k = np.concatenate([np.arange(-8, 8), rng.integers(-(4 << 20),
                                                       4 << 20, 64)])
    return ((k + 0.5) / (1 << exp_int8.S)).astype(np.float32)


def test_limbs_of_is_bit_equal_to_reference(ref):
    rng = np.random.default_rng(5)
    vals = np.concatenate([
        rng.standard_normal(4096).astype(np.float32),
        rng.uniform(-4, 4, 4096).astype(np.float32),
        np.array([4.0, -4.0, 0.0, -0.0, 1e-7, -3e-7], np.float32),
        _half_quanta(rng)]).reshape(2, 1, -1)
    want = ref["exp_int8"].limbs_of(vals)
    got = exp_int8.limbs_of(vals)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        assert np.array_equal(w.view(np.uint8), g.view(np.uint8))
    q = np.round(vals.astype(np.float64) * (1 << exp_int8.S))
    assert np.array_equal(got[3] * (1 << exp_int8.S), q)
    # Half quanta round to even, as np.round.
    half = _half_quanta(rng).astype(np.float64) * (1 << exp_int8.S)
    assert np.all(np.round(half) % 2 == 0)


def test_limbs_of_refuses_what_the_reference_refuses(ref):
    """A top limb of magnitude 127 or more: the reference asserts, the
    port raises ValueError (|v| >= ~7.97)."""
    vals = np.array([1.0, 8.0], np.float32)
    with pytest.raises(AssertionError):
        ref["exp_int8"].limbs_of(vals)
    with pytest.raises(ValueError, match="range"):
        exp_int8.limbs_of(vals)
    exp_int8.limbs_of(np.array([7.9, -7.9], np.float32))


@pytest.mark.parametrize("layers", LAYERS)
def test_run_int8_matches_reference(ref, interpret, layers):
    port, jax_args, geo, ns = _args(layers)
    l0, l1, l2, _ = exp_int8.limbs_of(port[5].numpy())
    want = ref["exp_int8"].run_int8(*jax_args[:5], *map(jnp.asarray,
                                                        (l0, l1, l2)),
                                    jax_args[6], *geo, GROUP)
    got = exp_int8.run_int8(*port[:5], *map(torch.from_numpy, (l0, l1, l2)),
                            port[6], *geo, GROUP)
    _compare(want, got, ns, 1)   # measured byte-equal at every count
    assert exp_int8.run_int8.launches == 0   # CPU: plain version
    # Against B1 (f32 values): the tool's quantization to 2^-20 flips
    # pixels of near-zero coverage — byte-equal here at 1, 2 and 4
    # layers, 18 straight levels on 1.1e-4 of the bytes at 16 (ROADMAP.md
    # queue C, an intended divergence of the tool itself).
    b1 = exp_split.variant_plain(*port, *geo, GROUP, "full")[:, :ns]
    d = np.abs(got[:, :ns].numpy().view(np.uint8).astype(np.int32)
               - b1.numpy().view(np.uint8).astype(np.int32))
    assert d.max() <= (18 if layers == 16 else 0)
    assert (d != 0).mean() <= 1.1e-4


# -- exp_k3 -------------------------------------------------------------------


def test_split3_is_bit_equal_to_the_jax_split():
    """``split3`` against the reference's split (flatblock.py:263-271,
    exp_k3.py:40-49), jnp on the CPU: the same bf16 bits, and the parts
    sum to the value exactly."""
    rng = np.random.default_rng(9)
    v = np.concatenate([rng.standard_normal(8192), rng.uniform(-4, 4, 8192),
                        rng.standard_normal(512) * 1e-6,
                        [0.0, 1.0, -1.0, 1 / 3, 3.999999]]).astype(np.float32)
    j = jnp.asarray(v)
    hi = j.astype(jnp.bfloat16)
    hi32 = hi.astype(jnp.float32)
    mid = (j - hi32).astype(jnp.bfloat16)
    lo = (j - hi32 - mid.astype(jnp.float32)).astype(jnp.bfloat16)
    got = exp_k3.split3(torch.from_numpy(v))
    for want, part in zip((hi, mid, lo), got):
        assert part.dtype == torch.bfloat16
        assert np.array_equal(np.asarray(want).view(np.uint16),
                              part.view(torch.int16).numpy().view(np.uint16))
    total = sum(p.to(torch.float64) for p in got)
    assert torch.equal(total, torch.from_numpy(v).to(torch.float64))


@pytest.mark.parametrize("k3", [False, True])
@pytest.mark.parametrize("layers", LAYERS)
def test_k3_run_variant_matches_reference(ref, interpret, layers, k3):
    port, jax_args, geo, ns = _args(layers)
    want = ref["exp_k3"].run_variant(*jax_args, *geo, GROUP, k3)
    got = exp_k3.run_variant(*port, *geo, GROUP, k3)
    _compare(want, got, ns, layers)
    assert exp_k3.run_variant.launches == 0


# -- exp_lmask ----------------------------------------------------------------


@pytest.mark.parametrize("layers", LAYERS)
def test_render_lmask_matches_reference(ref, interpret, layers):
    port, jax_args, geo, ns = _args(layers)
    want = ref["exp_lmask"].render_lmask(*jax_args, *geo, group=GROUP)
    got = exp_lmask.render_lmask(*port, *geo, group=GROUP)
    _compare(want, got, ns, layers)
    assert exp_lmask.render_lmask.launches == 0


def test_render_lmask_refuses_planes_over_128_rows():
    """The reference's planes are 128 rows: 17 chunks (2100 px) raise."""
    tables, colors = build_scene_edges(1, 1, 16, 2100, shapes_per_layer=2)
    d = exp_split.pack(tables, 16, 2100, "cpu")
    assert d["nc"] == 17
    with pytest.raises(ValueError, match="128"):
        exp_lmask.render_lmask(*(d[k] for k in ("sidx", "flags", "lays",
                                                "urc", "ucm", "uval")),
                               torch.as_tensor(colors), 1, 1, d["ns"],
                               d["nc"])


# -- exp_dmamerge -------------------------------------------------------------


def _rv_case(layers, height, width):
    tables, colors = build_scene_edges(FRAMES, layers, height, width,
                                       shapes_per_layer=4, seed=layers + 40)
    d, urv, spp = exp_dmamerge.pack_rv(tables, height, width, "cpu")
    port = (d["sidx"], d["flags"], d["lays"], urv, d["ucm"],
            torch.as_tensor(colors))
    return port, tuple(jnp.asarray(t.numpy()) for t in port), d, spp


@pytest.mark.parametrize("layers", LAYERS)
def test_render_rv_matches_reference(ref, interpret, layers):
    port, jax_args, d, spp = _rv_case(layers, HEIGHT, WIDTH)
    assert spp == 5   # 40 rows, 2 chunks: all five strips in a plane
    geo = (FRAMES, layers, d["ns"], d["nc"])
    want = ref["exp_dmamerge"].render_rv(*jax_args, *geo, group=GROUP,
                                         spp=spp)
    got = exp_dmamerge.render_rv(*port, *geo, group=GROUP, spp=spp)
    _compare(want, got, d["ns"], layers)
    assert exp_dmamerge.render_rv.launches == 0


@pytest.mark.parametrize("rule", [1, "mixed"])
def test_render_rv_matches_reference_tiny_under_rules(ref, interpret, rule):
    """exp_dmamerge's ``tiny`` config (2 x 2 x 64x96: 1 chunk, 8 strips,
    spp 8) under even-odd and a mixed rule."""
    frames, layers, height, width = exp_dmamerge.CONFIGS["tiny"]
    tables, colors = build_scene_edges(frames, layers, height, width)
    d, urv, spp = exp_dmamerge.pack_rv(tables, height, width, "cpu")
    assert spp > 1
    rule = (1, 0) if rule == "mixed" else rule
    port = (d["sidx"], d["flags"], d["lays"], urv, d["ucm"],
            torch.as_tensor(colors))
    geo = (frames, layers, d["ns"], d["nc"])
    want = ref["exp_dmamerge"].render_rv(
        *(jnp.asarray(t.numpy()) for t in port), *geo, group=GROUP,
        fill_rule=rule, spp=spp)
    got = exp_dmamerge.render_rv(*port, *geo, group=GROUP, fill_rule=rule,
                                 spp=spp)
    _compare(want, got, d["ns"], layers)


def test_product_forms_refuse_what_the_kernels_refuse():
    """Groups over 8 placement blocks (the kernels' gather), limbs of the
    wrong type, a wrong merged block: ValueError, on the CPU as on the
    card."""
    port, _, geo, _ = _args(4)
    tables, colors = build_scene_edges(FRAMES, 4, HEIGHT, WIDTH,
                                       shapes_per_layer=4, seed=34)
    d9 = exp_split.pack(tables, HEIGHT, WIDTH, "cpu", group=9)
    big = tuple(d9[k] for k in ("sidx", "flags", "lays", "urc", "ucm",
                                "uval")) + (port[6],)
    with pytest.raises(ValueError, match="group 9"):
        exp_k3.run_variant(*big, *geo[:2], d9["ns"], d9["nc"], 9, True)
    with pytest.raises(ValueError, match="group 9"):
        exp_lmask.render_lmask(*big, *geo[:2], d9["ns"], d9["nc"], group=9)
    limbs = [torch.zeros_like(port[5], dtype=torch.int8) for _ in range(3)]
    with pytest.raises(ValueError, match="l1"):
        exp_int8.run_int8(*port[:5], limbs[0], port[5], limbs[2], port[6],
                          *geo, GROUP)
    with pytest.raises(ValueError, match="urv"):
        exp_dmamerge.render_rv(*port[:3], port[3], port[4], port[6], *geo)
