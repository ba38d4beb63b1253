"""The port's ``tools/exp_split.py`` variants against the reference tool's
functions of the same names, on the CPU.

The reference tool (``tools/exp_split.py``) is loaded by path; its Pallas
kernels run in interpret mode through ``pallas_call`` wrapped for the
test's duration (the tool itself is unchanged).  Both sides take the
same packed arrays (the port's native grouped packer, one strip a plane,
group 6) of 2 frames x 40x200 at 1, 2 and 4 layers and of a 16-layer
scene.  Tolerance: byte-equal words on the visited strips [:, :NS];
the 16-layer words within B1's pinned envelope (ROADMAP.md queue C,
order of the winding sums: premultiplied bytes 1 level, straight bytes 5
levels on a share under 1e-4).  The ablated variants write zero words on
both sides.
"""

import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from swf_renderer_tpu_torch.tools import exp_split
from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

REPO = pathlib.Path(__file__).resolve().parent.parent
FRAMES, HEIGHT, WIDTH, GROUP = 2, 40, 200, 6
LAYERS = (1, 2, 4, 16)
SHARE_ENVELOPE = 1e-4


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location(
        "reference_exp_split", REPO / "tools" / "exp_split.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


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
    d = np.abs(a - b)
    if layers < 16:
        assert d.max() == 0, (int(d.max()), float((d != 0).mean()))
        return
    assert d.max() <= 5 and (d != 0).mean() <= SHARE_ENVELOPE
    pa, pb = (np.concatenate([(x.reshape(-1, 4)[:, :3] * x.reshape(
        -1, 4)[:, 3:] + 127) // 255, x.reshape(-1, 4)[:, 3:]], 1)
        for x in (a, b))
    assert np.abs(pa - pb).max() <= 1


@pytest.mark.parametrize("mode", exp_split.MODES)
@pytest.mark.parametrize("layers", LAYERS)
def test_run_variant_matches_reference(ref, interpret, layers, mode):
    port, jax_args, geo, ns = _args(layers)
    want = ref.run_variant(*jax_args, *geo, GROUP, mode)
    got = exp_split.run_variant(*port, *geo, GROUP, mode)
    _compare(want, got, ns, layers)
    assert bool(got[:, :ns].any()) == (mode == "full")
    assert exp_split.run_variant.launches == 0   # CPU: plain version


@pytest.mark.parametrize("layers", LAYERS)
def test_run_none0_matches_reference(ref, interpret, layers):
    port, jax_args, geo, ns = _args(layers)
    want = ref.run_none0(jax_args[0], jax_args[1], jax_args[6], *geo)
    got = exp_split.run_none0(port[0], port[1], port[6], *geo)
    _compare(want, got, ns, layers)
    assert not got.any()


@pytest.mark.parametrize("kk", [1, 2, 4])
@pytest.mark.parametrize("layers", LAYERS)
def test_run_batched_in_matches_reference(ref, interpret, layers, kk):
    port, jax_args, geo, ns = _args(layers)
    want = ref.run_batched_in(*jax_args, *geo, GROUP, kk)
    got = exp_split.run_batched_in(*port, *geo, GROUP, kk)
    _compare(want, got, ns, layers)


@pytest.mark.parametrize("layers", LAYERS)
def test_run_merged_matches_reference(ref, interpret, layers):
    port, jax_args, geo, ns = _args(layers)
    urcval = jnp.concatenate([jax_args[3], jax_args[5]], axis=2)
    want = ref.run_merged(*jax_args[:3], urcval, jax_args[4], jax_args[6],
                          *geo, GROUP)
    got = exp_split.run_merged(
        *port[:3], torch.cat([port[3], port[5]], dim=2), port[4], port[6],
        *geo, GROUP)
    _compare(want, got, ns, layers)


def test_variants_refuse_what_the_reference_refuses():
    """Modes outside the four, kk not dividing the groups, a batched block
    over 227 KB of shared memory (16 layers, group 6, kk 32: 362 KB), a
    wrong merged array: ValueError, on the CPU as on the card."""
    port, _, geo, _ = _args(16)
    with pytest.raises(ValueError, match="mode"):
        exp_split.run_variant(*port, *geo, GROUP, "resolve_only")
    ng = port[0].shape[0]
    with pytest.raises(ValueError, match="divide"):
        exp_split.run_batched_in(*port, *geo, GROUP, 3 if ng % 3 else 7)
    assert exp_split.batched_smem_bytes(16, GROUP, 16) <= exp_split.SMEM_MAX
    assert exp_split.batched_smem_bytes(16, GROUP, 32) > exp_split.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        exp_split.run_batched_in(*port, *geo, GROUP, 32)
    with pytest.raises(ValueError, match="urcval"):
        exp_split.run_merged(*port[:3], port[3], port[4], port[6], *geo,
                             GROUP)
    assert sorted(exp_split.variants(*_scene(16)[:1], port[6], FRAMES, 16)) \
        == sorted(list(exp_split.MODES) + ["none0", "batched4", "batched8",
                                           "batched16", "merged"])
