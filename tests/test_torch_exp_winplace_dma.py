"""The port's ``tools/exp_winplace.py`` and ``exp_dma.py`` against the
reference tools of the same names, on the CPU.

The reference tools are loaded by path; their Pallas kernels run in
interpret mode through a wrapper of ``pallas_call`` that sets
``interpret=True`` on every call for the test's duration (the reference
``exp_dma.run_variant`` passes no ``interpret`` of its own; the tools
are unchanged).  Both sides take the same inputs: the windowed packer
on the port's update lists of 2 frames x 40x200 (5 strips a plane) and
of the reference's ``tiny`` config (64x96, 8 strips a plane) at 1, 2, 4
and 16 layers (``build_scene_edges``, seeded); the coarse steps on the
port's native grouped packing of the 40x200 scene at one strip a plane.

Tolerance: ``pack_windowed`` byte-equal, every array and count; words
byte-equal on the visited strips [:, :NS] at 1, 2 and 4 layers; at 16
layers within B1's pinned envelope (ROADMAP.md queue C, order of the
winding sums: premultiplied bytes 1 level, straight bytes 5 levels on a
share under 1e-4; ``test_torch_exp_product._compare``).
"""

import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from swf_renderer_tpu_torch.ops import flatblock as fb
from swf_renderer_tpu_torch.ops.pipeline import lower_update_lists
from swf_renderer_tpu_torch.tools import exp_dma, exp_split, exp_winplace
from swf_renderer_tpu_torch.utils.scenes import build_scene_edges
from tests.test_torch_exp_product import _compare

REPO = pathlib.Path(__file__).resolve().parent.parent
FRAMES, GROUP = 2, 6
LAYERS = (1, 2, 4, 16)
SCENES = {"40x200": (40, 200), "tiny": exp_winplace.CONFIGS["tiny"][2:]}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def ref():
    return {name: _load(name) for name in ("exp_winplace", "exp_dma")}


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
def _scene(scene, layers):
    height, width = SCENES[scene]
    tables, colors = build_scene_edges(FRAMES, layers, height, width,
                                       shapes_per_layer=4, seed=layers + 60)
    return tables, colors, lower_update_lists(tables, height, width)


def _spp(height, width):
    _, nc, ns = fb.plane_geometry(height, width)
    return fb.strips_per_plane(nc, ns)


# -- exp_winplace --------------------------------------------------------------


@pytest.mark.parametrize("layers", LAYERS)
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_pack_windowed_is_byte_equal_to_reference(ref, scene, layers):
    height, width = SCENES[scene]
    _, _, ul = _scene(scene, layers)
    spp = _spp(height, width)
    assert spp == (5 if scene == "40x200" else 8)
    want = ref["exp_winplace"].pack_windowed(ul, height, width, GROUP, spp)
    got = exp_winplace.pack_windowed(ul, height, width, GROUP, spp)
    assert len(got) == len(want) == 10
    for w, g in zip(want[:7], got[:7]):
        assert w.dtype == g.dtype and w.shape == g.shape
        assert np.array_equal(w.view(np.uint8), g.view(np.uint8))
    assert tuple(got[7:]) == tuple(want[7:])
    assert got[0].shape[0] % 256 == 0 and got[9] <= got[0].shape[0]
    # Windows 0 .. spp - 1, local row ids inside one strip window.
    assert got[3].max() == spp - 1
    assert got[4].max() < got[8] * 8


def _win_case(scene, layers):
    height, width = SCENES[scene]
    tables, colors, _ = _scene(scene, layers)
    d, spp = exp_winplace.pack(tables, height, width, "cpu")
    port = tuple(d[k] for k in ("sidx", "flags", "lays", "wins", "urc", "ucm",
                                "uval")) + (torch.as_tensor(colors),)
    return port, d, spp


@pytest.mark.parametrize("layers", LAYERS)
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_render_win_matches_reference(ref, interpret, scene, layers):
    port, d, spp = _win_case(scene, layers)
    ns, nc = d["ns"], d["nc"]
    geo = (FRAMES, layers, ns, nc)
    rule = 1 if scene == "tiny" else 0
    want = ref["exp_winplace"].render_win(
        *(jnp.asarray(t.numpy()) for t in port), *geo, group=GROUP,
        fill_rule=rule, spp=spp, win_rows=nc * 8)
    got = exp_winplace.render_win(*port, *geo, group=GROUP, fill_rule=rule,
                                  spp=spp)
    _compare(want, got, ns, layers)
    assert exp_winplace.render_win.launches == 0   # CPU: plain version


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_render_win_equals_b1_on_the_pooled_packing(scene):
    """The windowed words equal B1's plain version on the grouped
    packer's arrays of the same scene and strips per plane, under a
    mixed rule."""
    height, width = SCENES[scene]
    port, d, spp = _win_case(scene, 4)
    tables = _scene(scene, 4)[0]
    base = exp_split.pack(tables, height, width, "cpu", spp=spp)
    geo = (FRAMES, 4, d["ns"], d["nc"])
    rule = (0, 1, 1, 0)
    got = exp_winplace.render_win(*port, *geo, fill_rule=rule, spp=spp)
    b1 = fb.fusedn_plain(*(base[k] for k in ("sidx", "flags", "lays", "urc",
                                             "ucm", "uval")), port[7], *geo,
                         fill_rule=rule, spp=spp)
    assert torch.equal(got[:, :d["ns"]], b1[:, :d["ns"]])
    assert int(base["sidx"].shape[0]) <= int(d["sidx"].shape[0])


def test_render_win_refuses_windows_other_than_a_strip():
    """``win_rows`` must be None or n_chunks * 8: the reference's default
    of 128 places wrongly at 5 strips a plane of 16 rows each (ValueError
    here); None and 16 give the same words."""
    port, d, spp = _win_case("40x200", 1)
    geo = (FRAMES, 1, d["ns"], d["nc"])
    assert d["nc"] * 8 == 16 and spp == 5
    for bad in (128, 8, 24):
        with pytest.raises(ValueError, match="win_rows"):
            exp_winplace.render_win(*port, *geo, spp=spp, win_rows=bad)
    assert torch.equal(
        exp_winplace.render_win(*port, *geo, spp=spp, win_rows=16),
        exp_winplace.render_win(*port, *geo, spp=spp))
    with pytest.raises(ValueError, match="wins"):
        exp_winplace.render_win(*port[:3], port[3].long(), *port[4:], *geo,
                                spp=spp)


# -- exp_dma ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dma_case(layers):
    tables, colors, _ = _scene("40x200", layers)
    d = exp_split.pack(tables, 40, 200, "cpu")
    port = tuple(d[k] for k in ("sidx", "flags", "lays", "urc", "ucm",
                                "uval")) + (torch.as_tensor(colors),)
    return port, (FRAMES, layers, d["ns"], d["nc"])


@pytest.mark.parametrize("coarse", exp_dma.COARSES)
@pytest.mark.parametrize("layers", LAYERS)
def test_dma_run_variant_matches_reference(ref, interpret, layers, coarse):
    port, geo = _dma_case(layers)
    want = ref["exp_dma"].run_variant(
        *(jnp.asarray(t.numpy()) for t in port), *geo, GROUP, coarse)
    got = exp_dma.run_variant(*port, *geo, GROUP, coarse)
    _compare(want, got, geo[2], layers)
    assert exp_dma.run_variant.launches == 0   # CPU: plain version


def test_dma_refuses_what_the_reference_refuses(ref, interpret):
    """A ``coarse`` that does not divide the groups (the reference
    asserts) and arrays packed at more than one strip a plane (row ids
    past the strip): ValueError."""
    port, geo = _dma_case(1)
    ng = int(port[0].shape[0])
    assert ng % 3
    with pytest.raises(AssertionError):
        ref["exp_dma"].run_variant(*(jnp.asarray(t.numpy()) for t in port),
                                   *geo, GROUP, 3)
    for coarse in (3, 0):
        with pytest.raises(ValueError, match="coarse"):
            exp_dma.run_variant(*port, *geo, GROUP, coarse)
    tables, colors, _ = _scene("40x200", 1)
    d = exp_split.pack(tables, 40, 200, "cpu", spp=5)
    wide = tuple(d[k] for k in ("sidx", "flags", "lays", "urc", "ucm",
                                "uval")) + (torch.as_tensor(colors),)
    assert int(d["urc"].max()) >= d["nc"] * 8
    with pytest.raises(ValueError, match="one strip a plane"):
        exp_dma.run_variant(*wide, FRAMES, 1, d["ns"], d["nc"], GROUP, 1)
    want = exp_dma.dma_plain(*port, *geo, GROUP)
    assert torch.equal(exp_dma.run_variant(*port, *geo, GROUP, 4), want)
