"""The styled grouped kernel (B2) as redesigned for the H100, run on the
CPU under the g++ emulation of ``tests/test_torch_kernel_emulated.py``
against the unchanged plain version ``fused_styled_plain``.

``csrc/flatblock_device.cuh`` ``fused_block<true, kChain, kPremul>``
(its resolve ``styled_resolve``): B1's walk (four slots'
loads in flight, the carry as two 32-bit adds), strips a block from the
three-blocks-an-SM budget, and a resolve that goes layer by layer over
a batch of pixels a thread.  Held here at 1, 3, 4, 5 and 16 layers; colour, linear, focal and field paints mixed; nonzero, even-odd
and mixed rules; the single pass, the chain with and without ``bg``,
premultiplied planes out, and ``mask_from`` at 1, 2 and L - 1; 1, 2
and 6 strips a plane (6 at 16 layers: one strip a block, so a plane is
split over six blocks); and dense scenes whose supergroups hold several
groups, so that the walk's batches of four slots cross groups.  Four
mutants of the new body must fail, and one case holds the emulated
kernel against the JAX package's ``_fused_styled_kernel`` in Pallas
interpret mode.

Tolerance: byte-equal to the plain version (words equal, planes max
abs 0: it performs the kernel's arithmetic and g++ contracts no FMA);
against the JAX kernel the envelope of ROADMAP.md queue C (premultiplied
1 level, straight 2, share 2.1e-5).
"""

import ctypes
import functools
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swf_renderer_tpu.ops import flatblock as jfb
from swf_renderer_tpu_torch.convert import packed_to_device
from swf_renderer_tpu_torch.native import bindings
from swf_renderer_tpu_torch.ops import cuda_lib
from swf_renderer_tpu_torch.ops import flatblock as fb
from swf_renderer_tpu_torch.ops.pipeline import lower_update_lists
from swf_renderer_tpu_torch.utils.scenes import build_scene_edges
from tests.test_torch_kernel_emulated import (  # noqa: F401 (fixture)
    _bg_planes, _build_emulator, _c, _chain_paints, _run, one_torch_thread,
)
from tests.test_torch_multipass import _paints, levels

FRAMES = 2


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    return _build_emulator(tmp_path_factory.mktemp("cuda_emu_styled"),
                           cuda_lib.CSRC_DIR)


@functools.lru_cache(maxsize=None)
def _scene(height, width, layers, spp, seed, shapes):
    tables, colors = build_scene_edges(FRAMES, layers, height, width,
                                       shapes_per_layer=shapes, seed=seed)
    packed = bindings.pack_grouped_native(
        lower_update_lists(tables, height, width), height, width, group=6,
        spp=spp)
    return packed_to_device(*packed, device="cpu"), colors


def _rule(rule, layers):
    return tuple(i % 2 for i in range(layers)) if rule == "mixed" else rule


# name -> (height, width, layers, spp, rule, shapes a layer, mode keywords
# of render_fused_styled).  6 strips a plane at 16 layers split over six
# blocks; the dense scenes (30 shapes a layer) have supergroups of
# several groups.
CASES = {
    "single_L1": (24, 300, 1, 1, 0, 3, {}),
    "single_L3_spp2": (40, 300, 3, 2, 1, 3, {}),
    "single_L4_dense": (40, 300, 4, 2, "mixed", 30, {}),
    "single_L5": (24, 300, 5, 1, "mixed", 3, {}),
    "single_L16_spp6": (48, 100, 16, 6, "mixed", 3, {}),
    "chain_L4_dense": (40, 300, 4, 2, 0, 30, dict(chain=True)),
    "chain_bg_L5_spp2": (40, 300, 5, 2, "mixed", 3,
                         dict(chain=True, bg=True)),
    "premul_L16_spp6": (48, 100, 16, 6, 1, 3,
                        dict(chain=True, emit="premul")),
    "premul_bg_L3": (24, 300, 3, 1, "mixed", 3,
                     dict(chain=True, bg=True, emit="premul")),
    "mask_first_L5": (40, 300, 5, 2, "mixed", 3,
                      dict(chain=True, bg=True, mask_from=1)),
    "mask_mid_L5_premul": (24, 300, 5, 1, "mixed", 3,
                           dict(chain=True, emit="premul", mask_from=2)),
    "mask_last_L4_premul": (24, 300, 4, 1, 1, 3,
                            dict(chain=True, emit="premul", mask_from=3)),
    "mask_last_L16_spp6": (48, 100, 16, 6, 0, 3,
                           dict(chain=True, bg=True, mask_from=15)),
}


def _case(emu, name):
    """(emulated kernel output, plain version's output, ns, premul)."""
    height, width, layers, spp, rule, shapes, mode = CASES[name]
    d, colors = _scene(height, width, layers, spp, layers + 70, shapes)
    if shapes > 3:   # a supergroup of several groups
        flags = d["flags"].numpy()
        assert ((flags & 2).nonzero()[0] > (flags & 1).nonzero()[0]).any()
    ns, nc = d["ns"], d["nc"]
    rng = np.random.default_rng(layers + spp)
    paints = _chain_paints(rng, layers)
    field = fb.field_to_chunkmajor(
        torch.as_tensor(rng.uniform(0, 1, (height, width, 4))
                        .astype(np.float32)), ns, nc, spp=spp)
    rule = _rule(rule, layers)
    kw = dict(mode)
    if kw.pop("bg", False):
        kw["bg"] = _bg_planes(rng, FRAMES, ns, nc, spp)
    want = fb.fused_styled_plain(
        d["sidx"], d["flags"], d["lays"], d["urc"], d["ucm"], d["uval"],
        torch.as_tensor(colors), (field,), FRAMES, layers, ns, nc, paints,
        fill_rule=rule, spp=spp, **kw)
    got, _ = _run(emu, d, colors, rule, FRAMES, layers, spp, paints,
                  _c(field), **kw)
    return got, want, ns, kw.get("emit") == "premul"


def _equal(got, want, ns, premul):
    if premul:
        return got.shape == want.shape and torch.equal(got, want)
    return torch.equal(got[:, :ns], want[:, :ns])


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_styled_equals_plain_version(emulator, name):
    """The styled kernel against fused_styled_plain: words equal on every strip block, or planes
    equal over the whole tensor (NaN where the kernel wrote nothing
    fails), the sentinel strip block of the words unwritten."""
    got, want, ns, premul = _case(emulator, name)
    assert _equal(got, want, ns, premul)
    if not premul:
        assert (got[:, ns] == -7).all()
        assert (want[:, :ns] != 0).any()


def test_styled_strips_per_block_split_the_16_layer_plane(emulator):
    """The budget of three blocks an SM: one strip a block at 16 layers
    (76,096 B), every strip of a plane in one block at 4."""
    d, colors = _scene(48, 100, 16, 6, 86, 3)
    _, spb = _run(emulator, d, colors, 0, FRAMES, 16, 6,
                  _chain_paints(np.random.default_rng(1), 16),
                  _c(torch.zeros((d["ns"] + 1, 4, 128, 128))))
    assert spb == 1
    d, colors = _scene(40, 300, 4, 2, 74, 3)
    _, spb = _run(emulator, d, colors, 0, FRAMES, 4, 2,
                  _chain_paints(np.random.default_rng(1), 4),
                  _c(torch.zeros((d["ns"] + 1, 4, 128, 128))))
    assert spb == 2


# Mutants of the new body, built together into one scratch copy behind a
# run-time switch (swf_mutant), each with a case it must fail: the walk's
# fourth slot of each batch dropped (a dense scene), the carry's high
# word dropped (negative deltas of earlier chunks), the chain's layer
# loop one layer short, and the mask union folded the other way round
# (equal in exact arithmetic, not in f32).
MUTANTS = {
    "walk_slot": (1, "      if (gs[u] > g1) continue;",
                  "      if (gs[u] > g1 || (swf_mutant == 1 && u == kU - 1))"
                  " continue;", "chain_L4_dense"),
    "carry_high": (2, "    atomicAdd(&word[1], static_cast<unsigned>(q >> 32)"
                      " +",
                   "    atomicAdd(&word[1], (swf_mutant == 2 ? 0u : "
                   "static_cast<unsigned>(q >> 32)) +", "premul_bg_L3"),
    "layer_bound": (3, "      for (int l = 0; l < L; ++l) {\n"
                       "        const int kind = static_cast<int>((kinds >> "
                       "(2 * l)) & 3u);\n        const int rule",
                    "      for (int l = 0; l < L - (swf_mutant == 3); ++l) {\n"
                    "        const int kind = static_cast<int>((kinds >> "
                    "(2 * l)) & 3u);\n        const int rule",
                    "chain_bg_L5_spp2"),
    "mask_fold": (4, "m = (l == mf) ? ca : ca + m * (1.0f - ca);",
                  "m = (l == mf) ? ca : (swf_mutant == 4 ? m + ca * (1.0f - "
                  "m) : ca + m * (1.0f - ca));", "mask_mid_L5_premul"),
}


@pytest.fixture(scope="module")
def mutant_emulator(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("cuda_emu_styled_mutants")
    csrc = d / "csrc"
    shutil.copytree(cuda_lib.CSRC_DIR, csrc)
    header = csrc / "flatblock_device.cuh"
    text = header.read_text()
    for name, (_, before, after, _) in MUTANTS.items():
        assert text.count(before) == 1, name
        text = text.replace(before, after)
    header.write_text(text.replace("#pragma once\n",
                                   "#pragma once\nextern int swf_mutant;\n", 1))
    emu = _build_emulator(d, csrc, """
int swf_mutant = 0;
extern "C" void set_mutant(int m) { swf_mutant = m; }
""")
    emu.set_mutant.restype = None
    emu.set_mutant.argtypes = [ctypes.c_int]
    return emu


@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_emulated_styled_mutants_are_caught(mutant_emulator, mutant):
    """Each mutant differs from the plain version on its case; with the
    switch off the same build is equal."""
    flag, _, _, name = MUTANTS[mutant]
    mutant_emulator.set_mutant(0)
    assert _equal(*_case(mutant_emulator, name))
    mutant_emulator.set_mutant(flag)
    try:
        assert not _equal(*_case(mutant_emulator, name))
    finally:
        mutant_emulator.set_mutant(0)


def test_emulated_styled_mask_pair_matches_reference_kernel(emulator):
    """A clip group fused with its mask over a background (4 layers,
    mask_from 1, colour / linear / focal / field paints, 3 strips a
    plane): the emulated kernel against the JAX package's
    ``_fused_styled_kernel`` in interpret mode, within the envelope the
    port's plain version keeps (tests/test_torch_multipass.py)."""
    height, width, layers, spp = 24, 200, 4, 3
    tables, colors = build_scene_edges(FRAMES, layers, height, width,
                                       shapes_per_layer=4, seed=31)
    packed = bindings.pack_grouped_native(
        lower_update_lists(tables, height, width), height, width, group=6,
        spp=spp)
    dev = packed_to_device(*packed, device="cpu")
    ns, nc = dev["ns"], dev["nc"]
    rows = fb.plane_rows_for(nc, spp)
    rng = np.random.default_rng(5)
    field = rng.uniform(0, 1, (height, width, 4)).astype(np.float32)
    bg = _bg_planes(rng, FRAMES, ns, nc, spp)
    assert bg.shape == (FRAMES, ns + 1, 4, rows, 128)
    rule = (0, 1, 0, 1)
    got, _ = _run(emulator, dev, colors, rule, FRAMES, layers, spp,
                  _paints(fb, np.random.default_rng(9)),
                  _c(fb.field_to_chunkmajor(torch.as_tensor(field), ns, nc,
                                            spp=spp)),
                  chain=True, bg=bg, mask_from=1)
    want = np.asarray(jfb.render_fused_styled(
        *(jnp.asarray(x) for x in packed[:6]), jnp.asarray(colors),
        (jfb.field_to_chunkmajor(jnp.asarray(field), ns, nc, spp=spp),),
        FRAMES, layers, ns, nc, _paints(jfb, np.random.default_rng(9)),
        group=6, fill_rule=rule, spp=spp, chain=True,
        bg=jnp.asarray(bg.numpy()), mask_from=1))
    g = got.numpy().view(np.uint32)[:, :ns].view(np.uint8)
    w = want[:, :ns].view(np.uint8)
    smax, pmax, share = levels(w.reshape(-1, 4), g.reshape(-1, 4))
    assert pmax <= 1 and smax <= 2 and share <= 2.1e-5, (smax, pmax, share)
    assert w[..., 3].max() > 0
