"""B1's resolve half, the one-block form on its body (B13) and the
texfield kernel (B8) as redesigned for the H100, run on the CPU under
the g++ emulation of ``tests/test_torch_kernel_emulated.py`` against
the unchanged plain versions.

B1 (``csrc/flatblock_device.cuh`` ``fused_block`` for the solid grouped
kernel): the launcher picks the layer class ``solid_layer_class(L)`` (4
up to four layers, else 16), which unrolls the resolve's layer loops;
the walk issues the loads of four slots at once.  Held here at 1, 2, 4
and 16 layers, 1, 2 and 5 strips a plane (5 at 16 layers splits each
plane's strips over three blocks), nonzero, even-odd and mixed rules,
with the ``kVarResolve`` and ``kVarNone0`` cuts at both classes, one
styled and one chain / premultiplied / mask case of the styled kernel
(its own body since its redesign: ``styled_resolve``, held in full in
``tests/test_torch_kernel_emulated_styled.py``), and the one-block form
(B13) on the same body at ``kVarOne`` (a slot's layer from its block's
``sidx``, values split in two bf16 parts when ``passes`` < 3) at 1, 4,
9 and 16 layers, passes 2 and 3, both rules; the carry of earlier
chunks is two native 32-bit adds, the low word's wrap carried into the
high word, held on supergroups of several groups through B1, mode
"none"'s loads and kVarBatched.

B8 (``csrc/texfield_device.cuh``): ``texfield_block<N, kSmooth,
kEdge>`` at n = 1, 2 and 4 (unrolled) and the run-time body (N = 0) at
n = 3 and at every n, smoothed and nearest, repeat / flash / canvas,
textures of 64 x 64 (the wrap a mask) and 37 x 23 (a remainder), with
coordinates below zero and beyond 2^24 texels.  Four mutants of the
new bodies must fail.

Tolerance: byte-equal (the plain versions perform the kernels'
arithmetic; g++ contracts no FMA).
"""

import ctypes
import functools
import shutil

import numpy as np
import pytest
import torch

from swf_renderer_tpu_torch.convert import packed_to_device
from swf_renderer_tpu_torch.native import bindings
from swf_renderer_tpu_torch.ops import cuda_lib
from swf_renderer_tpu_torch.ops import flatblock as fb
from swf_renderer_tpu_torch.ops import texfield
from swf_renderer_tpu_torch.ops.pipeline import lower_update_lists
from swf_renderer_tpu_torch.tools import exp_split
from swf_renderer_tpu_torch.utils.scenes import build_scene_edges
from tests.test_torch_kernel_emulated import (  # noqa: F401 (fixture)
    _bg_planes, _build_emulator, _c, _chain_paints, _emulate_variant,
    _flat_blocks, _run, one_torch_thread,
)

SOLID = r"""
// The solid grouped kernel as its launchers run it: fused_block<...,
// kVar, kLc> over (chunk x strip slice, strip block, frame) blocks, kLc
// the layer class the launcher picks.  Returns kLc.
template <int kVar, int kLc>
void run_solid(const swf::FusedArgs& a, int frames, size_t bytes) {
  std::vector<unsigned char> smem(bytes);
  for (int z = 0; z < frames; ++z)
    for (int y = 0; y < a.ns1 - 1; ++y)
      for (int x = 0; x < a.n_chunks * a.n_spg; ++x) {
        std::memset(smem.data(), 0xab, smem.size());  // stale contents
        run_block(swf::kThreads, x, y, z, [&] {
          swf::fused_block<false, false, false, kVar, kLc>(a, smem.data());
        });
      }
}

template <int kVar>
int run_solid_class(const swf::FusedArgs& a, int frames, size_t bytes) {
  const int lc = swf::solid_layer_class(a.layers);
  if (lc == swf::kSolidSmallLayers)
    run_solid<kVar, swf::kSolidSmallLayers>(a, frames, bytes);
  else
    run_solid<kVar, swf::kMaxLayers>(a, frames, bytes);
  return lc;
}

extern "C" int emulate_solid(int variant, const int* sidx, const int* flags,
                             const int* lays, const float* urc,
                             const float* ucm, const float* uval,
                             const float* colors, const int* rules, int* out,
                             int ng, int group, int frames, int layers,
                             int ns1, int n_chunks, int spp) {
  swf::FusedArgs a{};
  a.sidx = sidx; a.flags = flags; a.lays = lays; a.urc = urc; a.ucm = ucm;
  a.uval = uval; a.colors = colors; a.rules = rules; a.out = out;
  a.mask_from = -1; a.ng = ng; a.group = group; a.layers = layers;
  a.ns1 = ns1; a.n_chunks = n_chunks; a.spp = spp; a.plane_rows = 128;
  a.passes = 3; a.kk = 1;
  a.spb = swf::strips_per_block(layers, spp, false);
  a.n_spg = (spp + a.spb - 1) / a.spb;
  std::vector<int> first(frames * ns1, -1), last(frames * ns1, -1);
  for (int i = 0; i < ng; ++i) {  // supergroup_index_kernel
    const int fl = flags[i];
    if ((fl & 3) == 0) continue;
    const int sg = (sidx[i] / (layers * ns1)) * ns1 + sidx[i] % ns1;
    if (fl & 1) first[sg] = i;
    if (fl & 2) last[sg] = i;
  }
  a.sg_first = first.data();
  a.sg_last = last.data();
  const size_t bytes = swf::smem_bytes(layers, a.spb * swf::kStripH, false);
  switch (variant) {
    case swf::kVarFull: return run_solid_class<swf::kVarFull>(a, frames, bytes);
    case swf::kVarResolve:
      return run_solid_class<swf::kVarResolve>(a, frames, bytes);
    case swf::kVarNone0:
      return run_solid_class<swf::kVarNone0>(a, frames, bytes);
    default: return -1;
  }
}
"""


def _build(d, csrc):
    emu = _build_emulator(d, csrc, SOLID)
    emu.emulate_solid.restype = ctypes.c_int
    emu.emulate_solid.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [
        ctypes.c_int] * 7
    return emu


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    return _build(tmp_path_factory.mktemp("cuda_emu_redesign"),
                  cuda_lib.CSRC_DIR)


FRAMES = 2


@functools.lru_cache(maxsize=None)
def _scene(height, width, layers, spp, seed, shapes=3):
    tables, colors = build_scene_edges(FRAMES, layers, height, width,
                                       shapes_per_layer=shapes, seed=seed)
    packed = bindings.pack_grouped_native(
        lower_update_lists(tables, height, width), height, width, group=6,
        spp=spp)
    return packed_to_device(*packed, device="cpu"), colors


def _emulate_solid(emu, d, colors, layers, spp, rule, variant):
    a = {k: _c(d[k]) for k in ("sidx", "flags", "lays", "urc", "ucm",
                                "uval")}
    ns, nc = d["ns"], d["nc"]
    out = np.full((FRAMES, ns + 1, spp * 8, nc * 128), -7, np.int32)
    rules = np.asarray(fb.layer_rules(rule, layers), np.int32)
    cols = _c(colors)
    lc = emu.emulate_solid(
        variant, *(a[k].ctypes.data for k in ("sidx", "flags", "lays", "urc",
                                               "ucm", "uval")),
        cols.ctypes.data, rules.ctypes.data, out.ctypes.data,
        len(a["sidx"]), 6, FRAMES, layers, ns + 1, nc, spp)
    return torch.from_numpy(out), lc


def _rule(rule, layers):
    return tuple(i % 2 for i in range(layers)) if rule == "mixed" else rule


# (height, width, layers, spp, rule, shapes a layer): the layer class 4
# below and at four layers (its guards and its exact copy), 16 above; 5
# strips a plane at 16 layers split over three blocks of 2 strips; the
# dense scenes' supergroups run over several groups (5 and 32), so the
# walk's batches of four slots cross groups.
SOLID_SCENES = [(24, 200, 1, 1, 0, 3), (40, 300, 2, 2, 1, 3),
                (40, 300, 4, 2, "mixed", 30), (40, 100, 4, 5, 1, 3),
                (16, 2560, 16, 1, 0, 3), (40, 100, 16, 5, "mixed", 3)]


@pytest.mark.parametrize("scene", SOLID_SCENES)
def test_emulated_solid_equals_plain_version(emulator, scene):
    """B1 through the launcher's layer class against fusedn_plain: words
    equal on every strip block; the sentinel strip block unwritten."""
    height, width, layers, spp, rule, shapes = scene
    d, colors = _scene(height, width, layers, spp, 5, shapes)
    if shapes > 3:   # a supergroup of several groups
        flags = d["flags"].numpy()
        assert ((flags & 2).nonzero()[0] > (flags & 1).nonzero()[0]).any()
    ns, nc = d["ns"], d["nc"]
    rule = _rule(rule, layers)
    want = fb.fusedn_plain(d["sidx"], d["flags"], d["lays"], d["urc"],
                           d["ucm"], d["uval"], torch.as_tensor(colors),
                           FRAMES, layers, ns, nc, fill_rule=rule, spp=spp)
    got, lc = _emulate_solid(emulator, d, colors, layers, spp, rule,
                             exp_split._VARIANTS["full"])
    assert lc == (4 if layers <= 4 else 16)
    assert torch.equal(got[:, :ns], want[:, :ns])
    assert (got[:, ns] == -7).all()
    assert (want[:, :ns] != 0).any()


@pytest.mark.parametrize("kind", ["resolve", "none0"])
@pytest.mark.parametrize("layers", [3, 16])
def test_emulated_solid_cuts_equal_plain_versions(emulator, kind, layers):
    """The exp_split cuts of the new body at both layer classes: zero
    words on every strip block they visit (resolve prefixes and resolves
    zeroed planes: coverage 0 everywhere)."""
    tables, colors = build_scene_edges(FRAMES, layers, 24, 300,
                                       shapes_per_layer=3, seed=layers + 90)
    d = exp_split.pack(tables, 24, 300, "cpu")
    ns = d["ns"]
    want = exp_split.variants(d, torch.as_tensor(colors), FRAMES,
                              layers)[kind].plain()[:, :ns]
    got, _ = _emulate_solid(emulator, d, colors, layers, 1, 0,
                            exp_split._VARIANTS[kind])
    assert torch.equal(got[:, :ns], want)
    assert not want.any()


def _dense_one_strip_scene(layers=4):
    """40 x 300 at one strip a plane, 30 shapes a layer: supergroups of
    several groups, so the walk's batches of four slots cross groups."""
    tables, colors = build_scene_edges(FRAMES, layers, 40, 300,
                                       shapes_per_layer=30, seed=5)
    d = exp_split.pack(tables, 40, 300, "cpu")
    flags = d["flags"].numpy()
    assert ((flags & 2).nonzero()[0] > (flags & 1).nonzero()[0]).any()
    arrays = tuple(d[k] for k in ("sidx", "flags", "lays", "urc", "ucm",
                                  "uval"))
    return d, colors, arrays


def _none_seen(got, ns, nc):
    """Mode "none"'s words (observe set) -> the xor of each chunk block's
    words, (F, NS, n_chunks)."""
    blocks = got[:, :ns].numpy().reshape(FRAMES, ns, 8, nc, 128)
    return np.bitwise_xor.reduce(np.bitwise_xor.reduce(blocks, axis=4),
                                 axis=2)


def test_emulated_walk_forms_on_long_supergroups(emulator):
    """The loads solid_walk issues (mode "none" with observe: their xor)
    and kVarBatched's placement through place_loaded (B1's words) on
    supergroups of several groups."""
    d, colors, arrays = _dense_one_strip_scene()
    ns, nc = d["ns"], d["nc"]
    seen = _none_seen(_emulate_variant(emulator, d, colors, 4, "none",
                                       observe=1), ns, nc)
    want_seen = exp_split.none_observed_plain(*arrays, FRAMES, 4, ns,
                                              6).numpy()
    assert (seen == want_seen[..., None]).all()
    want = fb.fusedn_plain(*arrays, torch.as_tensor(colors), FRAMES, 4, ns,
                           nc)[:, :ns]
    got = _emulate_variant(emulator, d, colors, 4, "batched1")[:, :ns]
    assert torch.equal(got, want)


def test_emulated_styled_keeps_its_body(emulator):
    """The styled single pass (colour, gradient and field paints) through
    the styled kernel's own body (styled_resolve), beside B1's: equal to fused_styled_plain."""
    height, width, layers, spp = 40, 300, 4, 2
    d, colors = _scene(height, width, layers, spp, 41)
    ns, nc = d["ns"], d["nc"]
    rng = np.random.default_rng(41)
    paints = _chain_paints(rng, layers)
    field = fb.field_to_chunkmajor(
        torch.as_tensor(rng.uniform(0, 1, (height, width, 4))
                        .astype(np.float32)), ns, nc, spp=spp)
    want = fb.fused_styled_plain(
        d["sidx"], d["flags"], d["lays"], d["urc"], d["ucm"], d["uval"],
        torch.as_tensor(colors), (field,), FRAMES, layers, ns, nc, paints,
        fill_rule=(0, 1, 0, 1), spp=spp)
    got, _ = _run(emulator, d, colors, (0, 1, 0, 1), FRAMES, layers, spp,
                  paints, _c(field))
    assert torch.equal(got[:, :ns], want[:, :ns])


def test_emulated_chain_premul_mask_keeps_its_body(emulator):
    """A chain pass seeded from background planes, premultiplied planes
    out, layers 3.. a clip group's mask, 5 strips a plane, through the
    styled kernel's own body (styled_resolve)."""
    height, width, layers, spp = 40, 100, 9, 5
    d, colors = _scene(height, width, layers, spp, 43)
    ns, nc = d["ns"], d["nc"]
    rng = np.random.default_rng(43)
    paints = _chain_paints(rng, layers)
    field = fb.field_to_chunkmajor(
        torch.as_tensor(rng.uniform(0, 1, (height, width, 4))
                        .astype(np.float32)), ns, nc, spp=spp)
    rule = tuple(int(i % 3 == 1) for i in range(layers))
    kw = dict(chain=True, emit="premul", mask_from=3,
              bg=_bg_planes(rng, FRAMES, ns, nc, spp))
    want = fb.fused_styled_plain(
        d["sidx"], d["flags"], d["lays"], d["urc"], d["ucm"], d["uval"],
        torch.as_tensor(colors), (field,), FRAMES, layers, ns, nc, paints,
        fill_rule=rule, spp=spp, **kw)
    got, _ = _run(emulator, d, colors, rule, FRAMES, layers, spp, paints,
                  _c(field), **kw)
    assert torch.equal(got, want)


def _emulate_fused1(emu, frames, layers, height, width, seed, rule, passes,
                    empty_layer=None):
    """B13 (launch_one: B1's solid body at kVarOne, the layer class the
    launcher picks) on sort_blocks_fused blocks, and fused_blocks_plain's
    words; out pre-filled with -7 so that words it does not write show."""
    (sidx, keep, urc, ucm, uval, ns, nc), colors = _flat_blocks(
        frames, layers, height, width, seed=seed, empty_layer=empty_layer)
    blocks = fb.sort_blocks_fused(sidx, keep, urc, ucm, uval, layers, ns,
                                  block_pad_multiple=16)
    si, ke, la, rc, cm, uv = (_c(x) for x in blocks)
    rules = np.asarray(rule, np.int32)
    colors = _c(np.asarray(colors, np.float32))
    want = fb.fused_blocks_plain(*map(torch.as_tensor, blocks),
                                 torch.as_tensor(colors), frames,
                                 layers, ns, nc, fill_rule=rule,
                                 passes=passes)
    out = np.full(want.shape, -7, np.int32)
    emu.emulate_fused1(
        si.ctypes.data, ke.ctypes.data, la.ctypes.data, rc.ctypes.data,
        cm.ctypes.data, uv.ctypes.data, colors.ctypes.data,
        rules.ctypes.data, out.ctypes.data, len(si), frames, layers, ns + 1,
        nc, passes)
    return torch.from_numpy(out), want, ns


def test_emulated_one_block_form_keeps_its_body(emulator):
    """The one-block form (B13, B1's body at kVarOne) on sorted blocks,
    mixed rules, passes 2: equal to fused_blocks_plain, strip NS
    zeroed."""
    got, want, ns = _emulate_fused1(emulator, 2, 4, 40, 300, 45,
                                    (0, 1, 1, 0), 2)
    assert torch.equal(got, want)
    assert (want[:, :ns] != 0).any()


# (layers, height, width, rules, passes, empty layer): layer classes 4
# (1 and 4 layers) and 16 (9 and 16), both rules and mixed, the values
# whole (passes 3) and split in two bf16 parts (passes 2), ragged
# 128-column chunks.
FUSED1_CASES = {
    "1_layer_nonzero_p3": (1, 40, 300, (0,), 3, None),
    "1_layer_evenodd_p2": (1, 24, 200, (1,), 2, None),
    "4_layers_evenodd_p3": (4, 40, 300, (1, 1, 1, 1), 3, 1),
    "9_layers_mixed_p2": (9, 24, 200, tuple(i % 2 for i in range(9)), 2,
                          None),
    "16_layers_nonzero_p3": (16, 16, 260, (0,) * 16, 3, None),
    "16_layers_mixed_p2": (16, 16, 260, tuple(int(i % 3 == 1)
                                              for i in range(16)), 2, 7),
}


@pytest.mark.parametrize("case", sorted(FUSED1_CASES))
def test_emulated_one_block_form_equals_plain_version(emulator, case):
    """B13 on B1's body: words equal to fused_blocks_plain at 1, 4, 9
    and 16 layers, passes 2 and 3, both rules; strip NS zeroed."""
    layers, height, width, rule, passes, empty = FUSED1_CASES[case]
    got, want, ns = _emulate_fused1(emulator, 2, layers, height, width,
                                    60 + layers + passes, rule, passes,
                                    empty_layer=empty)
    assert torch.equal(got, want)
    assert (want[:, :ns] != 0).any() and not want[:, ns].any()
    assert len(torch.unique(want)) > 20


# -- B8 -----------------------------------------------------------------

TEX_EDGES = {"repeat": (True, "flash"), "flash": (False, "flash"),
             "canvas": (False, "canvas")}


def _tex_invs():
    """Frames whose samples fall below zero, across the edges, and beyond
    2^24 texels (the float remainder of the repeat wrap)."""
    return np.asarray([(0.31, 0.12, -0.2, 0.27, -9.5, -4.25),
                       (1.7, -0.9, 0.4, 2.2, -40.0, 31.0),
                       (3.0, 0.4, -0.6, 2.5, -3.3e7, 2.9e7)], np.float32)


@pytest.mark.parametrize("shape", [(64, 64), (37, 23)])
@pytest.mark.parametrize("edge", sorted(TEX_EDGES))
@pytest.mark.parametrize("smoothed", [True, False])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_emulated_texfield_forms_equal_plain_version(emulator, n, smoothed,
                                                     edge, shape):
    """Each instantiation the launcher picks (n 1, 2, 4 unrolled; n 3 the
    run-time body) and the run-time body at the same n against
    texfield_plain: fields equal bit for bit, 3 frames walked by 2
    z-blocks over a 37 x 45 frame (ragged 32 x 32 tiles)."""
    repeating, edge_mode = TEX_EDGES[edge]
    rng = np.random.default_rng(n * 100 + sum(shape) + smoothed)
    img = rng.integers(0, 256, (*shape, 4)).astype(np.uint8)
    img[0, :3, 3] = 0   # transparent texels: the un-premultiply guard
    invs = _tex_invs()
    height, width = 37, 45
    want = texfield.texfield_plain(torch.as_tensor(img),
                                   torch.as_tensor(invs), height, width, n,
                                   repeating, smoothed, edge_mode)
    assert float(want[..., 3].std()) > 0.05
    for generic in (0, 1):
        tex = np.empty((*shape, 4), np.float32)
        out = np.full((3, height, width, 4), np.nan, np.float32)
        emulator.emulate_texfield(
            img.ctypes.data, tex.ctypes.data, invs.ctypes.data,
            out.ctypes.data, shape[0], shape[1], 3, height, width, n,
            int(repeating), int(smoothed), int(edge_mode == "canvas"), 2,
            generic)
        assert torch.equal(torch.as_tensor(out), want), generic


# Mutants of the new bodies, built together into one scratch copy, each
# with a comparison only it breaks: the walk's fourth slot of each batch
# dropped (the loads mode "none" xors: solid_walk without place_loaded),
# the carry's low-word wrap not carried into the high word (kVarBatched's
# words: place_loaded without solid_walk), the repeat wrap masking a side
# that is not a power of two, and the mean of n * n = 9 subsamples taken
# as a reciprocal multiply.
MUTANTS = {
    "walk_slot": ("flatblock_device.cuh", "      if (gs[u] > g1) continue;",
                  "      if (gs[u] > g1 || u == kU - 1) continue;"),
    "carry_wrap": ("flatblock_device.cuh",
                   "(old + lo < old ? 1u : 0u));", "0u);"),
    "wrap_mask": ("texfield_device.cuh",
                  "return TexAxis{n, (n & (n - 1)) == 0 ? n - 1 : -1};",
                  "return TexAxis{n, n - 1};"),
    "mean_rcp": ("texfield_device.cuh",
                 "return pow2 ? v * rcp : __fdiv_rn(v, nnf);",
                 "return v * rcp;"),
}


def test_emulated_redesign_mutants_are_caught(tmp_path):
    """The comparisons above see a broken copy of each new body."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC_DIR, csrc)
    for name, (header, before, after) in MUTANTS.items():
        path = csrc / header
        text = path.read_text()
        assert text.count(before) == 1, name
        path.write_text(text.replace(before, after))
    emu = _build(tmp_path, csrc)

    d, colors, arrays = _dense_one_strip_scene()
    ns, nc = d["ns"], d["nc"]
    seen = _none_seen(_emulate_variant(emu, d, colors, 4, "none",
                                       observe=1), ns, nc)
    want_seen = exp_split.none_observed_plain(*arrays, FRAMES, 4, ns,
                                              6).numpy()
    assert not (seen == want_seen[..., None]).all(), "walk_slot"
    want = fb.fusedn_plain(*arrays, torch.as_tensor(colors), FRAMES, 4, ns,
                           nc)[:, :ns]
    got = _emulate_variant(emu, d, colors, 4, "batched1")[:, :ns]
    assert not torch.equal(got, want), "carry_wrap"

    rng = np.random.default_rng(5)
    for name, shape, repeating, n in (("wrap_mask", (37, 23), True, 2),
                                      ("mean_rcp", (64, 64), False, 3)):
        img = rng.integers(0, 256, (*shape, 4)).astype(np.uint8)
        invs = _tex_invs()
        want = texfield.texfield_plain(torch.as_tensor(img),
                                       torch.as_tensor(invs), 37, 45, n,
                                       repeating, True, "flash")
        tex = np.empty((*shape, 4), np.float32)
        out = np.full((3, 37, 45, 4), np.nan, np.float32)
        emu.emulate_texfield(img.ctypes.data, tex.ctypes.data,
                             invs.ctypes.data, out.ctypes.data, shape[0],
                             shape[1], 3, 37, 45, n, int(repeating), 1, 0,
                             2, 0)
        assert not torch.equal(torch.as_tensor(out), want), name
