"""The window-targeted form of B1 (``kVarWin``, the reference's
tools/exp_winplace.py) and the coarse steps with explicit output copies
(``csrc/coarse_device.cuh``, the reference's tools/exp_dma.py), run on
the CPU under the g++ emulation of ``tests/test_torch_kernel_emulated.py``
against their plain versions and B1's.

The emulation gains the four bulk-copy operations the coarse kernel
issues (``fence.proxy.async.shared::cta``, ``cp.async.bulk.global.
shared::cta.bulk_group``, ``cp.async.bulk.commit_group`` and
``cp.async.bulk.wait_group[.read]``).  The copies are deferred: each
issuing thread keeps its committed bulk groups and performs the oldest
only when a wait leaves fewer pending, or at the block's exit, where
they are counted.  So a kernel that writes a ring slot before waiting
for the copy that reads it shows in the words, where an eager copy
would hide the race; and one that exits with copies in flight shows in
the count.  Misaligned copies (address or size not a multiple of 16 B)
are counted too.

A file of its own so that the test runner's workers take it apart from
the other emulated kernels.  Tolerance: byte-equal (B1's arithmetic; the
float atomics of a layer never share a target).
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
from swf_renderer_tpu_torch.ops.pipeline import lower_update_lists
from swf_renderer_tpu_torch.tools import exp_dma, exp_split, exp_winplace
from swf_renderer_tpu_torch.utils.scenes import build_scene_edges
from tests.test_torch_kernel_emulated import (  # noqa: F401 (fixture)
    _build_emulator, _c, one_torch_thread,
)

BULK = r"""
// cp.async.bulk shared -> global, deferred (see the test module's note).
struct BulkCopy { void* dst; const void* src; unsigned bytes; };
// Each emulated thread's open copies and committed groups (indexed by
// threadIdx.x: a block's threads are fibers of one OS thread).
struct BulkState {
  std::vector<BulkCopy> open;
  std::vector<std::vector<BulkCopy>> groups;
};
BulkState bulk_state[1024];
std::atomic<long long> bulk_copies{0}, bulk_at_exit{0}, bulk_misaligned{0};
inline void emu_bulk_copy_s2g(int* dst, const int* src, unsigned bytes) {
  if (bytes % 16 || reinterpret_cast<uintptr_t>(dst) % 16 ||
      reinterpret_cast<uintptr_t>(src) % 16) {
    ++bulk_misaligned;
  }
  ++bulk_copies;
  bulk_state[threadIdx.x].open.push_back({dst, src, bytes});
}
inline void emu_bulk_commit() {
  BulkState& s = bulk_state[threadIdx.x];
  s.groups.push_back(std::move(s.open));
  s.open.clear();
}
inline void emu_bulk_wait(int n) {
  BulkState& s = bulk_state[threadIdx.x];
  while (static_cast<int>(s.groups.size()) > n) {
    for (const BulkCopy& c : s.groups.front())
      std::memcpy(c.dst, c.src, c.bytes);
    s.groups.erase(s.groups.begin());
  }
}
// The block's exit: what is still pending (or never committed) is
// counted, then performed.
inline void emu_bulk_exit() {
  const BulkState& s = bulk_state[threadIdx.x];
  bulk_at_exit += static_cast<long long>(s.groups.size()) +
                  (s.open.empty() ? 0 : 1);
  emu_bulk_commit();
  emu_bulk_wait(0);
}
#include "coarse_device.cuh"

static void supergroup_index(const int* sidx, const int* flags, int ng,
                             int layers, int ns1, std::vector<int>& first,
                             std::vector<int>& last) {
  for (int i = 0; i < ng; ++i) {  // supergroup_index_kernel
    const int fl = flags[i];
    if ((fl & 3) == 0) continue;
    const int sg = (sidx[i] / (layers * ns1)) * ns1 + sidx[i] % ns1;
    if (fl & 1) first[sg] = i;
    if (fl & 2) last[sg] = i;
  }
}

// swf_fused_win: B1's grid over kVarWin.  Returns the strips a block.
extern "C" int emulate_win(const int* sidx, const int* flags,
                           const int* lays, const int* wins,
                           const float* urc, const float* ucm,
                           const float* uval, const float* colors,
                           const int* rules, int* out, int ng, int group,
                           int frames, int layers, int ns1, int n_chunks,
                           int spp) {
  swf::FusedArgs a{};
  a.sidx = sidx; a.flags = flags; a.lays = lays; a.wins = wins;
  a.urc = urc; a.ucm = ucm; a.uval = uval; a.colors = colors;
  a.rules = rules; a.out = out; a.mask_from = -1; a.ng = ng;
  a.group = group; a.layers = layers; a.ns1 = ns1; a.n_chunks = n_chunks;
  a.spp = spp; a.plane_rows = 128; a.passes = 3; a.kk = 1;
  a.spb = swf::strips_per_block(layers, spp, false);
  a.n_spg = (spp + a.spb - 1) / a.spb;
  std::vector<int> first(frames * ns1, -1), last(frames * ns1, -1);
  supergroup_index(sidx, flags, ng, layers, ns1, first, last);
  a.sg_first = first.data();
  a.sg_last = last.data();
  std::vector<unsigned char> smem(
      swf::smem_bytes(layers, a.spb * swf::kStripH, false));
  for (int z = 0; z < frames; ++z)
    for (int y = 0; y < ns1 - 1; ++y)
      for (int x = 0; x < n_chunks * a.n_spg; ++x) {
        std::memset(smem.data(), 0xab, smem.size());  // stale contents
        run_block(swf::kThreads, x, y, z, [&] {
          swf::fused_block<false, false, false, swf::kVarWin>(a, smem.data());
        });
      }
  return a.spb;
}

extern "C" int emulate_n_buf() { return swf::kNBuf; }

// swf_fused_coarse: stats = (bulk copies issued, bulk groups pending at
// the blocks' exits, misaligned copies).  -1 when coarse does not
// divide ng.
extern "C" int emulate_coarse(int coarse, const int* sidx, const int* flags,
                              const int* lays, const float* urc,
                              const float* ucm, const float* uval,
                              const float* colors, const int* rules,
                              int* out, int ng, int group, int frames,
                              int layers, int ns1, int n_chunks,
                              long long* stats) {
  if (coarse < 1 || ng % coarse != 0) return -1;
  swf::FusedArgs a{};
  a.sidx = sidx; a.flags = flags; a.lays = lays; a.urc = urc; a.ucm = ucm;
  a.uval = uval; a.colors = colors; a.rules = rules; a.out = out;
  a.mask_from = -1; a.ng = ng; a.group = group; a.layers = layers;
  a.ns1 = ns1; a.n_chunks = n_chunks; a.spp = 1; a.plane_rows = 128;
  a.spb = 1; a.n_spg = 1;
  std::vector<int> first(frames * ns1, -1), last(frames * ns1, -1);
  supergroup_index(sidx, flags, ng, layers, ns1, first, last);
  a.sg_first = first.data();
  a.sg_last = last.data();
  bulk_copies = 0; bulk_at_exit = 0; bulk_misaligned = 0;
  // 16-B aligned, as the card's dynamic shared memory.
  std::vector<float4> smem((swf::coarse_smem_bytes(layers) + 15) / 16);
  auto* bytes = reinterpret_cast<unsigned char*>(smem.data());
  for (int x = 0; x < (ng / coarse) * n_chunks; ++x) {
    std::memset(bytes, 0xab, smem.size() * 16);  // stale contents
    run_block(swf::kThreads, x, 0, 0, [&] {
      const bool small = swf::solid_layer_class(layers) ==
                         swf::kSolidSmallLayers;
      if (coarse == 1) {   // launch_coarse's choice
        if (small) {
          swf::coarse_block<swf::kSolidSmallLayers, true>(a, 1, bytes);
        } else {
          swf::coarse_block<swf::kMaxLayers, true>(a, 1, bytes);
        }
      } else {
        if (small) {
          swf::coarse_block<swf::kSolidSmallLayers, false>(a, coarse, bytes);
        } else {
          swf::coarse_block<swf::kMaxLayers, false>(a, coarse, bytes);
        }
      }
      emu_bulk_exit();
    });
  }
  stats[0] = bulk_copies; stats[1] = bulk_at_exit;
  stats[2] = bulk_misaligned;
  return 0;
}
"""


def _build(d, csrc):
    emu = _build_emulator(d, csrc, BULK)
    emu.emulate_win.restype = ctypes.c_int
    emu.emulate_win.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
    emu.emulate_coarse.restype = ctypes.c_int
    emu.emulate_coarse.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return emu


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    return _build(tmp_path_factory.mktemp("cuda_emu_window"),
                  cuda_lib.CSRC_DIR)


FRAMES = 2


@functools.lru_cache(maxsize=None)
def _tables(height, width, layers, seed):
    return build_scene_edges(FRAMES, layers, height, width,
                             shapes_per_layer=3, seed=seed)


# -- kVarWin (exp_winplace's render_win) ------------------------------------

# (height, width, layers, rule): strips per plane 2 (16 x 300), 5 (40 x
# 200; at 16 layers 2 strips a block, so blocks skip windows), 8 (64 x
# 96) and 1 (40 x 2100).
WIN_SCENES = [(16, 300, 3, 1), (40, 200, 4, "mixed"), (64, 96, 2, 0),
              (40, 200, 16, 0), (40, 2100, 4, 0)]


def _emulate_win(emu, d, colors, layers, spp, rule):
    a = {k: _c(d[k]) for k in ("sidx", "flags", "lays", "wins", "urc", "ucm",
                                "uval")}
    ns, nc = d["ns"], d["nc"]
    out = np.full((FRAMES, ns + 1, spp * 8, nc * 128), -7, np.int32)
    rules = np.asarray(fb.layer_rules(rule, layers), np.int32)
    cols = _c(colors)
    spb = emu.emulate_win(
        *(a[k].ctypes.data for k in ("sidx", "flags", "lays", "wins", "urc",
                                     "ucm", "uval")),
        cols.ctypes.data, rules.ctypes.data, out.ctypes.data,
        len(a["sidx"]), 6, FRAMES, layers, ns + 1, nc, spp)
    return torch.from_numpy(out), spb


@pytest.mark.parametrize("scene", WIN_SCENES)
def test_emulated_win_equals_plain_and_b1(emulator, scene):
    """kVarWin against ``win_plain`` and against B1's plain version on
    the pooled packing of the same scene at the same strips per plane:
    byte-equal on every visited strip block, every word written."""
    height, width, layers, rule = scene
    if rule == "mixed":
        rule = tuple(i % 2 for i in range(layers))
    tables, colors = _tables(height, width, layers, layers + 110)
    d, spp = exp_winplace.pack(tables, height, width, "cpu")
    ns, nc = d["ns"], d["nc"]
    got, spb = _emulate_win(emulator, d, colors, layers, spp, rule)
    got = got[:, :ns]
    if layers == 16 and spp == 5:
        assert spb < spp   # the strip slices skip windows
    geo = (torch.as_tensor(colors), FRAMES, layers, ns, nc)
    want = exp_winplace.win_plain(*(d[k] for k in (
        "sidx", "flags", "lays", "wins", "urc", "ucm", "uval")), *geo,
        fill_rule=rule, spp=spp)[:, :ns]
    base = exp_split.pack(tables, height, width, "cpu", spp=spp)
    b1 = fb.fusedn_plain(*(base[k] for k in ("sidx", "flags", "lays", "urc",
                                             "ucm", "uval")), *geo,
                         fill_rule=rule, spp=spp)[:, :ns]
    assert torch.equal(got, want) and torch.equal(want, b1)
    assert want.any() and (got != -7).all()


# -- the coarse steps (exp_dma's run_variant) ---------------------------------

# (height, width, layers, group, group_pad_multiple): one strip a plane;
# 16 layers at group 2 give supergroups of many groups that cross steps;
# the last scene is 4 groups and a tail of 60 padding groups (flags 0).
COARSE_SCENES = [(40, 200, 1, 6, 8), (24, 300, 4, 6, 8),
                 (16, 1100, 16, 2, 8), (16, 300, 2, 6, 64)]


@functools.lru_cache(maxsize=None)
def _coarse_scene(height, width, layers, group, pad):
    tables, colors = _tables(height, width, layers, layers + 130)
    packed = bindings.pack_grouped_native(
        lower_update_lists(tables, height, width), height, width,
        group=group, spp=1, group_pad_multiple=pad)
    return packed_to_device(*packed, device="cpu"), colors


def _emulate_coarse(emu, d, colors, layers, group, coarse):
    a = {k: _c(d[k]) for k in ("sidx", "flags", "lays", "urc", "ucm",
                                "uval")}
    ns, nc = d["ns"], d["nc"]
    out = np.full((FRAMES, ns + 1, 8, nc * 128), -7, np.int32)
    rules = np.zeros(layers, np.int32)
    cols = _c(colors)
    stats = np.zeros(3, np.int64)
    rc = emu.emulate_coarse(
        coarse, *(a[k].ctypes.data for k in ("sidx", "flags", "lays", "urc",
                                             "ucm", "uval")),
        cols.ctypes.data, rules.ctypes.data, out.ctypes.data,
        len(a["sidx"]), group, FRAMES, layers, ns + 1, nc,
        stats.ctypes.data)
    assert rc == 0
    return torch.from_numpy(out), stats


@pytest.mark.parametrize("coarse", exp_dma.COARSES)
@pytest.mark.parametrize("scene", COARSE_SCENES)
def test_emulated_coarse_equals_plain_and_b1(emulator, scene, coarse):
    """The coarse kernel against ``dma_plain`` and B1's plain version:
    byte-equal words on every strip, the sentinel strip block still -7
    (the bulk copies write nothing else), one bulk copy of 512 B per
    (frame, strip, chunk, row), none pending at a block's exit, none
    misaligned."""
    height, width, layers, group, pad = scene
    d, colors = _coarse_scene(height, width, layers, group, pad)
    ns, nc = d["ns"], d["nc"]
    got, stats = _emulate_coarse(emulator, d, colors, layers, group, coarse)
    geo = (torch.as_tensor(colors), FRAMES, layers, ns, nc)
    args = tuple(d[k] for k in ("sidx", "flags", "lays", "urc", "ucm",
                                "uval"))
    want = exp_dma.dma_plain(*args, *geo, group)[:, :ns]
    b1 = fb.fusedn_plain(*args, *geo, group=group)[:, :ns]
    assert torch.equal(got[:, :ns], want) and torch.equal(want, b1)
    assert want.any() and (got[:, ns] == -7).all()
    assert stats.tolist() == [FRAMES * ns * nc * 8, 0, 0]


def test_ring_slots_are_the_tools_n_buf(emulator):
    """The coarse kernel's ring has ``exp_dma.N_BUF`` slots (the
    reference's ring size)."""
    assert emulator.emulate_n_buf() == exp_dma.N_BUF == 2


def test_emulated_coarse_scene_has_long_and_crossing_supergroups():
    """The coarse cases cover what the ring and the ownership rule must
    get right: a block owning three or more supergroups at coarse 4 (a
    ring slot used twice), and supergroups that run past their first
    group's step at coarse 2 and 4."""
    d, _ = _coarse_scene(24, 300, 4, 6, 8)
    first = d["flags"].numpy() & 1
    per_block = first.reshape(-1, 4).sum(axis=1)
    assert per_block.max() >= 3
    d, _ = _coarse_scene(16, 1100, 16, 2, 8)
    fl = d["flags"].numpy()
    starts = np.nonzero(fl & 1)[0]
    ends = np.nonzero(fl & 2)[0]
    for coarse in (2, 4):
        assert ((starts // coarse) != (ends // coarse)).any()


# -- mutation checks: broken copies of the device code are caught ----------

MUTANTS = {
    # The wait before a ring slot is written again.
    "missing_ring_wait": ("coarse_device.cuh",
                          "if (tid == 0 && n >= kNBuf) bulk_wait_read_ring();",
                          ""),
    # The window's strip offset (win * nc8 rows) dropped.
    "window_dropped": ("flatblock_device.cuh",
                       "wn[u] = kVar == kVarWin ? a.wins[kg] : 0;",
                       "wn[u] = 0;"),
}


@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_emulated_window_mutants_are_caught(tmp_path, mutant):
    """Each mutant of the device code differs from the plain version:
    the coarse kernel without its ring wait (the deferred copies read
    slots written again), kVarWin without its window offset (every slot
    in its block's first strip)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    name, before, after = MUTANTS[mutant]
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC_DIR, csrc)
    header = csrc / name
    text = header.read_text()
    assert text.count(before) == 1
    header.write_text(text.replace(before, after))
    emu = _build(tmp_path, csrc)
    with pytest.raises(AssertionError):
        if mutant == "missing_ring_wait":
            test_emulated_coarse_equals_plain_and_b1(emu, COARSE_SCENES[1],
                                                     4)
        else:
            test_emulated_win_equals_plain_and_b1(emu, WIN_SCENES[1])
