"""Where the design tools' time goes: the product forms (19b, 19f, 19g:
one warpgroup body) and the coarse steps (19d), timed beside B1.

    python3 -m swf_renderer_tpu_torch.tools.design_phases [--csrc DIR]
        [--parent DIR] [--build NAME=DIR] [--variants [NAME,...]]
        [--rounds N]

Needs one NVIDIA card and ``nvcc``.  Builds ``flatblock.cu`` from
``DIR`` (default: this package's ``csrc``) as it is and a copy with
``clock64()`` stamps around the stages of the product body
(``place_mma_device.cuh``: set-up, gather, tile rows, products issued
and waited for, resolve; the stamps of a parent's earlier forms are
kept) and of the coarse steps (``coarse_device.cuh``: set-up with the
ring wait, placement, prefix, resolve, the copies' issue, the drain),
thread 0's cycles summed over blocks into a device array, read after
one call of each form alone.  On the headline scene at one strip a plane
(60 frames x 4 layers x 1088x1920, ``build_scene_edges`` seed 7, group
6: ``exp_split.pack``) it prints the ms of every build (in the order
parent, change, the rest, then back, ``--rounds`` times) of B1
(``render_fused_blocksn``), exp_lmask's ``render_lmask``, exp_dma's
``run_variant`` at coarse 1, 2 and 4, exp_k3's ``run_variant`` (three,
concat) and exp_int8's ``run_int8``; each output against B1's words
(equal for the coarse steps, levels and share of differing bytes for
the products); the stamped stages' cycles and shares of the four
product forms and the coarse steps; ptxas registers / stack / spills and
a SASS census of the product, coarse and B1 kernels (HMMA, HGMMA, IMMA,
IGMMA, UBLKCP, CAS, local loads and stores, block barriers), and which
kernels' SASS is identical to the parent's (without ``--parent``, to
this build's).  ``--parent`` builds another checkout's ``csrc`` beside,
``--build NAME=DIR`` any other ``csrc`` directory, ``--variants`` the
design elements of ``VARIANTS`` (edits of the committed form; all, or
the named ones; names hold no commas).  One JSON object of the builds,
one of the times, one of the stages, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import tempfile

from .coverage_phases import ptxas_of, sass_census, variant_sources
from .timing import card_line, time_ms

COARSES = (1, 2, 4)
PRODUCTS = ("lmask", "k3_three", "k3_concat", "int8")   # one stamped body
# Stamp slots: the product forms 0-7, the coarse steps 8-15.
LMASK_STAGES = ("setup", "gather", "product", "issue_wait", "resolve")
LMASK_COUNTS = {"groups": 5, "batches": 6, "blocks": 7}
COARSE_STAGES = ("setup", "place", "prefix", "resolve", "ring", "drain")
COARSE_COUNTS = {"supergroups": 14, "blocks": 15}

_HELPER = """
__device__ unsigned long long swf_ds_stamp[16];
// Thread 0 of the block adds v at slot k.
__device__ __forceinline__ void swf_stamp(int k, long long v) {
  if (threadIdx.x == 0) {
    atomicAdd(&swf_ds_stamp[k], static_cast<unsigned long long>(v));
  }
}
"""

_READ = """
extern "C" int swf_ds_stamps(unsigned long long* host, int zero) {
  if (zero) {
    static unsigned long long z[16] = {0};
    return (int)cudaMemcpyToSymbol(swf::swf_ds_stamp, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(host, swf::swf_ds_stamp,
                                   16 * sizeof(unsigned long long));
}
"""

# (anchor, replacement) edits that stamp the stages, per form of each
# header; the first form whose anchors all occur exactly once is used.
LMASK_FORMS = {
    "mma.sync, a fragment a layer": [
        ("  solid_setup(a, sm, L, kRows, f);\n  __syncthreads();\n",
         "  const long long s0_ = clock64();\n"
         "  solid_setup(a, sm, L, kRows, f);\n  __syncthreads();\n"
         "  long long t_top_ = 0, t_mid_ = clock64();\n"
         "  swf_stamp(0, t_mid_ - s0_);\n"),
        ("    const int nblk = static_cast<int>(static_cast<unsigned>(a.flags"
         "[g]) >> 2);\n    uint32_t* key",
         "    {\n      const long long n_ = clock64();\n"
         "      if (g > g0) swf_stamp(2, n_ - t_mid_);\n"
         "      t_top_ = n_;\n      swf_stamp(5, 1);\n    }\n"
         "    const int nblk = static_cast<int>(static_cast<unsigned>(a.flags"
         "[g]) >> 2);\n    uint32_t* key"),
        ("    // 2. Product: warp w's 16 columns of every placement block.\n",
         "    {\n      const long long n_ = clock64();\n"
         "      swf_stamp(1, n_ - t_top_);\n      t_mid_ = n_;\n    }\n"
         "    // 2. Product: warp w's 16 columns of every placement block.\n"),
        ("  if constexpr (kLmask) {\n#pragma unroll\n    for (int l = 0; l < "
         "kMaxLayers; ++l) {\n      if (l < L) {\n        const int r0 = ",
         "  const long long r0_ = clock64();\n"
         "  if (g0 >= 0 && g1 >= g0) swf_stamp(2, r0_ - t_mid_);\n"
         "  if constexpr (kLmask) {\n#pragma unroll\n    for (int l = 0; l < "
         "kMaxLayers; ++l) {\n      if (l < L) {\n        const int r0 = "),
        ("          + chunk * kLane + c] = static_cast<int>(packed);\n"
         "  }\n}\n",
         "          + chunk * kLane + c] = static_cast<int>(packed);\n  }\n"
         "  swf_stamp(4, clock64() - r0_);\n  swf_stamp(7, 1);\n}\n"),
    ],
    "warpgroup wgmma, layers folded into N": [
        ("  lmask_setup(a, ls, L, f);\n  __syncthreads();\n",
         "  const long long s0_ = clock64();\n"
         "  lmask_setup(a, ls, L, f);\n  __syncthreads();\n"
         "  long long c_ = clock64();\n  swf_stamp(0, c_ - s0_);\n"),
        ("    // 1. Gather: every slot's loads first",
         "    swf_stamp(5, 1);\n    // 1. Gather: every slot's loads first"),
        ("    // 2. The batches of the K run",
         "    {\n      const long long n_ = clock64();\n"
         "      swf_stamp(1, n_ - c_);\n      c_ = n_;\n    }\n"
         "    // 2. The batches of the K run"),
        ("      // Issue: ",
         "      {\n        const long long n_ = clock64();\n"
         "        swf_stamp(2, n_ - c_);\n        c_ = n_;\n"
         "        swf_stamp(6, 1);\n      }\n      // Issue: "),
        ("      wgmma_wait<1>();\n",
         "      wgmma_wait<1>();\n      {\n"
         "        const long long n_ = clock64();\n"
         "        swf_stamp(3, n_ - c_);\n        c_ = n_;\n      }\n"),
        ("  // 3. Resolve: winding = D",
         "  {\n    const long long n_ = clock64();\n"
         "    swf_stamp(3, n_ - c_);\n    c_ = n_;\n  }\n"
         "  // 3. Resolve: winding = D"),
        ("  lmask_store_words(a, words, chunk, s, f);\n}\n",
         "  lmask_store_words(a, words, chunk, s, f);\n"
         "  swf_stamp(4, clock64() - c_);\n  swf_stamp(7, 1);\n}\n"),
    ],
    "one warpgroup body for every form": [
        ("  product_setup<kVar, kLc>(a, ps, L, f);\n  __syncthreads();\n",
         "  const long long s0_ = clock64();\n"
         "  product_setup<kVar, kLc>(a, ps, L, f);\n  __syncthreads();\n"
         "  long long c_ = clock64();\n  swf_stamp(0, c_ - s0_);\n"),
        ("    const int lp0 = pass * P::kLp;\n",
         "    {\n      const long long n_ = clock64();\n"
         "      if (pass > 0) swf_stamp(4, n_ - c_);\n      c_ = n_;\n    }\n"
         "    const int lp0 = pass * P::kLp;\n"),
        ("      // 1. Gather: every slot's loads first",
         "      swf_stamp(5, 1);\n"
         "      // 1. Gather: every slot's loads first"),
        ("      // 2. The batches of the K run",
         "      {\n        const long long n_ = clock64();\n"
         "        swf_stamp(1, n_ - c_);\n        c_ = n_;\n      }\n"
         "      // 2. The batches of the K run"),
        ("        // Issue: ",
         "        {\n          const long long n_ = clock64();\n"
         "          swf_stamp(2, n_ - c_);\n          c_ = n_;\n"
         "          swf_stamp(6, 1);\n        }\n        // Issue: "),
        ("        wgmma_wait<1>();\n",
         "        wgmma_wait<1>();\n        {\n"
         "          const long long n_ = clock64();\n"
         "          swf_stamp(3, n_ - c_);\n          c_ = n_;\n        }\n"),
        ("    // 3. Resolve: winding = D",
         "    {\n      const long long n_ = clock64();\n"
         "      swf_stamp(3, n_ - c_);\n      c_ = n_;\n    }\n"
         "    // 3. Resolve: winding = D"),
        ("  product_store_words(a, words, chunk, s, f);\n}\n",
         "  product_store_words(a, words, chunk, s, f);\n"
         "  swf_stamp(4, clock64() - c_);\n  swf_stamp(7, 1);\n}\n"),
    ],
}
COARSE_FORMS = {
    "one slot a step, generic resolve": [
        ("    int* slot = ring + (n % kNBuf) * kRingWords;\n",
         "    const long long c0_ = clock64();\n"
         "    int* slot = ring + (n % kNBuf) * kRingWords;\n"),
        ("    // Placement of groups g0..g1: this chunk's deltas into the "
         "plane,\n",
         "    const long long c1_ = clock64();\n"
         "    // Placement of groups g0..g1: this chunk's deltas into the "
         "plane,\n"),
        ("    // In-chunk inclusive prefix (left to right), plus the carry.\n",
         "    const long long c2_ = clock64();\n"
         "    // In-chunk inclusive prefix (left to right), plus the "
         "carry.\n"),
        ("    // Resolve into the ring slot: nonzero rule, suffix-product\n",
         "    const long long c3_ = clock64();\n"
         "    // Resolve into the ring slot: nonzero rule, suffix-product\n"),
        ("    if (tid == 0) {\n      int* dst = a.out",
         "    const long long c4_ = clock64();\n"
         "    if (tid == 0) {\n      int* dst = a.out"),
        ("    ++n;\n  }\n  if (tid == 0) bulk_wait_all();\n}\n",
         "    swf_stamp(8, c1_ - c0_);\n    swf_stamp(9, c2_ - c1_);\n"
         "    swf_stamp(10, c3_ - c2_);\n    swf_stamp(11, c4_ - c3_);\n"
         "    swf_stamp(12, clock64() - c4_);\n    swf_stamp(14, 1);\n"
         "    ++n;\n  }\n  const long long d0_ = clock64();\n"
         "  if (tid == 0) bulk_wait_all();\n"
         "  swf_stamp(13, clock64() - d0_);\n  swf_stamp(15, 1);\n}\n"),
    ],
    "B1's body": [
        ("    int* slot = ring + (n % kNBuf) * kRingWords;\n",
         "    const long long c0_ = clock64();\n"
         "    int* slot = ring + (n % kNBuf) * kRingWords;\n"),
        ("    // Placement (B1's walk): ",
         "    const long long c1_ = clock64();\n"
         "    // Placement (B1's walk): "),
        ("    prefix_rows(sm.plane, sm.carry, L * kStripH);\n",
         "    const long long c2_ = clock64();\n"
         "    prefix_rows(sm.plane, sm.carry, L * kStripH);\n"),
        ("    // Resolve into the ring slot (B1's solid_pixel)",
         "    const long long c3_ = clock64();\n"
         "    // Resolve into the ring slot (B1's solid_pixel)"),
        ("    if (tid == 0) {\n      int* dst = a.out",
         "    const long long c4_ = clock64();\n"
         "    if (tid == 0) {\n      int* dst = a.out"),
        ("    ++n;\n    if constexpr (kOne) break;\n  }\n"
         "  if (tid == 0) bulk_wait_all();\n}\n",
         "    swf_stamp(8, c1_ - c0_);\n    swf_stamp(9, c2_ - c1_);\n"
         "    swf_stamp(10, c3_ - c2_);\n    swf_stamp(11, c4_ - c3_);\n"
         "    swf_stamp(12, clock64() - c4_);\n    swf_stamp(14, 1);\n"
         "    ++n;\n    if constexpr (kOne) break;\n  }\n"
         "  const long long d0_ = clock64();\n"
         "  if (tid == 0) bulk_wait_all();\n"
         "  swf_stamp(13, clock64() - d0_);\n  swf_stamp(15, 1);\n}\n"),
    ],
}


# Design elements measured beside the committed form, as edits (file,
# anchor, replacement) of its sources.
_B1_PLACE = (
    "    const int rc = static_cast<int>(rcf);\n"
    "    const int sp = kVar == kVarWin ? win : rc / nc8;\n"
    "    const int local = kVar == kVarWin ? rc : rc - sp * nc8;\n"
    "    const int ch = local >> 3;\n    const int lsp = sp - sp0;\n"
    "    if (ch > chunk || lsp < 0 || lsp >= a.spb) return;\n"
    "    if (layer < 0 || layer >= L) return;\n"
    "    const int row = layer * rows + lsp * kStripH + (local & 7);\n"
    "    if (ch == chunk) {\n"
    "      atomicAdd(&plane[row * kRowStride + static_cast<int>(cmf)], v);\n"
    "    } else {\n"
    "      // The 64-bit carry as two native 32-bit adds (a 64-bit shared\n"
    "      // atomicAdd is a compare-and-swap loop on this card): the adder\n"
    "      // that wraps the low word carries one into the high word, so the\n"
    "      // pair ends as the same sum modulo 2^64, whatever the order.\n"
    "      const unsigned long long q =\n"
    "          static_cast<unsigned long long>(to_fixed(v));\n"
    "      unsigned* word = reinterpret_cast<unsigned*>(&carry[row]);\n"
    "      const unsigned lo = static_cast<unsigned>(q);\n"
    "      const unsigned old = atomicAdd(&word[0], lo);\n"
    "      atomicAdd(&word[1], static_cast<unsigned>(q >> 32) +\n"
    "                              (old + lo < old ? 1u : 0u));\n    }\n",
    "    place_slot<kVar>(a, plane, carry, L, rows, chunk, sp0, nc8, v, rcf, "
    "cmf,\n                     layer, win);\n")
_B1_COLOURS = (
    "    unsigned eo = 0;\n    float4 creg[kLc <= 4 ? kLc : 1];\n"
    "#pragma unroll\n    for (int l = 0; l < kLc; ++l) {\n"
    "      if (l < L) {\n"
    "        eo |= (rule_s[l] != 0 ? 1u : 0u) << l;\n"
    "        if constexpr (kLc <= 4) {\n"
    "          creg[l] = reinterpret_cast<const float4*>(col_s)[l];\n"
    "        }\n      }\n    }\n"
    "    auto colour = [&](int l) -> float4 {\n"
    "      if constexpr (kLc <= 4) {\n        return creg[l];\n"
    "      } else {\n"
    "        return reinterpret_cast<const float4*>(col_s)[l];\n"
    "      }\n    };\n",
    "    const SolidColours<kLc> colour(col_s, rule_s, L);\n"
    "    const unsigned eo = colour.eo;\n")
_COARSE_BOUND = "__global__ void __launch_bounds__(kThreads)\ncoarse_kernel("
_PRODUCT_BOUND = ("      kLc != kSolidSmallLayers ? 1 : kAccs == 1 ? 3 : "
                  "2;\n")
_RING_WAIT = "    if (tid == 0 && n >= kNBuf) bulk_wait_read_ring();\n"
_SG_LOOP = "  for (int g0 = g_lo; g0 < g_hi; ++g0) {\n"
_RESOLVE_LOOP = "    for (int p = tid; p < kRingWords; p += nthr) {\n"


def _coarse_bound(blocks: str):
    """The coarse kernel's launch bound of ``blocks`` blocks an SM."""
    return ("flatblock.cu", _COARSE_BOUND,
            f"__global__ void __launch_bounds__(kThreads, {blocks})\n"
            "coarse_kernel(")


# The shared-memory base, or the layer count and the resolve's bound, made
# opaque each supergroup, so that nothing derived from them is hoisted out
# of the supergroup loop.
_OPAQUE_BASE = [
    ("coarse_device.cuh",
     "  const SolidSmem sm = solid_smem(smem, L, kStripH);\n"
     "  int* ring = reinterpret_cast<int*>(smem + sm.end);\n", ""),
    ("coarse_device.cuh", "    if (g1 < g0) continue;\n",
     "    if (g1 < g0) continue;\n    unsigned char* base_ = smem;\n"
     "    asm volatile(\"\" : \"+l\"(base_));\n"
     "    const SolidSmem sm = solid_smem(base_, L, kStripH);\n"
     "    int* ring = reinterpret_cast<int*>(base_ + sm.end);\n")]
_OPAQUE_L = [
    ("coarse_device.cuh", "    solid_setup(a, sm, L, kStripH, f);\n",
     "    int lv_ = L;\n    asm volatile(\"\" : \"+r\"(lv_));\n"
     "    const int L = lv_;\n    solid_setup(a, sm, L, kStripH, f);\n"),
    ("coarse_device.cuh", _RESOLVE_LOOP,
     "    for (int p = tid; p < (L > 0 ? kRingWords : 0); p += nthr) {\n")]
# The kernel's arguments copied to shared memory and read from there in
# the supergroup loop, so that their loads are not hoisted out of it.
_ARGS_SMEM = (
    "flatblock.cu",
    "  extern __shared__ __align__(16) unsigned char smem[];\n"
    "  coarse_block<kLc, kOne>(a, coarse, smem);\n",
    "  extern __shared__ __align__(16) unsigned char smem[];\n"
    "  __shared__ FusedArgs sa;\n  if (threadIdx.x == 0) sa = a;\n"
    "  __syncthreads();\n  coarse_block<kLc, kOne>(sa, coarse, smem);\n")
_NO_RING = (
    "coarse_device.cuh",
    "      slot[p] = static_cast<int>(solid_pixel<kLc>(\n",
    "      a.out[((static_cast<long long>(f) * a.ns1 + s) * kStripH + p / "
    "kLane) * stride + chunk * kLane + p % kLane] = static_cast<int>("
    "solid_pixel<kLc>(\n")
_ONE_SG = ("coarse_device.cuh", "    if constexpr (kOne) break;\n",
           "    break;\n")
VARIANTS = {
    "B1's place through place_slot": [("flatblock_device.cuh", *_B1_PLACE)],
    "B1's colours through SolidColours": [
        ("flatblock_device.cuh", *_B1_COLOURS)],
    "coarse: 4 blocks an SM by a register bound": [_coarse_bound("4")],
    "coarse: 5 blocks an SM by a register bound": [_coarse_bound("5")],
    "coarse: the ring wait without its count test": [
        ("coarse_device.cuh", _RING_WAIT,
         "    if (tid == 0) bulk_wait_read_ring();\n")],
    "coarse: the supergroup loop kept rolled": [
        ("coarse_device.cuh", _SG_LOOP, "#pragma unroll 1\n" + _SG_LOOP)],
    "coarse: the resolve loop kept rolled": [
        ("coarse_device.cuh", _RESOLVE_LOOP,
         "#pragma unroll 1\n" + _RESOLVE_LOOP)],
    "coarse: the shared-memory base opaque to each supergroup": _OPAQUE_BASE,
    "coarse: the base opaque and 4 blocks an SM by a register bound":
        _OPAQUE_BASE + [_coarse_bound("4")],
    "coarse: the layer count opaque to each supergroup": _OPAQUE_L,
    "coarse: the layer count opaque and 4 blocks an SM at four layers":
        _OPAQUE_L + [_coarse_bound("kLc == kSolidSmallLayers ? 4 : 1")],
    "coarse: the layer count opaque and 5 blocks an SM at four layers":
        _OPAQUE_L + [_coarse_bound("kLc == kSolidSmallLayers ? 5 : 1")],
    "coarse: the arguments read from shared memory": [_ARGS_SMEM],
    "coarse: the arguments in shared memory and 5 blocks an SM at four "
    "layers": [_ARGS_SMEM,
               _coarse_bound("kLc == kSolidSmallLayers ? 5 : 1")],
    "coarse: the arguments in shared memory and 4 blocks an SM at four "
    "layers": [_ARGS_SMEM,
               _coarse_bound("kLc == kSolidSmallLayers ? 4 : 1")],
    # Cuts that locate the coarse kernel's registers (not designs: the
    # second leaves supergroups past a block's first unresolved).
    "coarse cut: the words stored directly and no ring": [_NO_RING],
    "coarse cut: one supergroup a block": [_ONE_SG],
    "coarse cut: no ring and one supergroup a block": [_NO_RING, _ONE_SG],
    "coarse: the supergroup loop kept at coarse 1": [
        ("coarse_device.cuh", "    if constexpr (kOne) break;\n", "")],
    "coarse: a row's copy a thread (eight issuers)": [
        ("coarse_device.cuh", _RING_WAIT,
         "    if (tid < kStripH && n >= kNBuf) bulk_wait_read_ring();\n"),
        ("coarse_device.cuh",
         "    if (tid == 0) {\n"
         "      int* dst = a.out + (static_cast<long long>(f) * a.ns1 + s) * "
         "kStripH *\n"
         "                             stride + chunk * kLane;\n"
         "      for (int r8 = 0; r8 < kStripH; ++r8) {\n"
         "        bulk_copy_s2g(dst + static_cast<long long>(r8) * stride,\n"
         "                      slot + r8 * kLane, kLane * 4);\n"
         "      }\n      bulk_commit();\n    }\n",
         "    if (tid < kStripH) {\n"
         "      bulk_copy_s2g(a.out + ((static_cast<long long>(f) * a.ns1 + "
         "s) "
         "* kStripH + tid) * stride + chunk * kLane, slot + tid * kLane, "
         "kLane * 4);\n"
         "      bulk_commit();\n    }\n"),
        ("coarse_device.cuh", "  if (tid == 0) bulk_wait_all();\n",
         "  if (tid < kStripH) bulk_wait_all();\n")],
    "products: two slots' loads in flight": [
        ("place_mma_device.cuh",
         "constexpr int kProductLoads = kProductRounds;",
         "constexpr int kProductLoads = 2;")],
    "products: no register bound at four layers": [
        ("place_mma_device.cuh", _PRODUCT_BOUND,
         _PRODUCT_BOUND.replace("? 1 : kAccs == 1 ? 3 : 2", "? 1 : 1"))],
    "products: three blocks an SM for three accumulators": [
        ("place_mma_device.cuh", _PRODUCT_BOUND,
         _PRODUCT_BOUND.replace("kAccs == 1 ? 3 : 2", "3"))],
    # Cuts that locate the time (not designs: the words are wrong).
    "products cut: no carry": [
        ("place_mma_device.cuh",
         "                carry_add(&ps.carry[row], vs[u]);\n", ""),
        ("place_mma_device.cuh",
         "                atomicAdd(&carry_i[row], q);\n", "")],
    "products cut: no composite": [
        ("place_mma_device.cuh",
         "          }\n          words[i] = solid_pixel<kLc>(w, 1, colour, "
         "colour.eo, L);\n",
         "          }\n          words[i] = __float_as_uint(w[0] + w[kLc - "
         "1]);\n")],
    "products: four layers a pass at 16 layers": [
        ("place_mma_device.cuh",
         "  static constexpr int kLp = kAccs == 3 && kLc > 8 ? 8 : kLc;",
         "  static constexpr int kLp = kAccs == 3 && kLc > 8 ? 4 : kLc;")],
    "products: the pass loop kept rolled": [
        ("place_mma_device.cuh",
         "#pragma unroll\n  for (int pass = 0; pass < P::kPasses; ++pass) {",
         "#pragma unroll 1\n"
         "  for (int pass = 0; pass < P::kPasses; ++pass) {")],
    "products: four blocks an SM for one accumulator": [
        ("place_mma_device.cuh", _PRODUCT_BOUND,
         _PRODUCT_BOUND.replace("kAccs == 1 ? 3 : 2", "kAccs == 1 ? 4 : 2"))],
}


def _stamp(text: str, forms: dict, what: str):
    """``text`` with the first applicable form's edits: (form, text)."""
    for name, edits in forms.items():
        if all(text.count(old) == 1 for old, _ in edits):
            for old, new in edits:
                text = text.replace(old, new)
            return name, text
    bad = {name: [old[:50] for old, _ in edits if text.count(old) != 1]
           for name, edits in forms.items()}
    raise SystemExit(f"{what} matches no stamped form: {bad}")


def stamped_sources(d: pathlib.Path):
    """Stamp the copy of ``csrc`` in ``d`` in place: (lmask form, coarse
    form)."""
    head = "namespace swf {\n"
    dev = d / "flatblock_device.cuh"
    dev.write_text(dev.read_text().replace(head, head + _HELPER, 1))
    forms = []
    for name, table in (("place_mma_device.cuh", LMASK_FORMS),
                        ("coarse_device.cuh", COARSE_FORMS)):
        form, text = _stamp((d / name).read_text(), table, name)
        (d / name).write_text(text)
        forms.append(form)
    (d / "flatblock.cu").write_text((d / "flatblock.cu").read_text() + _READ)
    return tuple(forms)


def census(lib: pathlib.Path):
    """{kernel: sass_census + HMMA / HGMMA / IMMA / IGMMA / UBLKCP / BAR.SYNC
    counts} of the product, coarse and B1 (kVarFull) kernels."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    heads = list(re.finditer(r"Function : (\S+)", text))
    out = {}
    for i, m in enumerate(heads):
        name = m.group(1)
        if not re.search(r"product_kernel|coarse_kernel|"
                         r"solid_flatblock_kernelILi0E", name):
            continue
        body = text[m.end():heads[i + 1].start() if i + 1 < len(heads)
                    else len(text)]
        v = sass_census(body)
        v["loops"] = v["loops"][:4]
        # (a GMMA into RZ is the null one ptxas adds at a commit)
        for key, pattern in (("hmma", r"\bHMMA\."),
                             ("hgmma", r"\bHGMMA\.\S+\s+(?!RZ\b)"),
                             ("imma", r"\bIMMA\."),
                             ("igmma", r"\bIGMMA\.\S+\s+(?!RZ\b)"),
                             ("ublkcp", r"\bUBLKCP\b"),
                             ("bar_sync", r"\bBAR\.SYNC")):
            v[key] = len(re.findall(pattern, body))
        out[name] = v
    return out


def sass_against(mine: pathlib.Path, theirs: pathlib.Path):
    """Kernels of two builds whose SASS text is identical, differs, or is
    in one build only (blanks collapsed, each kernel's own name blanked,
    as ``chip_smoke.py``'s ``ab_sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"

    def words(path):
        text = subprocess.run([tool, "-sass", str(path)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        heads = list(re.finditer(r"Function : (\S+)", text))
        return {m.group(1): " ".join(
            text[m.end():heads[i + 1].start() if i + 1 < len(heads)
                 else len(text)].replace(m.group(1), "<self>").split())
            for i, m in enumerate(heads)}

    a, b = words(mine), words(theirs)
    return {"identical": sorted(k for k in a if b.get(k) == a[k]),
            "differ": sorted(k for k in a if k in b and b[k] != a[k]),
            "only_change": sorted(k for k in a if k not in b),
            "only_other": sorted(k for k in b if k not in a)}


def build_all(cuda_lib, tmp, sources):
    """{name: csrc dir} -> {name: (bound swfkernels library, path)},
    ptxas logs, errors; one nvcc a build, all started together."""
    import threading

    libs, logs, errors = {}, {}, {}

    def one(i, name, d):
        path = tmp / f"libkernels_{i}.so"
        try:
            logs[name] = cuda_lib._nvcc_all(d, {"swfkernels": path})
            libs[name] = (cuda_lib.bind("swfkernels",
                                        ctypes.CDLL(str(path))), path)
        except Exception as exc:  # reported below
            errors[name] = str(exc)[-3000:]

    threads = [threading.Thread(target=one, args=(i, *item))
               for i, item in enumerate(sources.items())]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return libs, logs, errors


def forms(torch, d, cols, frames, layers):
    """name -> zero-argument call of every timed kernel on ``d``."""
    from ..ops.flatblock import render_fused_blocksn
    from . import exp_dma, exp_int8, exp_k3, exp_lmask, exp_split

    g = exp_split.GROUP
    a = tuple(d[k] for k in ("sidx", "flags", "lays", "urc", "ucm",
                             "uval")) + (cols, frames, layers, d["ns"],
                                         d["nc"])
    limbs = exp_int8.limbs_to_device(d)
    a8 = a[:5] + tuple(limbs) + a[6:]
    out = {"b1": lambda: render_fused_blocksn(*a, group=g),
           "lmask": lambda: exp_lmask.render_lmask(*a, group=g)}
    for c in COARSES:
        out[f"coarse{c}"] = (lambda c=c: exp_dma.run_variant(*a, g, c))
    out["k3_three"] = lambda: exp_k3.run_variant(*a, g, False)
    out["k3_concat"] = lambda: exp_k3.run_variant(*a, g, True)
    out["int8"] = lambda: exp_int8.run_int8(*a8, g)
    return out


def main() -> None:
    import sys

    import torch

    from ..ops import cuda_lib
    from ..utils.scenes import build_scene_edges
    from . import exp_split

    parser = argparse.ArgumentParser()
    parser.add_argument("--csrc", type=pathlib.Path,
                        default=cuda_lib.CSRC_DIR)
    parser.add_argument("--parent", type=pathlib.Path, default=None,
                        help="another checkout's csrc, timed beside")
    parser.add_argument("--build", action="append", default=[],
                        metavar="NAME=DIR",
                        help="another csrc directory, timed beside")
    parser.add_argument("--variants", nargs="?", const="", default=None,
                        metavar="NAME,...",
                        help="also build and time VARIANTS (all, or these)")
    parser.add_argument("--rounds", type=int, default=1,
                        help="passes there and back over the builds")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("design_phases needs a CUDA card")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="design_phases_"))
    mine = cuda_lib._libs.get("swfkernels")
    try:
        sources = {"change": tmp / "change", "stamped": tmp / "stamped"}
        shutil.copytree(args.csrc, sources["change"])
        shutil.copytree(args.csrc, sources["stamped"])
        stamp_forms = stamped_sources(sources["stamped"])
        if args.parent is not None:
            sources["parent"] = tmp / "parent"
            shutil.copytree(args.parent, sources["parent"])
        for i, spec in enumerate(args.build):
            name, _, d = spec.partition("=")
            sources[name] = tmp / f"build{i}"
            shutil.copytree(d, sources[name])
        skipped = []
        if args.variants is not None:
            wanted = set(args.variants.split(",")) if args.variants else \
                set(VARIANTS)
            unknown = sorted(wanted - set(VARIANTS))
            if unknown:
                raise SystemExit(f"unknown variants {unknown}")
            for i, (name, edits) in enumerate(VARIANTS.items()):
                if name not in wanted:
                    continue
                d = tmp / f"variant{i}"
                if variant_sources(args.csrc, d, edits):
                    sources[name] = d
                else:
                    skipped.append(name)
        libs, logs, errors = build_all(cuda_lib, tmp, sources)
        if "change" not in libs or "stamped" not in libs:
            raise SystemExit(f"build failed: {errors}")
        stamps = libs["stamped"][0]
        stamps.swf_ds_stamps.restype = ctypes.c_int
        stamps.swf_ds_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        ptx = {n: {k: ptxas_of(log, k) for k in set(re.findall(
                   r"Compiling entry function '(\w*(?:product_kernel|"
                   r"coarse_kernel|solid_flatblock_kernelILi0E)\w*)'", log))}
               for n, log in logs.items()}
        for n, log in logs.items():
            warn = [ln.strip() for ln in log.splitlines()
                    if "wgmma" in ln.lower() or "warning" in ln.lower()]
            if warn:
                ptx[n]["warnings"] = warn[:20]
        sass = {n: census(libs[n][1]) for n in libs if n != "stamped"}
        base = "parent" if "parent" in libs else "change"
        against = {n: sass_against(libs[n][1], libs[base][1])
                   for n in libs if n not in (base, "stamped")}
        print(json.dumps({"csrc": str(args.csrc), "stamp_forms": stamp_forms,
                          "build_errors": errors,
                          "variants_not_applied": skipped, "ptxas": ptx,
                          "sass": sass, "sass_against_" + base: against}),
              flush=True)

        frames, layers, height, width = exp_split.HEADLINE
        tables, colors = build_scene_edges(frames, layers, height, width,
                                           seed=7)
        d = exp_split.pack(tables, height, width, "cuda")
        cols = torch.as_tensor(colors, device="cuda")
        ns = d["ns"]
        calls = forms(torch, d, cols, frames, layers)
        order = ["parent"] * ("parent" in libs) + ["change"] + [
            n for n in libs if n not in ("parent", "change", "stamped")]
        cuda_lib._libs["swfkernels"] = libs["change"][0]
        b1 = calls["b1"]()[:, :ns].clone()
        check = {}
        for n in order + ["stamped"]:
            cuda_lib._libs["swfkernels"] = libs[n][0]
            row = {}
            for key, fn in calls.items():
                got = fn()[:, :ns]
                torch.cuda.synchronize()
                levels, share = exp_split.byte_diff(got, b1)
                row[key] = {"equal_b1": bool(torch.equal(got, b1)),
                            "levels": levels, "share": share}
                del got
            check[n] = row
        times = {n: {k: [] for k in calls} for n in order}
        for names in (order, order[::-1]) * args.rounds:
            for n in names:
                print(f"design_phases: timing {n}", file=sys.stderr,
                      flush=True)
                cuda_lib._libs["swfkernels"] = libs[n][0]
                for key, fn in calls.items():
                    times[n][key].append(time_ms(torch, fn))
        print(json.dumps({"groups": int(d["sidx"].shape[0]),
                          "check": check, "ms": times}), flush=True)

        cuda_lib._libs["swfkernels"] = stamps
        buf = (ctypes.c_ulonglong * 16)()
        stages = {}
        for key in PRODUCTS + tuple(f"coarse{c}" for c in COARSES):
            calls[key]()   # warm
            torch.cuda.synchronize()
            if stamps.swf_ds_stamps(buf, 1) != 0:
                raise SystemExit("stamp reset failed")
            calls[key]()
            torch.cuda.synchronize()
            if stamps.swf_ds_stamps(buf, 0) != 0:
                raise SystemExit("stamp read failed")
            if key in PRODUCTS:
                names, counts, base = LMASK_STAGES, LMASK_COUNTS, 0
            else:
                names, counts, base = COARSE_STAGES, COARSE_COUNTS, 8
            total = sum(buf[base + i] for i in range(len(names)))
            row = {"cycles": {s: buf[base + i] for i, s in enumerate(names)},
                   "share": {s: buf[base + i] / max(total, 1)
                             for i, s in enumerate(names)}}
            row.update({k: buf[i] for k, i in counts.items()})
            unit = "groups" if key in PRODUCTS else "supergroups"
            row[f"cycles_a_{unit[:-1]}"] = total / max(row[unit], 1)
            stages[key] = row
        print(json.dumps({"stages": stages}), flush=True)
    finally:
        if mine is None:
            cuda_lib._libs.pop("swfkernels", None)
        else:
            cuda_lib._libs["swfkernels"] = mine
        shutil.rmtree(tmp, ignore_errors=True)
    print(card_line())


if __name__ == "__main__":
    main()
