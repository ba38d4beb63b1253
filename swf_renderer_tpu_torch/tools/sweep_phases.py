"""Where the sweep kernels' time goes: the column sweeps (B3 affine, solid
and styled; B6 morph + affine; B7 morph ratio), the row-band sweep (B4)
and the compacted sweep (B5).

    python3 -m swf_renderer_tpu_torch.tools.sweep_phases [--csrc DIR]
        [--parent DIR] [--build NAME=DIR] [--variants [NAME,...]]
        [--cases NAME,...] [--rounds N]

Needs one NVIDIA card and ``nvcc``.  Builds ``sweep.cu`` from ``DIR``
(default: this package's ``csrc``) as it is, a copy with ``clock64()``
stamps around the phases of ``tile_sweep_block`` (and of the generic
``sweep_block`` where the source still has it, as the parents of the
morph redesign do, and of the compacted body, ``bin_sweep_block`` or a
parent's first design: setup, the walk's hit list, its scatter, the row
prefix or zero test, the resolve, the zeroed tiles' stores; thread 0's
cycles summed over blocks into a device array)
and a copy whose main kernels return at once (the bounds pre-pass
alone).  On the animation benchmark scene uncut (anim1080: 60 frames x
3 layers x 1088x1920, solid and with a fading gradient layer; also
through the compacted tiling on ``compact_pre``'s tables of the host
plan, the kernel alone), one interactive F = 1 frame of it (a field
layer, as the renderer's bitmap loop sends), 16 layers of it,
morph_affine1080 (16 frames, column and row bands) and morph1080 (16
ratios), built as ``chip_smoke.py`` builds them, it prints for each
case: ms of every
build (twice, in the order parent, change, the rest, then back), each
output against ``sweep_plain`` (equal words), cycles a block and each
phase's share, ptxas registers / stack / spills, the SASS instruction
count with its CALLs, its shared atomics by kind and its loops; and, on
the card's own tables, the pieces a tile walks (64-, 32- and 16-piece
chunks), the (piece, row) pairs that land in it and the columns each
scatters (mean, most), and the share of tiles no piece reaches and of
tiles whose windings are all 0 (compacted: the pieces gathered a bin
and those a bin's walk reads at 64- and 16-piece row bounds; a parent
build is handed its 64-piece bounds).  ``--parent`` builds another checkout's
``csrc`` beside, ``--build NAME=DIR`` any other ``csrc`` directory,
``--variants`` the design elements of ``VARIANTS`` (edits of the
committed form; all, or the named ones), ``--cases`` only the named
cases, ``--rounds`` N passes there and back over the builds (1).  One
JSON object of the builds, one a case, then the card's name and power
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

from .coverage_phases import ptxas_of, variant_sources
from .timing import card_line, time_ms

FRAMES, HEIGHT, WIDTH, MORPH_FRAMES = 60, 1088, 1920, 16
# Stamp slots: a base (0 the column sweep, 8 the row bands) + phase.
PHASES = ("setup", "hit_list", "scatter", "prefix", "resolve", "zero_store")
KERNELS = {"column": 0, "rows": 8, "compact": 0}   # kind -> stamp base
# Kernel -> mangled-name fragments: the current form's first, then the
# one before it (B3's two-parameter sweep_tile_kernel<kStyled, kLc>, and
# the generic sweep_kernel with 64-piece bounds that ran B6 and B7 before
# they moved onto tile_sweep_block).
NAMES = {
    "column_solid": ("sweep_tile_kernelILb0ELb1ELb0ELi4E",
                     "sweep_tile_kernelILb0ELi4E"),
    "column_styled": ("sweep_tile_kernelILb0ELb1ELb1E",
                      "sweep_tile_kernelILb1ELi16E"),
    "column_solid_16": ("sweep_tile_kernelILb0ELb1ELb0ELi16E",
                        "sweep_tile_kernelILb0ELi16E"),
    "column_morph_affine": ("sweep_tile_kernelILb1ELb1ELb0ELi4E",
                            "sweep_kernelILb1ELb1ELb0E"),
    "column_morph": ("sweep_tile_kernelILb1ELb0ELb0ELi4E",
                     "sweep_kernelILb1ELb0ELb0E"),
    "rows_solid": ("sweep_rows_kernelILb0ELb1ELb0ELi4E",),
    "rows_styled": ("sweep_rows_kernelILb0ELb1ELb1E",),
    "rows_morph": ("sweep_rows_kernelILb1ELb1ELb0ELi4E",),
    "compact_solid": ("sweep_bin_kernelILb0ELi4E",
                      "sweep_compact_kernelILb0EE"),
    "compact_styled": ("sweep_bin_kernelILb1ELi16E",
                       "sweep_compact_kernelILb1EE"),
    "bounds": ("fine_bounds_kernelILb0ELb1E",),
    "bounds_morph_affine": ("fine_bounds_kernelILb1ELb1E",
                            "sweep_bounds_kernelILb1ELb1E"),
    "bounds_morph": ("fine_bounds_kernelILb1ELb0E",
                     "sweep_bounds_kernelILb1ELb0E"),
}

_HELPER = """
__device__ unsigned long long swf_sw_stamp[16];
// Thread 0 of the block adds v at slot k.
__device__ __forceinline__ void swf_stamp(int k, long long v) {
  if (threadIdx.x == 0) {
    atomicAdd(&swf_sw_stamp[k], static_cast<unsigned long long>(v));
  }
}
"""

_READ = """
extern "C" int swf_sw_stamps(unsigned long long* host, int zero) {
  if (zero) {
    unsigned long long z[16] = {0};
    return (int)cudaMemcpyToSymbol(swf::swf_sw_stamp, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(host, swf::swf_sw_stamp,
                                   16 * sizeof(unsigned long long));
}
"""

# (anchor, replacement) edits of sweep_device.cuh that stamp the phases,
# per form of the source; every form whose anchors all occur exactly
# once is applied (the parent of the morph redesign holds both).  Slots of a base: +0 setup, +1 hit list, +2 scatter, +3
# prefix, +4 resolve, +5 a zeroed tile's stores, +6 tiles (row bands:
# chunks), +7 zeroed tiles.
_WALK = [
    ("  const int n_pairs = L * n_chunks;\n"
     "  for (int base = 0; base < n_pairs; base += kSweepMaxHits) {\n"
     "    if (tid == 0) *s.n_hits = 0;\n",
     "  const int n_pairs = L * n_chunks;\n"
     "  const int sb_ = stride == kLane + 1 ? 0 : 8;\n"
     "  for (int base = 0; base < n_pairs; base += kSweepMaxHits) {\n"
     "    const long long w0_ = clock64();\n"
     "    if (tid == 0) *s.n_hits = 0;\n"),
    ("    __syncthreads();\n    const int n_hits = *s.n_hits;\n",
     "    __syncthreads();\n    const long long w1_ = clock64();\n"
     "    swf_stamp(sb_ + 1, w1_ - w0_);\n"
     "    const int n_hits = *s.n_hits;\n"),
    ("    __syncthreads();   // the next round rewrites the list\n  }\n}\n",
     "    __syncthreads();   // the next round rewrites the list\n"
     "    swf_stamp(sb_ + 2, clock64() - w1_);\n  }\n}\n"),
]
FORMS = {
    "generic column": _WALK + [
        ("  for (int i = tid; i < a.layers * R * stride; i += nthr) "
         "s.plane[i] = 0;\n"
         "  sweep_setup<kMorph, kAffine, kStyled>(a, s, f, t, omt);\n",
         "  const long long st0_ = clock64();\n"
         "  for (int i = tid; i < a.layers * R * stride; i += nthr) "
         "s.plane[i] = 0;\n"
         "  sweep_setup<kMorph, kAffine, kStyled>(a, s, f, t, omt);\n"
         "  swf_stamp(0, clock64() - st0_);\n"),
        ("  if (*touched_s == 0) {\n"
         "    sweep_zero_tile(a, f, r0, tile_h, c0, tile_w);\n"
         "    return;\n  }\n"
         "  sweep_row_prefix(s.plane, a.layers * R, stride);\n"
         "  __syncthreads();\n",
         "  swf_stamp(6, 1);\n  const long long st2_ = clock64();\n"
         "  if (*touched_s == 0) {\n"
         "    sweep_zero_tile(a, f, r0, tile_h, c0, tile_w);\n"
         "    __syncthreads();\n    swf_stamp(5, clock64() - st2_);\n"
         "    swf_stamp(7, 1);\n    return;\n  }\n"
         "  sweep_row_prefix(s.plane, a.layers * R, stride);\n"
         "  __syncthreads();\n  const long long st3_ = clock64();\n"
         "  swf_stamp(3, st3_ - st2_);\n"),
        ("  sweep_resolve<kStyled>(a, s, f, stride, r0, tile_h, c0, "
         "tile_w);\n}\n",
         "  sweep_resolve<kStyled>(a, s, f, stride, r0, tile_h, c0, "
         "tile_w);\n  __syncthreads();\n"
         "  swf_stamp(4, clock64() - st3_);\n}\n"),
    ],
}

FORMS["warp scan, register composite"] = [
    ("  tile_setup<kMorph, kAffine, kStyled>(\n"
     "      a, s, smem, tile_zeroed_bytes(L, R, kTileW) / 16, f, t, omt);\n",
     "  constexpr int sb_ = kBand ? 8 : 0;\n"
     "  const long long st0_ = clock64();\n"
     "  tile_setup<kMorph, kAffine, kStyled>(\n"
     "      a, s, smem, tile_zeroed_bytes(L, R, kTileW) / 16, f, t, omt);\n"
     "  swf_stamp(sb_, clock64() - st0_);\n"),
    ("  const int n_listed = listed ? tile_hits(s, bounds, 0, n_pairs, r0f, "
     "r1f)\n                              : 0;\n",
     "  const long long sh0_ = clock64();\n"
     "  const int n_listed = listed ? tile_hits(s, bounds, 0, n_pairs, r0f, "
     "r1f)\n                              : 0;\n"
     "  swf_stamp(sb_ + 1, clock64() - sh0_);\n"),
    ("    if (c0 > c_first) {\n      __syncthreads();   // the previous "
     "chunk's resolve has read the planes\n",
     "    if (c0 > c_first) {\n      const long long sc0_ = clock64();\n"
     "      __syncthreads();   // the previous chunk's resolve has read the "
     "planes\n"),
    ("                                 : tile_zeroed_bytes(L, R, kTileW) / "
     "16);\n      __syncthreads();\n    }\n"
     "    if (listed) {\n"
     "      tile_place<kMorph, kAffine>(a, s, n_listed, t, omt, kTileW, r0, "
     "r1,\n                                  c0, c1, carry);\n",
     "                                 : tile_zeroed_bytes(L, R, kTileW) / "
     "16);\n      __syncthreads();\n"
     "      swf_stamp(sb_, clock64() - sc0_);\n    }\n"
     "    const long long sw_ = clock64();\n"
     "    if (listed) {\n"
     "      tile_place<kMorph, kAffine>(a, s, n_listed, t, omt, kTileW, r0, "
     "r1,\n                                  c0, c1, carry);\n"
     "      __syncthreads();\n      swf_stamp(sb_ + 2, clock64() - sw_);\n"),
    ("        const int n_hits = tile_hits(s, bounds, base, n_pairs, r0f, "
     "r1f);\n        tile_place<kMorph, kAffine>(a, s, n_hits, t, omt, "
     "kTileW, r0, r1,\n                                    c0, c1, carry);"
     "\n        __syncthreads();   // the next round rewrites the list\n",
     "        const long long sh_ = clock64();\n"
     "        const int n_hits = tile_hits(s, bounds, base, n_pairs, r0f, "
     "r1f);\n        const long long sp_ = clock64();\n"
     "        swf_stamp(sb_ + 1, sp_ - sh_);\n"
     "        tile_place<kMorph, kAffine>(a, s, n_hits, t, omt, "
     "kTileW, r0, r1,\n                                    c0, c1, carry);"
     "\n        __syncthreads();   // the next round rewrites the list\n"
     "        swf_stamp(sb_ + 2, clock64() - sp_);\n"),
    ("    __syncthreads();\n    // Every winding of the tile is 0 when no "
     "piece reached its columns\n",
     "    __syncthreads();\n    const long long sz_ = clock64();\n"
     "    // Every winding of the tile is 0 when no piece reached its "
     "columns\n"),
    ("    __syncthreads();\n    if (*s.touched == 0) {\n"
     "      tile_zero_words(a, f, r0, tile_h, c0, c1 - c0);\n"
     "      continue;\n    }\n"
     "    tile_resolve<kStyled, kLc, kTileW>(a, s, f, r0, tile_h, c0, c1 - "
     "c0,\n                                       eo, creg);\n  }\n}\n",
     "    __syncthreads();\n    swf_stamp(sb_ + 6, 1);\n"
     "    const long long sr_ = clock64();\n"
     "    swf_stamp(sb_ + 3, sr_ - sz_);\n"
     "    if (*s.touched == 0) {\n"
     "      tile_zero_words(a, f, r0, tile_h, c0, c1 - c0);\n"
     "      __syncthreads();\n      swf_stamp(sb_ + 5, clock64() - sr_);\n"
     "      swf_stamp(sb_ + 7, 1);\n      continue;\n    }\n"
     "    tile_resolve<kStyled, kLc, kTileW>(a, s, f, r0, tile_h, c0, c1 - "
     "c0,\n                                       eo, creg);\n"
     "    __syncthreads();\n    swf_stamp(sb_ + 4, clock64() - sr_);\n"
     "  }\n}\n"),
]
# In the redesigned form "prefix" is the zero test of the windings and
# "resolve" the warp scan with the resolve.  Since the column sweeps took
# the shard origin, the walk reads the global columns g0, g1 and the
# resolve the origin x0: the same stamps on that text.
FORMS["warp scan, register composite, at the origin"] = [
    tuple(t.replace("c0, c1, carry);", "g0, g1, carry);")
           .replace("eo, creg);", "eo, creg, x0);") for t in edit)
    for edit in FORMS["warp scan, register composite"]]

# The first design's compacted body (a parent checkout's, before B5 moved
# onto the tiled body): its bins' set-up (zeroing and prefix seeds)
# counts as setup, the walk's hit list and scatter as _WALK's.
FORMS["first compacted body"] = _WALK + [
    ("  sweep_setup<kStyled>(a, s, f);\n"
     "  for (int k = 0; k < a.bins_per_block; ++k) {\n",
     "  const long long st0_ = clock64();\n"
     "  sweep_setup<kStyled>(a, s, f);\n"
     "  swf_stamp(0, clock64() - st0_);\n"
     "  for (int k = 0; k < a.bins_per_block; ++k) {\n"),
    ("    __syncthreads();   // the previous bin's resolve has read the "
     "planes\n    if (tid == 0) *s.touched = 0;\n",
     "    const long long sb0_ = clock64();\n"
     "    __syncthreads();   // the previous bin's resolve has read the "
     "planes\n    if (tid == 0) *s.touched = 0;\n"),
    ("        s.plane[(static_cast<long long>(l) * R + r) * stride] = q;\n"
     "        *s.touched = 1;\n      }\n    }\n",
     "        s.plane[(static_cast<long long>(l) * R + r) * stride] = q;\n"
     "        *s.touched = 1;\n      }\n    }\n"
     "    swf_stamp(0, clock64() - sb0_);\n"),
    ("    __syncthreads();\n    if (*s.touched == 0) {\n"
     "      sweep_zero_tile(a, f, r0, tile_h, c0, c1 - c0);\n"
     "      continue;\n    }\n"
     "    sweep_row_prefix(s.plane, L * R, stride);\n    __syncthreads();\n"
     "    sweep_resolve<kStyled>(a, s, f, stride, r0, tile_h, c0, c1 - c0);"
     "\n  }\n}\n",
     "    __syncthreads();\n    swf_stamp(6, 1);\n"
     "    const long long sz_ = clock64();\n    if (*s.touched == 0) {\n"
     "      sweep_zero_tile(a, f, r0, tile_h, c0, c1 - c0);\n"
     "      __syncthreads();\n      swf_stamp(5, clock64() - sz_);\n"
     "      swf_stamp(7, 1);\n      continue;\n    }\n"
     "    sweep_row_prefix(s.plane, L * R, stride);\n    __syncthreads();\n"
     "    const long long sp_ = clock64();\n    swf_stamp(3, sp_ - sz_);\n"
     "    sweep_resolve<kStyled>(a, s, f, stride, r0, tile_h, c0, c1 - c0);"
     "\n    __syncthreads();\n    swf_stamp(4, clock64() - sp_);\n"
     "  }\n}\n"),
]

# The compacted tiling on the tiled body (bin_sweep_block): a tile's
# zeroing, prefix seeds and first hit list count as setup.
FORMS["bins on the tiled body"] = [
    ("  tile_setup<false, false, kStyled>(\n"
     "      a, s, smem, tile_zeroed_bytes(L, R, kLane) / 16, f, 0.0f, 1.0f);"
     "\n",
     "  const long long st0_ = clock64();\n"
     "  tile_setup<false, false, kStyled>(\n"
     "      a, s, smem, tile_zeroed_bytes(L, R, kLane) / 16, f, 0.0f, 1.0f);"
     "\n  swf_stamp(0, clock64() - st0_);\n"),
    ("      // The first walk round's row bounds and this thread's prefix "
     "seed\n",
     "      const long long sc0_ = clock64();\n"
     "      // The first walk round's row bounds and this thread's prefix "
     "seed\n"),
    ("      __syncthreads();   // the seeds and the list are in place\n",
     "      __syncthreads();   // the seeds and the list are in place\n"
     "      const long long sp_ = clock64();\n"
     "      swf_stamp(0, sp_ - sc0_);\n"),
    ("        bin_place(a, s, fb, n_hits, r0, r1, c0, c1);\n"
     "        __syncthreads();\n      }\n",
     "        bin_place(a, s, fb, n_hits, r0, r1, c0, c1);\n"
     "        __syncthreads();\n      }\n"
     "      const long long sz_ = clock64();\n"
     "      swf_stamp(2, sz_ - sp_);\n"),
    ("      __syncthreads();\n      dirty = *s.touched != 0;\n"
     "      if (!dirty) {\n"
     "        tile_zero_words<true>(a, f, r0, tile_h, c0, c1 - c0);\n"
     "        continue;\n      }\n"
     "      tile_resolve<kStyled, kLc, kLane, true>(a, s, f, r0, tile_h, c0,"
     "\n                                              c1 - c0, eo, creg);\n"
     "    }\n",
     "      __syncthreads();\n      swf_stamp(6, 1);\n"
     "      const long long sr_ = clock64();\n"
     "      swf_stamp(3, sr_ - sz_);\n      dirty = *s.touched != 0;\n"
     "      if (!dirty) {\n"
     "        tile_zero_words<true>(a, f, r0, tile_h, c0, c1 - c0);\n"
     "        __syncthreads();\n        swf_stamp(5, clock64() - sr_);\n"
     "        swf_stamp(7, 1);\n        continue;\n      }\n"
     "      tile_resolve<kStyled, kLc, kLane, true>(a, s, f, r0, tile_h, c0,"
     "\n                                              c1 - c0, eo, creg);\n"
     "      __syncthreads();\n      swf_stamp(4, clock64() - sr_);\n"
     "    }\n"),
]

# The copy whose main kernels return at once: the bounds pre-pass alone
# (the kernel bodies of every form of sweep.cu; those that occur).
_BOUNDS_ONLY = (
    "  sweep_block<kMorph, kAffine, kStyled>(a, smem);\n",
    "  tile_sweep_block<false, true, kStyled, kLc, kLane>(a, smem);\n",
    "  tile_sweep_block<kMorph, kAffine, kStyled, kLc, kLane>(a, smem);\n",
    "  tile_sweep_block<kMorph, kAffine, kStyled, kLc, kRowChunk>(a, "
    "smem);\n",
)

# Design elements measured beside the committed form, as edits
# (file, anchor, replacement) of its sources.
_LEFT = "      add_fixed(&lcarry[ri], to_fixed(dy));\n      continue;\n"
VARIANTS = {
    "left pieces mark the tile": [
        ("sweep_device.cuh", _LEFT,
         "      add_fixed(&lcarry[ri], to_fixed(dy));\n"
         "      *touched_s = 1;\n      continue;\n")],
    "64-bit shared atomics": [
        ("sweep_device.cuh",
         "  const unsigned long long u = static_cast<unsigned long long>(q);"
         "\n  unsigned* w",
         "  atomicAdd(reinterpret_cast<unsigned long long*>(slot),\n"
         "            static_cast<unsigned long long>(q));\n  return;\n"
         "  const unsigned long long u = static_cast<unsigned long long>(q);"
         "\n  unsigned* w")],
    "layer class 16 at any count": [
        ("sweep.cu", "    if (solid_layer_class(a.layers) != "
                     "kSolidSmallLayers) {",
         "    if (true) {")],
    "64-piece chunks": [("sweep_device.cuh", "kFineChunk = 16;",
                         "kFineChunk = 64;")],
    "one tile a block": [("sweep_device.cuh", "kTileRun = 5;",
                          "kTileRun = 1;")],
    "three tiles a block": [("sweep_device.cuh", "kTileRun = 5;",
                             "kTileRun = 3;")],
    "no register bound": [
        ("sweep.cu", "__launch_bounds__(kThreads, tile_min_blocks(kStyled, "
                     "kLc))\n    sweep_tile_kernel",
         "__launch_bounds__(kThreads)\n    sweep_tile_kernel"),
        ("sweep.cu", "__launch_bounds__(kThreads, tile_min_blocks(kStyled, "
                     "kLc))\n    sweep_rows_kernel",
         "__launch_bounds__(kThreads)\n    sweep_rows_kernel")],
    "two blocks an SM at 16 layers": [
        ("sweep_device.cuh",
         "  return styled || lc <= kSolidSmallLayers ? 2 : 3;",
         "  return 2;")],
    "B4 lists its hits a chunk": [
        ("sweep_device.cuh",
         "const bool listed = (kBand || run > 1) && n_pairs <= "
         "kSweepMaxHits;",
         "const bool listed = !kBand && run > 1 && n_pairs <= "
         "kSweepMaxHits;")],
    "runs of five tiles or one (the earlier rule)": [
        ("sweep_device.cuh", "  for (int run = kTileRun; run > 1; --run) {",
         "  for (int run = kTileRun; run > 1; run = 1) {")],
    "32-piece chunks": [("sweep_device.cuh", "kFineChunk = 16;",
                         "kFineChunk = 32;")],
    "tile runs from 1024 blocks": [
        ("sweep_device.cuh", "kTileRunBlocks = 2048;",
         "kTileRunBlocks = 1024;")],
    "B5 re-zeroes its planes every tile": [
        ("sweep_device.cuh",
         "        if (dirty) tile_zero_smem(smem, plane16);\n",
         "        tile_zero_smem(smem, plane16);\n")],
    "no all-zero pixel shortcut": [
        ("sweep_device.cuh", "          words[k] = blank ? 0u\n",
         "          words[k] = false ? 0u\n"),
        ("sweep_device.cuh",
         "  if (blank[0] && blank[1] && blank[2] && blank[3]) {",
         "  if (false) {"),
        ("sweep_device.cuh",
         "    words[k] = blank[k] ? 0u : quantize_pack(alpha_out[k], pm[k]);",
         "    words[k] = quantize_pack(alpha_out[k], pm[k]);")],
}


def stamped_source(text: str):
    """sweep_device.cuh with the phase stamps: (form names, text)."""
    names = []
    for name, edits in FORMS.items():
        if all(text.count(old) == 1 for old, _ in edits):
            for old, new in edits:
                text = text.replace(old, new)
            names.append(name)
    if not names:
        bad = {name: [old[:60] for old, _ in edits if text.count(old) != 1]
               for name, edits in FORMS.items()}
        raise SystemExit(f"sweep_device.cuh matches no stamped form: {bad}")
    head = "namespace swf {\n"
    return " + ".join(names), text.replace(head, head + _HELPER, 1)


def bounds_only_sources(csrc: pathlib.Path, dest: pathlib.Path):
    """A copy of ``csrc`` whose main sweep kernels return at once (every
    edit of ``_BOUNDS_ONLY`` whose anchor occurs once); False when none
    applies."""
    shutil.copytree(csrc, dest)
    path = dest / "sweep.cu"
    text = path.read_text()
    done = 0
    for old in _BOUNDS_ONLY:
        if text.count(old) == 1:
            text = text.replace(old, "  if (a.frames > 0) return;\n" + old)
            done += 1
    path.write_text(text)
    return done > 0


def sass_counts(lib: pathlib.Path, kernel: str):
    """Instructions, CALLs, shared atomics by kind and loops (backward
    branches: instructions from target to branch and the shared atomics
    among them, largest first) of the first kernel whose mangled name
    holds ``kernel``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    heads = list(re.finditer(r"Function : (\S+)", text))
    for i, m in enumerate(heads):
        if kernel not in m.group(1):
            continue
        body = text[m.end():heads[i + 1].start() if i + 1 < len(heads)
                    else len(text)]
        ins = [(int(a, 16), op.strip()) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        atoms = {}
        for _, op in ins:
            word = op.split()[0] if not op.startswith("@") else op.split()[1]
            if word.startswith("ATOMS"):
                atoms[word] = atoms.get(word, 0) + 1
        loops = []
        for addr, op in ins:
            b = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
            if b and int(b.group(1), 16) < addr:
                lo = int(b.group(1), 16)
                body_ops = [o for a, o in ins if lo <= a <= addr]
                loops.append((len(body_ops),
                              sum("ATOMS" in o for o in body_ops)))
        return {"kernel": m.group(1), "instructions": len(ins),
                "calls": sum(1 for _, op in ins if "CALL" in op),
                "atoms": atoms,
                "loops": sorted(loops, reverse=True)[:8]}
    return {}


def build_all(cuda_lib, tmp, sources):
    """{name: csrc dir} -> {name: (bound swfsweep library, path)}, ptxas
    logs, errors; one nvcc a build, all started together."""
    import threading

    libs, logs, errors = {}, {}, {}

    def one(i, name, d):
        path = tmp / f"libsweep_{i}.so"
        try:
            logs[name] = cuda_lib._nvcc_all(d, {"swfsweep": path})
            libs[name] = (cuda_lib.bind("swfsweep",
                                        ctypes.CDLL(str(path))), path)
        except Exception as exc:  # reported below
            errors[name] = str(exc)[-2000:]

    threads = [threading.Thread(target=one, args=(i, *item))
               for i, item in enumerate(sources.items())]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return libs, logs, errors


def tables_at_chunk(tables, chunk: int):
    """``compact_pre``'s tables with row bounds of ``chunk``-slot chunks
    (a multiple of the tables' own): the min of the lowest and the max of
    the highest row bases of the chunks they join.  The first design of
    the compacted kernel reads 64-slot bounds."""
    import dataclasses

    import torch

    *lead, n, two = tables.bounds.shape
    k = chunk // (tables.cap // n)
    b = tables.bounds.view(*lead, n // k, k, two)
    return dataclasses.replace(tables, bounds=torch.stack(
        [b[..., 0].amin(-1), b[..., 1].amax(-1)], -1).contiguous())


def compact_stats(torch, tables, rows):
    """Per (frame, row band, bin): the pieces gathered for the bin (all
    layers) and those its walk reads at 64- and 16-slot row bounds."""
    f_, nb, l_, _, cap = tables.tab.shape
    rb = torch.floor(torch.minimum(tables.tab[:, :, :, 1],
                                   tables.tab[:, :, :, 3]))
    filled = torch.arange(cap, device=rb.device) < tables.counts[..., None]
    bands = -(-HEIGHT // rows)
    r0 = torch.arange(bands, device=rb.device).float() * rows

    def walked_by(size):
        shape = (f_, nb, l_, cap // size, size)
        lo = torch.where(filled, rb, torch.full_like(rb, 3.0e38)).view(
            shape).amin(-1)
        hi = torch.where(filled, rb, torch.full_like(rb, -3.0e38)).view(
            shape).amax(-1)
        n = filled.view(shape).sum(-1).float()
        hit = (hi[..., None] >= r0 - 1) & (lo[..., None] < r0 + rows)
        return (hit * n[..., None]).sum(dim=(2, 3))      # (F, NB, bands)

    gathered = tables.counts.sum(-1).float()
    w64, w16 = walked_by(64), walked_by(16)
    return {"bins": f_ * nb * bands,
            "pieces_gathered_a_bin_mean": float(gathered.mean()),
            "pieces_gathered_a_bin_most": int(gathered.max()),
            "pieces_walked_a_tile_mean_64_slot_chunks": float(w64.mean()),
            "pieces_walked_a_tile_mean_16_slot_chunks": float(w16.mean()),
            "share_tiles_walking_nothing_16": float((w16 == 0).float()
                                                    .mean())}


def cases(np, torch, on_parent=lambda: False):
    """Case name -> (kind, kernel call, plain call, transformed pieces
    (F, L, n) x4 or (compacted) the tables, rows a tile, tile width).
    ``on_parent()`` tells whether the parent's build is swapped in (its
    compacted kernel reads 64-slot row bounds)."""
    from ..ops import flatblock, style as style_ops, transform as sweep
    from ..ops.morph import morph_pieces, render_morph_sweep
    from ..utils.scenes import anim_scene

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda()

    tables, colors, mats = anim_scene(HEIGHT, WIDTH, FRAMES)
    layers = len(tables)
    rules = (0,) * layers
    tab, colarr = sweep.affine_pieces(tables, colors, mats)
    counts = sweep.layer_piece_counts(tab)
    d_mats, d_tab, d_col = up(mats), up(tab), up(colarr)
    base = np.array([[1, 0.2, 0, 1], [0, 1, 0.5, 0.8], [0.2, 0, 1, 1]],
                    np.float32)
    paints = [style_ops.solid_paint(tuple(c)) for c in colors]
    paints[1] = style_ops.Paint(
        kind=style_ops.PAINT_LINEAR,
        inv_matrix=(2.0 * 16384.0 / WIDTH, 0.0, 0.0, 2.0 * 16384.0 / WIDTH,
                    -16384.0, -16384.0 * HEIGHT / WIDTH),
        stop_ratios=np.array([0.0, 0.5, 1.0], np.float32), stop_colors=base)
    kpaints, grad_mats = sweep.sweep_paints(paints, mats)
    stops = np.zeros((FRAMES, layers, 3, 4), np.float32)
    stops[:, 1] = base[None] * np.linspace(
        1.0, 0.4, FRAMES, dtype=np.float32)[:, None, None]
    styled = dict(paints=kpaints, grad_mats=up(grad_mats),
                  stop_colors=up(stops))
    # The interactive loop's F = 1 sweep: frame 0, layer 1 a baked field.
    field = torch.rand((1, 1, HEIGHT, WIDTH, 4),
                       generator=torch.Generator().manual_seed(5)).cuda()
    one = dict(paints=(flatblock.KernelPaint.color(),
                       flatblock.KernelPaint.field(0),
                       flatblock.KernelPaint.color()), fields=field)
    m1 = d_mats[:1].contiguous()

    def column(mats_, **kw):
        return lambda: sweep.render_affine_sweep(
            mats_, d_tab, d_col, HEIGHT, WIDTH, layer_counts=counts, **kw)

    def plain(mats_, **kw):
        return lambda: sweep.sweep_plain(mats_, d_tab, None, None, d_col,
                                         None, HEIGHT, WIDTH, rules, counts,
                                         **kw)

    from ..utils.scenes import anim_scene as scene2   # morph pairs
    start, c0, _ = scene2(HEIGHT, WIDTH, 1, seed=9)
    end, c1, _ = scene2(HEIGHT, WIDTH, 1, seed=10)
    pairs = list(zip(start, end, c0, c1))
    m16 = mats[:MORPH_FRAMES]
    ratios = np.linspace(0.0, 1.0, MORPH_FRAMES, dtype=np.float32)
    tab_s, tab_e, cs, ce = sweep.morph_affine_pieces(pairs, m16)
    mcounts = tuple(min(max(a, b), tab_s.shape[-1]) for a, b in zip(
        sweep.layer_piece_counts(tab_s), sweep.layer_piece_counts(tab_e)))
    dm = [up(x) for x in (m16, ratios, tab_s, tab_e, cs, ce)]
    # The ratio sweep (B7) on the same pairs, no matrices: morph1080.
    rtab_s, rtab_e, rcs, rce = morph_pieces(pairs)
    rfull = (rtab_s.shape[-1],) * layers
    rm = [up(x) for x in (ratios, rtab_s, rtab_e, rcs, rce)]
    ident = up(np.tile(np.float32([1, 0, 0, 1, 0, 0]), (MORPH_FRAMES, 1)))

    def pieces(mats_, ts, te=None, rt=None, cnt=counts):
        x0, y0, x1, y1 = (ts[:, ch, 0][None] for ch in range(4))
        if te is not None:
            t = rt[:, None, None]
            x0, y0, x1, y1 = ((1.0 - t) * v + t * te[:, ch, 0][None]
                              for ch, v in enumerate((x0, y0, x1, y1)))
        a, b, c, d, e, g = (mats_[:, k, None, None] for k in range(6))
        out = (a * x0 + c * y0 + e, b * x0 + d * y0 + g,
               a * x1 + c * y1 + e, b * x1 + d * y1 + g)
        live = torch.arange(ts.shape[-1], device=ts.device)[None, :] < \
            torch.tensor(cnt, device=ts.device)[:, None]
        return out, live

    col_rows = 32 if layers * 32 * 129 * 8 <= 100 * 1024 else 16
    # The compacted tiling on the host plan's tables, the kernel alone.
    plan = sweep.plan_compact_sweep(mats, tab, HEIGHT, WIDTH)
    tables_c = sweep.compact_pre(d_mats, d_tab, plan["compact_counts"],
                                 plan["wblock"], HEIGHT, WIDTH)
    tables_64 = tables_at_chunk(tables_c, 64)

    def compact(**kw):
        return lambda: sweep._launch_sweep_compact(
            tables_64 if on_parent() else tables_c, d_col, HEIGHT, WIDTH,
            rules, plan["blocks_per_step"], **kw)

    row_rows = 16
    # 16 layers (the layer class above 4): the scene's layers cycled,
    # translucent colours.
    tab16 = up(np.concatenate([tab] * 6)[:16])
    counts16 = (tuple(counts) * 6)[:16]
    col16 = up(np.random.default_rng(16).uniform(0.2, 0.9, (16, 4)))
    rules16 = (0,) * 16
    return {
        "anim1080": ("column", column(d_mats), plain(d_mats),
                     pieces(d_mats, d_tab), col_rows, 128),
        "anim1080_gradient": ("column", column(d_mats, **styled),
                              plain(d_mats, **styled),
                              pieces(d_mats, d_tab), col_rows, 128),
        "interactive_f1": ("column", column(m1, **one), plain(m1, **one),
                           pieces(m1, d_tab), col_rows, 128),
        "anim1080_16_layers": (
            "column",
            lambda: sweep.render_affine_sweep(d_mats, tab16, col16, HEIGHT,
                                              WIDTH, layer_counts=counts16),
            lambda: sweep.sweep_plain(d_mats, tab16, None, None, col16, None,
                                      HEIGHT, WIDTH, rules16, counts16),
            pieces(d_mats, tab16, cnt=counts16), 4, 128),
        "anim1080_compact": ("compact", compact(), plain(d_mats),
                             tables_c, col_rows, plan["wblock"]),
        "anim1080_gradient_compact": ("compact", compact(**styled),
                                      plain(d_mats, **styled), tables_c,
                                      col_rows, plan["wblock"]),
        "anim1080_rows": ("rows", column(d_mats, row_grid=True),
                          plain(d_mats), pieces(d_mats, d_tab), row_rows,
                          256),
        "anim1080_gradient_rows": ("rows",
                                   column(d_mats, row_grid=True, **styled),
                                   plain(d_mats, **styled),
                                   pieces(d_mats, d_tab), row_rows, 256),
        "morph_affine1080": (
            "column",
            lambda: sweep.render_morph_affine_sweep(
                *dm, HEIGHT, WIDTH, layer_counts=mcounts),
            lambda: sweep.sweep_plain(dm[0], dm[2], dm[3], dm[1], dm[4],
                                      dm[5], HEIGHT, WIDTH, rules, mcounts),
            pieces(dm[0], dm[2], dm[3], dm[1], mcounts), col_rows, 128),
        "morph1080": (
            "column",
            lambda: render_morph_sweep(*rm, HEIGHT, WIDTH),
            lambda: sweep.sweep_plain(None, rm[1], rm[2], rm[0], rm[3],
                                      rm[4], HEIGHT, WIDTH, rules, rfull),
            pieces(ident, rm[1], rm[2], rm[0], rfull), col_rows, 128),
        "morph_affine1080_rows": (
            "rows",
            lambda: sweep.render_morph_affine_sweep(
                *dm, HEIGHT, WIDTH, layer_counts=mcounts, row_grid=True),
            lambda: sweep.sweep_plain(dm[0], dm[2], dm[3], dm[1], dm[4],
                                      dm[5], HEIGHT, WIDTH, rules, mcounts),
            pieces(dm[0], dm[2], dm[3], dm[1], mcounts), row_rows, 256),
    }


def piece_stats(torch, piece_tuple, rows, tile_w, chunk=64):
    """On the card: per (frame, row band, column tile), the pieces the
    walk reads (64 a hit chunk, past-count slots skipped), the (piece,
    row) pairs that land in the tile (crossing it, or wholly left of it:
    one add at its first column), the columns each crossing pair
    scatters, and the tiles no pair reaches or whose windings are all 0
    (every row's left adds cancel and no pair crosses)."""
    from ..ops.coverage import edge_row_span

    (x0, y0, x1, y1), live = piece_tuple
    f_, l_, n = x0.shape
    nb = -(-HEIGHT // rows)
    nt = -(-WIDTH // tile_w)
    rowbase = torch.floor(torch.minimum(y0, y1))
    big = torch.full_like(rowbase, 3.0e38)
    r0 = torch.arange(nb, device=x0.device).float() * rows

    def walked_by(size):
        nch = -(-n // size)
        pad = nch * size - n
        lo_rb = torch.nn.functional.pad(torch.where(live, rowbase, big),
                                        (0, pad), value=3.0e38)
        hi_rb = torch.nn.functional.pad(torch.where(live, rowbase, -big),
                                        (0, pad), value=-3.0e38)
        blo = lo_rb.view(f_, l_, nch, size).amin(-1)
        bhi = hi_rb.view(f_, l_, nch, size).amax(-1)
        livec = torch.nn.functional.pad(live.float(), (0, pad)).view(
            l_, nch, size).sum(-1)                             # (L, nch)
        hit = (bhi[..., None] >= r0 - 1) & (blo[..., None] < r0 + rows)
        return (hit * livec[None, :, :, None]).sum(dim=(1, 2))  # (F, nb)

    walked = walked_by(chunk)
    walked16 = walked_by(16)
    walked32 = walked_by(32)
    c0 = torch.arange(nt, device=x0.device).float() * tile_w
    c1 = torch.clamp(c0 + tile_w, max=float(WIDTH))
    cross_cols = []
    n_cross = torch.zeros((f_, nb, nt), device=x0.device)
    n_left = torch.zeros_like(n_cross)
    left_sum = torch.zeros((f_, l_, nb * rows, nt), dtype=torch.float64,
                           device=x0.device)
    for k in (0.0, 1.0):
        py = rowbase + k
        dy, xmn, xmx = edge_row_span(x0, y0, x1, y1, py)
        ok = live[None] & (py >= 0) & (py < HEIGHT) & (dy != 0)
        lo = torch.floor(xmn)[..., None]
        hi = torch.ceil(xmx)[..., None]
        land = ok[..., None] & (lo < c1)                      # (F,L,n,T)
        left = land & (hi <= c0)
        cross = land & ~left
        xs = torch.maximum(lo, c0)
        xe = torch.minimum(torch.maximum(hi, xs), c1 - 1)
        cols = (xe - xs + 1)[cross]
        cross_cols.append(cols)
        band = torch.clamp(py, 0, HEIGHT - 1).long() // rows
        idx = band[..., None].expand_as(land)
        n_cross.scatter_add_(1, idx.reshape(f_, -1, nt).clamp(max=nb - 1),
                             cross.reshape(f_, -1, nt).float())
        n_left.scatter_add_(1, idx.reshape(f_, -1, nt).clamp(max=nb - 1),
                            left.reshape(f_, -1, nt).float())
        q = torch.where(left, torch.round(dy.double() * 2.0 ** 32)[..., None],
                        torch.zeros((), dtype=torch.float64,
                                    device=x0.device))
        rowi = torch.clamp(py, 0, HEIGHT - 1).long()
        left_sum.scatter_add_(2, rowi[..., None].expand_as(q).reshape(
            f_, l_, -1, nt), q.reshape(f_, l_, -1, nt))
    cols = torch.cat(cross_cols)
    nz_left = (left_sum != 0).view(f_, l_, nb, rows, nt).any(dim=3).any(
        dim=1)                                                  # (F,nb,T)
    reached = (n_cross + n_left) > 0
    tiles = f_ * nb * nt
    return {
        "tiles": tiles,
        "pieces_walked_a_tile_mean": float(walked.mean()),
        "pieces_walked_a_tile_most": int(walked.max()),
        "pieces_walked_a_tile_mean_16_piece_chunks": float(walked16.mean()),
        "pieces_walked_a_tile_mean_32_piece_chunks": float(walked32.mean()),
        "crossing_pairs_a_tile_mean": float(n_cross.mean()),
        "crossing_pairs_a_tile_most": int(n_cross.max()),
        "left_pairs_a_tile_mean": float(n_left.mean()),
        "columns_a_crossing_pair_mean": float(cols.mean()),
        "columns_a_crossing_pair_most": int(cols.max()),
        "crossing_pairs_wider_than_32": int((cols > 32).sum()),
        "crossing_pairs": int(cols.numel()),
        "share_tiles_unreached": float((~reached).float().mean()),
        "share_tiles_all_zero": float(((n_cross == 0) & ~nz_left).float()
                                      .mean()),
    }


def main() -> None:
    import numpy as np
    import torch

    import sys

    from ..ops import cuda_lib, transform as sweep

    parser = argparse.ArgumentParser()
    parser.add_argument("--csrc", type=pathlib.Path,
                        default=cuda_lib.CSRC_DIR)
    parser.add_argument("--parent", type=pathlib.Path, default=None,
                        help="another checkout's csrc, timed beside")
    parser.add_argument("--variants", nargs="?", const="", default=None,
                        metavar="NAME,...",
                        help="also build and time VARIANTS (all, or these)")
    parser.add_argument("--rounds", type=int, default=1,
                        help="passes there and back over the builds")
    parser.add_argument("--cases", default=None, metavar="NAME,...",
                        help="only these cases (default: every case)")
    parser.add_argument("--build", action="append", default=[],
                        metavar="NAME=DIR",
                        help="another csrc directory, timed beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_phases needs a CUDA card")
    # The bounds scratch for the shortest chunks a variant may build.
    sweep.FINE_CHUNK = min(sweep.FINE_CHUNK, 8)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="sweep_phases_"))
    try:
        sources = {"change": tmp / "change", "stamped": tmp / "stamped"}
        shutil.copytree(args.csrc, sources["change"])
        shutil.copytree(args.csrc, sources["stamped"])
        form, text = stamped_source(
            (sources["stamped"] / "sweep_device.cuh").read_text())
        (sources["stamped"] / "sweep_device.cuh").write_text(text)
        (sources["stamped"] / "sweep.cu").write_text(
            (sources["stamped"] / "sweep.cu").read_text() + _READ)
        skipped = []
        if not bounds_only_sources(args.csrc, tmp / "bounds"):
            raise SystemExit("sweep.cu: the bounds-only edits do not apply")
        sources["bounds_only"] = tmp / "bounds"
        if args.parent is not None:
            sources["parent"] = tmp / "parent"
            shutil.copytree(args.parent, sources["parent"])
        for i, spec in enumerate(args.build):
            name, _, d = spec.partition("=")
            sources[name] = tmp / f"build{i}"
            shutil.copytree(d, sources[name])
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
        stamps.swf_sw_stamps.restype = ctypes.c_int
        stamps.swf_sw_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        ptx = {n: {k: next((v for v in (ptxas_of(logs[n], frag)
                                        for frag in frags) if v), {})
                   for k, frags in NAMES.items()}
               for n in logs}
        sass = {n: {k: next((v for v in (sass_counts(libs[n][1], frag)
                                         for frag in frags) if v), {})
                    for k, frags in NAMES.items() if k != "bounds"}
                for n in ("change", "parent") if n in libs}
        print(json.dumps({"csrc": str(args.csrc), "form": form,
                          "build_errors": errors,
                          "variants_not_applied": skipped, "ptxas": ptx,
                          "sass": sass}), flush=True)
        order = ["parent"] * ("parent" in libs) + ["change"] + [
            n for n in libs if n not in ("parent", "change")]
        mine = cuda_lib._libs.get("swfsweep")
        chosen = cases(np, torch, lambda: "parent" in libs and cuda_lib.
                       _libs.get("swfsweep") is libs["parent"][0])
        if args.cases is not None:
            keep = args.cases.split(",")
            unknown = sorted(set(keep) - set(chosen))
            if unknown:
                raise SystemExit(f"unknown cases {unknown}: {sorted(chosen)}")
            chosen = {k: chosen[k] for k in keep}
        for name, (kind, run, plain, pcs, rows, tile_w) in chosen.items():
            want = plain()
            row = {"kind": kind, "ms": {n: [] for n in order},
                   "equal_plain": {}}
            try:
                # Each build once, checked, before any is timed: a fault
                # shows here under its build's name.
                for n in order:
                    print(f"sweep_phases: {name}: {n}", file=sys.stderr,
                          flush=True)
                    cuda_lib._libs["swfsweep"] = libs[n][0]
                    got = run()
                    torch.cuda.synchronize()
                    if n != "bounds_only":
                        row["equal_plain"][n] = bool(torch.equal(got, want))
                    del got
                for names in (order, order[::-1]) * args.rounds:
                    for n in names:
                        cuda_lib._libs["swfsweep"] = libs[n][0]
                        row["ms"][n].append(time_ms(torch, run))
                buf = (ctypes.c_ulonglong * 16)()
                if stamps.swf_sw_stamps(buf, 1) != 0:
                    raise SystemExit("stamp reset failed")
                cuda_lib._libs["swfsweep"] = stamps
                run()
                torch.cuda.synchronize()
                if stamps.swf_sw_stamps(buf, 0) != 0:
                    raise SystemExit("stamp read failed")
            finally:
                if mine is None:
                    cuda_lib._libs.pop("swfsweep", None)
                else:
                    cuda_lib._libs["swfsweep"] = mine
            base = KERNELS[kind]
            total = sum(buf[base:base + 6])
            row["tiles"] = buf[base + 6]
            row["zeroed_tiles"] = buf[base + 7]
            row["cycles"] = total
            blocks = buf[base + 6] if kind == "column" else None
            row["cycles_a_tile"] = total / max(buf[base + 6], 1)
            row["blocks"] = blocks
            row["share"] = {ph: buf[base + i] / max(total, 1)
                            for i, ph in enumerate(PHASES)}
            row["pieces"] = (compact_stats(torch, pcs, rows)
                             if kind == "compact" else
                             piece_stats(torch, pcs, rows, tile_w))
            print(json.dumps({name: row}), flush=True)
            del want
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(card_line())


if __name__ == "__main__":
    main()
