#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (swf_renderer_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, as a CI gate
    python3 chip_smoke.py --parent DIR   # and an A/B against DIR's kernels

Phases, each of which exits non-zero on failure before the last line:

1. build   — g++ builds the native splitter/packer and nvcc builds the CUDA
             kernels (both from this checkout, started together);
2. kernels — each fused kernel against its plain PyTorch version on the
             card, on random packed scenes (1/4/16 layers, 1, 2 and 6
             strips per plane, the last split over several blocks at 16
             layers; nonzero/even-odd/mixed rules; colour, linear, focal
             and field paints for the styled kernel);
3. headline — ``render_batch_flatblock`` on 60 frames x 4 layers x
             1088x1920 (the benchmark's scene generator, seed 7): host
             lowering, upload, kernel (CUDA events, median of 5 after a
             warm-up), download, Gpx/s; every frame held against the plain
             version on the card;
4. renderer — ``TorchRenderer(1920, 1088).render(stage)`` and
             ``render_batch`` over stages built in code (solid, linear and
             focal gradient, and axis-aligned bitmap fills), one frame held
             against the plain version;
5. sweeps  — the three animation sweep kernels (affine, morph-affine,
             morph ratio) against their plain version on random scenes
             (1/3/16 layers, 100x150 and 400x550, every rule, global and
             per-layer matrices, colour / linear / focal / field paints,
             static and per-frame stops); ``render_batch`` of a 60-stage
             rotating display list and of a morph timeline, and
             ``render_morph_sweep``, with the launch counters read; then
             the animation benchmark scene uncut (60 frames x 3 layers x
             1088x1920, solid and with a fading gradient layer), a
             morph-affine and a 16-ratio morph run at the same size, each
             timed (CUDA events, median of 5 after a warm-up) and held
             against the plain version on every frame, word for word (B3,
             B6, B7);
6. bitmaps — the texfield kernel against its plain version on random
             cases (repeat / clamp / canvas, bilinear / nearest,
             supersample 1/2/4, identity, rotated, skewed and far-zoomed
             inverses; textures 17x23, 64x64 and 512x512): fields within
             1e-6 and u8 bytes equal; every instantiation (supersample 1,
             2, 4 and the run-time body at 3, each fetch mode and filter,
             power-of-two and odd texture sides) bit-equal to it;
             ``grid_sample`` timed beside it as a yardstick; through the
             entry points with the launch counters read:
             ``render_batch`` of the rotating display list with a
             bitmap layer (one texfield, one sweep launch),
             ``render_shape_animation`` of a bitmap fill, ``render(stage)``
             of a rotated, unsmoothed 512x512 bitmap (one texfield launch
             into the styled kernel), and 30 interactive ``render()`` calls
             (call 1 the normal path, calls 2-30 the F = 1 sweep: 30
             texfield and 29 sweep launches; median wall of calls 3-30);
             then bench.py's animtex scene at 512x512 and at 1088x1920 (60
             frames; bake kernel, whole bake, sweep and download timed,
             every frame held against the plain versions);
7. layered — the banded and tiled coverage kernels against their plain
             versions on closed random paths (3 to 5000 edges, 37x300,
             100x150 and 1088x1920, both rules) and the resolve kernel on
             random planes (1/4/16 layers, strides 256 and 8448, every
             rule); then direct1080 (bench.py --direct uncut: 60 x 4 x
             1088x1920 through ``render_solid_batch``, banded), dense1080
             (4 x 4 frames of 320 octagons a layer, tiled) and wide8k
             (16 x 4 x 1088x8320 through ``render_batch_flatblock``, the
             resolve kernel): host lowering, upload, kernel, download
             timed, every banded and tiled plane held equal to its
             plain version (max abs 0); and
             phase 4's stages through ``backend="direct"`` /
             ``"scanline"``, ``quality="flash-pointaa"``,
             ``validate=True`` and an 8320-px renderer under auto, with
             the paths and launch counters checked and two scanline
             renders compared byte for byte;
8. flat_blocks — the placement kernel, the grid and pipelined plane
             resolves and the one-block fused kernel against their plain
             versions (equal) on random scenes (1/4/16 layers, 200, 300,
             1920 and 2047 px wide, 8, 40 and 1088 rows, every rule, the
             empty-group scene; step and prefixed both ways, passes 2
             and 3, n_buf 2 and 3) and random planes (n_buf 2, 3 and 4:
             a shallower ring at 16 layers), the pipelined resolve also
             against the grid one's words; then the headline
             scene through ``render_flat_blocks`` (headline_planes: one
             place and one resolve launch; native packing, upload, each
             kernel, download timed; every plane and frame held against
             the plain versions, the pipelined resolve against the grid
             one, the frames against phase 3's; the plane resolves'
             registers, stack and SASS census: B16 must issue bulk
             copies, UBLKCP, and no cp.async, LDGSTS), through
             ``sort_blocks_fused`` + ``render_fused_blocks``
             (headline_fused1: also equal to ``render_fused_blocksn`` on
             ``group_blocks_fused`` of the same blocks), and the port's
             ``entry()`` forward once;
9. deep_masked — the chain modes of the styled kernel (chain from
             transparent and from background planes, packed words and
             premultiplied planes out, mask_from 1 and L-1) against their
             plain version on random scenes (1/4/16 layers, 1, 2 and 6
             strips per plane, mixed rules, colour / gradient / field
             paints): words and planes equal; deep1080 (16 x 40 x
             1088x1920, seed 7) through ``render_batch_styled``: the
             scene's colours in 3 chained passes, byte-equal to one
             40-layer chain, and a list of bitmaps, gradients and solids
             in 4 passes, each equal to its plain version; masked1080
             (bench.py's bench_masked uncut: 60 x 4 x 1088x1920, layers
             2-3 clipped to the left two thirds) through the masked
             program: 2 launches, byte-equal to the unfused plane-algebra
             program; and the renderer's routes at 1920x1088 (a clip of
             18 children, multiply, alpha + erase, blur + drop shadow, 20
             plain layers, a 3-stage batch of one group structure), each
             path checked and within 1 level of the scanline compositor;
10. tilings — the sweep's row-band tiling (B4: solid at 128- and
             256-column chunks, styled, morph + affine) and compacted
             tiling (B5: solid and styled with gradients, stops and field
             planes, one and per-layer matrix tracks, the plan's bins and
             256- / 120-column bins) against ``sweep_plain``, B5 also
             against ``sweep_compact_plain`` on ``compact_pre``'s tables,
             each also against the column kernel's frames (B4 and B5
             word for word), on random
             scenes (1/3/16 layers, 100x300 and 400x550, mixed rules),
             with the plan's capacities checked against every crossing
             count; grouped coverage (B11) against ``grouped_plain`` on
             phase 7's random paths (max abs 0); then the main path once —
             ``render_affine_sweep(row_grid=True)`` and
             ``render_affine_sweep(**plan_compact_sweep(...))`` on
             anim1080 and anim1080_gradient,
             ``render_morph_affine_sweep(row_grid=True)`` on
             morph_affine1080, ``coverage_grouped`` on direct1080's and
             dense1080's planes — and each kernel timed beside the column
             kernel (B3, B6) or the banded / tiled kernel (B9, B10) on the
             same inputs (B11 also against the parent's build with
             --parent), ``compact_pre`` apart, every frame and plane
             held against the plain versions (B4's and B5's, like B3's,
             B6's and B7's in phases 5 and 6, word for word, and equal to
             B3's and B6's); B5's registers, stack and SASS census (no
             stack, no compare-and-swap loop);
11. probes — the variants of B1 that the reference's tools/exp_split.py
             cuts it into (modes full / place / resolve / none, none0,
             batched kk 4 / 8 / 16, merged) against their plain versions
             and full / batched / merged against ``render_fused_blocksn``
             on random scenes at one strip a plane (1/4/16 layers, group
             6 and 2, 200 and 1920 px wide), the ablated modes into
             buffers filled with -7 and the observe guard of place and
             none checked; then on phase 3's headline scene each variant
             driven once through its wrapper and timed beside B1 (the
             decomposition: none0, none - none0, place - none, resolve -
             none0, full); exp_bw's passthroughs (both layouts) and
             read+sum on (60, 4, 137, 128, 128) f32 planes and exp_scatter
             D's step probe on 16384 and 131072 tiles, each equal to its
             plain version (also as bare launches into one buffer) and
             timed beside its plain version and its one-call library
             yardstick (``torch.add``, ``torch.sum``), per call and as
             runs of back-to-back calls, the kernel also as bare
             launches (the wrapper's enqueue apart); with --parent each
             of the five rows A/B against the parent's libswfprobes;
12. products — placement as a matrix product on the tensor cores (the
             reference's tools/exp_int8.py, exp_k3.py three / concat and
             exp_lmask.py) and the merged read of exp_dmamerge.py at any
             rule and strips per plane: ``cuobjdump -sass`` shows HGMMA
             in the bf16 forms and IGMMA in int8 (warpgroup products, at
             both layer classes, no HMMA or IMMA); each form against its plain
             version on phase 11's random scenes (int8 equal; k3 and
             lmask within B1's envelope: premultiplied bytes 1 level,
             differing bytes 1e-4, straight levels logged) and
             ``render_rv`` under three rules equal to its plain version
             and to ``render_fused_blocksn``; then on phase 3's headline
             at one strip a plane each form driven once through its
             wrapper and timed beside B1 (tensor-core operations logged
             beside the bound), and ``render_rv`` on exp_dmamerge's
             headline, flat256 and gradients scenes beside B1 at the same
             strips per plane;
13. windows — window-targeted placement (the reference's
             tools/exp_winplace.py: ``render_win``, B1 over per-strip
             placement blocks with local row ids) and coarse steps with
             explicit output copies (tools/exp_dma.py: ``run_variant``,
             bulk copies from a 2-slot shared-memory ring):
             ``cuobjdump -sass`` shows UBLKCP in the coarse kernel and not
             in B1; ``render_win`` against ``win_plain`` and
             ``render_fused_blocksn`` on random scenes (1/4/16 layers; 1,
             2, 5 and 8 strips a plane, 16 layers splitting 5 and 8 over
             blocks; nonzero, even-odd and mixed rules), the coarse kernel
             at coarse 1, 2 and 4 against ``dma_plain`` and B1 on phase
             11's random scenes, through ``run_variant`` and into buffers
             filled with -7 (the sentinel strip block stays -7), all
             byte-equal; then ``render_win`` on
             exp_winplace's headline (spp 2), flat256, gradients and
             textured scenes uncut, and the coarse kernel at coarse 1, 2
             and 4 on phase 3's headline at one strip a plane, each driven
             once through its wrapper, held equal to its plain version and
             to B1, and timed beside B1 (group counts and the windowed
             packing time logged).  Phase 1 names the ptxas registers,
             stack and spills of B1 (its layer classes 4 and 16), of B2
             (the styled kernel: single pass, chain and chain +
             premultiplied; it fails if they keep a stack), of the
             four product kernels, of the windowed instantiation, of the
             coarse kernel, of the texfield kernel at animtex1080 and of
             the banded and tiled coverage kernels (it fails if these keep
             a stack or spill);
14. movies — .swf files built in code by the port's emitter (frame RECT
             38400 x 21600 twips = 1920x1080) through the user entry
             points: movie_anim1080 (``emit_movie_timeline``, 60 frames at
             30 fps: 8 DefineShape3 polygons and stars, 6 solid and 2
             linear-gradient fills, moved every frame by PlaceFlagMove,
             one fading) through ``render_movie_timeline`` in FWS (three
             calls), CWS and ZWS, each one B3 launch and no B2;
             movie_morph1080 (a DefineMorphShape2 at 3 depths, a 16-frame
             ratio track, moving matrices), one B6 launch; movie_still1080
             (background, DefineFont2 + DefineText, a two-shape sprite
             under a colour transform, a scale-9 sprite under a
             non-uniform scale, a DefineBitsLossless2 fill under a rotated
             matrix) through ``render_movie``, B2 and B8; every frame
             equal word for word to the renderer's render of the stages
             built by hand, each recorded launch equal to its plain
             version (sweep_plain, fused_styled_plain word for word,
             texfield_plain within 1e-6); parse and stage-build ms and
             each render's wall split by replaying its launches (kernel by
             CUDA events, upload, download); then ``python3 -m
             swf_renderer_tpu_torch`` in a subprocess: ``--frames DIR
             --stats`` on movie_anim1080 and ``-o`` on movie_still1080,
             the PNGs read back equal to the in-process frames;
15. service_mesh — ``RendererService`` at 1920x1080 on the card, over a
             styled 4-layer scene built in code (anim_movie's shapes by
             asset id): ``render_refs`` (one B2 launch), ``animate_refs``
             and ``render_batch`` of 60 moving-matrix frames (one B3
             launch each), each byte-equal to the same call on a
             ``TorchRenderer`` and each launch to its plain version, walls
             split into host, upload, kernel and download; then
             ``parallel.mesh`` on a NCCL group of one rank (a FileStore in a
             temporary directory; one card shows no collective across
             GPUs, which the CPU tests hold over gloo ranks):
             ``render_fused_dp`` on the headline (one B13 launch),
             ``render_styled_dp`` (one B2 launch) and the three
             tile-sharded sweeps (one B3, B6 or B7 launch each), all
             byte-equal to the single-device calls over the whole output;
             then B3 (solid and styled), B6 and B7 on anim1080,
             anim1080_gradient, morph_affine1080 and morph1080 split into
             2 and 4 column shards at their origins, each shard equal word
             for word to its plain version and to those columns of the
             whole frame, timed beside the whole frame's launch.  With
             ``--parent`` every sweep kernel but the column sweeps (which
             read the origin) must keep the parent's SASS;
16. sound — movie_sound1080 (``utils/movie_scenes.py`` ``sound_movie``:
             the morph movie's timeline, 60 frames at 24 fps, 1920x1080,
             with an MP3 SoundStreamHead / SoundStreamBlock stream, MPEG-1
             Layer III 44.1 kHz joint stereo, and an ADPCM and an MP3
             DefineSound + StartSound, one with in / out points and
             loops) through ``python -m swf_renderer_tpu_torch movie.swf
             --wav out.wav --frames DIR`` in a subprocess (``CLI_PROBE``:
             the kernel wrappers' counts set to 0 before the CLI runs and
             written out when it ends): one B6 launch, every PNG equal to
             an in-process ``render_movie_timeline`` (its launch equal to
             ``sweep_plain`` word for word), out.wav equal to an
             in-process ``wav_bytes(mix_movie_audio(...))``; soundtrack10s
             (the same movie at 240 frames, a 10 s track) through
             ``--wav`` alone: no launch, no PNG, the WAV equal; the MP3
             decode, mix, WAV write and CLI walls printed; then B9, B10
             and B11 held against the reference's f64 oracle
             ``coverage_numpy`` (64x64 to 256x256, up to 512 edges, both
             rules, max abs 1e-4) and direct1080's first two planes
             through B9 against it (printed, not gated).

With ``--parent DIR`` (a checkout of the parent commit) phase 1 also
builds DIR's kernels and compares every kernel's SASS with theirs, and
B1 (headline), the styled kernel (renderer frame), its chain modes
(deep1080 pass 1 of the solid and the styled arm, masked1080's fused
pair and pre pass), the one-block kernel (headline_fused1), the exp_split
cuts, the texfield kernel (yardstick, animtex, animtex1080), the
banded and tiled coverage kernels (direct1080, dense1080, the renderer's
``direct`` route), the affine sweep B3 (anim1080 solid and styled, one
interactive F = 1 frame), the morph sweeps B6 (morph_affine1080) and B7
(morph1080), the row bands B4 (anim1080 solid and
styled, morph_affine1080), the compacted bins B5 (anim1080 solid and
styled; the parent's kernel reads 64-slot row bounds, made from the same
tables) and the plane resolves B15 and B16 (headline_planes) are timed
with DIR's build and with this one on the same inputs, parent / change /
change / parent (``report.json`` ``ab`` and ``ab_sass``).

The launch counters of the kernel wrappers are set to 0 right before the
headline, the renderer, the sweep, the bitmap, the layered, the flat
block, the deep and masked and the tilings paths, before each probe,
product form, windowed scene and coarse step, before each movie entry
point call, before each service and mesh call and, in the CLI's own
process, before the sound movie's CLI render, and read right after.
The
script prints one JSON line describing each kernel (time, bound, plain
version's time, library yardstick's time where one call computes the
same function), then the card's name and power limit as nvidia-smi
prints them, and as its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chip_smoke_out"   # report.json, ptxas.log
# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
TOL_LEVELS = 1       # u8 levels per channel, kernel vs plain version
DEVICE = "cuda"
HEADLINE = (60, 4, 1088, 1920)   # frames, layers, height, width
_HELD = {}   # phase 3's headline scene and frames, read again in phase 8
# --parent DIR: a checkout of the parent commit whose kernels are built
# beside this one's and timed against them on the same inputs (A/B).
PARENT_ROOT = None


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


sys.path.insert(0, str(ROOT))
try:
    from swf_renderer_tpu_torch.tools.exp_split import byte_diff
    from swf_renderer_tpu_torch.tools.timing import (
        card_line, time_ms, time_run_ms,
    )
except ImportError as exc:
    fail(f"the port's package is not beside this script: {exc}")


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------


def phase_build():
    from swf_renderer_tpu_torch.native import bindings
    from swf_renderer_tpu_torch.ops import cuda_lib

    results = {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn(force=True)
            results[name] = (time.perf_counter() - t0, None)
        except Exception as exc:  # reported below, then the phase fails
            results[name] = (time.perf_counter() - t0, exc)

    def parent(force):
        pkg = PARENT_ROOT / "swf_renderer_tpu_torch"
        _HELD["parent_libs"], _HELD["parent_log"] = cuda_lib.build_other(
            pkg / "csrc", pkg / "_build")

    jobs = [("g++ native", bindings.build_library),
            ("nvcc kernels", cuda_lib.build)]
    if PARENT_ROOT is not None:
        jobs.append(("nvcc parent kernels", parent))
    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, (secs, exc) in results.items():
        if exc is not None:
            fail(f"{name} build: {exc}")
        log(f"build: {name} {secs:.2f} s")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "ptxas.log").write_text(cuda_lib.build_log)
    for line in cuda_lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")
    kernels = ptxas_kernels(cuda_lib.build_log)
    for label, key in PTXAS_WATCH.items():
        found = [v for k, v in kernels.items() if key in k]
        if len(found) != 1:
            fail(f"ptxas: {len(found)} entries for {label} ({key})")
        v = found[0]
        log(f"ptxas: {label}: {v['registers']} registers, {v['stack']} B "
            f"stack, {v['spill_stores']} B spill stores, "
            f"{v['spill_loads']} B spill loads")
        if (label.startswith(("B2", "B9", "B10", "B11")) or
                label in NO_STACK) and (
                v["stack"] or v["spill_stores"] or v["spill_loads"]):
            fail(f"ptxas: {label} keeps a stack frame or spills: {v}")
        _HELD.setdefault("ptxas", {})[label] = v
    for name in cuda_lib.LIBRARIES:
        cuda_lib.load(name)
    bindings.load_library()


# Instantiations whose ptxas readings phase 1 names (mangled-name
# fragments): B1's at the headline (solid_flatblock_kernel<kVarFull, 4>,
# the layer class of up to four layers) and at 16 layers, B2's single
# pass, chain and chain + premultiplied forms (styled_flatblock_kernel
# <kChain, kPremul>; phase 1 fails if these keep a stack frame or
# spill), the product forms' (product_kernel<kVar, kLc>, every form at
# both layer classes, in NO_STACK), the coarse steps' (coarse_kernel<kLc,
# kOne>, both layer classes, in NO_STACK), the windowed one's and the
# texfield kernel's at animtex1080 (n 2, bilinear, repeat), the banded (B9),
# tiled (B10) and grouped (B11) coverage kernels (phase 1 fails if these
# keep a stack frame or spill, as for B2), the one-block form B13 at the
# headline (solid_flatblock_kernel<kVarOne, 4>, in NO_STACK), and the
# sweeps' column (sweep_tile_kernel
# <kMorph, kAffine, kStyled, kLc>: B3 affine, B6 morph + affine, B7 morph
# ratio) and row-band (B4, sweep_rows_kernel<kMorph, kAffine, kStyled,
# kLc>) instantiations at anim1080, morph_affine1080 and morph1080, the
# compacted bins (B5, sweep_bin_kernel<kStyled, kLc>) at anim1080 and the
# pipelined plane resolve (B16) (the solid sweeps and B16 in NO_STACK),
# and the two streaming probes of csrc/probes.cu (in NO_STACK).
PTXAS_WATCH = {
    "B1 fused_block<solid>": "solid_flatblock_kernelILi0ELi4E",
    "B1 at 16 layers": "solid_flatblock_kernelILi0ELi16E",
    "B2 single pass": "styled_flatblock_kernelILb0ELb0EE",
    "B2 chain": "styled_flatblock_kernelILb1ELb0EE",
    "B2 chain + premul": "styled_flatblock_kernelILb1ELb1EE",
    "product k3_three": "product_kernelILi7ELi4E",
    "product k3_three at 16 layers": "product_kernelILi7ELi16E",
    "product k3_concat": "product_kernelILi8ELi4E",
    "product k3_concat at 16 layers": "product_kernelILi8ELi16E",
    "product lmask": "product_kernelILi9ELi4E",
    "product lmask at 16 layers": "product_kernelILi9ELi16E",
    "product int8": "product_kernelILi10ELi4E",
    "product int8 at 16 layers": "product_kernelILi10ELi16E",
    "windowed kVarWin": "solid_flatblock_kernelILi11ELi4E",
    "coarse": "coarse_kernelILi4ELb0E",
    "coarse at 16 layers": "coarse_kernelILi16ELb0E",
    "coarse 1": "coarse_kernelILi4ELb1E",
    "coarse 1 at 16 layers": "coarse_kernelILi16ELb1E",
    "texfield n2 bilinear repeat": "texfield_kernelILi2ELb1ELi0E",
    "B9 banded": "banded_kernel",
    "B10 tiled": "tiled_kernel",
    "B11 grouped": "grouped_kernel",
    "B13 one-block": "solid_flatblock_kernelILi12ELi4E",
    "B3 solid": "sweep_tile_kernelILb0ELb1ELb0ELi4E",
    "B3 styled": "sweep_tile_kernelILb0ELb1ELb1ELi16E",
    "B6 morph + affine": "sweep_tile_kernelILb1ELb1ELb0ELi4E",
    "B7 morph": "sweep_tile_kernelILb1ELb0ELb0ELi4E",
    "B4 solid": "sweep_rows_kernelILb0ELb1ELb0ELi4E",
    "B4 styled": "sweep_rows_kernelILb0ELb1ELb1ELi16E",
    "B4 morph": "sweep_rows_kernelILb1ELb1ELb0ELi4E",
    "B5 solid": "sweep_bin_kernelILb0ELi4E",
    "B5 styled": "sweep_bin_kernelILb1ELi16E",
    "B16 pipelined resolve": "resolve_dma_kernel",
    "probe passthrough": "passthrough_kernel",
    "probe read+sum": "read_sum_kernel",
}
NO_STACK = ("B3 solid", "B4 solid", "B4 morph", "B5 solid",
            "B6 morph + affine", "B7 morph", "B13 one-block",
            "B16 pipelined resolve", "product k3_three",
            "product k3_three at 16 layers", "product k3_concat",
            "product k3_concat at 16 layers", "product lmask",
            "product lmask at 16 layers", "product int8",
            "product int8 at 16 layers", "coarse", "coarse at 16 layers",
            "coarse 1", "coarse 1 at 16 layers", "probe passthrough",
            "probe read+sum")


def ab_times(torch, name, fn, lib="swfkernels", run=None):
    """With --parent: ``fn`` timed (CUDA events, median of 5) with the
    parent's build of ``lib`` swapped in and with this one's, in the
    order parent, change, change, parent; with ``run``, each turn also
    times ``run`` calls back to back (``time_run_ms``: ms a call); kept
    for report.json["ab"] and returned.  None without --parent.  The
    wrappers count these launches too, so callers time after reading
    their launch counters."""
    from swf_renderer_tpu_torch.ops import cuda_lib

    parent = _HELD.get("parent_libs")
    if parent is None:
        return None
    mine = cuda_lib.load(lib)
    times = {"parent_ms": [], "change_ms": []}
    if run:
        times.update(parent_run_ms=[], change_run_ms=[])
    try:
        for key, which in (("parent", parent[lib]), ("change", mine),
                           ("change", mine), ("parent", parent[lib])):
            cuda_lib._libs[lib] = which
            times[f"{key}_ms"].append(time_ms(torch, fn, reps=5))
            if run:
                times[f"{key}_run_ms"].append(time_run_ms(torch, fn, run)[0])
    finally:
        cuda_lib._libs[lib] = mine
    p, c = (statistics.mean(times[k]) for k in ("parent_ms", "change_ms"))
    times["change_vs_parent"] = c / p - 1.0
    runs = ""
    if run:
        pr, cr = (statistics.mean(times[f"{k}_run_ms"])
                  for k in ("parent", "change"))
        times["change_vs_parent_run"] = cr / pr - 1.0
        runs = (f"; {run} back to back: parent {pr:.4f} / change {cr:.4f} "
                f"ms a call ({100 * (cr / pr - 1):+.1f}%)")
    _HELD.setdefault("ab", {})[name] = times
    log(f"A/B: {name}: parent {times['parent_ms'][0]:.4f} / change "
        f"{times['change_ms'][0]:.4f} / {times['change_ms'][1]:.4f} / "
        f"parent {times['parent_ms'][1]:.4f} ms ({100 * (c / p - 1):+.1f}% "
        f"of the means){runs}")
    return times


def sass_of(path):
    """``cuobjdump -sass`` of a built library -> {mangled kernel: SASS}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump -sass {path} failed: {proc.stderr.strip()[:400]}")
    text = proc.stdout
    heads = list(re.finditer(r"Function : (\S+)", text))
    return {m.group(1): text[m.end():heads[i + 1].start()
                             if i + 1 < len(heads) else len(text)]
            for i, m in enumerate(heads)}


def ab_sass(report):
    """With --parent: each library's kernels against the parent's, SASS
    text compared function by function (report.json["ab_sass"]), blanks
    collapsed: cuobjdump pads its columns to the widest instruction of the
    whole library, so a change to one kernel re-pads the text of all.  A
    kernel's own name is blanked in its text, so a kernel whose template
    arguments were renamed and whose text did not change pairs with the
    parent's under its old name ("renamed")."""
    from swf_renderer_tpu_torch.ops import cuda_lib

    if "parent_libs" not in _HELD:
        return
    out = {}
    pkg = PARENT_ROOT / "swf_renderer_tpu_torch" / "_build"

    def words(path):
        return {k: " ".join(v.replace(k, "<self>").split())
                for k, v in sass_of(path).items()}

    for name in cuda_lib.LIBRARIES:
        mine = words(cuda_lib.lib_path(name))
        theirs = words(pkg / f"lib{name}.so")
        gone = {v: k for k, v in theirs.items() if k not in mine}
        renamed = sorted([gone[v], k] for k, v in mine.items()
                         if k not in theirs and v in gone)
        new_names = {k for _, k in renamed}
        old_names = {k for k, _ in renamed}
        same = sorted(k for k in mine if theirs.get(k) == mine[k])
        out[name] = {
            "identical": len(same) + len(renamed),
            "renamed": renamed,
            "differ": sorted(k for k in mine if k in theirs
                             and theirs[k] != mine[k]),
            "only_change": sorted(k for k in mine if k not in theirs
                                  and k not in new_names),
            "only_parent": sorted(k for k in theirs if k not in mine
                                  and k not in old_names)}
        log(f"A/B: SASS of {name}: {out[name]['identical']} kernels "
            f"identical to the parent's ({len(renamed)} of them renamed), "
            f"{len(out[name]['differ'])} differ, "
            f"{len(out[name]['only_change'])} new, "
            f"{len(out[name]['only_parent'])} gone")
    report["ab_sass"] = out


def ptxas_kernels(text):
    """``nvcc -Xptxas -v`` output -> {mangled kernel: registers, stack,
    spill stores, spill loads (bytes)}."""
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            current = out.setdefault(m.group(1), {
                "registers": None, "stack": None, "spill_stores": None,
                "spill_loads": None})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            current.update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return out


# ---------------------------------------------------------------------------
# Shared helpers: packing and operation counts
# ---------------------------------------------------------------------------


def pack_scene(tables, height, width, device, spp=None):
    from swf_renderer_tpu_torch.convert import packed_to_device
    from swf_renderer_tpu_torch.native.bindings import pack_grouped_native
    from swf_renderer_tpu_torch.ops.flatblock import (
        plane_geometry, strips_per_plane,
    )
    from swf_renderer_tpu_torch.ops.pipeline import GROUP, lower_update_lists

    _, nc, ns = plane_geometry(height, width)
    if spp is None:
        spp = strips_per_plane(nc, ns)
    updates = lower_update_lists(tables, height, width)
    packed = pack_grouped_native(updates, height, width, group=GROUP,
                                 spp=spp)
    return packed_to_device(*packed, device=device), spp


def kernel_args(dev):
    return (dev["sidx"], dev["flags"], dev["lays"], dev["urc"], dev["ucm"],
            dev["uval"])


def work_counts(torch, dev, frames, layers, spp, rules, paints=(),
                fields=(), colors=None):
    """(bytes, f32 operations) the fused function needs on these inputs:
    every input read once, the resolved rows written once; operations
    counted per valid update, per resolved pixel-layer and per pixel."""
    from swf_renderer_tpu_torch.ops.flatblock import (
        BLK, KPAINT_FIELD, KPAINT_FOCAL, KPAINT_LINEAR, LANE, STRIP_H,
    )

    ins = list(kernel_args(dev)) + list(fields)
    if colors is not None:
        ins.append(colors)
    in_bytes = sum(t.numel() * t.element_size() for t in ins)
    ns, nc = dev["ns"], dev["nc"]
    pixels = frames * ns * spp * STRIP_H * nc * LANE
    out_bytes = pixels * 4
    valid = valid_updates(torch, dev)
    per_layer = 0
    for lyr in range(layers):
        rule_ops = 2 if rules[lyr] == 0 else 5
        per_layer += 2 + rule_ops + 11     # prefix, carry, rule, composite
        kind = paints[lyr].kind if paints else 0
        if kind in (KPAINT_LINEAR, KPAINT_FOCAL):
            k = len(paints[lyr].stop_ratios)
            per_layer += 8 + (2 if kind == KPAINT_LINEAR else 14) + 3
            per_layer += 4 * 6 * max(k - 1, 0)
        elif kind == KPAINT_FIELD:
            per_layer += 0
    ops = valid + pixels * per_layer + pixels * 21   # quantize + pack
    return in_bytes + out_bytes, ops


def valid_updates(torch, dev):
    """Used slots of the grouped arrays with a nonzero value: the
    placement's adds."""
    from swf_renderer_tpu_torch.ops.flatblock import BLK

    ng = dev["urc"].shape[0]
    group = dev["lays"].shape[0]
    nblk = (dev["flags"] >> 2).view(ng, 1)
    slot = torch.arange(group, device=nblk.device).view(1, group)
    used = ((nblk == 0) | (slot < nblk)).repeat_interleave(BLK, dim=1)
    return int(((dev["uval"].view(ng, -1) != 0) & used).sum().item())


def bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------


def random_paints(rng, layers, n_fields_max=4):
    from swf_renderer_tpu_torch.ops.flatblock import (
        KPAINT_FOCAL, KPAINT_LINEAR, KernelPaint,
    )

    paints, n_fields = [], 0
    for lyr in range(layers):
        kind = lyr % 4
        k = int(rng.integers(2, 6))
        ratios = sorted(rng.uniform(0, 1, k).astype("float32"))
        ratios[0], ratios[-1] = 0.0, 1.0
        stops = rng.uniform(0, 1, (k, 4)).astype("float32")
        inv = (float(rng.uniform(20, 40)), float(rng.uniform(-5, 5)),
               float(rng.uniform(-5, 5)), float(rng.uniform(20, 40)),
               float(rng.uniform(-20000, -10000)),
               float(rng.uniform(-20000, -10000)))
        if kind == 1:
            paints.append(KernelPaint.gradient(
                KPAINT_LINEAR, inv, ratios, stops, spread=lyr % 3))
        elif kind == 2:
            paints.append(KernelPaint.gradient(
                KPAINT_FOCAL, inv, ratios, stops,
                focal=float(rng.uniform(-0.9, 0.9)), spread=(lyr // 2) % 3))
        elif kind == 3 and n_fields < n_fields_max:
            paints.append(KernelPaint.field(n_fields))
            n_fields += 1
        else:
            paints.append(KernelPaint.color())
    return tuple(paints), n_fields


def phase_kernels(torch, np):
    from swf_renderer_tpu_torch.ops import cuda_lib
    from swf_renderer_tpu_torch.ops.flatblock import (
        field_to_chunkmajor, fused_styled_plain, fusedn_plain,
        render_fused_blocksn, render_fused_styled,
    )
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    lib = cuda_lib.load()
    rng = np.random.default_rng(11)
    worst = {"fusedn": 0, "styled": 0}
    frames = 2
    # (height, width) -> strips per plane: 1 at 2560 px wide, 2 at 1920,
    # 6 at 550 (the default Flash stage), where 16 layers split each
    # plane's strips over several blocks (spb < spp).
    for (height, width), want_spp in (((64, 2560), 1), ((136, 1920), 2),
                                      ((400, 550), 6)):
        for layers in (1, 4, 16):
            spb = {styled: lib.swf_strips_per_block(layers, want_spp, styled)
                   for styled in (0, 1)}
            if want_spp == 6 and layers == 16 and max(spb.values()) >= 6:
                fail(f"the narrow 16-layer case does not split its strips "
                     f"(strips per block {spb})")
            tables, colors = build_scene_edges(
                frames, layers, height, width, shapes_per_layer=6,
                seed=int(rng.integers(1 << 30)))
            dev, spp = pack_scene(tables, height, width, DEVICE)
            if spp != want_spp:
                fail(f"{height}x{width} packs {spp} strips per plane, "
                     f"expected {want_spp}")
            cols = torch.as_tensor(colors, device=DEVICE)
            ns, nc = dev["ns"], dev["nc"]
            mixed = tuple(int(x) for x in rng.integers(0, 2, layers))
            for rule in (0, 1, mixed):
                args = kernel_args(dev) + (cols, frames, layers, ns, nc)
                got = render_fused_blocksn(*args, fill_rule=rule, spp=spp)
                want = fusedn_plain(*args, fill_rule=rule, spp=spp)
                torch.cuda.synchronize()
                dmax, share = byte_diff(got[:, :ns], want[:, :ns])
                tag = rule if isinstance(rule, int) else "mixed"
                log(f"kernels: fusedn L={layers} spp={spp} spb={spb[0]} "
                    f"rule={tag}: "
                    f"max diff {dmax}, differing bytes {share:.3g}")
                if dmax > TOL_LEVELS:
                    fail(f"fusedn kernel vs plain: {dmax} levels")
                worst["fusedn"] = max(worst["fusedn"], dmax)

            paints, n_fields = random_paints(rng, layers)
            fields = tuple(
                field_to_chunkmajor(
                    torch.as_tensor(rng.uniform(0, 1, (height, width, 4))
                                    .astype("float32"), device=DEVICE),
                    ns, nc, spp=spp)
                for _ in range(n_fields))
            args = kernel_args(dev) + (cols, fields, frames, layers, ns, nc,
                                       paints)
            got = render_fused_styled(*args, fill_rule=mixed, spp=spp)
            want = fused_styled_plain(*args, fill_rule=mixed, spp=spp)
            torch.cuda.synchronize()
            dmax, share = byte_diff(got[:, :ns], want[:, :ns])
            log(f"kernels: styled L={layers} spp={spp} spb={spb[1]} kinds="
                f"{[p.kind for p in paints]}: max diff {dmax}, "
                f"differing bytes {share:.3g}")
            if dmax > TOL_LEVELS:
                fail(f"styled kernel vs plain: {dmax} levels")
            worst["styled"] = max(worst["styled"], dmax)
    return worst


# ---------------------------------------------------------------------------
# Phase 3: headline
# ---------------------------------------------------------------------------


def phase_headline(torch, np, report):
    from swf_renderer_tpu_torch.ops.flatblock import (
        fusedn_plain, packed_to_frames, render_fused_blocksn,
    )
    from swf_renderer_tpu_torch.ops.pipeline import render_batch_flatblock
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    frames, layers, height, width = HEADLINE
    tables, colors = build_scene_edges(frames, layers, height, width, seed=7)
    _HELD["headline_scene"] = (tables, colors)

    # The main path, once, through the user entry point.
    render_fused_blocksn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_main = render_batch_flatblock(tables, colors, height, width,
                                      device=DEVICE)
    wall = time.perf_counter() - t0
    launches = render_fused_blocksn.launches
    if launches < 1:
        fail("render_batch_flatblock did not launch the fused kernel")
    if out_main.shape != (frames, height, width, 4):
        fail(f"headline frames {out_main.shape}")
    _HELD["headline_frames"] = out_main
    coverage = float((out_main[..., 3] > 0).mean())
    if not 0.05 < coverage < 1.0:
        fail(f"headline coverage share {coverage}")
    log(f"headline: render_batch_flatblock wall {wall * 1e3:.1f} ms "
        f"({frames * height * width / wall / 1e9:.3f} Gpx/s end to end), "
        f"kernel launches {launches}, covered share {coverage:.3f}")

    # Breakdown of the same path.
    t0 = time.perf_counter()
    dev_cpu, spp = pack_scene(tables, height, width, "cpu")
    t_lower = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = {k: (v.to(DEVICE) if torch.is_tensor(v) else v)
           for k, v in dev_cpu.items()}
    cols = torch.as_tensor(colors, device=DEVICE)
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    ns, nc = dev["ns"], dev["nc"]
    args = kernel_args(dev) + (cols, frames, layers, ns, nc)

    def kernel():
        return render_fused_blocksn(*args, spp=spp)

    def plain():
        return fusedn_plain(*args, spp=spp)

    ms = time_ms(torch, kernel, reps=5)
    plain_ms = time_ms(torch, plain, reps=3)
    ab = ab_times(torch, "fused_flatblock_solid (headline)", kernel)
    out = kernel()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = packed_to_frames(out, frames, ns, nc, spp, height, width)
    t_d2h = time.perf_counter() - t0
    if not np.array_equal(got, out_main):
        fail("headline: timed kernel output differs from the main path's")
    want = plain()
    dmax, share = byte_diff(out[:, :ns], want[:, :ns])
    log(f"headline: kernel vs plain over all {frames} frames: max diff "
        f"{dmax}, differing bytes {share:.3g}")
    if dmax > TOL_LEVELS:
        fail(f"headline kernel vs plain: {dmax} levels")
    nbytes, ops = work_counts(torch, dev, frames, layers, spp,
                              (0,) * layers, colors=cols)
    bound_ms, bound_by = bound(nbytes, ops)
    pixels = frames * height * width
    log(f"headline: host lowering {t_lower * 1e3:.1f} ms, H2D "
        f"{t_h2d * 1e3:.1f} ms, kernel {ms:.3f} ms "
        f"({pixels / ms / 1e6:.3f} Gpx/s), D2H {t_d2h * 1e3:.1f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} Gop)")
    report["headline"] = {
        "frames": frames, "layers": layers, "height": height,
        "width": width, "spp": spp, "groups": int(dev["urc"].shape[0]),
        "wall_ms": wall * 1e3, "host_lowering_ms": t_lower * 1e3,
        "h2d_ms": t_h2d * 1e3, "kernel_ms": ms, "d2h_ms": t_d2h * 1e3,
        "kernel_gpx_s": pixels / ms / 1e6,
        "end_to_end_gpx_s": pixels / wall / 1e9,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": nbytes, "ops": ops, "max_diff": dmax, "diff_share": share,
        "parent_ms": None if ab is None else ab["parent_ms"],
    }
    return {"name": "fused_flatblock_solid", "launches": launches,
            "max_abs_err": dmax, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


# ---------------------------------------------------------------------------
# Phase 4: renderer
# ---------------------------------------------------------------------------


def _shape_tag(ast, shape_id, fill, points):
    """A DefineShape of one closed polygon (twips) with one fill."""
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    records = [ast.StyleChangeRecord(
        left_fill=None, right_fill=1, line_style=None,
        move_to=ast.Vector2D(x=points[0][0], y=points[0][1]),
        new_styles=None)]
    for (x0, y0), (x1, y1) in zip(points, points[1:] + points[:1]):
        records.append(ast.EdgeRecord(delta=ast.Vector2D(x=x1 - x0,
                                                         y=y1 - y0)))
    return ast.DefineShape(
        id=shape_id,
        bounds=ast.Rect(x_min=min(xs), x_max=max(xs), y_min=min(ys),
                        y_max=max(ys)),
        shape=ast.ShapeBody(
            initial_styles=ast.ShapeStyles(fill=[fill], line=[]),
            records=records))


def _matrix(ast, tx, ty, scale=1.0):
    from swf_renderer_tpu_torch.utils.fixed import Sfixed16P16

    s = Sfixed16P16.from_value(scale)
    z = Sfixed16P16.from_value(0.0)
    return ast.Matrix(scale_x=s, scale_y=s, rotate_skew0=z, rotate_skew1=z,
                      translate_x=int(tx), translate_y=int(ty))


def build_stages(np, n_frames=3):
    """Stages of a 1920x1088 scene: a solid star that moves (and is a new
    definition) from frame to frame, a linear and a focal gradient and an
    axis-aligned bitmap fill."""
    from swf_renderer_tpu_torch.models import ast, display
    from swf_renderer_tpu_torch.runtime.bitmap_service import (
        encode_x_swf_bmp2_argb,
    )

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (24, 32, 4)).astype(np.uint8)
    bitmap = ast.DefineBitmap(id=9, width=32, height=24,
                              media_type="image/x-swf-bmp2",
                              data=encode_x_swf_bmp2_argb(img))
    grad = ast.Gradient(
        spread=ast.GradientSpread.PAD, color_space=ast.ColorSpace.S_RGB,
        colors=[ast.GradientStop(0, ast.StraightSRgba8(255, 0, 0, 255)),
                ast.GradientStop(128, ast.StraightSRgba8(0, 255, 0, 200)),
                ast.GradientStop(255, ast.StraightSRgba8(0, 0, 255, 255))])
    box = [(0, 0), (16000, 0), (16000, 12000), (0, 12000)]
    linear = _shape_tag(ast, 1, ast.LinearGradientFill(
        matrix=_matrix(ast, 8000, 6000, 0.5), gradient=grad), box)
    focal = _shape_tag(ast, 2, ast.FocalGradientFill(
        matrix=_matrix(ast, 20000, 12000, 0.6), gradient=grad,
        focal_point_epsilons=100), [(x + 14000, y + 6000) for x, y in box])
    bmp = _shape_tag(ast, 3, ast.BitmapFill(
        bitmap_id=9, matrix=_matrix(ast, 2000, 9000, 20.0), repeating=True,
        smoothed=True), [(x // 2 + 2000, y // 2 + 9000) for x, y in box])
    star = [(int(4000 * np.cos(a) * (1.0 if i % 2 else 0.45)),
             int(4000 * np.sin(a) * (1.0 if i % 2 else 0.45)))
            for i, a in enumerate(np.linspace(0, 2 * np.pi, 10,
                                              endpoint=False))]
    stages = []
    for f in range(n_frames):
        # A new star definition in every frame: the frames differ in
        # geometry, so the batch takes the fused route, not the sweep.
        solid = _shape_tag(ast, 4 + f, ast.SolidFill(
            ast.StraightSRgba8(40, 90, 200, 230)), star)
        stages.append(display.Stage(
            width=1920, height=1088,
            children=[
                display.ShapeInstance(definition=linear),
                display.ShapeInstance(definition=focal),
                display.ShapeInstance(definition=bmp),
                display.ShapeInstance(
                    definition=solid,
                    matrix=_matrix(ast, 9000 + 3000 * f, 10000 + 900 * f)),
            ]))
    return stages, bitmap


def phase_renderer(torch, np, report):
    from swf_renderer_tpu_torch.convert import packed_to_device
    from swf_renderer_tpu_torch.ops.flatblock import (
        fused_styled_plain, packed_to_frames, render_fused_styled,
    )
    from swf_renderer_tpu_torch.ops.pipeline import (
        _pack_styled, kernel_paints_for,
    )
    from swf_renderer_tpu_torch.runtime.renderer import TorchRenderer

    stages, bitmap = build_stages(np)
    renderer = TorchRenderer(1920, 1088, device=DEVICE)
    renderer.add_bitmap(bitmap)

    # The main path, once: render(stage) and render_batch(stages).
    render_fused_styled.launches = 0
    t0 = time.perf_counter()
    frame = renderer.render(stages[0])
    t_render = time.perf_counter() - t0
    path_one = renderer.last_stats.path
    t0 = time.perf_counter()
    batch = renderer.render_batch(stages)
    t_batch = time.perf_counter() - t0
    path_batch = renderer.last_stats.path
    launches = render_fused_styled.launches
    if launches < 2:
        fail(f"renderer launched the styled kernel {launches} times")
    if path_one != "flatblock" or path_batch != "batched-styled":
        fail(f"renderer paths {path_one!r}, {path_batch!r}")
    if frame.shape != (1088, 1920, 4) or batch.shape != (3, 1088, 1920, 4):
        fail(f"renderer shapes {frame.shape}, {batch.shape}")
    if not np.array_equal(batch[0], frame):
        fail("render_batch frame 0 differs from render(stage)")
    log(f"renderer: render {t_render * 1e3:.1f} ms (path {path_one}), "
        f"render_batch x{len(stages)} {t_batch * 1e3:.1f} ms (path "
        f"{path_batch}), styled launches {launches}")

    # Hold frame 0 against the plain version on the same inputs.
    draws = renderer._compiler().compile_stage(stages[0])
    paints = [d.paint for d in draws]
    tables = [[d.edges for d in draws]]
    *arrays, spp = _pack_styled(tables, 1088, 1920, None)
    kpaints, fields, base = kernel_paints_for(paints, 1088, 1920, spp=spp,
                                              device=DEVICE)
    dev = packed_to_device(*arrays, device=DEVICE)
    cols = torch.as_tensor(base[None], device=DEVICE)
    ns, nc = dev["ns"], dev["nc"]
    layers = len(paints)
    rules = tuple(d.fill_rule for d in draws)
    args = kernel_args(dev) + (cols, fields, 1, layers, ns, nc, kpaints)

    def kernel():
        return render_fused_styled(*args, fill_rule=rules, spp=spp)

    def plain():
        return fused_styled_plain(*args, fill_rule=rules, spp=spp)

    out = kernel()
    want = plain()
    torch.cuda.synchronize()
    dmax, share = byte_diff(out[:, :ns], want[:, :ns])
    got = packed_to_frames(out, 1, ns, nc, spp, 1088, 1920)[0]
    if not np.array_equal(got, frame):
        fail("renderer frame differs from a direct kernel call")
    log(f"renderer: kernel vs plain: max diff {dmax}, differing bytes "
        f"{share:.3g}, paint kinds {[p.kind for p in kpaints]}")
    if dmax > TOL_LEVELS:
        fail(f"styled kernel vs plain on the renderer frame: {dmax}")
    ms = time_ms(torch, kernel, reps=5)
    plain_ms = time_ms(torch, plain, reps=3)
    ab = ab_times(torch, "fused_flatblock_styled (renderer frame)", kernel)
    nbytes, ops = work_counts(torch, dev, 1, layers, spp, rules,
                              paints=kpaints, fields=fields, colors=cols)
    bound_ms, bound_by = bound(nbytes, ops)
    log(f"renderer: styled kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    report["renderer"] = {
        "render_ms": t_render * 1e3, "render_batch_ms": t_batch * 1e3,
        "batch_frames": len(stages), "layers": layers, "spp": spp,
        "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "max_diff": dmax, "diff_share": share,
        "parent_ms": None if ab is None else ab["parent_ms"],
    }
    return {"name": "fused_flatblock_styled", "launches": launches,
            "max_abs_err": dmax, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


# ---------------------------------------------------------------------------
# Phase 5: animation sweeps
# ---------------------------------------------------------------------------

SWEEP_SIZE = (1088, 1920)     # the animation benchmark's frame
SWEEP_FRAMES = 60
MORPH_RATIOS = 16


def _up(torch, np, x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(DEVICE)


def sweep_work_counts(torch, mats, tab_s, tab_e, ratios, counts, height,
                      width, rules, paints=None, fields=None, extra=()):
    """(bytes, f32 operations) the sweep function needs on these inputs:
    tables, tracks and field planes read once, one u32 written per pixel;
    operations = lerp and transform per piece and frame, the row-span
    terms per piece-row inside the frame, the ramp at every column such a
    piece-row crosses (counted from THIS run's transformed pieces), the
    per-pixel-layer winding, rule and composite, and the per-pixel
    quantize and pack."""
    from swf_renderer_tpu_torch.ops.coverage import edge_row_span
    from swf_renderer_tpu_torch.ops.flatblock import (
        KPAINT_FOCAL, KPAINT_LINEAR,
    )

    frames = (mats if mats is not None else ratios).shape[0]
    layers = tab_s.shape[0]
    ins = [t for t in (mats, tab_s, tab_e, ratios, fields) + tuple(extra)
           if t is not None]
    nbytes = (sum(t.numel() * t.element_size() for t in ins)
              + frames * height * width * 4)
    pieces = rows = columns = 0
    for lyr in range(layers):
        n = min(int(counts[lyr]), tab_s.shape[-1])
        x0, y0, x1, y1 = (tab_s[lyr, ch, 0, :n][None] for ch in range(4))
        if tab_e is not None:
            t = ratios[:, None]
            x0, y0, x1, y1 = (
                (1.0 - t) * v + t * tab_e[lyr, ch, 0, :n][None]
                for ch, v in enumerate((x0, y0, x1, y1)))
        if mats is not None:
            m = mats[:, lyr] if mats.ndim == 3 else mats
            a, b, c, d, e, g = (m[:, k, None] for k in range(6))
            x0, y0, x1, y1 = (a * x0 + c * y0 + e, b * x0 + d * y0 + g,
                              a * x1 + c * y1 + e, b * x1 + d * y1 + g)
        pieces += frames * n
        rowbase = torch.floor(torch.minimum(y0, y1))
        for k in (0.0, 1.0):
            py = rowbase + k
            dy, xmn, xmx = edge_row_span(x0, y0, x1, y1, py)
            live = (py >= 0) & (py < height) & (dy != 0)
            lo = torch.clamp(torch.floor(xmn), 0, width)
            hi = torch.clamp(torch.ceil(xmx) + 1, 0, width)
            rows += int(live.sum().item())
            columns += int(((hi - lo).clamp(min=0) * live).sum().item())
    per_piece = (12 if tab_e is not None else 0) + (
        16 if mats is not None else 0) + 3
    per_layer = 0
    for lyr in range(layers):
        per_layer += 2 + (2 if rules[lyr] == 0 else 5) + 11
        kind = paints[lyr].kind if paints else 0
        if kind in (KPAINT_LINEAR, KPAINT_FOCAL):
            k = len(paints[lyr].stop_ratios)
            per_layer += 8 + (2 if kind == KPAINT_LINEAR else 14) + 3
            per_layer += 4 * 6 * max(k - 1, 0)
    pixels = frames * height * width
    ops = (pieces * per_piece + rows * 22 + columns * 14
           + pixels * per_layer + pixels * 21)
    return nbytes, ops


def premul_bytes(np, frame):
    """(H, W, 4) straight u8 -> the premultiplied bytes it was rounded
    from (int32)."""
    x = frame.astype(np.int32)
    return np.concatenate(
        [(x[..., :3] * x[..., 3:] + 127) // 255, x[..., 3:]], -1)


def _check(torch, what, got, want, exact=False):
    """A sweep's frames against the plain version's: within TOL_LEVELS,
    or with ``exact`` (B3-B7) equal word for word."""
    torch.cuda.synchronize()
    dmax, share = byte_diff(got, want)
    same = bool(torch.equal(got, want))
    log(f"sweeps: {what}: max diff {dmax}, differing bytes {share:.3g}"
        f"{', words equal' if same else ''}")
    if dmax > TOL_LEVELS or (exact and not same):
        fail(f"sweep kernel vs plain ({what}): {dmax} levels, words "
             f"{'equal' if same else 'differ'}")
    return dmax


def sweeps_random(torch, np):
    """Each sweep kernel against the plain version on random scenes."""
    from swf_renderer_tpu_torch.ops import transform as sweep
    from swf_renderer_tpu_torch.ops.coverage import layer_rules
    from swf_renderer_tpu_torch.ops.morph import (
        morph_pieces, render_morph_sweep,
    )
    from swf_renderer_tpu_torch.utils.scenes import (
        random_blobs, random_tracks,
    )

    rng = np.random.default_rng(17)
    worst = {"affine": 0, "morph_affine": 0, "morph": 0}
    frames = 3
    for height, width in ((100, 150), (400, 550)):
        for layers in (1, 3, 16):
            tables = random_blobs(rng, layers, height, width)
            tracks = random_tracks(rng, frames, layers, height, width)
            mixed = tuple(int(x) for x in rng.integers(0, 2, layers))
            colors = rng.uniform(0.1, 1, (frames, layers, 4))
            for rule, mats, cols in ((0, tracks[:, 0], colors[0]),
                                     (1, tracks, colors),
                                     (mixed, tracks, colors[0])):
                tab, _ = sweep.affine_pieces(tables, [(0,) * 4] * layers,
                                             mats)
                counts = sweep.layer_piece_counts(tab)
                args = (_up(torch, np, mats), _up(torch, np, tab),
                        _up(torch, np, cols), height, width)
                got = sweep.render_affine_sweep(
                    *args, fill_rule=rule, layer_counts=counts)
                want = sweep.sweep_plain(
                    args[0], args[1], None, None, args[2], None, height,
                    width, layer_rules(rule, layers),
                    tuple(min(c, tab.shape[-1]) for c in counts))
                tag = rule if isinstance(rule, int) else "mixed"
                worst["affine"] = max(worst["affine"], _check(
                    torch, f"affine {height}x{width} L={layers} rule={tag} "
                    f"mats{tuple(mats.shape)}", got, want, exact=True))

            # Styled: the paint kinds of phase 2, matrices and stops per
            # frame, field planes per frame.
            paints, n_fields = random_paints(rng, layers)
            gm = rng.uniform(-1, 1, (frames, layers, 6)) * 4
            gm[..., 0] += 30.0
            gm[..., 3] += 30.0
            gm[..., 4:] = rng.uniform(-20000, -10000, (frames, layers, 2))
            fields = (_up(torch, np, rng.uniform(
                0, 1, (n_fields, frames, height, width, 4)))
                if n_fields else None)
            tab, _ = sweep.affine_pieces(tables, [(0,) * 4] * layers, tracks)
            counts = tuple(min(c, tab.shape[-1])
                           for c in sweep.layer_piece_counts(tab))
            for stops in (None, rng.uniform(0, 1, (frames, layers, 5, 4))):
                if layers == 1 and stops is not None:
                    continue   # a single COLOR layer takes no stops
                kw = dict(paints=paints if layers > 1 else None,
                          grad_mats=(_up(torch, np, gm) if layers > 1
                                     else None),
                          stop_colors=(None if stops is None
                                       else _up(torch, np, stops)),
                          fields=fields)
                args = (_up(torch, np, tracks), _up(torch, np, tab),
                        _up(torch, np, colors), height, width)
                got = sweep.render_affine_sweep(
                    *args, fill_rule=mixed, layer_counts=counts, **kw)
                want = sweep.sweep_plain(
                    args[0], args[1], None, None, args[2], None, height,
                    width, mixed, counts, **kw)
                worst["affine"] = max(worst["affine"], _check(
                    torch, f"styled affine {height}x{width} L={layers} "
                    f"kinds={[p.kind for p in paints]} "
                    f"stops={'per-frame' if stops is not None else 'static'}",
                    got, want, exact=True))

            # Morph + affine and the ratio sweep on the same pairs.
            pairs = [(s, s + rng.uniform(-9, 9, s.shape).astype(np.float32),
                      rng.uniform(0.1, 1, 4), rng.uniform(0.1, 1, 4))
                     for s in tables]
            ratios = _up(torch, np, np.array([0.0, 0.41, 1.0]))
            tab_s, tab_e, cs, ce = sweep.morph_affine_pieces(pairs, tracks)
            counts = tuple(min(max(a, b), tab_s.shape[-1]) for a, b in zip(
                sweep.layer_piece_counts(tab_s),
                sweep.layer_piece_counts(tab_e)))
            args = (_up(torch, np, tracks), ratios, _up(torch, np, tab_s),
                    _up(torch, np, tab_e), _up(torch, np, cs),
                    _up(torch, np, ce), height, width)
            got = sweep.render_morph_affine_sweep(
                *args, fill_rule=mixed, layer_counts=counts)
            want = sweep.sweep_plain(
                args[0], args[2], args[3], ratios, args[4], args[5], height,
                width, mixed, counts)
            worst["morph_affine"] = max(worst["morph_affine"], _check(
                torch, f"morph-affine {height}x{width} L={layers}", got,
                want, exact=True))
            tab_s, tab_e, cs, ce = morph_pieces(pairs)
            args = (ratios, _up(torch, np, tab_s), _up(torch, np, tab_e),
                    _up(torch, np, cs), _up(torch, np, ce), height, width)
            got = render_morph_sweep(*args, fill_rule=mixed)
            want = sweep.sweep_plain(
                None, args[1], args[2], ratios, args[3], args[4], height,
                width, mixed, (tab_s.shape[-1],) * layers)
            worst["morph"] = max(worst["morph"], _check(
                torch, f"morph {height}x{width} L={layers}", got, want,
                exact=True))
    return worst


def _polygons_tag(ast, shape_id, fill, polygons):
    """A DefineShape of several closed polygons (twips) with one fill."""
    records = []
    for pts in polygons:
        records.append(ast.StyleChangeRecord(
            left_fill=None, right_fill=1, line_style=None,
            move_to=ast.Vector2D(x=pts[0][0], y=pts[0][1]),
            new_styles=None))
        for (x0, y0), (x1, y1) in zip(pts, pts[1:] + pts[:1]):
            records.append(ast.EdgeRecord(
                delta=ast.Vector2D(x=x1 - x0, y=y1 - y0)))
    xs = [p[0] for pts in polygons for p in pts]
    ys = [p[1] for pts in polygons for p in pts]
    return ast.DefineShape(
        id=shape_id,
        bounds=ast.Rect(x_min=min(xs), x_max=max(xs), y_min=min(ys),
                        y_max=max(ys)),
        shape=ast.ShapeBody(
            initial_styles=ast.ShapeStyles(fill=[fill], line=[]),
            records=records))


def _rotation(ast, th, width, height):
    """SWF matrix rotating by ``th`` about the frame centre."""
    from swf_renderer_tpu_torch.utils.fixed import Sfixed16P16

    a, b = math.cos(th), math.sin(th)
    cx, cy = width * 10.0, height * 10.0    # centre in twips
    return ast.Matrix(
        scale_x=Sfixed16P16.from_value(a), scale_y=Sfixed16P16.from_value(a),
        rotate_skew0=Sfixed16P16.from_value(b),
        rotate_skew1=Sfixed16P16.from_value(-b),
        translate_x=int(round(cx - a * cx + b * cy)),
        translate_y=int(round(cy - b * cx - a * cy)))


def rotating_stages(np, frames, bitmap=None, phase=0.0):
    """The animation scene as a display list: one DefineShape per layer
    (its 12 blobs, in twips), every instance under the frame's rotation
    about the centre, starting at ``phase``.  With ``bitmap`` (a
    DefineBitmap), layer 1 is filled with it, repeating and smoothed, one
    texel to 20 px (animtex's fill at this width)."""
    from swf_renderer_tpu_torch.models import ast, display
    from swf_renderer_tpu_torch.utils.scenes import anim_scene

    height, width = SWEEP_SIZE
    tables, colors, _ = anim_scene(height, width, frames)
    tags = []
    for lyr, (table, color) in enumerate(zip(tables, colors)):
        pts = np.rint(table[:, :2] * 20).astype(int).reshape(12, 10, 2)
        polygons = [[(int(x), int(y)) for x, y in blob] for blob in pts]
        rgba = [int(round(float(c) * 255)) for c in color]
        fill = ast.SolidFill(ast.StraightSRgba8(*rgba))
        if bitmap is not None and lyr == 1:
            fill = ast.BitmapFill(bitmap_id=bitmap.id,
                                  matrix=_matrix(ast, 0, 0, 400.0),
                                  repeating=True, smoothed=True)
        tags.append(_polygons_tag(ast, 30 + lyr, fill, polygons))
    return [display.Stage(width=width, height=height, children=[
        display.ShapeInstance(
            definition=tag,
            matrix=_rotation(ast, phase + 2 * np.pi * i / frames, width,
                             height))
        for tag in tags]) for i in range(frames)]


def morph_stages(np, frames):
    """A morph timeline: one DefineMorphShape (a polygon morphing into
    another) whose ratio runs 0..1 while it drifts across the frame."""
    from swf_renderer_tpu_torch.models import ast, display
    from swf_renderer_tpu_torch.utils.fixed import Sfixed16P16

    height, width = SWEEP_SIZE
    ang = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    start = [(int(9000 + 7000 * np.cos(a)), int(9000 + 7000 * np.sin(a)))
             for a in ang]
    end = [(int(9000 + (5000 if i % 2 else 8500) * np.cos(a + 0.3)),
            int(9000 + (5000 if i % 2 else 8500) * np.sin(a + 0.3)))
           for i, a in enumerate(ang)]

    def v(p):
        return ast.Vector2D(x=p[0], y=p[1])

    records = [ast.MorphStyleChangeRecord(
        right_fill=1, move_to=v(start[0]), morph_move_to=v(end[0]))]
    for i in range(12):
        j = (i + 1) % 12
        records.append(ast.MorphEdgeRecord(
            delta=v((start[j][0] - start[i][0], start[j][1] - start[i][1])),
            morph_delta=v((end[j][0] - end[i][0], end[j][1] - end[i][1]))))
    fill = ast.MorphSolidFill(color=ast.StraightSRgba8(255, 40, 0, 255),
                              morph_color=ast.StraightSRgba8(0, 80, 255, 160))
    tag = ast.DefineMorphShape(
        id=40, bounds=ast.Rect(0, 18000, 0, 18000),
        morph_bounds=ast.Rect(0, 18000, 0, 18000),
        shape=ast.MorphShapeBody(
            initial_styles=ast.MorphShapeStyles(fill=(fill,), line=()),
            records=tuple(records)))
    one, zero = Sfixed16P16.from_value(1.0), Sfixed16P16.from_value(0.0)
    return [display.Stage(width=width, height=height, children=[
        display.MorphShapeInstance(
            definition=tag, ratio=i / (frames - 1.0),
            matrix=ast.Matrix(scale_x=one, scale_y=one, rotate_skew0=zero,
                              rotate_skew1=zero, translate_x=1200 * i,
                              translate_y=150 * i))])
        for i in range(frames)]


def _record_sweeps(sweep):
    """Record every column or row-band sweep launch (its arguments and
    its words) until the returned ``restore`` is called: a route's frames
    are then held against ``sweep_plain`` on the very tables the route
    built.  Recording launches nothing and touches no count."""
    calls = []
    launch = sweep._launch_sweep

    def recorded(*args, **kwargs):
        out = launch(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    sweep._launch_sweep = recorded
    return calls, lambda: setattr(sweep, "_launch_sweep", launch)


def _route_equals_plain(torch, sweep, what, calls):
    """Each recorded launch's words equal ``sweep_plain``'s on its own
    arguments -> the number of words compared."""
    words = 0
    for args, kwargs, out in calls:
        plain = {k: v for k, v in kwargs.items() if k != "rows"}
        want = sweep.sweep_plain(*args, **plain)
        if out.shape != want.shape or not torch.equal(out, want):
            bad = (int((out != want).sum()) if out.shape == want.shape
                   else "all")
            fail(f"{what}: {bad} words differ from sweep_plain")
        words += out.numel()
    calls.clear()
    return words


def sweeps_entry_points(torch, np, report):
    """The slice's main path through the user entry points, launch
    counters set to 0 before and read after -> launches per kernel.
    Every route's frames equal sweep_plain's words on the tables the
    route built."""
    from swf_renderer_tpu_torch.ops import transform as sweep
    from swf_renderer_tpu_torch.ops.morph import render_morph_sweep

    wrappers = {"affine": sweep.render_affine_sweep,
                "morph_affine": sweep.render_morph_affine_sweep,
                "morph": render_morph_sweep}
    for w in wrappers.values():
        w.launches = 0
    calls, restore = _record_sweeps(sweep)
    try:
        return _sweep_routes(torch, np, report, sweep, wrappers, calls)
    finally:
        restore()


def _sweep_routes(torch, np, report, sweep, wrappers, calls):
    """sweeps_entry_points' routes, each launch recorded in ``calls``."""
    from swf_renderer_tpu_torch.ops.morph import (
        morph_frames_to_u8, morph_pieces, render_morph_sweep,
    )
    from swf_renderer_tpu_torch.runtime.renderer import TorchRenderer

    height, width = SWEEP_SIZE
    stages = rotating_stages(np, SWEEP_FRAMES)
    renderer = TorchRenderer(width, height, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = renderer.render_batch(stages)
    wall = time.perf_counter() - t0
    path = renderer.last_stats.path
    if path != "transform-sweep":
        fail(f"render_batch of the rotating display list took {path!r}")
    if wrappers["affine"].launches != 1:
        fail(f"render_batch launched the affine sweep "
             f"{wrappers['affine'].launches} times, expected exactly 1")
    if frames.shape != (SWEEP_FRAMES, height, width, 4):
        fail(f"sweep frames {frames.shape}")
    exact = {"render_batch": _route_equals_plain(
        torch, sweep, "render_batch (affine sweep)", calls)}
    covered = float((frames[..., 3] > 0).mean())
    if not 0.01 < covered < 1.0:
        fail(f"sweep covered share {covered}")
    probe = 7
    one = TorchRenderer(width, height, device=DEVICE).render(stages[probe])
    # Held in the premultiplied bytes the pipeline rounds: un-premultiplying
    # scales one level by 255 / alpha, so a translucent AA pixel can move
    # many straight levels.
    straight = np.abs(frames[probe].astype(np.int32) - one.astype(np.int32))
    diff = np.abs(premul_bytes(np, frames[probe]) - premul_bytes(np, one))
    far = float((diff > 1).mean())
    log(f"sweeps: render_batch x{SWEEP_FRAMES} wall {wall * 1e3:.1f} ms "
        f"(path {path}, {renderer.last_stats.draws // SWEEP_FRAMES} layers, "
        f"1 sweep launch, covered share {covered:.3f}); frame {probe} vs "
        f"render(stage): max {int(diff.max())} premultiplied levels, share "
        f"> 1 level {far:.3g} (straight bytes: max {int(straight.max())}, "
        f"differing {float((straight != 0).mean()):.3g})")
    if diff.max() > 2 or far >= 1e-3:
        fail(f"sweep frame vs per-frame render: {int(diff.max())} levels, "
             f"share {far}")
    exact["render"] = _route_equals_plain(torch, sweep, "render (probe)",
                                          calls)

    mstages = morph_stages(np, MORPH_RATIOS)
    t0 = time.perf_counter()
    mframes = renderer.render_batch(mstages)
    mwall = time.perf_counter() - t0
    if (renderer.last_stats.path != "transform-sweep"
            or wrappers["morph_affine"].launches != 1):
        fail(f"morph timeline: path {renderer.last_stats.path!r}, "
             f"morph-affine launches {wrappers['morph_affine'].launches}")
    if float((mframes[..., 3] > 0).mean()) < 0.01:
        fail("morph timeline rendered nothing")
    exact["morph_timeline"] = _route_equals_plain(
        torch, sweep, "render_batch (morph timeline)", calls)
    log(f"sweeps: render_batch morph timeline x{MORPH_RATIOS} wall "
        f"{mwall * 1e3:.1f} ms (1 morph-affine launch, "
        f"{exact['morph_timeline']} words equal to sweep_plain)")

    # render_morph_sweep is its own entry point (no renderer route).
    pairs = morph_pairs(np)
    tab_s, tab_e, cs, ce = morph_pieces(pairs)
    ratios = np.linspace(0.0, 1.0, MORPH_RATIOS, dtype=np.float32)
    t0 = time.perf_counter()
    out = morph_frames_to_u8(render_morph_sweep(
        ratios, tab_s, tab_e, cs, ce, height, width, device=DEVICE),
        height, width)
    rwall = time.perf_counter() - t0
    if wrappers["morph"].launches != 1 or not out[..., 3].any():
        fail(f"render_morph_sweep launches {wrappers['morph'].launches}")
    exact["render_morph_sweep"] = _route_equals_plain(
        torch, sweep, "render_morph_sweep", calls)
    log(f"sweeps: render_morph_sweep x{MORPH_RATIOS} wall "
        f"{rwall * 1e3:.1f} ms (1 launch, "
        f"{exact['render_morph_sweep']} words equal to sweep_plain)")
    report["sweep_entry"] = {
        "render_batch_ms": wall * 1e3, "frames": SWEEP_FRAMES,
        "morph_timeline_ms": mwall * 1e3, "render_morph_sweep_ms": rwall * 1e3,
        "probe_max_diff": int(diff.max()), "probe_share_gt1": far,
        "words_equal_plain": exact}
    return {k: w.launches for k, w in wrappers.items()}


def morph_pairs(np):
    """Start/end pairs from two blob sets of the animation scene's kind
    (seeds 9 and 10): blob i of one morphs into blob i of the other."""
    from swf_renderer_tpu_torch.utils.scenes import anim_scene

    height, width = SWEEP_SIZE
    start, c0, _ = anim_scene(height, width, 1, seed=9)
    end, c1, _ = anim_scene(height, width, 1, seed=10)
    return [(s, e, a, b) for s, e, a, b in zip(start, end, c0, c1)]


def _timed_sweep(torch, what, kernel, plain, counts_args, report,
                 exact=False):
    """Time one full-width sweep, hold every frame against the plain
    version (``exact``: word for word), work out its bound."""
    ms = time_ms(torch, kernel, reps=5)
    got = kernel()
    held = {}

    def plain_once():
        held["want"] = plain()

    plain_ms = time_ms(torch, plain_once, reps=1, warmup=0)
    dmax = _check(torch, f"{what}: all {got.shape[0]} frames", got,
                  held.pop("want"), exact)
    nbytes, ops = sweep_work_counts(torch, *counts_args)
    bound_ms, bound_by = bound(nbytes, ops)
    pixels = got.numel()
    log(f"sweeps: {what}: kernel {ms:.3f} ms ({pixels / ms / 1e6:.3f} "
        f"Gpx/s), plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} Gop)")
    report[what] = {"kernel_ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bytes": nbytes, "ops": ops, "max_diff": dmax,
                    "frames": int(got.shape[0])}
    return {"max_abs_err": dmax, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def sweeps_full_width(torch, np, report):
    """The animation benchmark scene uncut, and morph runs at its size."""
    from swf_renderer_tpu_torch.ops import style as style_ops
    from swf_renderer_tpu_torch.ops import transform as sweep
    from swf_renderer_tpu_torch.ops.morph import (
        morph_frames_to_u8, morph_pieces, render_morph_sweep,
    )
    from swf_renderer_tpu_torch.utils.scenes import anim_scene

    height, width = SWEEP_SIZE
    frames = SWEEP_FRAMES
    tables, colors, mats = anim_scene(height, width, frames)
    layers = len(tables)
    t0 = time.perf_counter()
    tab, colarr = sweep.affine_pieces(tables, colors, mats)
    counts = sweep.layer_piece_counts(tab)
    t_split = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_mats, d_tab, d_col = (_up(torch, np, x) for x in (mats, tab, colarr))
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    rules = (0,) * layers

    def kernel():
        return sweep.render_affine_sweep(d_mats, d_tab, d_col, height, width,
                                         layer_counts=counts)

    def plain():
        return sweep.sweep_plain(d_mats, d_tab, None, None, d_col, None,
                                 height, width, rules, counts)

    out = {"affine": _timed_sweep(
        torch, "anim1080", kernel, plain,
        (d_mats, d_tab, None, None, counts, height, width, rules, None,
         None, (d_col,)), report, exact=True)}
    ab_times(torch, "affine_sweep B3 (anim1080)", kernel, "swfsweep")
    res = kernel()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = morph_frames_to_u8(res, height, width)
    t_d2h = time.perf_counter() - t0
    log(f"sweeps: anim1080 host piece split {t_split * 1e3:.1f} ms "
        f"({tab.shape[-1]} pieces a layer), H2D {t_h2d * 1e3:.2f} ms, D2H "
        f"{t_d2h * 1e3:.1f} ms, covered share "
        f"{float((host[..., 3] > 0).mean()):.3f}")
    report["anim1080"].update(piece_split_ms=t_split * 1e3,
                              h2d_ms=t_h2d * 1e3, d2h_ms=t_d2h * 1e3,
                              pieces_per_layer=int(tab.shape[-1]))
    del host, res

    # Layer 1 as a linear gradient whose stops fade frame by frame.
    base_stops = np.array([[1, 0.2, 0, 1], [0, 1, 0.5, 0.8], [0.2, 0, 1, 1]],
                          np.float32)
    paints = [style_ops.solid_paint(tuple(c)) for c in colors]
    paints[1] = style_ops.Paint(
        kind=style_ops.PAINT_LINEAR,
        inv_matrix=(2.0 * 16384.0 / width, 0.0, 0.0, 2.0 * 16384.0 / width,
                    -16384.0, -16384.0 * height / width),
        stop_ratios=np.array([0.0, 0.5, 1.0], np.float32),
        stop_colors=base_stops)
    kpaints, grad_mats = sweep.sweep_paints(paints, mats)
    stop_colors = np.zeros((frames, layers, 3, 4), np.float32)
    fade = np.linspace(1.0, 0.4, frames, dtype=np.float32)
    stop_colors[:, 1] = base_stops[None] * fade[:, None, None]
    d_gm, d_sc = _up(torch, np, grad_mats), _up(torch, np, stop_colors)

    def kernel_g():
        return sweep.render_affine_sweep(
            d_mats, d_tab, d_col, height, width, layer_counts=counts,
            paints=kpaints, grad_mats=d_gm, stop_colors=d_sc)

    def plain_g():
        return sweep.sweep_plain(d_mats, d_tab, None, None, d_col, None,
                                 height, width, rules, counts,
                                 paints=kpaints, grad_mats=d_gm,
                                 stop_colors=d_sc)

    grad = _timed_sweep(
        torch, "anim1080_gradient", kernel_g, plain_g,
        (d_mats, d_tab, None, None, counts, height, width, rules, kpaints,
         None, (d_col, d_gm, d_sc)), report, exact=True)
    ab_times(torch, "affine_sweep B3 styled (anim1080_gradient)", kernel_g,
             "swfsweep")
    out["affine"]["max_abs_err"] = max(out["affine"]["max_abs_err"],
                                       grad["max_abs_err"])

    # Morph + affine: 16 frames, the rotation track's first 16 matrices.
    pairs = morph_pairs(np)
    m16 = mats[:MORPH_RATIOS]
    ratios = np.linspace(0.0, 1.0, MORPH_RATIOS, dtype=np.float32)
    tab_s, tab_e, cs, ce = sweep.morph_affine_pieces(pairs, m16)
    mcounts = tuple(min(max(a, b), tab_s.shape[-1]) for a, b in zip(
        sweep.layer_piece_counts(tab_s), sweep.layer_piece_counts(tab_e)))
    d = [_up(torch, np, x) for x in (m16, ratios, tab_s, tab_e, cs, ce)]

    def kernel_ma():
        return sweep.render_morph_affine_sweep(*d, height, width,
                                               layer_counts=mcounts)

    def plain_ma():
        return sweep.sweep_plain(d[0], d[2], d[3], d[1], d[4], d[5], height,
                                 width, rules, mcounts)

    out["morph_affine"] = _timed_sweep(
        torch, "morph_affine1080", kernel_ma, plain_ma,
        (d[0], d[2], d[3], d[1], mcounts, height, width, rules, None, None,
         (d[4], d[5])), report, exact=True)
    ab_times(torch, "morph_affine_sweep B6 (morph_affine1080)", kernel_ma,
             "swfsweep")

    tab_s, tab_e, cs, ce = morph_pieces(pairs)
    e = [_up(torch, np, x) for x in (ratios, tab_s, tab_e, cs, ce)]
    full = (tab_s.shape[-1],) * layers

    def kernel_m():
        return render_morph_sweep(*e, height, width)

    def plain_m():
        return sweep.sweep_plain(None, e[1], e[2], e[0], e[3], e[4], height,
                                 width, rules, full)

    out["morph"] = _timed_sweep(
        torch, "morph1080", kernel_m, plain_m,
        (None, e[1], e[2], e[0], full, height, width, rules, None, None,
         (e[3], e[4])), report, exact=True)
    ab_times(torch, "morph_sweep B7 (morph1080)", kernel_m, "swfsweep")
    return out


def phase_sweeps(torch, np, report):
    worst = sweeps_random(torch, np)
    launches = sweeps_entry_points(torch, np, report)
    kernels = sweeps_full_width(torch, np, report)
    names = {"affine": "affine_sweep", "morph_affine": "morph_affine_sweep",
             "morph": "morph_sweep"}
    for key, k in kernels.items():
        k.update(name=names[key], launches=launches[key],
                 max_abs_err=max(k["max_abs_err"], worst[key]))
        if k["launches"] < 1:
            fail(f"{names[key]}: no launch on the main path")
    return kernels


# ---------------------------------------------------------------------------
# Phase 6: bitmaps (the texfield kernel)
# ---------------------------------------------------------------------------

ANIMTEX = (512, 512, 60)      # bench.py bench_animtex: height, width, frames
TEX_TOL = 1e-6                # field max abs difference, kernel vs plain
TEX_EDGES = {"repeat": (True, "flash"), "clamp": (False, "flash"),
             "canvas": (False, "canvas")}


def texfield_work(frames, height, width, texels, n, smoothed):
    """(bytes, f32 operations) of one texfield call: the u8 texture and
    the inverses read once, the f32 planes written once; per subsample the
    coordinate (10), the bilinear setup and blend (46) or nothing for
    nearest, the accumulate (4); per pixel the divisions of the average
    and the un-premultiply (9).  Address arithmetic is not counted."""
    nbytes = texels * 4 + frames * 24 + frames * height * width * 16
    per_sub = 10 + (46 if smoothed else 0) + 4
    return nbytes, frames * height * width * (n * n * per_sub + 9)


def _fields_u8(torch, f):
    return torch.round(torch.clamp(f, 0.0, 1.0) * 255.0).to(torch.uint8)


def _check_fields(torch, what, got, want):
    torch.cuda.synchronize()
    err = float((got - want).abs().max().item())
    same_u8 = torch.equal(_fields_u8(torch, got), _fields_u8(torch, want))
    log(f"bitmaps: {what}: field max abs diff {err:.3g}, u8 "
        f"{'byte-equal' if same_u8 else 'DIFFERENT'}")
    if err > TEX_TOL or not same_u8:
        fail(f"texfield kernel vs plain ({what}): {err}")
    return err


def _tex_invs(np, rng, th, tw):
    """Identity, rotated, skewed and extreme-zoom device->texel inverses,
    offsets that carry samples across the texture's edges, and one far
    beyond 2^24 texels (the float remainder of the repeat wrap)."""
    rot = rng.uniform(0, 2 * np.pi)
    s = rng.uniform(0.05, 0.4)
    return np.asarray([
        (1.0, 0.0, 0.0, 1.0, -0.5 * tw, -0.25 * th),
        (s * np.cos(rot), s * np.sin(rot), -s * np.sin(rot), s * np.cos(rot),
         rng.uniform(-tw, tw), rng.uniform(-th, th)),
        (0.3, 0.17, -0.11, 0.26, rng.uniform(-tw, 0), rng.uniform(-th, 0)),
        (7.5, 1.25, -0.75, 6.0, -3 * tw, 2 * th),
        (0.004, 0.001, -0.0007, 0.005, 0.5 * tw, 0.5 * th),
        (2.5, 0.3, -0.4, 2.0, -3.1e7, 2.7e7),   # beyond 2^24 texels
    ], np.float32)


def texfield_random(torch, np):
    """The kernel against its plain version: every fetch mode, smoothed
    and nearest, supersample 1/2/4, textures 17x23, 64x64 and 512x512, on
    a ragged frame."""
    from swf_renderer_tpu_torch.ops.texfield import (
        bitmap_field_planes, texfield_plain,
    )

    rng = np.random.default_rng(29)
    height, width = 75, 133
    worst = 0.0
    for shape in ((17, 23), (64, 64), (512, 512)):
        img = rng.integers(0, 256, (*shape, 4)).astype(np.uint8)
        img[:3, :5, 3] = 0
        d_img = torch.from_numpy(img).to(DEVICE)
        for edge, (repeating, edge_mode) in TEX_EDGES.items():
            for smoothed in (True, False):
                for n in (1, 2, 4):
                    invs = _up(torch, np, _tex_invs(np, rng, *shape))
                    got = bitmap_field_planes(
                        d_img, invs, height, width, n, repeating, smoothed,
                        edge_mode, device=DEVICE)
                    want = texfield_plain(d_img, invs, height, width, n,
                                          repeating, smoothed, edge_mode)
                    worst = max(worst, _check_fields(
                        torch, f"{shape[0]}x{shape[1]} {edge} "
                        f"{'bilinear' if smoothed else 'nearest'} n={n}",
                        got, want))
    return worst


def texfield_forms_random(torch, np):
    """Every instantiation of the texfield kernel against its plain
    version, bit for bit: n 1, 2, 4 (unrolled) and 3 (the run-time body)
    x bilinear / nearest x repeat / clamp / canvas, on textures of 64x64
    (power-of-two sides: the wrap a mask), 37x23 (remainders) and 32x48
    (one of each), with _tex_invs's inverses (samples below zero, across
    the edges and beyond 2^24 texels).  Returns the number of cases."""
    from swf_renderer_tpu_torch.ops.texfield import (
        bitmap_field_planes, texfield_plain,
    )

    rng = np.random.default_rng(37)
    height, width = 75, 133
    cases = 0
    for shape in ((64, 64), (37, 23), (32, 48)):
        img = rng.integers(0, 256, (*shape, 4)).astype(np.uint8)
        img[:2, :3, 3] = 0
        d_img = torch.from_numpy(img).to(DEVICE)
        for edge, (repeating, edge_mode) in TEX_EDGES.items():
            for smoothed in (True, False):
                for n in (1, 2, 3, 4):
                    invs = _up(torch, np, _tex_invs(np, rng, *shape))
                    got = bitmap_field_planes(
                        d_img, invs, height, width, n, repeating, smoothed,
                        edge_mode, device=DEVICE)
                    want = texfield_plain(d_img, invs, height, width, n,
                                          repeating, smoothed, edge_mode)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        err = float((got - want).abs().max().item())
                        fail(f"texfield form {shape[0]}x{shape[1]} {edge} "
                             f"{'bilinear' if smoothed else 'nearest'} "
                             f"n={n}: not bit-equal to its plain version "
                             f"(max abs {err:.3g})")
                    cases += 1
    log(f"bitmaps: {cases} texfield forms (n 1/2/3/4 x bilinear/nearest x "
        f"repeat/clamp/canvas x 64x64, 37x23, 32x48) bit-equal to the "
        f"plain version")
    return cases


def library_yardstick(torch, np, report):
    """grid_sample (bilinear, border padding) computes the texfield of a
    supersample-1 clamped fill up to the final un-premultiply; timed
    beside the kernel on the same inverse at 1088x1920 (not used by the
    port)."""
    from swf_renderer_tpu_torch.ops.texfield import (
        bitmap_field_planes, premultiplied_texels,
    )

    height, width = SWEEP_SIZE
    rng = np.random.default_rng(31)
    img = torch.from_numpy(rng.integers(0, 256, (512, 512, 4)).astype(
        np.uint8)).to(DEVICE)
    inv = np.asarray([(0.21, 0.08, -0.08, 0.21, 40.0, -30.0)], np.float32)
    d_inv = _up(torch, np, inv)
    py, px = torch.meshgrid(
        torch.arange(height, device=DEVICE, dtype=torch.float32) + 0.5,
        torch.arange(width, device=DEVICE, dtype=torch.float32) + 0.5,
        indexing="ij")
    a, b, c, d, e, f = (float(v) for v in inv[0])
    sx, sy = a * px + c * py + e, b * px + d * py + f
    grid = torch.stack([2.0 * sx / 512 - 1.0, 2.0 * sy / 512 - 1.0],
                       -1)[None]
    tex = premultiplied_texels(img).permute(2, 0, 1)[None].contiguous()

    def library():
        return torch.nn.functional.grid_sample(
            tex, grid, mode="bilinear", padding_mode="border",
            align_corners=False)

    def kernel():
        return bitmap_field_planes(img, d_inv, height, width, 1, False, True,
                                   "flash", device=DEVICE)

    lib_ms = time_ms(torch, library)
    ms = time_ms(torch, kernel)
    ab = ab_times(torch, "texfield (yardstick)", kernel, "swftexfield")
    log(f"bitmaps: yardstick {height}x{width} supersample-1 clamp: kernel "
        f"{ms:.3f} ms, grid_sample {lib_ms:.3f} ms")
    report["texfield_yardstick"] = {
        "kernel_ms": ms, "grid_sample_ms": lib_ms,
        "parent_ms": None if ab is None else ab["parent_ms"]}


def animtex_run(torch, np, what, height, width, frames, report):
    """bench.py's animtex function at one size: layer 1 of the animation
    scene as a repeating, smoothed 64x64 texture; sweep_paints ->
    bake_sweep_fields (frame 0 axis-aligned: a mixed track) ->
    render_affine_sweep.  Bake kernel, whole bake, sweep and download
    timed; every frame held against the plain versions."""
    from swf_renderer_tpu_torch.ops import style as style_ops
    from swf_renderer_tpu_torch.ops import transform as sweep
    from swf_renderer_tpu_torch.ops.morph import morph_frames_to_u8
    from swf_renderer_tpu_torch.ops.texfield import (
        bitmap_field_planes, texfield_plain,
    )
    from swf_renderer_tpu_torch.utils.scenes import anim_scene

    tables, colors, mats = anim_scene(height, width, frames)
    img = np.random.default_rng(11).integers(0, 256, (64, 64, 4)).astype(
        np.uint8)
    paints = [style_ops.solid_paint(tuple(c)) for c in colors]
    paints[1] = style_ops.Paint(
        kind=style_ops.PAINT_BITMAP,
        inv_matrix=(96.0 / width, 0.0, 0.0, 96.0 / width, 0.0, 0.0),
        image=img, repeating=True, smoothed=True, supersample=2)
    kpaints, grad_mats, specs = sweep.sweep_paints(paints, mats,
                                                   allow_fields=True)
    tab, colarr = sweep.affine_pieces(tables, colors, mats)
    counts = sweep.layer_piece_counts(tab)
    sep = style_ops.separable_frames_mask(paints[1], specs[0].invs)
    if not sep[0] or sep[1:].any():
        fail(f"{what}: expected frame 0 alone axis-aligned, got {sep}")
    rest = _up(torch, np, specs[0].invs[~sep])
    d_img = torch.from_numpy(img).to(DEVICE)
    d_mats, d_tab, d_col = (_up(torch, np, x) for x in (mats, tab, colarr))
    rules = (0,) * len(tables)

    def bake_kernel():
        return bitmap_field_planes(d_img, rest, height, width, 2, True, True,
                                   "flash", device=DEVICE)

    def bake():
        return sweep.bake_sweep_fields(specs, height, width, device=DEVICE)

    ms = time_ms(torch, bake_kernel)
    ab = ab_times(torch, f"texfield ({what})", bake_kernel, "swftexfield")
    bake_ms = time_ms(torch, bake)
    fields = bake()
    sampled = bake_kernel()
    held = {}

    def plain_once():
        held["want"] = texfield_plain(d_img, rest, height, width, 2, True,
                                      True, "flash")

    plain_ms = time_ms(torch, plain_once, reps=1, warmup=0)
    err = _check_fields(torch, f"{what} bake, {rest.shape[0]} frames",
                        sampled, held["want"])
    fields_plain = fields.clone()
    fields_plain[0, 1:] = held.pop("want")
    if not torch.equal(fields[0, 1:], sampled):
        fail(f"{what}: the bake's kernel frames differ from a direct call")

    def run_sweep():
        return sweep.render_affine_sweep(
            d_mats, d_tab, d_col, height, width, layer_counts=counts,
            paints=kpaints, fields=fields)

    sweep_ms = time_ms(torch, run_sweep)
    out = run_sweep()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = morph_frames_to_u8(out, height, width)
    d2h_ms = (time.perf_counter() - t0) * 1e3
    want = sweep.sweep_plain(d_mats, d_tab, None, None, d_col, None, height,
                             width, rules, counts, paints=kpaints,
                             fields=fields_plain)
    dmax = _check(torch, f"{what}: all {frames} frames through the sweep",
                  out, want, exact=True)
    covered = float((host[..., 3] > 0).mean())
    del fields_plain, want, out
    nbytes, ops = texfield_work(int(rest.shape[0]), height, width, 64 * 64,
                                2, True)
    bound_ms, bound_by = bound(nbytes, ops)
    pixels = frames * height * width
    log(f"bitmaps: {what}: bake kernel {ms:.3f} ms ({rest.shape[0]} frames, "
        f"bound {bound_ms:.4f} ms {bound_by}: {nbytes / 1e9:.3f} GB, "
        f"{ops / 1e9:.2f} Gop; plain {plain_ms:.1f} ms), whole bake "
        f"{bake_ms:.3f} ms, sweep {sweep_ms:.3f} ms, D2H {d2h_ms:.1f} ms, "
        f"{pixels / (bake_ms + sweep_ms) / 1e6:.3f} Gpx/s bake + sweep, "
        f"covered share {covered:.3f}")
    report[what] = {
        "frames": frames, "height": height, "width": width,
        "kernel_frames": int(rest.shape[0]), "kernel_ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": nbytes, "ops": ops, "bake_ms": bake_ms,
        "sweep_ms": sweep_ms, "d2h_ms": d2h_ms, "max_abs_err": err,
        "parent_ms": None if ab is None else ab["parent_ms"],
        "sweep_max_diff": dmax, "library_ms": None,
        "library": "none: no single call wraps or supersamples"}
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _texture_tag(np, shape_id=50):
    from swf_renderer_tpu_torch.models import ast
    from swf_renderer_tpu_torch.runtime.bitmap_service import (
        encode_x_swf_bmp2_argb,
    )

    img = np.random.default_rng(12).integers(0, 256, (512, 512, 4)).astype(
        np.uint8)
    img[..., 3] = np.maximum(img[..., 3], 1)
    return ast.DefineBitmap(id=shape_id, width=512, height=512,
                            media_type="image/x-swf-bmp2",
                            data=encode_x_swf_bmp2_argb(img))


def bitmaps_entry_points(torch, np, report):
    """The slice's routes through the user entry points, each with the
    launch counters set to 0 before and read after."""
    from swf_renderer_tpu_torch.models import ast, display
    from swf_renderer_tpu_torch.ops import transform as sweep
    from swf_renderer_tpu_torch.ops.flatblock import render_fused_styled
    from swf_renderer_tpu_torch.ops.texfield import (
        bitmap_field_planes, texfield_plain,
    )
    from swf_renderer_tpu_torch.runtime.bitmap_service import (
        encode_x_swf_bmp2_argb,
    )
    from swf_renderer_tpu_torch.runtime.renderer import (
        TorchRenderer, render_shape_animation,
    )
    from swf_renderer_tpu_torch.utils.fixed import Sfixed16P16

    height, width = SWEEP_SIZE
    counters = {"texfield": bitmap_field_planes,
                "affine": sweep.render_affine_sweep,
                "styled": render_fused_styled}

    def reset():
        for c in counters.values():
            c.launches = 0

    def read():
        return {k: c.launches for k, c in counters.items()}

    small = ast.DefineBitmap(
        id=11, width=64, height=64, media_type="image/x-swf-bmp2",
        data=encode_x_swf_bmp2_argb(np.random.default_rng(11).integers(
            0, 256, (64, 64, 4)).astype(np.uint8)))
    total = 0
    affine = 0   # B3's launches on these routes

    # (a) render_batch of the 60-stage rotating display list, bitmap layer.
    stages = rotating_stages(np, SWEEP_FRAMES, bitmap=small)
    renderer = TorchRenderer(width, height, device=DEVICE)
    renderer.add_bitmap(small)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = renderer.render_batch(stages)
    batch_ms = (time.perf_counter() - t0) * 1e3
    got = read()
    total += got["texfield"]
    affine += got["affine"]
    if (renderer.last_stats.path != "transform-sweep"
            or got["texfield"] != 1 or got["affine"] != 1):
        fail(f"render_batch with a bitmap layer: path "
             f"{renderer.last_stats.path!r}, launches {got}")
    if frames.shape != (SWEEP_FRAMES, height, width, 4) or not (
            0.01 < float((frames[..., 3] > 0).mean()) < 1.0):
        fail(f"render_batch with a bitmap layer: frames {frames.shape}")
    log(f"bitmaps: render_batch x{SWEEP_FRAMES} with a bitmap layer: wall "
        f"{batch_ms:.1f} ms, path transform-sweep, launches {got}")

    # (b) render_shape_animation of the bitmap-filled layer alone.
    mats = [st.children[1].matrix for st in stages[:8]]
    reset()
    anim = render_shape_animation(stages[0].children[1].definition, mats,
                                  width, height, bitmaps=[small],
                                  device=DEVICE)
    got = read()
    total += got["texfield"]
    affine += got["affine"]
    if got["texfield"] != 1 or got["affine"] != 1 or not anim[..., 3].any():
        fail(f"render_shape_animation of a bitmap fill: launches {got}")
    log(f"bitmaps: render_shape_animation x8 of a bitmap fill: launches "
        f"{got}")

    # (c) render(stage): a rotated, unsmoothed, clipped 512x512 bitmap.
    big = _texture_tag(np)
    rot = Sfixed16P16.from_value
    fill = ast.BitmapFill(
        bitmap_id=big.id, matrix=ast.Matrix(
            scale_x=rot(50.0), scale_y=rot(50.0), rotate_skew0=rot(27.0),
            rotate_skew1=rot(-27.0), translate_x=9000, translate_y=-2000),
        repeating=False, smoothed=False)
    still_tag = _shape_tag(ast, 51, fill, [(1000, 1000), (37000, 2000),
                                           (36000, 20000), (2000, 21000)])
    still = display.Stage(width=width, height=height, children=[
        display.ShapeInstance(definition=still_tag)])
    one = TorchRenderer(width, height, device=DEVICE)
    one.add_bitmap(big)
    reset()
    t0 = time.perf_counter()
    frame = one.render(still)
    still_ms = (time.perf_counter() - t0) * 1e3
    got = read()
    total += got["texfield"]
    if (got["texfield"] != 1 or got["styled"] != 1
            or one.last_stats.path != "flatblock"):
        fail(f"render(stage) of a rotated bitmap: launches {got}, path "
             f"{one.last_stats.path!r}")
    if not 0.05 < float((frame[..., 3] > 0).mean()) < 1.0:
        fail("render(stage) of a rotated bitmap drew nothing")
    paint = one._compiler().compile_stage(still)[0].paint
    inv = _up(torch, np, np.asarray([paint.inv_matrix], np.float32))
    d_big = torch.from_numpy(np.asarray(paint.image)).to(DEVICE)

    def still_kernel():
        return bitmap_field_planes(d_big, inv, height, width,
                                   paint.supersample, False, False, "canvas",
                                   device=DEVICE)

    still_k = time_ms(torch, still_kernel)
    held = {}

    def still_plain():
        held["want"] = texfield_plain(d_big, inv, height, width,
                                      paint.supersample, False, False,
                                      "canvas")

    still_plain_ms = time_ms(torch, still_plain, reps=3)
    still_err = _check_fields(torch, "still 512x512 nearest canvas",
                              still_kernel(), held.pop("want"))
    nbytes, ops = texfield_work(1, height, width, 512 * 512,
                                paint.supersample, False)
    still_bound, still_by = bound(nbytes, ops)
    log(f"bitmaps: render(stage) rotated nearest 512x512: wall "
        f"{still_ms:.1f} ms, launches {got}; texfield kernel {still_k:.3f} "
        f"ms, plain {still_plain_ms:.3f} ms, bound {still_bound:.4f} ms "
        f"({still_by})")

    # (d) 30 interactive render() calls, rotation off the axes throughout.
    loop = rotating_stages(np, 30, bitmap=small, phase=0.3)
    live = TorchRenderer(width, height, device=DEVICE)
    live.add_bitmap(small)
    reset()
    walls, paths = [], []
    for st in loop:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = live.render(st)
        walls.append((time.perf_counter() - t0) * 1e3)
        paths.append(live.last_stats.path)
        if len(paths) == 10:
            probe, probe_stage = out.copy(), st
            probe_state = live._frame_sweep_state[1]
    got = read()
    total += got["texfield"]
    affine += got["affine"]
    want_paths = ["flatblock"] + ["transform-sweep-1f"] * 29
    if paths != want_paths or got != {"texfield": 30, "affine": 29,
                                      "styled": 1}:
        fail(f"interactive loop: paths {sorted(set(paths))}, launches {got}")
    per_frame = statistics.median(walls[2:])
    log(f"bitmaps: interactive render() x30: first {walls[0]:.1f} ms "
        f"(normal path), median of calls 3-30 {per_frame:.2f} ms "
        f"(transform-sweep-1f; min {min(walls[2:]):.2f}, max "
        f"{max(walls[2:]):.2f}), launches {got}")
    _interactive_plain_check(torch, np, live, probe_state, probe_stage,
                             probe)
    report["bitmaps_entry"] = {
        "render_batch_ms": batch_ms, "still_render_ms": still_ms,
        "still_kernel_ms": still_k, "still_plain_ms": still_plain_ms,
        "still_bound_ms": still_bound, "still_bound_by": still_by,
        "still_max_abs_err": still_err, "interactive_first_ms": walls[0],
        "interactive_median_ms": per_frame, "interactive_walls_ms": walls}
    return total, still_err, affine


def _interactive_plain_check(torch, np, renderer, state, stage, frame):
    """One F = 1 sweep frame against the plain versions on the card: the
    texfield plane through texfield_plain, the sweep through
    sweep_plain, on the renderer's cached pieces; then B3 on the same
    inputs (the field plane texfield_plain's) held to sweep_plain's words
    and timed against the parent's build."""
    from swf_renderer_tpu_torch.ops import style as style_ops
    from swf_renderer_tpu_torch.ops import transform as sweep
    from swf_renderer_tpu_torch.ops.morph import morph_frames_to_u8
    from swf_renderer_tpu_torch.ops.texfield import texfield_plain

    leaves = renderer._stage_leaves(stage)
    mats = renderer._frame_sweep_mats(leaves, state["child_counts"])
    draws = state["draws"]
    kpaints, _gm, specs = sweep.sweep_paints([d.paint for d in draws], mats,
                                             allow_fields=True)
    colors = np.zeros((1, len(draws), 4), np.float32)
    for li, d in enumerate(draws):
        if d.paint.kind == style_ops.PAINT_SOLID:
            colors[0, li] = d.paint.color
    fields = torch.stack([texfield_plain(
        torch.from_numpy(np.asarray(s.paint.image)).to(DEVICE),
        _up(torch, np, s.invs), *SWEEP_SIZE, s.paint.supersample,
        s.paint.repeating, s.paint.smoothed, s.paint.edge_mode)
        for s in specs])
    d_mats, d_colors = _up(torch, np, mats), _up(torch, np, colors)
    rules = sweep.layer_rules(state["rule"], len(draws))
    want = sweep.sweep_plain(
        d_mats, state["tab"], None, None, d_colors, None, *SWEEP_SIZE,
        rules, state["layer_counts"], paints=kpaints, fields=fields)

    def f1_sweep():
        return sweep.render_affine_sweep(
            d_mats, state["tab"], d_colors, *SWEEP_SIZE, fill_rule=rules,
            layer_counts=state["layer_counts"], paints=kpaints,
            fields=fields)

    _check(torch, "interactive call 10, B3 F = 1 on the same inputs",
           f1_sweep(), want, exact=True)
    ab_times(torch, "affine_sweep B3 (interactive F = 1)", f1_sweep,
             "swfsweep")
    want = morph_frames_to_u8(want, *SWEEP_SIZE)[0]
    diff = int(np.abs(want.astype(np.int32) - frame.astype(np.int32)).max())
    log(f"bitmaps: interactive call 10 vs plain versions: max diff {diff}")
    if diff > TOL_LEVELS:
        fail(f"interactive frame vs plain versions: {diff} levels")


def phase_bitmaps(torch, np, report):
    worst = texfield_random(torch, np)
    report["texfield_forms_cases"] = texfield_forms_random(torch, np)
    library_yardstick(torch, np, report)
    launches, still_err, affine = bitmaps_entry_points(torch, np, report)
    small = animtex_run(torch, np, "animtex", *ANIMTEX, report)
    k = animtex_run(torch, np, "animtex1080", *SWEEP_SIZE, SWEEP_FRAMES,
                    report)
    k.update(name="texfield", launches=launches,
             max_abs_err=max(worst, still_err, small["max_abs_err"],
                             k["max_abs_err"]))
    if k["launches"] < 1:
        fail("texfield: no launch on the main path")
    return {"texfield": k, "affine_launches": affine}


# ---------------------------------------------------------------------------
# Phase 7: layered backends (direct coverage, wide frames)
# ---------------------------------------------------------------------------

COV_TOL = 1e-6                   # resolve premul max abs, kernel vs plain
COV_EXACT = 0.0                  # banded / tiled / grouped: byte-equal
DIRECT = (60, 4, 1088, 1920)     # bench.py --direct, uncut
DENSE = (4, 4, 1088, 1920, 320)  # frames, layers, height, width, shapes
WIDE = (16, 4, 1088, 8320)       # stride 8448 > 8192
COV_EDGES = ((3, 128), (128, 128), (700, 768), (2048, 2048), (2176, 2176),
             (5000, 5120))       # (edges, padded)
COV_FRAMES = ((37, 300), (100, 150))
# The 1088x1920 random cases: (edges, padded) through both kernels (700)
# or the tiled one (5000).
COV_BIG = ((700, 768), (5000, 5120))
WIDE_ROUTE = (8320, 1088)        # TorchRenderer(width, height), auto


def _cov_u8(torch, c):
    return torch.round(torch.clamp(c, 0.0, 1.0) * 255.0).to(torch.uint8)


def _check_planes(torch, what, got, want, tol=COV_TOL):
    """Coverage or premultiplied planes of a kernel against its plain
    version: max abs within ``tol`` and equal u8 bytes."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max().item())
    same = torch.equal(_cov_u8(torch, got), _cov_u8(torch, want))
    log(f"layered: {what}: max abs diff {err:.3g}, u8 "
        f"{'byte-equal' if same else 'DIFFERENT'}")
    if err > tol or not same:
        fail(f"kernel vs plain ({what}): {err}")
    return err


# Operations per (edge, pixel of a row the edge spans) left of the edge
# or under its clipped x-extent: the least of the three formulations'
# bodies (grouped 16, tiled 38, banded 40); a pixel right of the extent
# adds dy alone.
COV_OPS_PER_PAIR = 16
COV_OPS_RIGHT = 1


def coverage_work(torch, edges, height, width):
    """(bytes, f32 operations) of analytic coverage of these (B, 4, E)
    planes, the function the banded, tiled and grouped kernels share: the
    edges read once, the coverage written once; per (edge, row the edge
    spans) COV_OPS_RIGHT operations for each pixel right of the edge's
    clipped x-extent in that row (xmx - px <= 0, ``edge_row_span`` on the
    card) and COV_OPS_PER_PAIR for each other pixel, so padding and
    horizontal edges count nothing, and 3 per pixel for the rule.  The
    work a kernel adds by its own path through the edges (band windows,
    128-edge blocks, strips) is not counted."""
    from swf_renderer_tpu_torch.ops.coverage import edge_row_span

    x0, y0, x1, y1 = (edges[:, c].reshape(-1) for c in range(4))
    lo = torch.clamp(torch.floor(torch.minimum(y0, y1)), 0, height)
    hi = torch.clamp(torch.ceil(torch.maximum(y0, y1)), 0, height)
    rows = torch.where(y0 != y1, (hi - lo).clamp(min=0),
                       torch.zeros_like(lo))
    right = torch.zeros((), dtype=torch.int64, device=edges.device)
    for k in range(int(rows.max().item()) if rows.numel() else 0):
        sel = rows > k
        _, _, xmx = edge_row_span(x0[sel], y0[sel], x1[sel], y1[sel],
                                  lo[sel] + k)
        right += (width - torch.clamp(torch.ceil(xmx), 0, width)).to(
            torch.int64).sum()
    right = int(right.item())
    pairs = int(rows.to(torch.int64).sum().item()) * width
    pixels = edges.shape[0] * height * width
    return (edges.numel() * edges.element_size() + pixels * 4,
            right * COV_OPS_RIGHT + (pairs - right) * COV_OPS_PER_PAIR
            + pixels * 3)


def resolve_work(frames, layers, height, stride, rules):
    """(bytes, f32 operations) of one resolve call: every delta read once,
    the colours read once, the four channel planes written once; per
    pixel-layer the ladder (7 adds), the carry, the rule (2 or 5) and the
    composite (12)."""
    nbytes = (frames * layers * height * stride * 4 + frames * layers * 16
              + frames * 4 * height * stride * 4)
    per = sum(7 + 1 + (2 if r == 0 else 5) + 12 for r in rules)
    return nbytes, frames * height * stride * per


def coverage_random(torch, np):
    """B9 and B10 against their plain versions on closed random paths
    (rectangles, slivers under 1e-9, long unsplit edges, octagons partly
    off the frame), both rules: max abs 0."""
    from swf_renderer_tpu_torch.ops import coverage as cov
    from swf_renderer_tpu_torch.utils.scenes import closed_edge_planes

    rng = np.random.default_rng(37)
    worst = {"banded": 0.0, "tiled": 0.0}
    cases = [(h, w, n, e) for h, w in COV_FRAMES for n, e in COV_EDGES]
    cases += [(1088, 1920, n, e) for n, e in COV_BIG]
    for height, width, n, e_pad in cases:
        t = _up(torch, np, closed_edge_planes(rng, 2, n, e_pad, height,
                                              width))
        es, key, pad = cov.sort_edges(t)
        for rule in (0, 1):
            if e_pad <= cov.SMEM_EDGE_CAP:
                got = cov.coverage_banded(t, height, width, rule)
                want = cov.banded_plain(es, cov.band_ranges(t, key, height),
                                        height, width, rule)
                worst["banded"] = max(worst["banded"], _check_planes(
                    torch, f"banded {height}x{width} E={n}/{e_pad} "
                    f"rule={rule}", got, want, COV_EXACT))
            got = cov.coverage_tiled(t, height, width, rule)
            want = cov.tiled_plain(es, cov.block_bounds(es, key, pad), height,
                                   width, rule)
            worst["tiled"] = max(worst["tiled"], _check_planes(
                torch, f"tiled {height}x{width} E={n}/{e_pad} rule={rule}",
                got, want, COV_EXACT))
    return worst


def resolve_random(torch, np):
    """B12 against its plain version: L = 1, 4, 16; strides 256 and 8448;
    every rule (mixed per layer too); alpha from 0 to 1."""
    from swf_renderer_tpu_torch.ops.coverage import (
        layer_rules, normalize_fill_rule,
    )
    from swf_renderer_tpu_torch.ops.resolve import resolve_frames, resolve_plain

    rng = np.random.default_rng(41)
    worst = 0.0
    for stride, height in ((256, 40), (8448, 16)):
        for layers in (1, 4, 16):
            d = rng.normal(0, 0.4, (2, layers, height, stride)).astype(
                np.float32)
            d[rng.uniform(size=d.shape) < 0.6] = 0.0
            c = rng.uniform(0, 1, (2, layers, 4)).astype(np.float32)
            c[0, 0, 3], c[1, -1, 3] = 0.0, 1.0
            dd, dc = _up(torch, np, d), _up(torch, np, c)
            mixed = tuple(int(x) for x in rng.integers(0, 2, layers))
            for rule in (0, 1, mixed):
                got = resolve_frames(dd, dc, rule)
                want = resolve_plain(dd, dc, layer_rules(
                    normalize_fill_rule(rule, layers), layers))
                tag = rule if isinstance(rule, int) else "mixed"
                worst = max(worst, _check_planes(
                    torch, f"resolve L={layers} S={stride} rule={tag}",
                    got, want))
    return worst


def direct_run(torch, np, what, kind, frames, layers, height, width, shapes,
               report):
    """render_solid_batch on one scene: the main path once (counters
    read), then host lowering, upload, coverage kernel, composite and
    download timed; every plane held against the kernel's plain
    version."""
    from swf_renderer_tpu_torch.ops import coverage as cov
    from swf_renderer_tpu_torch.ops.composite import (
        composite_solid_layers, premul_to_straight_u8,
    )
    from swf_renderer_tpu_torch.ops.pipeline import render_solid_batch
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    tables, colors = build_scene_edges(frames, layers, height, width,
                                       shapes_per_layer=shapes, seed=7)
    t0 = time.perf_counter()
    edges_t = cov.split_pad_tables([t for per in tables for t in per])
    edges_t = edges_t.reshape(frames, layers, 4, -1)
    t_lower = time.perf_counter() - t0
    n_edges = int((edges_t != 0).any(axis=2).sum(axis=-1).max())
    banded = edges_t.shape[-1] <= cov.SMEM_EDGE_CAP
    if kind != ("banded" if banded else "tiled"):
        fail(f"{what}: {n_edges} edges do not take the {kind} kernel")
    counter = cov.coverage_banded if banded else cov.coverage_tiled
    cov.coverage_banded.launches = cov.coverage_tiled.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_main = render_solid_batch(edges_t, colors, height, width,
                                  device=DEVICE)
    wall = time.perf_counter() - t0
    launches = counter.launches
    other = (cov.coverage_tiled if banded else cov.coverage_banded).launches
    if launches != 1 or other != 0:
        fail(f"{what}: {kind} launches {launches}, other kernel {other}")
    if out_main.shape != (frames, height, width, 4):
        fail(f"{what}: frames {out_main.shape}")
    covered = float((out_main[..., 3] > 0).mean())
    if not 0.02 < covered < 1.0:
        fail(f"{what}: covered share {covered}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_edges = _up(torch, np, edges_t).view(frames * layers, 4, -1)
    d_colors = _up(torch, np, colors)
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    es, key, pad = cov.sort_edges(d_edges)
    table = (cov.band_ranges(d_edges, key, height) if banded
             else cov.block_bounds(es, key, pad))

    def kernel():
        return cov._launch_coverage(kind, es, table, height, width, 0)

    def whole():
        return cov.coverage(d_edges, height, width, 0)

    ms = time_ms(torch, kernel)
    ab = ab_times(torch, f"{kind} ({what})", kernel, lib="swfcoverage")
    whole_ms = time_ms(torch, whole)
    got = kernel()
    held = {}
    plain_fn = cov.banded_plain if banded else cov.tiled_plain

    def plain():
        held["want"] = plain_fn(es, table, height, width, 0)

    plain_ms = time_ms(torch, plain, reps=1, warmup=0)
    err = _check_planes(torch, f"{what}: all {frames * layers} planes",
                        got, held["want"], COV_EXACT)

    def composite():
        return composite_solid_layers(got.view(frames, layers, height, width),
                                      d_colors)

    comp_ms = time_ms(torch, composite)
    pm = composite()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = premul_to_straight_u8(pm)
    t_d2h = time.perf_counter() - t0
    if not np.array_equal(host, out_main):
        fail(f"{what}: timed kernel frames differ from the main path's")
    want_frames = premul_to_straight_u8(composite_solid_layers(
        held.pop("want").view(frames, layers, height, width), d_colors))
    if not np.array_equal(want_frames, out_main):
        fail(f"{what}: frames from the plain coverage differ")
    work = coverage_work(torch, es, height, width)
    bound_ms, bound_by = bound(*work)
    pixels = frames * height * width
    log(f"layered: {what}: render_solid_batch wall {wall * 1e3:.1f} ms "
        f"({kind}, {n_edges} edges padded to {edges_t.shape[-1]}, launches "
        f"{launches}); host split+pad {t_lower * 1e3:.1f} ms, H2D "
        f"{t_h2d * 1e3:.1f} ms, kernel {ms:.3f} ms (sort + windows + kernel "
        f"{whole_ms:.3f}), composite {comp_ms:.3f} ms, u8 + D2H "
        f"{t_d2h * 1e3:.1f} ms; plain {plain_ms:.1f} ms; bound "
        f"{bound_ms:.4f} ms ({bound_by}: {work[0] / 1e9:.3f} GB, "
        f"{work[1] / 1e9:.1f} Gop); covered share {covered:.3f}")
    report[what] = {
        "frames": frames, "layers": layers, "height": height,
        "width": width, "edges": n_edges, "padded": int(edges_t.shape[-1]),
        "kernel": kind, "launches": launches, "wall_ms": wall * 1e3,
        "host_lowering_ms": t_lower * 1e3, "h2d_ms": t_h2d * 1e3,
        "kernel_ms": ms, "coverage_call_ms": whole_ms,
        "composite_ms": comp_ms, "d2h_ms": t_d2h * 1e3,
        "kernel_gpx_s": pixels / ms / 1e6, "end_to_end_gpx_s":
        pixels / wall / 1e9, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "bytes": work[0], "ops": work[1],
        "max_abs_err": err, "covered": covered}
    if ab is not None:
        report[what]["parent_ms"] = ab["parent_ms"]
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def wide_run(torch, np, report):
    """render_batch_flatblock at 8320 px (the resolve route): the main
    path once (counter read), then host lowering, upload, scatter (twice:
    byte-equal), kernel, quantize + download timed; every frame's planes
    held against the plain version."""
    from swf_renderer_tpu_torch.ops.composite import premul_to_straight_u8
    from swf_renderer_tpu_torch.ops.pipeline import (
        lower_update_lists, render_batch_flatblock,
    )
    from swf_renderer_tpu_torch.ops.resolve import (
        pack_updates, resolve_frames, resolve_plain,
    )
    from swf_renderer_tpu_torch.ops.scanline import scatter_add
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    frames, layers, height, width = WIDE
    tables, colors = build_scene_edges(frames, layers, height, width, seed=7)
    resolve_frames.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_main = render_batch_flatblock(tables, colors, height, width,
                                      device=DEVICE)
    wall = time.perf_counter() - t0
    launches = resolve_frames.launches
    if launches != 1 or out_main.shape != (frames, height, width, 4):
        fail(f"wide8k: launches {launches}, frames {out_main.shape}")
    covered = float((out_main[..., 3] > 0).mean())
    if not 0.005 < covered < 1.0 or not out_main[:, :, 8192:, 3].any():
        fail(f"wide8k: covered share {covered}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()    # a second call: the first one's set-up
    again = render_batch_flatblock(tables, colors, height, width,
                                   device=DEVICE)
    wall2 = time.perf_counter() - t0
    if not np.array_equal(again, out_main):
        fail("wide8k: two calls differ")

    t0 = time.perf_counter()
    flat = [u for per in lower_update_lists(tables, height, width)
            for u in per]
    rows, cols, vals = pack_updates(flat)
    t_lower = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_rows = torch.from_numpy(rows).to(DEVICE).view(frames, layers, -1)
    d_cols = torch.from_numpy(cols).to(DEVICE).view(frames, layers, -1)
    d_vals = torch.from_numpy(vals).to(DEVICE).view(frames, layers, -1)
    d_colors = _up(torch, np, colors)
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    stride = -(-(width + 1) // 128) * 128
    plane = height * stride
    base = torch.arange(frames * layers, device=DEVICE).view(
        frames, layers, 1) * plane
    idx = base + d_rows.long() * stride + d_cols.long()

    def scatter():
        return scatter_add(frames * layers * plane, idx, d_vals).view(
            frames, layers, height, stride)

    scatter_ms = time_ms(torch, scatter, reps=3)
    planes = scatter()
    if not torch.equal(planes, scatter()):
        fail("wide8k: two scatters of the same updates differ")

    def kernel():
        return resolve_frames(planes, d_colors)

    resolve_frames.launches = 0
    ms = time_ms(torch, kernel)
    got = kernel()
    held = {}

    def plain():
        held["want"] = resolve_plain(planes, d_colors, (0,) * layers)

    plain_ms = time_ms(torch, plain, reps=1, warmup=0)
    err = _check_planes(torch, f"wide8k: resolve, all {frames} frames", got,
                        held.pop("want"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = premul_to_straight_u8(got.permute(0, 2, 3, 1)[:, :, :width])
    t_d2h = time.perf_counter() - t0
    if not np.array_equal(host, out_main):
        fail("wide8k: timed kernel frames differ from the main path's")
    work = resolve_work(frames, layers, height, stride, (0,) * layers)
    bound_ms, bound_by = bound(*work)
    pixels = frames * height * width
    log(f"layered: wide8k: render_batch_flatblock wall {wall * 1e3:.1f} ms "
        f"({pixels / wall / 1e9:.3f} Gpx/s; second call "
        f"{wall2 * 1e3:.1f} ms, byte-equal), resolve launches {launches}; "
        f"host lowering {t_lower * 1e3:.1f} ms, H2D {t_h2d * 1e3:.1f} ms, "
        f"scatter {scatter_ms:.3f} ms (byte-equal twice), kernel {ms:.3f} "
        f"ms, u8 + D2H {t_d2h * 1e3:.1f} ms; plain {plain_ms:.1f} ms; bound "
        f"{bound_ms:.4f} ms ({bound_by}: {work[0] / 1e9:.3f} GB, "
        f"{work[1] / 1e9:.2f} Gop); covered share {covered:.3f}")
    report["wide8k"] = {
        "frames": frames, "layers": layers, "height": height,
        "width": width, "stride": stride, "updates": int(rows.shape[1]),
        "launches": launches, "wall_ms": wall * 1e3,
        "second_wall_ms": wall2 * 1e3,
        "host_lowering_ms": t_lower * 1e3, "h2d_ms": t_h2d * 1e3,
        "scatter_ms": scatter_ms, "kernel_ms": ms, "d2h_ms": t_d2h * 1e3,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": work[0], "ops": work[1], "max_abs_err": err,
        "covered": covered}
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def layered_routes(torch, np, report):
    """Phase 4's 1920x1088 stages through every layered route of the
    renderer, and an 8320-px stage under auto, with the launch counters
    set to 0 before and read after each route."""
    from swf_renderer_tpu_torch.models import display
    from swf_renderer_tpu_torch.ops import coverage as cov
    from swf_renderer_tpu_torch.ops.flatblock import render_fused_styled
    from swf_renderer_tpu_torch.ops.resolve import resolve_frames
    from swf_renderer_tpu_torch.runtime.renderer import TorchRenderer

    stages, bitmap = build_stages(np)
    width, height = stages[0].width, stages[0].height
    counters = {"banded": cov.coverage_banded, "tiled": cov.coverage_tiled,
                "resolve": resolve_frames, "styled": render_fused_styled}
    routes = {  # name -> (renderer options, path, render_batch's reason)
        "direct": ({"backend": "direct"}, "direct",
                   "explicit backend='direct'"),
        "scanline": ({"backend": "scanline"}, "scanline",
                     "explicit backend='scanline'"),
        "pointaa": ({"quality": "flash-pointaa"}, "pointaa",
                    "point-sampled AA quality"),
        "validate": ({"validate": True}, "scanline",
                     "validate=True inspects raw coverage")}
    totals = {"banded": 0, "tiled": 0}
    out = {}
    launch = cov._launch_coverage
    seen = []   # the direct route's coverage launches, timed below

    def spy(*args):
        seen.append(args)
        return launch(*args)

    for name, (kw, path, reason) in routes.items():
        renderer = TorchRenderer(width, height, device=DEVICE, **kw)
        renderer.add_bitmap(bitmap)
        for c in counters.values():
            c.launches = 0
        cov._launch_coverage = spy if name == "direct" else launch
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame = renderer.render(stages[0])
            t_one = time.perf_counter() - t0
            got_path = renderer.last_stats.path
            t0 = time.perf_counter()
            batch = renderer.render_batch(stages)
            t_batch = time.perf_counter() - t0
            batch_path = renderer.last_stats.path
        finally:
            cov._launch_coverage = launch
        got = {k: c.launches for k, c in counters.items()}
        if got_path != path or batch_path != f"per-stage:{reason}":
            fail(f"route {name}: paths {got_path!r}, {batch_path!r}")
        if got["styled"] or got["resolve"] or got["tiled"]:
            fail(f"route {name}: unexpected launches {got}")
        if (name == "direct") != (got["banded"] == 4):
            fail(f"route {name}: banded launches {got['banded']}")
        if batch.shape != (3, height, width, 4) or not np.array_equal(
                batch[0], frame) or not frame[..., 3].any():
            fail(f"route {name}: frames {batch.shape}")
        if name == "scanline":
            again = renderer.render(stages[0])
            if not np.array_equal(again, frame):
                fail("scanline route: two renders of one stage differ")
        for k in totals:
            totals[k] += got[k]
        log(f"layered: route {name}: render {t_one * 1e3:.1f} ms (path "
            f"{got_path}), render_batch x3 {t_batch * 1e3:.1f} ms (path "
            f"{batch_path}), launches {got}"
            + (", two scanline renders byte-equal" if name == "scanline"
               else ""))
        out[name] = {"render_ms": t_one * 1e3, "render_batch_ms":
                     t_batch * 1e3, "path": got_path, "batch_path":
                     batch_path, "launches": got}

    # render(stages[0])'s banded launch, timed alone (and A/B); the
    # route launched it (4 banded launches, checked above).
    args = seen[0]

    def route_kernel():
        return launch(*args)

    route_ms = time_ms(torch, route_kernel)
    ab_times(torch, "banded (renderer direct route)", route_kernel,
             lib="swfcoverage")
    log(f"layered: route direct: banded kernel of render() "
        f"{route_ms:.4f} ms ({args[1].shape[0]} planes of {args[3]}x"
        f"{args[4]}, {args[1].shape[-1]} edges)")
    out["direct"]["banded_ms"] = route_ms

    wide_w, wide_h = WIDE_ROUTE
    wide = TorchRenderer(wide_w, wide_h, device=DEVICE)
    wide.add_bitmap(bitmap)
    for c in counters.values():
        c.launches = 0
    stage = display.Stage(width=wide_w, height=wide_h,
                          children=stages[0].children)
    t0 = time.perf_counter()
    frame = wide.render(stage)
    t_wide = time.perf_counter() - t0
    got = {k: c.launches for k, c in counters.items()}
    if wide.last_stats.path != "scanline" or any(got.values()) or \
            frame.shape != (wide_h, wide_w, 4) or not frame[..., 3].any():
        fail(f"wide render: path {wide.last_stats.path!r}, launches {got}")
    log(f"layered: TorchRenderer({wide_w}, {wide_h}).render: "
        f"{t_wide * 1e3:.1f} ms, "
        f"path scanline (auto), launches {got}")
    out["wide_render_ms"] = t_wide * 1e3
    report["layered_routes"] = out
    return totals


def phase_layered(torch, np, report):
    worst = coverage_random(torch, np)
    worst_resolve = resolve_random(torch, np)
    f, l, h, w = DIRECT
    direct = direct_run(torch, np, "direct1080", "banded", f, l, h, w, 16,
                        report)
    f, l, h, w, shapes = DENSE
    dense = direct_run(torch, np, "dense1080", "tiled", f, l, h, w, shapes,
                       report)
    wide = wide_run(torch, np, report)
    routes = layered_routes(torch, np, report)
    direct.update(name="coverage_banded",
                  launches=direct["launches"] + routes["banded"],
                  max_abs_err=max(direct["max_abs_err"], worst["banded"]))
    dense.update(name="coverage_tiled",
                 launches=dense["launches"] + routes["tiled"],
                 max_abs_err=max(dense["max_abs_err"], worst["tiled"]))
    wide.update(name="resolve",
                max_abs_err=max(wide["max_abs_err"], worst_resolve))
    return {"banded": direct, "tiled": dense, "resolve": wide}


# ---------------------------------------------------------------------------
# Phase 8: flat blocks — placement, the plane resolves, the one-block
# fused kernel, entry()
# ---------------------------------------------------------------------------

# (layers, height, width) of the random scenes: 2, 3 and 16 chunks (200,
# 300, 1920 and 2047 px), 1, 5 and 136 strips.
FLAT_CASES = ((1, 8, 200), (4, 40, 300), (16, 40, 1920), (4, 1088, 2047),
              (16, 8, 2047), (1, 1088, 1920))
FLAT_GROUP = 4   # group_blocks_fused size of the B13 == B1 check


def place_work(blocks, frames, layers, ns, step):
    """(bytes, f32 operations) of one placement: the blocks read once,
    the planes written once; one add per valid update, plus one per
    plane value for the in-chunk prefix."""
    sidx, keep, urc, ucm, uval = blocks
    in_bytes = sum(t.numel() * t.element_size()
                   for t in (sidx, keep, urc, ucm, uval))
    plane_values = frames * layers * (ns + 1) * 128 * 128
    valid = int((uval != 0).sum().item())
    return in_bytes + plane_values * 4, valid + (plane_values if step else 0)


def resolve_u32_work(frames, layers, ns, nc, rules, prefixed):
    """(bytes, f32 operations) of one plane resolve: the real strips'
    rows read once (n_chunks * 8 rows a plane), the colours, the packed
    frames written once; per pixel-layer the lane ladder (7 adds, raw
    planes only), the carry (1), the rule (2 or 5) and the over chain
    (13), per pixel the quantize tail (21), per row-chunk-layer the carry
    ladder (5)."""
    pixels = frames * ns * 8 * nc * 128
    nbytes = (frames * layers * ns * nc * 8 * 128 * 4 + frames * layers * 16
              + pixels * 4)
    per = sum((0 if prefixed else 7) + 1 + (2 if r == 0 else 5) + 13
              for r in rules)
    return nbytes, pixels * (per + 21) + frames * ns * 8 * nc * layers * 5


def fused1_work(blocks, frames, layers, ns, nc, rules):
    """(bytes, f32 operations) of one one-block fused call: the sorted
    blocks and colours read once, the packed strips written once; one add
    per valid update, per pixel-layer the prefix, carry, rule and suffix
    composite, per pixel the quantize tail (as work_counts)."""
    in_bytes = sum(t.numel() * t.element_size() for t in blocks)
    pixels = frames * ns * 8 * nc * 128
    valid = int((blocks[5] != 0).sum().item())
    per = sum(2 + (2 if r == 0 else 5) + 11 for r in rules)
    return in_bytes + pixels * 4, valid + pixels * (per + 21)


VS_PHASE3_SHARE = 1e-6   # differing straight bytes; measured 1.3e-7


def _vs_phase3(np, what, host, ref):
    """Frames of another composite form against phase 3's: premultiplied
    bytes within 1 level (the reference's bound of
    tests/test_flatblock.py:292-296, there on straight bytes of a small
    scene; un-premultiplying scales a premultiplied level by 255 / alpha,
    so straight bytes of low-alpha pixels move further) and differing
    straight bytes at most VS_PHASE3_SHARE (the over chain and the
    suffix form round apart on a few low-alpha pixels of the headline:
    1.3e-7 of the bytes measured on an H100)."""
    d = np.abs(host.astype(np.int16) - ref.astype(np.int16))
    pm = int(np.abs(premul_bytes(np, host) - premul_bytes(np, ref)).max())
    share = float((d != 0).mean())
    if pm > 1 or share > VS_PHASE3_SHARE:
        fail(f"{what} vs phase 3: {pm} premultiplied levels, differing "
             f"bytes {share:.3g}")
    return pm, int(d.max()), share


def _flat_upload(torch, np, arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
                 for a in arrays)


def _equal_words(torch, what, got, want):
    """Packed words of a kernel against its plain version: equal."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    dmax, share = byte_diff(got, want)
    if dmax or not torch.equal(got, want):
        fail(f"{what}: kernel vs plain differ ({dmax} levels on "
             f"{share:.3g} of the bytes)")
    return 0


def _equal_planes(torch, what, got, want):
    torch.cuda.synchronize()
    err = float((got - want).abs().max().item())
    if err != 0.0 or not torch.equal(got, want):
        fail(f"{what}: planes differ from the plain version by {err}")
    return err


def flat_random(torch, np):
    """B13-B16 against their plain versions: the random scenes of
    FLAT_CASES (2 frames, nonzero / even-odd / mixed rules), the
    reference's empty-group scene, and random planes with deltas in every
    chunk; step and prefixed both ways, passes 2 and 3, n_buf 2 and 3
    (random planes also 4: at 16 layers a shallower ring); B16 also
    against B15's words."""
    from swf_renderer_tpu_torch.native.bindings import pack_blocks_native
    from swf_renderer_tpu_torch.ops import flatblock as fb
    from swf_renderer_tpu_torch.ops.pipeline import lower_update_lists
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    rng = np.random.default_rng(53)
    frames = 2
    n_cases = 0
    scenes = []
    for layers, height, width in FLAT_CASES:
        tables, colors = build_scene_edges(
            frames, layers, height, width, shapes_per_layer=6,
            seed=int(rng.integers(1 << 30)))
        scenes.append((layers, height, width, pack_blocks_native(
            lower_update_lists(tables, height, width), height, width,
            block_pad_multiple=64), colors))
    empty = [[(np.zeros(0, np.int32),) * 2 + (np.zeros(0, np.float32),)]
             * 2]
    scenes.append((2, 16, 100, fb.pack_flat_blocks(empty, 16, 100, 4),
                   np.full((1, 2, 4), 0.7, np.float32)))
    for layers, height, width, packed, colors in scenes:
        f = colors.shape[0]
        *arrays, ns, nc = packed
        blocks = _flat_upload(torch, np, arrays)
        cols = _up(torch, np, colors)
        mixed = tuple(int(x) for x in rng.integers(0, 2, layers))
        tag = f"L={layers} {height}x{width} ({nc} chunks)"
        planes = {}
        b15 = None
        for step in (False, True):
            got = fb.place_blocks(*blocks, f, layers, ns, step=step)
            want = fb.place_plain(*blocks, f, layers, ns, step=step)
            _equal_planes(torch, f"place {tag} step={step}", got, want)
            planes[step] = got
            n_cases += 1
        for rule in (0, 1, mixed):
            for prefixed in (False, True):
                got = fb.resolve_planes_u32(planes[prefixed], cols, nc,
                                            fill_rule=rule, prefixed=prefixed)
                want = fb.resolve_u32_plain(planes[prefixed], cols, nc, rule,
                                            prefixed)
                _equal_words(torch, f"resolve_u32 {tag} rule={rule} "
                             f"prefixed={prefixed}", got, want)
                b15 = got
                n_cases += 1
            for n_buf in (2, 3):
                dma = fb.resolve_planes_u32_dma(planes[True], cols, nc,
                                                fill_rule=rule, n_buf=n_buf)
                _equal_words(torch, f"resolve_u32_dma {tag} rule={rule} "
                             f"n_buf={n_buf}", dma, want)
                _equal_words(torch, f"resolve_u32_dma {tag} rule={rule} "
                             f"n_buf={n_buf} vs resolve_u32", dma, b15)
                n_cases += 1
        sorted_blocks = _flat_upload(torch, np, fb.sort_blocks_fused(
            *arrays, layers, ns, block_pad_multiple=64))
        for rule in (0, 1, mixed):
            for passes in (3, 2):
                got = fb.render_fused_blocks(*sorted_blocks, cols, f, layers,
                                             ns, nc, fill_rule=rule,
                                             passes=passes)
                want = fb.fused_blocks_plain(*sorted_blocks, cols, f, layers,
                                             ns, nc, fill_rule=rule,
                                             passes=passes)
                _equal_words(torch, f"fused1 {tag} rule={rule} "
                             f"passes={passes}", got, want)
                n_cases += 1
        log(f"flat_blocks: {tag}{' (empty groups)' if f == 1 else ''}: "
            f"place, resolve_u32, resolve_u32_dma, fused1 equal to their "
            f"plain versions")
    # Random planes: deltas in every chunk of every row, so every carry
    # step shows.
    for layers in (1, 4, 16):
        raw = rng.normal(0, 0.4, (2, layers, 3, 128, 128)).astype(np.float32)
        raw[rng.uniform(size=raw.shape) < 0.6] = 0.0
        colors = rng.uniform(0, 1, (2, layers, 4)).astype(np.float32)
        colors[0, 0, 3], colors[1, -1, 3] = 0.0, 1.0
        cols = _up(torch, np, colors)
        raw_t = _up(torch, np, raw)
        stepped = torch.cumsum(raw_t, -1)
        mixed = tuple(int(x) for x in rng.integers(0, 2, layers))
        for rule in (0, 1, mixed):
            for prefixed, p in ((False, raw_t), (True, stepped)):
                want = fb.resolve_u32_plain(p, cols, 16, rule, prefixed)
                b15 = fb.resolve_planes_u32(p, cols, 16, rule, prefixed)
                _equal_words(torch, f"resolve_u32 random L={layers} "
                             f"rule={rule} prefixed={prefixed}", b15, want)
                n_cases += 1
            # n_buf 4 at 16 layers: the ring goes shallower (3 slots).
            for n_buf in (2, 3, 4):
                dma = fb.resolve_planes_u32_dma(stepped, cols, 16, rule,
                                                n_buf)
                _equal_words(torch, f"resolve_u32_dma random L={layers} "
                             f"n_buf={n_buf}", dma, want)
                _equal_words(torch, f"resolve_u32_dma random L={layers} "
                             f"n_buf={n_buf} vs resolve_u32", dma, b15)
                n_cases += 1
    log(f"flat_blocks: {n_cases} random comparisons equal (planes max abs "
        f"0, packed words equal)")


def headline_planes(torch, np, report, ref_frames):
    """The headline scene through render_flat_blocks: native packing,
    upload, B14, B15, B16 on the same planes and the download timed; every
    plane and frame held against the plain versions; the frames against
    phase 3's (suffix form) within 1 level on < 1% of the bytes."""
    from swf_renderer_tpu_torch.native.bindings import pack_blocks_native
    from swf_renderer_tpu_torch.ops import flatblock as fb
    from swf_renderer_tpu_torch.ops.pipeline import lower_update_lists

    frames, layers, height, width = HEADLINE
    tables, colors = _HELD["headline_scene"]
    t0 = time.perf_counter()
    updates = lower_update_lists(tables, height, width)
    t_lower = time.perf_counter() - t0
    t0 = time.perf_counter()
    *arrays, ns, nc = pack_blocks_native(updates, height, width)
    t_pack = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks = _flat_upload(torch, np, arrays)
    cols = _up(torch, np, colors)
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    counters = (fb.place_blocks, fb.resolve_planes_u32,
                fb.resolve_planes_u32_dma, fb.render_fused_blocks)

    def reset():
        for c in counters:
            c.launches = 0

    def read():
        return tuple(c.launches for c in counters)

    # The main path once, through the user entry point.
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fb.render_flat_blocks(*blocks, cols, height, width, frames, layers,
                                ns, nc)
    torch.cuda.synchronize()
    t_call = time.perf_counter() - t0
    main = read()
    if main != (1, 1, 0, 0):
        fail(f"render_flat_blocks launches (place, resolve, dma, fused1) "
             f"{main}: expected one place and one resolve")
    t0 = time.perf_counter()
    host = fb.frames_u32_to_u8(out.cpu().numpy().view(np.uint32), height,
                               width)
    t_d2h = time.perf_counter() - t0
    covered = float((host[..., 3] > 0).mean())
    if host.shape != (frames, height, width, 4) or not 0.05 < covered < 1.0:
        fail(f"headline_planes frames {host.shape}, covered {covered}")
    vs3 = _vs_phase3(np, "headline_planes", host, ref_frames)
    log(f"flat_blocks: headline_planes: render_flat_blocks {t_call * 1e3:.1f}"
        f" ms (launches place/resolve/dma/fused1 {main}); vs phase 3's "
        f"frames (suffix form): premultiplied max {vs3[0]}, straight max "
        f"{vs3[1]} levels, differing bytes {vs3[2]:.3g}")

    # The pipelined resolve's route once: place_blocks, then the DMA one.
    reset()
    planes = fb.place_blocks(*blocks, frames, layers, ns)
    dma_out = fb.resolve_planes_u32_dma(planes, cols, nc)
    dma_route = read()
    if dma_route != (1, 0, 1, 0):
        fail(f"place + resolve_planes_u32_dma launches {dma_route}")
    _equal_words(torch, "headline: resolve_u32_dma vs resolve_u32", dma_out,
                 out)

    # Each kernel alone on the same inputs, CUDA events, median of 5.
    ms_place = time_ms(torch, lambda: fb.place_blocks(
        *blocks, frames, layers, ns))
    ms_res = time_ms(torch, lambda: fb.resolve_planes_u32(planes, cols,
                                                            nc))
    ms_dma = time_ms(torch, lambda: fb.resolve_planes_u32_dma(planes, cols,
                                                                nc))
    ms_call = time_ms(torch, lambda: fb.render_flat_blocks(
        *blocks, cols, height, width, frames, layers, ns, nc))
    ab_dma = ab_times(torch, "resolve_u32_dma B16 (headline_planes)",
                      lambda: fb.resolve_planes_u32_dma(planes, cols, nc),
                      "swfplanes")
    ab_res = ab_times(torch, "resolve_u32 B15 (headline_planes)",
                      lambda: fb.resolve_planes_u32(planes, cols, nc),
                      "swfplanes")
    census = b16_census()
    held = {}

    def plain_place():
        held["planes"] = fb.place_plain(*blocks, frames, layers, ns)

    plain_place_ms = time_ms(torch, plain_place, reps=1, warmup=0)
    err = _equal_planes(torch, f"headline: place, all {frames * layers} "
                        f"frame-layers", planes, held.pop("planes"))

    def plain_resolve():
        held["out"] = fb.resolve_u32_plain(planes, cols, nc)

    plain_res_ms = time_ms(torch, plain_resolve, reps=1, warmup=0)
    _equal_words(torch, f"headline: resolve_u32, all {frames} frames", out,
                 held.pop("out"))
    rules = (0,) * layers
    w_place = place_work(blocks, frames, layers, ns, True)
    w_res = resolve_u32_work(frames, layers, ns, nc, rules, True)
    b_place, b_res = bound(*w_place), bound(*w_res)
    log(f"flat_blocks: headline_planes ({frames}x{layers}x{height}x{width}, "
        f"{len(arrays[0])} blocks, planes {planes.numel() * 4 / 1e9:.2f} GB):"
        f" host lowering {t_lower * 1e3:.1f} ms, native packing "
        f"{t_pack * 1e3:.1f} ms, H2D {t_h2d * 1e3:.1f} ms, place "
        f"{ms_place:.3f} ms (bound {b_place[0]:.4f}, {b_place[1]}), "
        f"resolve {ms_res:.3f} ms (bound {b_res[0]:.4f}, {b_res[1]}), "
        f"resolve_dma {ms_dma:.3f} ms, render_flat_blocks {ms_call:.3f} ms, "
        f"D2H + u8 {t_d2h * 1e3:.1f} ms; plain place {plain_place_ms:.1f} "
        f"ms, plain resolve {plain_res_ms:.1f} ms; all equal")
    report["headline_planes"] = {
        "frames": frames, "layers": layers, "height": height, "width": width,
        "blocks": int(len(arrays[0])), "host_lowering_ms": t_lower * 1e3,
        "native_pack_ms": t_pack * 1e3, "h2d_ms": t_h2d * 1e3,
        "first_call_ms": t_call * 1e3, "place_ms": ms_place,
        "resolve_ms": ms_res, "resolve_dma_ms": ms_dma,
        "render_flat_blocks_ms": ms_call, "d2h_u8_ms": t_d2h * 1e3,
        "plain_place_ms": plain_place_ms, "plain_resolve_ms": plain_res_ms,
        "place_bound_ms": b_place[0], "resolve_bound_ms": b_res[0],
        "place_bytes": w_place[0], "resolve_bytes": w_res[0],
        "vs_phase3_premul_max": vs3[0], "vs_phase3_max": vs3[1],
        "vs_phase3_share": vs3[2], "resolve_dma_ab": ab_dma,
        "resolve_ab": ab_res, "resolve_census": census}
    entries = {
        "place": dict(launches=main[0] + dma_route[0], max_abs_err=err,
                      ms=ms_place, plain_ms=plain_place_ms,
                      bound_ms=b_place[0], bound_by=b_place[1]),
        "resolve_u32": dict(launches=main[1], max_abs_err=0, ms=ms_res,
                            plain_ms=plain_res_ms, bound_ms=b_res[0],
                            bound_by=b_res[1]),
        "resolve_u32_dma": dict(launches=dma_route[2], max_abs_err=0,
                                ms=ms_dma, plain_ms=plain_res_ms,
                                bound_ms=b_res[0], bound_by=b_res[1])}
    return entries, arrays, (ns, nc), reset, read


def b16_census():
    """ptxas registers / stack and SASS census of the plane resolves
    (``planes_phases.census``: bulk copies, cp.async, block barriers,
    mbarrier operations) in this build and, with --parent, the
    parent's; fails unless B16 issues bulk copies (UBLKCP) and no
    cp.async (LDGSTS)."""
    from swf_renderer_tpu_torch.ops import cuda_lib
    from swf_renderer_tpu_torch.tools.planes_phases import census

    builds = {"change": (cuda_lib.lib_path("swfplanes"),
                         cuda_lib.build_log)}
    if "parent_libs" in _HELD:
        builds["parent"] = (PARENT_ROOT / "swf_renderer_tpu_torch" / "_build"
                            / "libswfplanes.so", _HELD["parent_log"])
    out = {}
    for which, (path, text) in builds.items():
        ptx = ptxas_kernels(text)
        for name, v in census(path).items():
            v = {**ptx.get(name, {}), **v}
            out.setdefault(which, {})[name] = v
            log(f"flat_blocks: SASS census ({which}) {name}: "
                f"{v.get('registers')} registers, {v.get('stack')} B stack, "
                f"{v['instructions']} instructions, UBLKCP {v['ublkcp']}, "
                f"LDGSTS {v['ldgsts']}, BAR.SYNC {v['bar_sync']}, SYNCS "
                f"{v['syncs']}")
    dma = [v for k, v in out["change"].items() if "resolve_dma" in k]
    if len(dma) != 1 or not dma[0]["ublkcp"] or dma[0]["ldgsts"]:
        fail(f"B16's SASS: expected bulk copies and no cp.async: {dma}")
    return out


# B13's kernel by mangled-name fragment: the first design's generic body
# (fused_flatblock_kernel<false, true>) and B1's solid body at kVarOne
# (solid_flatblock_kernel<12, kLc>); and B1 at the headline's layer
# class beside them (solid_flatblock_kernel<kVarFull, 4>).
B13_KERNELS = ("fused_flatblock_kernelILb0ELb1E",
               "solid_flatblock_kernelILi12E",
               "solid_flatblock_kernelILi0ELi4E")


def b13_census():
    """ptxas readings and SASS census (``coverage_phases.sass_census``:
    instructions, local loads and stores, compare-and-swap atomics,
    loops) of B13's kernels, and of B1's beside them, in this build and,
    with --parent, the parent's: {build: {kernel: readings}}."""
    from swf_renderer_tpu_torch.ops import cuda_lib
    from swf_renderer_tpu_torch.tools.coverage_phases import sass_census

    builds = {"change": (cuda_lib.lib_path("swfkernels"),
                         cuda_lib.build_log)}
    if "parent_libs" in _HELD:
        builds["parent"] = (PARENT_ROOT / "swf_renderer_tpu_torch" / "_build"
                            / "libswfkernels.so", _HELD["parent_log"])
    out = {}
    for which, (path, text) in builds.items():
        ptx = ptxas_kernels(text)
        for name, body in sass_of(path).items():
            if any(k in name for k in B13_KERNELS):
                v = {**ptx.get(name, {}), **sass_census(body)}
                out.setdefault(which, {})[name] = v
                log(f"flat_blocks: SASS census ({which}) {name}: "
                    f"{v.get('registers')} registers, {v.get('stack')} B "
                    f"stack, {v['instructions']} instructions, STL "
                    f"{v['stl']}, LDL {v['ldl']}, CAS {v['cas']}, loops "
                    f"{v['loops'][:6]}")
    return out


def headline_fused1(torch, np, report, ref_frames, arrays, geometry, reset,
                    read):
    """The headline's blocks sorted for the one-block fused kernel (B13):
    timed, held against its plain version, against render_fused_blocksn
    (B1) on group_blocks_fused of the same blocks (word for word), and
    against phase 3's frames (1 level)."""
    from swf_renderer_tpu_torch.ops import flatblock as fb

    frames, layers, height, width = HEADLINE
    ns, nc = geometry
    _, colors = _HELD["headline_scene"]
    cols = _up(torch, np, colors)
    t0 = time.perf_counter()
    sorted_np = fb.sort_blocks_fused(*arrays, layers, ns)
    t_sort = time.perf_counter() - t0
    blocks = _flat_upload(torch, np, sorted_np)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fb.render_fused_blocks(*blocks, cols, frames, layers, ns, nc)
    torch.cuda.synchronize()
    t_call = time.perf_counter() - t0
    launches = read()
    if launches != (0, 0, 0, 1):
        fail(f"render_fused_blocks launches {launches}")
    ms = time_ms(torch, lambda: fb.render_fused_blocks(
        *blocks, cols, frames, layers, ns, nc))
    ab_times(torch, "fused_blocks1 (headline_fused1)",
             lambda: fb.render_fused_blocks(*blocks, cols, frames, layers,
                                            ns, nc))
    held = {}

    def plain():
        held["out"] = fb.fused_blocks_plain(*blocks, cols, frames, layers,
                                            ns, nc)

    plain_ms = time_ms(torch, plain, reps=1, warmup=0)
    _equal_words(torch, f"headline: fused1, all {frames} frames", out,
                 held.pop("out"))
    t0 = time.perf_counter()
    grouped = fb.group_blocks_fused(*sorted_np, layers, ns, group=FLAT_GROUP)
    t_group = time.perf_counter() - t0
    b1 = fb.render_fused_blocksn(*_flat_upload(torch, np, grouped), cols,
                                 frames, layers, ns, nc, group=FLAT_GROUP)
    torch.cuda.synchronize()
    if not torch.equal(b1[:, :ns], out[:, :ns]):
        fail("headline: fused1 differs from render_fused_blocksn on "
             "group_blocks_fused of the same blocks")
    host = fb.packed_to_frames(out, frames, ns, nc, 1, height, width)
    vs3 = _vs_phase3(np, "headline_fused1", host, ref_frames)
    work = fused1_work(blocks, frames, layers, ns, nc, (0,) * layers)
    b = bound(*work)
    log(f"flat_blocks: headline_fused1: sort_blocks_fused {t_sort * 1e3:.1f}"
        f" ms ({len(sorted_np[0])} blocks), first call {t_call * 1e3:.1f} "
        f"ms (launches {launches}), kernel {ms:.3f} ms (bound {b[0]:.4f}, "
        f"{b[1]}), plain {plain_ms:.1f} ms; equal to its plain version and "
        f"to render_fused_blocksn on group_blocks_fused (group {FLAT_GROUP},"
        f" {t_group * 1e3:.0f} ms to group); vs phase 3: premultiplied "
        f"max {vs3[0]}, straight max {vs3[1]}, differing bytes "
        f"{vs3[2]:.3g}")
    report["headline_fused1"] = {
        "blocks": int(len(sorted_np[0])), "sort_ms": t_sort * 1e3,
        "first_call_ms": t_call * 1e3, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": b[0], "bound_by": b[1], "group_ms": t_group * 1e3,
        "vs_phase3_premul_max": vs3[0], "vs_phase3_max": vs3[1],
        "vs_phase3_share": vs3[2], "sass": b13_census()}
    return dict(launches=launches[3], max_abs_err=0, ms=ms, plain_ms=plain_ms,
                bound_ms=b[0], bound_by=b[1])


def entry_forward(torch, np, reset, read):
    """The port's entry(): its forward once on the card (one place and
    one resolve launch), equal to the same forward on the CPU."""
    from swf_renderer_tpu_torch import entry

    reset()
    forward, args = entry.entry()
    out = forward(*args)
    torch.cuda.synchronize()
    launches = read()
    if launches != (1, 1, 0, 0):
        fail(f"entry() forward launches {launches}")
    cpu_forward, cpu_args = entry.entry(device="cpu")
    want = cpu_forward(*cpu_args)
    if out.shape != (2, 64, 256) or not torch.equal(out.cpu(), want):
        fail("entry() forward on the card differs from its plain version")
    if not (out.cpu().numpy().view(np.uint32) >> 24).any():
        fail("entry() forward drew nothing")
    log(f"flat_blocks: entry() forward {tuple(out.shape)}, launches "
        f"{launches}, equal to the plain version")
    return launches


def phase_flat_blocks(torch, np, report):
    from swf_renderer_tpu_torch.ops.pipeline import render_batch_flatblock
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    flat_random(torch, np)
    if "headline_frames" not in _HELD:   # phase 3 did not run first
        frames, layers, height, width = HEADLINE
        tables, colors = build_scene_edges(frames, layers, height, width,
                                           seed=7)
        _HELD["headline_scene"] = (tables, colors)
        _HELD["headline_frames"] = render_batch_flatblock(
            tables, colors, height, width, device=DEVICE)
    ref = _HELD["headline_frames"]
    entries, arrays, geometry, reset, read = headline_planes(
        torch, np, report, ref)
    entries["fused1"] = headline_fused1(torch, np, report, ref, arrays,
                                        geometry, reset, read)
    launches = entry_forward(torch, np, reset, read)
    entries["place"]["launches"] += launches[0]
    entries["resolve_u32"]["launches"] += launches[1]
    for name, e in entries.items():
        e["name"] = name
    return entries


# ---------------------------------------------------------------------------
# Phase 9: deep draw lists, clip groups, blend modes and filters
# ---------------------------------------------------------------------------

DEEP = (16, 40, 1088, 1920)      # frames, layers, height, width
MASKED = (60, 4, 1088, 1920)     # bench.py bench_masked, uncut
ROUTE_SIZE = (1920, 1088)        # the renderer routes' stage
CHAIN_SIZES = (((64, 2560), 1), ((136, 1920), 2), ((400, 550), 6))
CHAIN_MODES = {   # name -> render_fused_styled keywords (chain=True)
    "chain": {}, "chain_bg": {"bg": True},
    "premul": {"emit": "premul"}, "premul_bg": {"bg": True, "emit": "premul"},
    "mask_first": {"bg": True, "mask_from": 1},
    "mask_last": {"emit": "premul", "mask_from": -1},
}


def bg_planes(torch, frames, ns, nc, spp, seed):
    """Random premultiplied planes (rgb <= a) on the card, zero in the
    padding rows and the sentinel strip block, as a pass emits them."""
    from swf_renderer_tpu_torch.ops.flatblock import plane_rows_for

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rows = plane_rows_for(nc, spp)
    a = torch.rand((frames, ns + 1, 1, rows, 128), generator=gen,
                   device=DEVICE)
    rgb = torch.rand((frames, ns + 1, 3, rows, 128), generator=gen,
                     device=DEVICE) * a
    bg = torch.cat([rgb, a], dim=2)
    bg[:, ns] = 0.0
    bg[:, :, :, spp * nc * 8:] = 0.0
    return bg.contiguous()


def chain_work_counts(torch, dev, frames, layers, spp, rules, paints,
                      fields, colors, bg, premul):
    """work_counts for the chain modes: the sequential over chain's f32
    operations per pixel-layer (13: ca, 1 - ca, three channels' two
    products and a sum, alpha's product and sum) in place of the suffix
    form's 11, the background planes read once (16 B a pixel) and, for
    premultiplied output, 16 B a pixel written in place of 4."""
    nbytes, ops = work_counts(torch, dev, frames, layers, spp, rules,
                              paints=paints, fields=fields, colors=colors)
    pixels = frames * dev["ns"] * spp * 8 * dev["nc"] * 128
    ops += pixels * 2 * layers
    if bg is not None:
        nbytes += pixels * 16
        ops += pixels * 9       # the mask group's scale and over
    if premul:
        nbytes += pixels * 12
    return nbytes, ops


def _equal_out(torch, what, got, want, ns, premul):
    """Kernel against plain version: planes equal over the whole tensor
    (padding and sentinel included), or words equal over the real
    strips."""
    if premul:
        return _equal_planes(torch, what, got, want)
    return _equal_words(torch, what, got[:, :ns], want[:, :ns])


def chain_random(torch, np):
    """Phase 9a: every chain mode of the styled kernel against its plain
    version on random packed scenes (1/4/16 layers, 1, 2 and 6 strips
    per plane, mixed rules, colour / gradient / field paints)."""
    from swf_renderer_tpu_torch.ops.flatblock import (
        field_to_chunkmajor, fused_styled_plain, render_fused_styled,
    )
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    rng = np.random.default_rng(19)
    frames, n = 2, 0
    for (height, width), want_spp in CHAIN_SIZES:
        for layers in (1, 4, 16):
            tables, colors = build_scene_edges(
                frames, layers, height, width, shapes_per_layer=6,
                seed=int(rng.integers(1 << 30)))
            dev, spp = pack_scene(tables, height, width, DEVICE)
            if spp != want_spp:
                fail(f"{height}x{width} packs {spp} strips per plane")
            ns, nc = dev["ns"], dev["nc"]
            cols = torch.as_tensor(colors, device=DEVICE)
            paints, n_fields = random_paints(rng, layers)
            fields = tuple(
                field_to_chunkmajor(
                    torch.as_tensor(rng.uniform(0, 1, (height, width, 4))
                                    .astype("float32"), device=DEVICE),
                    ns, nc, spp=spp)
                for _ in range(n_fields))
            rule = tuple(int(x) for x in rng.integers(0, 2, layers))
            bg = bg_planes(torch, frames, ns, nc, spp, int(rng.integers(99)))
            args = kernel_args(dev) + (cols, fields, frames, layers, ns, nc,
                                       paints)
            for mode, opts in CHAIN_MODES.items():
                mask_from = opts.get("mask_from")
                if mask_from is not None and layers < 2:
                    continue
                kw = dict(chain=True, emit=opts.get("emit", "u32"),
                          bg=bg if opts.get("bg") else None,
                          mask_from=(None if mask_from is None
                                     else mask_from % layers))
                got = render_fused_styled(*args, fill_rule=rule, spp=spp,
                                          **kw)
                want = fused_styled_plain(*args, fill_rule=rule, spp=spp,
                                          **kw)
                _equal_out(torch, f"chain {mode} L={layers} spp={spp}", got,
                           want, ns, kw["emit"] == "premul")
                n += 1
            log(f"deep_masked: chain modes L={layers} spp={spp} kinds="
                f"{[p.kind for p in paints]}: {len(CHAIN_MODES)} modes "
                "equal to the plain version")
    log(f"deep_masked: {n} random chain-mode cases equal (words, planes "
        "max abs 0)")
    return n


def _solid_paints(colors):
    from swf_renderer_tpu_torch.ops.style import solid_paint

    return [solid_paint(tuple(float(c) for c in colors[0, j]))
            for j in range(colors.shape[1])]


def _deep_styled_paints(np, colors):
    """Layer i: an axis-aligned bitmap where i % 3 == 2, else a linear
    sRGB gradient where i % 8 == 5, else the scene's solid colour."""
    from swf_renderer_tpu_torch.ops import style

    rng = np.random.default_rng(23)
    paints = _solid_paints(colors)
    for i in range(len(paints)):
        if i % 3 == 2:
            img = rng.integers(0, 256, (24, 32, 4)).astype(np.uint8)
            paints[i] = style.Paint(
                kind=style.PAINT_BITMAP,
                inv_matrix=(0.05 + 0.01 * (i % 4), 0.0, 0.0, 0.04,
                            -3.0 * i, -2.0),
                image=img, repeating=True, smoothed=True, supersample=1)
        elif i % 8 == 5:
            paints[i] = style.Paint(
                kind=style.PAINT_LINEAR,
                inv_matrix=(18.0, 3.0, -2.0, 17.0, -16384.0 - 300.0 * i,
                            -9000.0),
                stop_ratios=np.array([0.0, 0.5, 1.0], np.float32),
                stop_colors=np.array([[1, 0, 0, 1], [0, 1, 0, 0.5],
                                      [0, 0, 1, 0.9]], np.float32))
    return paints


def _pass_walls(torch, tpl, tables, paints, colors, height, width):
    """One pass's host walls: lowering and native packing timed alone,
    then the pass's whole set-up (lowering, packing, paint fields,
    upload) through the pipeline's own function, whose result is
    returned."""
    from swf_renderer_tpu_torch.native.bindings import pack_grouped_native
    from swf_renderer_tpu_torch.ops.flatblock import (
        plane_geometry, strips_per_plane,
    )

    _, nc, ns_geo = plane_geometry(height, width)
    t0 = time.perf_counter()
    updates = tpl.lower_update_lists(tables, height, width)
    t_lower = time.perf_counter() - t0
    t0 = time.perf_counter()
    pack_grouped_native(updates, height, width, group=tpl.GROUP,
                        spp=strips_per_plane(nc, ns_geo))
    t_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = tpl._styled_pass(tables, paints, colors, height, width, None,
                              DEVICE)
    torch.cuda.synchronize()
    return t_lower, t_pack, time.perf_counter() - t0, result


def _timed_passes(torch, np, tables, paints, colors, height, width, groups,
                  what, report):
    """The passes of one multi-pass render again, step by step: lowering
    and packing, upload, each pass's kernel (timed, CUDA events) and its
    plain version on the same inputs (equal), the download.  Returns
    (frames, per-pass records, the first pass's work and arguments)."""
    from swf_renderer_tpu_torch.ops import pipeline as tpl
    from swf_renderer_tpu_torch.ops.flatblock import (
        fused_styled_plain, render_fused_styled,
    )

    frames = len(tables)
    bg = out = None
    records = []
    first = None
    for gi, (lo, hi) in enumerate(groups):
        last = gi == len(groups) - 1
        t_lower, t_pack, t_pass, (args, spp) = _pass_walls(
            torch, tpl, [per[lo:hi] for per in tables], paints[lo:hi],
            colors[:, lo:hi], height, width)
        kw = dict(group=tpl.GROUP, fill_rule=0, spp=spp, chain=True, bg=bg,
                  emit="u32" if last else "premul")
        out = render_fused_styled(*args, **kw)
        want = fused_styled_plain(*args, **kw)
        ns = args[10]
        _equal_out(torch, f"{what} pass {gi}", out, want, ns, not last)
        del want
        ms = time_ms(torch, lambda: render_fused_styled(*args, **kw))
        rec = {"layers": hi - lo, "fields": len(args[7]),
               "lowering_ms": t_lower * 1e3, "packing_ms": t_pack * 1e3,
               "pass_setup_ms": t_pass * 1e3, "kernel_ms": ms}
        if gi == 0:
            arm = "" if what == "deep1080_solid" else " styled"
            ab = ab_times(torch, "fused_flatblock_styled_chain "
                          f"(deep1080{arm} pass 1)",
                          lambda: render_fused_styled(*args, **kw))
            rec["parent_ms"] = None if ab is None else ab["parent_ms"]
            plain_ms = time_ms(torch, lambda: fused_styled_plain(
                *args, **kw), reps=3)
            dev = dict(zip(("sidx", "flags", "lays", "urc", "ucm", "uval"),
                           args[:6]), ns=ns, nc=args[11])
            nbytes, ops = chain_work_counts(
                torch, dev, frames, hi - lo, spp, (0,) * (hi - lo), args[12],
                args[7], args[6], None, True)
            b = bound(nbytes, ops)
            rec.update(plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1])
            first = rec
        records.append(rec)
        log(f"deep_masked: {what} pass {gi}: {hi - lo} layers, "
            f"{len(args[7])} field planes, lowering {t_lower * 1e3:.1f} ms, "
            f"packing {t_pack * 1e3:.1f} ms (with paints and upload "
            f"{t_pass * 1e3:.1f} ms), kernel {ms:.3f} ms"
            + (f", plain {rec['plain_ms']:.1f} ms, bound "
               f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})"
               if gi == 0 else "") + ", equal to its plain version")
        bg = out
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = tpl._to_frames(out, frames, spp, height, width)
    t_d2h = time.perf_counter() - t0
    report[what] = {"passes": records, "d2h_ms": t_d2h * 1e3}
    log(f"deep_masked: {what} download + u8 crop {t_d2h * 1e3:.1f} ms")
    return got, first


def deep_run(torch, np, report):
    """Phase 9b, deep1080: 16 x 40 x 1088x1920 through
    render_batch_styled in two arms — the scene's solid colours (3
    passes, byte-equal to the plain version of ONE 40-layer chain, frame
    by frame) and a styled list of bitmaps, gradients and solids (4
    passes, each equal to its plain version)."""
    from swf_renderer_tpu_torch.convert import packed_to_device
    from swf_renderer_tpu_torch.native.bindings import pack_grouped_native
    from swf_renderer_tpu_torch.ops import pipeline as tpl
    from swf_renderer_tpu_torch.ops.flatblock import (
        KernelPaint, fused_styled_plain, packed_to_frames, plane_geometry,
        render_fused_styled, strips_per_plane,
    )
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    frames, layers, height, width = DEEP
    tables, colors = build_scene_edges(frames, layers, height, width,
                                       seed=7)
    launches = 0
    first, outs = {}, {}
    for arm, paints, want_groups in (
            ("solid", _solid_paints(colors), [(0, 16), (16, 32), (32, 40)]),
            ("styled", _deep_styled_paints(np, colors),
             [(0, 14), (14, 26), (26, 38), (38, 40)])):
        groups = tpl.split_layer_groups(paints)
        if groups != want_groups:
            fail(f"deep1080 {arm}: passes {groups}")
        render_fused_styled.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tpl.render_batch_styled(tables, paints, height, width,
                                      colors=colors, device=DEVICE)
        wall = time.perf_counter() - t0
        n = render_fused_styled.launches
        if n != len(groups):
            fail(f"deep1080 {arm}: {n} launches for {len(groups)} passes")
        launches += n
        if out.shape != (frames, height, width, 4) or not out[..., 3].any():
            fail(f"deep1080 {arm}: frames {out.shape}")
        log(f"deep_masked: deep1080 {arm}: render_batch_styled wall "
            f"{wall * 1e3:.1f} ms ({frames * height * width / wall / 1e9:.3f}"
            f" Gpx/s end to end), {n} launches ({len(groups)} passes)")
        again, first[arm] = _timed_passes(
            torch, np, tables, paints, colors, height, width, groups,
            f"deep1080_{arm}", report)
        if not np.array_equal(again, out):
            fail(f"deep1080 {arm}: the passes again differ from the main "
                 "path's frames")
        report[f"deep1080_{arm}"].update(wall_ms=wall * 1e3, launches=n)
        outs[arm] = out
    # The solid arm against ONE chain over all 40 layers (the plain
    # version has no layer cap), frame by frame.
    _, nc, ns_geo = plane_geometry(height, width)
    spp = strips_per_plane(nc, ns_geo)
    for f in range(frames):
        updates = tpl.lower_update_lists(tables[f:f + 1], height, width)
        dev = packed_to_device(*pack_grouped_native(
            updates, height, width, group=tpl.GROUP, spp=spp), device=DEVICE)
        one = fused_styled_plain(
            *kernel_args(dev), torch.as_tensor(colors[f:f + 1],
                                               device=DEVICE),
            (), 1, layers, dev["ns"], dev["nc"],
            (KernelPaint.color(),) * layers, group=tpl.GROUP, spp=spp,
            chain=True)
        want = packed_to_frames(one, 1, dev["ns"], dev["nc"], spp, height,
                                width)[0]
        if not np.array_equal(outs["solid"][f], want):
            d = np.abs(outs["solid"][f].astype(np.int16)
                       - want.astype(np.int16))
            fail(f"deep1080 solid frame {f}: 3 chained passes differ from "
                 f"one 40-layer chain ({int(d.max())} levels, "
                 f"{float((d != 0).mean()):.3g} of the bytes)")
    log(f"deep_masked: deep1080 solid: 3 chained passes byte-equal to one "
        f"40-layer chain on all {frames} frames")
    return launches, first["solid"]


def masked_run(torch, np, report):
    """Phase 9b, masked1080: bench.py's bench_masked scene uncut (60 x 4
    x 1088x1920, seed 7; layers 2-3 inside a clip whose mask is the left
    two thirds) through render_batch_styled(mask_tree=...): two
    launches (the pre pass, then the fused content + mask pair that
    quantizes over it), byte-equal to the unfused plane-algebra program
    (mask pass, content pass, scaled + bg * (1 - scaled_a), quantize
    pass), the fused pair equal to its plain version."""
    from swf_renderer_tpu_torch.ops import pipeline as tpl
    from swf_renderer_tpu_torch.ops.flatblock import (
        fused_styled_plain, render_fused_styled,
    )
    from swf_renderer_tpu_torch.ops.style import solid_paint
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    frames, layers, height, width = MASKED
    tables, colors = build_scene_edges(frames, layers, height, width,
                                       seed=7)
    w3 = width * 2 / 3
    mask_rect = np.array([[0, 0, w3, 0], [w3, 0, w3, height],
                          [w3, height, 0, height], [0, height, 0, 0]],
                         np.float32)
    half = layers // 2
    draws = [per + [mask_rect] for per in tables]
    white = solid_paint((1.0, 1.0, 1.0, 1.0))
    paints = _solid_paints(colors) + [white]
    cols = np.concatenate([colors, np.ones((frames, 1, 4), np.float32)],
                          axis=1)
    tree = ([("draw", i) for i in range(half)]
            + [("mask", [layers], [("draw", i)
                                   for i in range(half, layers)])])
    render_fused_styled.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tpl.render_batch_styled(draws, paints, height, width, colors=cols,
                                  mask_tree=tree, device=DEVICE)
    wall = time.perf_counter() - t0
    launches = render_fused_styled.launches
    if launches != 2:
        fail(f"masked1080: {launches} launches, expected 2 (pre pass, "
             "fused mask pair)")
    if out.shape != (frames, height, width, 4) or not out[..., 3].any():
        fail(f"masked1080: frames {out.shape}")
    log(f"deep_masked: masked1080: render_batch_styled(mask_tree) wall "
        f"{wall * 1e3:.1f} ms ({frames * height * width / wall / 1e9:.3f} "
        f"Gpx/s end to end), {launches} launches")

    def seg(idxs, sub_cols):
        sub = ([[per[i] for i in idxs] for per in draws] if idxs else
               [[np.zeros((0, 4), np.float32)]] * frames)
        t_lower, t_pack, t_pass, (args, spp) = _pass_walls(
            torch, tpl, sub, [paints[i] for i in idxs] or [white], sub_cols,
            height, width)
        return args, spp, (t_lower, t_pack, t_pass)

    pre, spp, t_pre = seg(list(range(half)), colors[:, :half])
    pair, _, t_pair = seg(list(range(half, layers + 1)), cols[:, half:])
    common = dict(group=tpl.GROUP, fill_rule=0, spp=spp, chain=True)
    pre_out = render_fused_styled(*pre, emit="premul", **common)
    pair_kw = dict(bg=pre_out, emit="u32", mask_from=layers - half, **common)
    fused = render_fused_styled(*pair, **pair_kw)
    want = fused_styled_plain(*pair, **pair_kw)
    ns = pair[10]
    _equal_out(torch, "masked1080 fused pair", fused, want, ns, False)
    del want
    _equal_out(torch, "masked1080 pre pass", pre_out,
               fused_styled_plain(*pre, emit="premul", **common), ns, True)
    got = tpl._to_frames(fused, frames, spp, height, width)
    if not np.array_equal(got, out):
        fail("masked1080: the main path's frames differ from the fused pair "
             "run again")
    # The unfused plane-algebra program on the same inputs.
    mask, _, _ = seg([layers], np.ones((frames, 1, 4), np.float32))
    content, _, _ = seg(list(range(half, layers)), colors[:, half:])
    final, _, _ = seg([], np.zeros((frames, 1, 4), np.float32))
    m = render_fused_styled(*mask, emit="premul", **common)
    c = render_fused_styled(*content, emit="premul", **common)
    scaled = c * m[:, :, 3:4]
    planes = scaled + pre_out * (1.0 - scaled[:, :, 3:4])
    unfused = render_fused_styled(*final, bg=planes, emit="u32", **common)
    _equal_words(torch, "masked1080 fused pair vs unfused program",
                 fused[:, :ns], unfused[:, :ns])
    ms_pre = time_ms(torch, lambda: render_fused_styled(
        *pre, emit="premul", **common))
    ms_pair = time_ms(torch, lambda: render_fused_styled(*pair, **pair_kw))
    plain_ms = time_ms(torch, lambda: fused_styled_plain(*pair, **pair_kw),
                         reps=3)
    ab_pair = ab_times(torch, "fused_flatblock_styled_chain (masked1080 "
                       "pair)", lambda: render_fused_styled(*pair, **pair_kw))
    ab_pre = ab_times(torch, "fused_flatblock_styled_chain (masked1080 pre "
                      "pass)", lambda: render_fused_styled(
                          *pre, emit="premul", **common))
    dev = dict(zip(("sidx", "flags", "lays", "urc", "ucm", "uval"),
                   pair[:6]), ns=ns, nc=pair[11])
    nbytes, ops = chain_work_counts(torch, dev, frames, layers + 1 - half,
                                    spp, (0,) * (layers + 1 - half),
                                    pair[12], (), pair[6], pre_out, False)
    b = bound(nbytes, ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tpl._to_frames(fused, frames, spp, height, width)
    t_d2h = time.perf_counter() - t0
    log(f"deep_masked: masked1080: lowering pre {t_pre[0] * 1e3:.1f} ms, "
        f"pair {t_pair[0] * 1e3:.1f} ms; packing pre {t_pre[1] * 1e3:.1f} "
        f"ms, pair {t_pair[1] * 1e3:.1f} ms (with paints and upload "
        f"{(t_pre[2] + t_pair[2]) * 1e3:.1f} ms); kernel pre pass "
        f"{ms_pre:.3f} ms, "
        f"fused mask pair {ms_pair:.3f} ms (plain {plain_ms:.1f} ms, bound "
        f"{b[0]:.4f} ms, {b[1]}), download + u8 crop {t_d2h * 1e3:.1f} ms; "
        "fused pair byte-equal to the unfused plane-algebra program and to "
        "its plain version")
    report["masked1080"] = {
        "wall_ms": wall * 1e3, "launches": launches,
        "lowering_ms": (t_pre[0] + t_pair[0]) * 1e3,
        "packing_ms": (t_pre[1] + t_pair[1]) * 1e3,
        "pass_setup_ms": (t_pre[2] + t_pair[2]) * 1e3,
        "pre_kernel_ms": ms_pre, "pair_kernel_ms": ms_pair,
        "pair_plain_ms": plain_ms, "pair_bound_ms": b[0],
        "pair_bound_by": b[1], "d2h_ms": t_d2h * 1e3,
        "pair_parent_ms": None if ab_pair is None else ab_pair["parent_ms"],
        "pre_parent_ms": None if ab_pre is None else ab_pre["parent_ms"]}
    return launches


def _rect(ast, sid, x, y, w, h, rgba):
    """A DefineShape of one w x h px rectangle at (x, y) px."""
    pts = [(x * 20, y * 20), ((x + w) * 20, y * 20),
           ((x + w) * 20, (y + h) * 20), (x * 20, (y + h) * 20)]
    return _shape_tag(ast, sid, ast.SolidFill(ast.StraightSRgba8(*rgba)),
                      pts)


def route_stages(np):
    """The 1920x1088 stages of phase 9c: (three stages of one group
    structure, name -> stage)."""
    from swf_renderer_tpu_torch.models import ast, display
    from swf_renderer_tpu_torch.ops import filters

    rng = np.random.default_rng(29)

    def inst(d, **kw):
        return display.ShapeInstance(definition=d, **kw)

    def color(a=255):
        return tuple(int(x) for x in rng.integers(0, 256, 3)) + (a,)

    back = _rect(ast, 1, 0, 0, 1920, 1088, (200, 100, 50, 255))
    boxes = [_rect(ast, 10 + i, 60 * i, 30 * i, 700, 500, color(200))
             for i in range(20)]
    left = _rect(ast, 2, 0, 0, 1280, 1088, (0, 200, 0, 255))
    clip = display.MaskedGroup(mask=inst(left),
                               children=tuple(inst(b) for b in boxes[:18]))
    knock = _rect(ast, 3, 0, 0, 960, 1088, (255, 255, 255, 128))
    green = _rect(ast, 4, 300, 200, 1200, 700, (0, 200, 0, 255))
    dot = _rect(ast, 5, 800, 400, 300, 300, (255, 230, 0, 230))

    def stage(children):
        return display.Stage(width=ROUTE_SIZE[0], height=ROUTE_SIZE[1],
                             children=children)

    # Three frames of one group structure: the mask moves.
    batch = [stage([inst(back), display.MaskedGroup(
        mask=inst(left, matrix=_matrix(ast, -4000 * k, 0)),
        children=clip.children)]) for k in range(3)]
    return batch, {
        "clip18": stage([inst(back), clip]),
        "multiply": stage([inst(back), inst(boxes[3], blend_mode="multiply"),
                           display.Container(children=(
                               inst(boxes[5]), inst(boxes[6])),
                               blend_mode="multiply")]),
        "alpha_erase": stage([inst(back), display.Container(children=(
            inst(green), inst(knock, blend_mode="alpha")),
            blend_mode="layer"), display.Container(children=(
                inst(boxes[8]), inst(knock, blend_mode="erase")),
                blend_mode="layer")]),
        "filters": stage([inst(back), inst(dot, filters=(
            filters.BlurFilter(7.0, 7.0, passes=3),
            filters.DropShadowFilter(color=(0, 0, 0, 0.8), blur_x=4.0,
                                     blur_y=4.0, angle=math.pi / 4,
                                     distance=3.0)))]),
        "deep20": stage([inst(b) for b in boxes]),
    }


def renderer_routes(torch, np, report):
    """Phase 9c: the renderer's masked and deep routes at 1920x1088, each
    path checked, each fused frame within 1 level of the layered
    (scanline) compositor's; a 3-stage render_batch of one group
    structure; the filter group's filter time alone."""
    from swf_renderer_tpu_torch.ops.filters import apply_filters
    from swf_renderer_tpu_torch.ops.flatblock import render_fused_styled
    from swf_renderer_tpu_torch.runtime.renderer import TorchRenderer

    batch_stages, stages = route_stages(np)
    width, height = ROUTE_SIZE
    fused = TorchRenderer(width, height, device=DEVICE)
    layered = TorchRenderer(width, height, backend="scanline", device=DEVICE)
    launches, out = 0, {}
    for name, stage in stages.items():
        render_fused_styled.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = fused.render(stage)
        wall = time.perf_counter() - t0
        n = render_fused_styled.launches
        path = fused.last_stats.path
        if path != "flatblock" or n < 1 or not frame[..., 3].any():
            fail(f"route {name}: path {path!r}, {n} launches")
        launches += n
        t0 = time.perf_counter()
        lay = layered.render(stage)
        t_lay = time.perf_counter() - t0
        if layered.last_stats.path != "scanline":
            fail(f"route {name}: layered path {layered.last_stats.path!r}")
        d = np.abs(frame.astype(np.int16) - lay.astype(np.int16))
        if d.max() > 1:
            fail(f"route {name}: fused vs scanline {int(d.max())} levels")
        log(f"deep_masked: route {name}: render {wall * 1e3:.1f} ms (path "
            f"{path}, {n} launches), scanline {t_lay * 1e3:.1f} ms, max "
            f"diff {int(d.max())} on {float((d != 0).mean()):.3g} of the "
            "bytes")
        out[name] = {"render_ms": wall * 1e3, "launches": n,
                     "scanline_ms": t_lay * 1e3, "vs_scanline_max":
                     int(d.max()), "vs_scanline_share":
                     float((d != 0).mean())}
    render_fused_styled.launches = 0
    t0 = time.perf_counter()
    batch = fused.render_batch(batch_stages)
    wall = time.perf_counter() - t0
    n = render_fused_styled.launches
    launches += n
    if fused.last_stats.path != "batched-styled" or batch.shape != (
            3, height, width, 4):
        fail(f"render_batch of one group structure: path "
             f"{fused.last_stats.path!r}")
    if not np.array_equal(batch[2], fused.render(batch_stages[2])):
        fail("render_batch frame 2 differs from render(stage)")
    log(f"deep_masked: render_batch x3 of one group structure "
        f"{wall * 1e3:.1f} ms (path batched-styled, {n} launches)")
    out["render_batch_ms"] = wall * 1e3
    filt = stages["filters"].children[1].filters
    img = torch.rand((1, height, width, 4), device=DEVICE)
    ms = time_ms(torch, lambda: apply_filters(img, filt))
    log(f"deep_masked: filters (blur 7x7 x3 + drop shadow) on one "
        f"{height}x{width} image: {ms:.3f} ms")
    out["filters_ms"] = ms
    report["deep_masked_routes"] = out
    return launches


def phase_deep_masked(torch, np, report):
    n_cases = chain_random(torch, np)
    launches, deep = deep_run(torch, np, report)
    launches += masked_run(torch, np, report)
    launches += renderer_routes(torch, np, report)
    report["chain_random_cases"] = n_cases
    return {"styled_chain": {
        "name": "fused_flatblock_styled_chain", "launches": launches,
        "max_abs_err": 0, "ms": deep["kernel_ms"],
        "plain_ms": deep["plain_ms"], "bound_ms": deep["bound_ms"],
        "bound_by": deep["bound_by"]}}


# ---------------------------------------------------------------------------
# Phase 10: the sweep's row-band (B4) and compacted (B5) tilings, grouped
# coverage (B11)
# ---------------------------------------------------------------------------

TILING_CASES = ((100, 300), (400, 550))   # random scenes: height, width
# Grouped vs banded / tiled coverage: the formulations round differently
# (reciprocals vs divisions, 8-edge group trees vs one running sum).  This
# phase measured on an H100 up to 1.22e-4 on both scenes, above 1e-5 on
# 2.0e-5 of direct1080's pixels and on 1.19e-4 of dense1080's; the limits
# are about twice and 2.5 times those readings.
COV_VS_OTHER_TOL = 1e-5       # the bulk of the pixels
COV_VS_OTHER_MAX = 2.5e-4     # every pixel
COV_VS_OTHER_SHARE = {"direct1080": 5e-5, "dense1080": 3e-4}   # above TOL


def _tiling_check(torch, what, got, want, column, exact=False):
    """A tiling's frames against the plain version and against the column
    kernel's frames on the same inputs (both expected byte-equal; with
    ``exact``, B4's and B5's gate, held to equal words)."""
    dmax = _check(torch, what, got, want, exact)
    cmax, share = byte_diff(got, column)
    if cmax > TOL_LEVELS or (exact and not torch.equal(got, column)):
        fail(f"{what} vs the column kernel: {cmax} levels ({share:.3g})")
    return max(dmax, cmax)


def _plan_covers(torch, what, tables, plan):
    """The host plan's capacities hold every (frame, bin, layer)'s
    crossing pieces, so compact_pre dropped none."""
    caps = torch.tensor(plan["compact_counts"], dtype=torch.int32,
                        device=tables.crossing.device)
    most = tables.crossing.amax(dim=(0, 1))
    if bool((most > caps).any()):
        fail(f"{what}: crossing counts {most.tolist()} exceed the plan's "
             f"capacities {list(plan['compact_counts'])}")
    return most.tolist()


def tilings_random(torch, np):
    """B4 (solid, styled, morph + affine) and B5
    (solid, styled with gradients, stops and fields, per-layer matrices;
    planned and 256 / 120-column bins) against sweep_plain, B5 also
    against sweep_compact_plain, each also against the column kernel:
    equal words."""
    from swf_renderer_tpu_torch.ops import transform as sweep
    from swf_renderer_tpu_torch.ops.coverage import layer_rules
    from swf_renderer_tpu_torch.ops.flatblock import KPAINT_FIELD, KernelPaint
    from swf_renderer_tpu_torch.utils.scenes import (
        random_blobs, random_tracks,
    )

    rng = np.random.default_rng(53)
    worst = {"affine_rows": 0, "morph_affine_rows": 0, "affine_compact": 0}
    frames = 3
    for height, width in TILING_CASES:
        for layers in (1, 3, 16):
            tables = random_blobs(rng, layers, height, width)
            tracks = random_tracks(rng, frames, layers, height, width)
            mixed = tuple(int(x) for x in rng.integers(0, 2, layers))
            colors = _up(torch, np, rng.uniform(0.1, 1, (frames, layers, 4)))
            tab, _ = sweep.affine_pieces(tables, [(0,) * 4] * layers,
                                         tracks)
            counts = tuple(min(c, tab.shape[-1])
                           for c in sweep.layer_piece_counts(tab))
            d_tracks, d_tab = _up(torch, np, tracks), _up(torch, np, tab)
            tag = f"{height}x{width} L={layers}"
            paints, n_fields = random_paints(rng, layers)
            gm = rng.uniform(-1, 1, (frames, layers, 6)) * 4
            gm[..., 0] += 30.0
            gm[..., 3] += 30.0
            gm[..., 4:] = rng.uniform(-20000, -10000, (frames, layers, 2))
            stops = _up(torch, np, rng.uniform(0, 1, (frames, layers, 5, 4)))
            fields = (_up(torch, np, rng.uniform(
                0, 1, (n_fields, frames, height, width, 4)))
                if n_fields else None)
            styled = dict(paints=paints, grad_mats=_up(torch, np, gm),
                          stop_colors=stops, fields=fields)
            row_styled = dict(styled, paints=tuple(
                KernelPaint.color() if p.kind == KPAINT_FIELD else p
                for p in paints), fields=None)
            if layers == 1:
                styled = row_styled = {}

            # B4: solid, styled (no fields: the reference's row grid
            # takes none).
            args = (d_tracks, d_tab, colors, height, width)
            got = sweep.render_affine_sweep(
                *args, fill_rule=mixed, layer_counts=counts, row_grid=True)
            want = sweep.sweep_plain(d_tracks, d_tab, None, None, colors,
                                     None, height, width, mixed, counts)
            column = sweep.render_affine_sweep(
                *args, fill_rule=mixed, layer_counts=counts)
            worst["affine_rows"] = max(worst["affine_rows"], _tiling_check(
                torch, f"rows {tag}", got, want, column, exact=True))
            if row_styled:
                kw = dict(fill_rule=mixed, layer_counts=counts, **row_styled)
                got = sweep.render_affine_sweep(
                    d_tracks, d_tab, colors, height, width, row_grid=True,
                    **kw)
                want = sweep.sweep_plain(d_tracks, d_tab, None, None, colors,
                                         None, height, width, mixed, counts,
                                         **row_styled)
                column = sweep.render_affine_sweep(
                    d_tracks, d_tab, colors, height, width, **kw)
                worst["affine_rows"] = max(worst["affine_rows"], _tiling_check(
                    torch, f"styled rows {tag}", got, want, column,
                    exact=True))

            # B5: solid under one matrix track, styled under per-layer
            # tracks; the plan's bins, then 256- or 120-column bins.
            for mats, kw in ((tracks[:, 0], {}), (tracks, styled)):
                d_mats = _up(torch, np, mats)
                for wblock in (None, 256 if height == 100 else 120):
                    plan = sweep.plan_compact_sweep(mats, tab, height, width,
                                                    wblock=wblock)
                    if plan is None:
                        fail(f"compact {tag}: no plan")
                    got = sweep.render_affine_sweep(
                        d_mats, d_tab, colors, height, width, fill_rule=mixed,
                        **plan, **kw)
                    tables_c = sweep.compact_pre(
                        d_mats, d_tab, plan["compact_counts"],
                        plan["wblock"], height, width)
                    _plan_covers(torch, f"compact {tag}", tables_c, plan)
                    want = sweep.sweep_plain(
                        d_mats, d_tab, None, None, colors, None, height,
                        width, mixed, (tab.shape[-1],) * layers, **kw)
                    want_c = sweep.sweep_compact_plain(
                        tables_c, colors, height, width,
                        layer_rules(mixed, layers), **kw)
                    column = sweep.render_affine_sweep(
                        d_mats, d_tab, colors, height, width, fill_rule=mixed,
                        **kw)
                    what = (f"compact {tag} wblock={plan['wblock']} "
                            f"bps={plan['blocks_per_step']} "
                            f"{'styled' if kw else 'solid'}")
                    worst["affine_compact"] = max(
                        worst["affine_compact"],
                        _tiling_check(torch, what, got, want, column,
                                      exact=True),
                        _check(torch, what + " vs compact plain", got,
                               want_c, exact=True))

            # B4's morph + affine form.
            pairs = [(s_, s_ + rng.uniform(-9, 9, s_.shape).astype(
                np.float32), rng.uniform(0.1, 1, 4), rng.uniform(0.1, 1, 4))
                for s_ in tables]
            ratios = _up(torch, np, np.array([0.0, 0.41, 1.0]))
            tab_s, tab_e, cs, ce = sweep.morph_affine_pieces(pairs, tracks)
            mcounts = tuple(min(max(a, b), tab_s.shape[-1]) for a, b in zip(
                sweep.layer_piece_counts(tab_s),
                sweep.layer_piece_counts(tab_e)))
            margs = (d_tracks, ratios, _up(torch, np, tab_s),
                     _up(torch, np, tab_e), _up(torch, np, cs),
                     _up(torch, np, ce), height, width)
            got = sweep.render_morph_affine_sweep(
                *margs, fill_rule=mixed, layer_counts=mcounts, row_grid=True)
            want = sweep.sweep_plain(margs[0], margs[2], margs[3], ratios,
                                     margs[4], margs[5], height, width,
                                     mixed, mcounts)
            column = sweep.render_morph_affine_sweep(
                *margs, fill_rule=mixed, layer_counts=mcounts)
            worst["morph_affine_rows"] = max(
                worst["morph_affine_rows"],
                _tiling_check(torch, f"morph-affine rows {tag}", got, want,
                              column, exact=True))
    return worst


def grouped_random(torch, np):
    """B11 against grouped_plain on closed random paths (both rules; the
    phase 7 frames and edge counts that are multiples of 128): max abs
    0."""
    from swf_renderer_tpu_torch.ops import coverage as cov
    from swf_renderer_tpu_torch.utils.scenes import closed_edge_planes

    rng = np.random.default_rng(59)
    worst = 0.0
    cases = [(h, w, n, e) for h, w in COV_FRAMES for n, e in COV_EDGES
             if e % cov.EDGE_BLOCK == 0]
    cases += [(1088, 1920, n, e) for n, e in COV_BIG]
    for height, width, n, e_pad in cases:
        t = _up(torch, np, closed_edge_planes(rng, 2, n, e_pad, height,
                                              width))
        es, key, pad = cov.sort_edges(t)
        bounds = cov.block_bounds(es, key, pad)
        for rule in (0, 1):
            got = cov.coverage_grouped(t, height, width, rule)
            want = cov.grouped_plain(es, bounds, height, width, rule)
            worst = max(worst, _check_planes(
                torch, f"grouped {height}x{width} E={n}/{e_pad} rule={rule}",
                got, want, tol=COV_EXACT))
    return worst


def grouped_run(torch, np, what, d_edges, height, width, report):
    """B11 on phase 7's planes of one scene: the kernel timed beside the
    kernel phase 7 routes them to (banded or tiled) and, with --parent,
    against the parent's build, held against grouped_plain (max abs 0)
    and against that kernel's coverage (COV_VS_OTHER_*)."""
    from swf_renderer_tpu_torch.ops import coverage as cov

    es, key, pad = cov.sort_edges(d_edges)
    bounds = cov.block_bounds(es, key, pad)
    banded = d_edges.shape[-1] <= cov.SMEM_EDGE_CAP
    other = "banded" if banded else "tiled"
    table = cov.band_ranges(d_edges, key, height) if banded else bounds

    def kernel():
        return cov._launch_coverage("grouped", es, bounds, height, width, 0)

    def yardstick():
        return cov._launch_coverage(other, es, table, height, width, 0)

    ms = time_ms(torch, kernel)
    other_ms = time_ms(torch, yardstick)
    ab_times(torch, f"grouped ({what})", kernel, lib="swfcoverage")
    got = kernel()
    held = {}

    def plain():
        held["want"] = cov.grouped_plain(es, bounds, height, width, 0)

    plain_ms = time_ms(torch, plain, reps=1, warmup=0)
    err = _check_planes(torch, f"{what}: grouped, all {got.shape[0]} planes",
                        got, held.pop("want"), tol=COV_EXACT)
    diff = (got - yardstick()).abs()
    vs_other = float(diff.max().item())
    over = float((diff > COV_VS_OTHER_TOL).float().mean().item())
    del diff
    log(f"tilings: {what}: grouped vs {other} max abs {vs_other:.3g}, "
        f"share above {COV_VS_OTHER_TOL:g} {over:.3g}")
    if vs_other > COV_VS_OTHER_MAX or over > COV_VS_OTHER_SHARE[what]:
        fail(f"{what}: grouped vs {other} coverage {vs_other} ({over})")
    work = coverage_work(torch, es, height, width)
    bound_ms, bound_by = bound(*work)
    log(f"tilings: {what}: grouped kernel {ms:.3f} ms ({other} {other_ms:.3f}"
        f" ms on the same planes), plain {plain_ms:.1f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {work[0] / 1e9:.3f} GB, "
        f"{work[1] / 1e9:.1f} Gop)")
    report[f"{what}_grouped"] = {
        "planes": int(got.shape[0]), "edges": int(d_edges.shape[-1]),
        "kernel_ms": ms, f"{other}_ms": other_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": work[0],
        "ops": work[1], "max_abs_err": err, f"vs_{other}": vs_other,
        f"vs_{other}_share_above_1e-5": over}
    return {"max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def _timed_tiling(torch, what, kernel, column, plain, counts_args, report,
                  extra_bytes=0, exact=False):
    """Time one full-width tiling beside the column kernel on the same
    inputs, hold every frame against the plain version and the column
    kernel's frames (``exact``: word for word), work out its bound."""
    out = _timed_sweep(torch, what, kernel, plain, counts_args, report,
                       exact)
    column_ms = time_ms(torch, column, reps=5)
    got = kernel()
    col = column()
    cmax, share = byte_diff(got, col)
    if cmax > TOL_LEVELS or (exact and not torch.equal(got, col)):
        fail(f"{what} vs the column kernel: {cmax} levels ({share:.3g})")
    del col
    if extra_bytes:
        nbytes = report[what]["bytes"] + extra_bytes
        out["bound_ms"], out["bound_by"] = bound(nbytes, report[what]["ops"])
        report[what].update(bytes=nbytes, bound_ms=out["bound_ms"],
                            bound_by=out["bound_by"])
    log(f"tilings: {what}: column kernel {column_ms:.3f} ms on the same "
        f"inputs, frames {cmax} levels apart")
    report[what].update(column_ms=column_ms, vs_column_max=cmax)
    return out


# B5's kernels by mangled-name fragment: the first design's
# (sweep_compact_kernel<kStyled>) and the bins on the tiled body
# (sweep_bin_kernel<kStyled, kLc>).
B5_KERNELS = ("sweep_compact_kernel", "sweep_bin_kernel")


def b5_census():
    """ptxas readings and SASS census (``coverage_phases.sass_census``:
    instructions, local loads and stores, compare-and-swap atomics) of
    B5's kernels in this build and, with --parent, the parent's; fails if
    this build's keep a stack or a compare-and-swap loop."""
    from swf_renderer_tpu_torch.ops import cuda_lib
    from swf_renderer_tpu_torch.tools.coverage_phases import sass_census

    builds = {"change": (cuda_lib.lib_path("swfsweep"), cuda_lib.build_log)}
    if "parent_libs" in _HELD:
        builds["parent"] = (PARENT_ROOT / "swf_renderer_tpu_torch" / "_build"
                            / "libswfsweep.so", _HELD["parent_log"])
    out = {}
    for which, (path, text) in builds.items():
        ptx = ptxas_kernels(text)
        for name, body in sass_of(path).items():
            if any(k in name for k in B5_KERNELS):
                v = {**ptx.get(name, {}), **sass_census(body)}
                v.pop("loops")
                out.setdefault(which, {})[name] = v
                log(f"tilings: SASS census ({which}) {name}: "
                    f"{v.get('registers')} registers, {v.get('stack')} B "
                    f"stack, {v['instructions']} instructions, STL "
                    f"{v['stl']}, LDL {v['ldl']}, CAS {v['cas']}")
    mine = out.get("change", {})
    if len(mine) != 3 or any(v.get("stack") or v["cas"]
                             for v in mine.values()):
        fail(f"B5's kernels keep a stack or a CAS loop: {mine}")
    return out


def tilings_full_width(torch, np, report, launches):
    """anim1080 and anim1080_gradient through the row-band and compacted
    tilings, morph_affine1080 through the row-band one (the main path
    once, counters read), then each timed beside the column kernel; B11
    on direct1080's and dense1080's planes."""
    from swf_renderer_tpu_torch.ops import coverage as cov
    from swf_renderer_tpu_torch.ops import style as style_ops
    from swf_renderer_tpu_torch.ops import transform as sweep
    from swf_renderer_tpu_torch.utils.scenes import anim_scene, \
        build_scene_edges

    height, width = SWEEP_SIZE
    frames = SWEEP_FRAMES
    tables, colors, mats = anim_scene(height, width, frames)
    layers = len(tables)
    tab, colarr = sweep.affine_pieces(tables, colors, mats)
    counts = sweep.layer_piece_counts(tab)
    t0 = time.perf_counter()
    plan = sweep.plan_compact_sweep(mats, tab, height, width)
    t_plan = time.perf_counter() - t0
    if plan is None:
        fail("anim1080: no compaction plan")
    d_mats, d_tab, d_col = (_up(torch, np, x) for x in (mats, tab, colarr))
    rules = (0,) * layers
    base_stops = np.array([[1, 0.2, 0, 1], [0, 1, 0.5, 0.8], [0.2, 0, 1, 1]],
                          np.float32)
    paints = [style_ops.solid_paint(tuple(c)) for c in colors]
    paints[1] = style_ops.Paint(
        kind=style_ops.PAINT_LINEAR,
        inv_matrix=(2.0 * 16384.0 / width, 0.0, 0.0, 2.0 * 16384.0 / width,
                    -16384.0, -16384.0 * height / width),
        stop_ratios=np.array([0.0, 0.5, 1.0], np.float32),
        stop_colors=base_stops)
    kpaints, grad_mats = sweep.sweep_paints(paints, mats)
    stop_colors = np.zeros((frames, layers, 3, 4), np.float32)
    fade = np.linspace(1.0, 0.4, frames, dtype=np.float32)
    stop_colors[:, 1] = base_stops[None] * fade[:, None, None]
    styled = dict(paints=kpaints, grad_mats=_up(torch, np, grad_mats),
                  stop_colors=_up(torch, np, stop_colors))
    pairs = morph_pairs(np)
    m16 = mats[:MORPH_RATIOS]
    ratios = np.linspace(0.0, 1.0, MORPH_RATIOS, dtype=np.float32)
    tab_s, tab_e, cs, ce = sweep.morph_affine_pieces(pairs, m16)
    mcounts = tuple(min(max(a, b), tab_s.shape[-1]) for a, b in zip(
        sweep.layer_piece_counts(tab_s), sweep.layer_piece_counts(tab_e)))
    dm = [_up(torch, np, x) for x in (m16, ratios, tab_s, tab_e, cs, ce)]
    planes = {}   # phase 7's planes: name -> (edges, height, width)
    for name, (f, l, h, w, shapes) in (("direct1080", DIRECT + (16,)),
                                       ("dense1080", DENSE)):
        tbl = build_scene_edges(f, l, h, w, shapes_per_layer=shapes,
                                seed=7)[0]
        planes[name] = (_up(torch, np, cov.split_pad_tables(
            [t for per in tbl for t in per])), h, w)

    def rows(**kw):
        return sweep.render_affine_sweep(d_mats, d_tab, d_col, height, width,
                                         layer_counts=counts, row_grid=True,
                                         **kw)

    def compact(**kw):
        return sweep.render_affine_sweep(d_mats, d_tab, d_col, height, width,
                                         **plan, **kw)

    def morph_rows():
        return sweep.render_morph_affine_sweep(
            *dm, height, width, layer_counts=mcounts, row_grid=True)

    # The main path once: each tiling and B11 through its entry point.
    counters = {"affine_rows": (sweep.render_affine_sweep, "row_launches"),
                "affine_compact": (sweep.render_affine_sweep,
                                   "compact_launches"),
                "morph_affine_rows": (sweep.render_morph_affine_sweep,
                                      "row_launches"),
                "grouped": (cov.coverage_grouped, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    main = [rows(), rows(**styled), compact(), compact(**styled),
            morph_rows()]
    main += [cov.coverage_grouped(*p) for p in planes.values()]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.update({k: getattr(fn, attr)
                     for k, (fn, attr) in counters.items()})
    log(f"tilings: main path (anim1080 and anim1080_gradient rows and "
        f"compact, morph_affine1080 rows, grouped direct1080 and dense1080) "
        f"{wall * 1e3:.1f} ms, launches {launches}")
    for k, n in launches.items():
        if n < 1:
            fail(f"{k}: no launch on the main path")
    if any(out.shape != (frames, height, width) for out in main[:4]) or \
            not all(bool(out.any()) for out in main):
        fail("tilings: main path frames are empty or misshapen")
    del main

    tables_c = sweep.compact_pre(d_mats, d_tab, plan["compact_counts"],
                                 plan["wblock"], height, width)
    most = _plan_covers(torch, "anim1080", tables_c, plan)
    pre_ms = time_ms(torch, lambda: sweep.compact_pre(
        d_mats, d_tab, plan["compact_counts"], plan["wblock"], height,
        width))
    compact_bytes = sum(x.numel() * x.element_size() for x in (
        tables_c.tab, tables_c.counts, tables_c.bounds, tables_c.prefix))
    log(f"tilings: anim1080 plan {plan} in {t_plan * 1e3:.1f} ms (host); "
        f"most crossing pieces {most}; compact_pre {pre_ms:.3f} ms "
        f"({compact_bytes / 1e6:.1f} MB of tables)")
    report["anim1080_plan"] = {"plan": plan, "plan_ms": t_plan * 1e3,
                               "most_crossing": most, "compact_pre_ms": pre_ms,
                               "table_bytes": compact_bytes}

    def column(**kw):
        return lambda: sweep.render_affine_sweep(
            d_mats, d_tab, d_col, height, width, layer_counts=counts, **kw)

    def plain(**kw):
        return lambda: sweep.sweep_plain(d_mats, d_tab, None, None, d_col,
                                         None, height, width, rules, counts,
                                         **kw)

    def compact_kernel(tbl, **kw):
        return lambda: sweep._launch_sweep_compact(
            tbl, d_col, height, width, rules, plan["blocks_per_step"], **kw)

    out = {}
    counts_args = (d_mats, d_tab, None, None, counts, height, width, rules)
    grad_extra = (d_col, styled["grad_mats"], styled["stop_colors"])
    out["affine_rows"] = _timed_tiling(
        torch, "anim1080_rows", rows, column(), plain(),
        counts_args + (None, None, (d_col,)), report, exact=True)
    ab_times(torch, "affine_sweep_rows B4 (anim1080)", rows, "swfsweep")
    grad = _timed_tiling(
        torch, "anim1080_gradient_rows", lambda: rows(**styled),
        column(**styled), plain(**styled),
        counts_args + (kpaints, None, grad_extra), report, exact=True)
    ab_times(torch, "affine_sweep_rows B4 styled (anim1080_gradient)",
             lambda: rows(**styled), "swfsweep")
    out["affine_rows"]["max_abs_err"] = max(out["affine_rows"]["max_abs_err"],
                                            grad["max_abs_err"])
    out["affine_compact"] = _timed_tiling(
        torch, "anim1080_compact", compact_kernel(tables_c), column(),
        plain(), counts_args + (None, None, (d_col,)), report,
        extra_bytes=compact_bytes, exact=True)
    want_c = sweep.sweep_compact_plain(tables_c, d_col, height, width, rules)
    out["affine_compact"]["max_abs_err"] = max(
        out["affine_compact"]["max_abs_err"],
        _check(torch, "anim1080_compact vs compact plain",
               compact_kernel(tables_c)(), want_c, exact=True))
    del want_c
    ab_times(torch, "affine_sweep_compact B5 (anim1080)",
             compact_kernel(tables_c), "swfsweep")
    grad = _timed_tiling(
        torch, "anim1080_gradient_compact",
        compact_kernel(tables_c, **styled), column(**styled),
        plain(**styled), counts_args + (kpaints, None, grad_extra), report,
        extra_bytes=compact_bytes, exact=True)
    want_c = sweep.sweep_compact_plain(tables_c, d_col, height, width, rules,
                                       **styled)
    grad["max_abs_err"] = max(
        grad["max_abs_err"],
        _check(torch, "anim1080_gradient_compact vs compact plain",
               compact_kernel(tables_c, **styled)(), want_c, exact=True))
    del want_c
    ab_times(torch, "affine_sweep_compact B5 styled (anim1080_gradient)",
             compact_kernel(tables_c, **styled), "swfsweep")
    report["anim1080_compact"]["census"] = b5_census()
    out["affine_compact"]["max_abs_err"] = max(
        out["affine_compact"]["max_abs_err"], grad["max_abs_err"])
    mrules = (0,) * layers
    out["morph_affine_rows"] = _timed_tiling(
        torch, "morph_affine1080_rows", morph_rows,
        lambda: sweep.render_morph_affine_sweep(*dm, height, width,
                                                layer_counts=mcounts),
        lambda: sweep.sweep_plain(dm[0], dm[2], dm[3], dm[1], dm[4], dm[5],
                                  height, width, mrules, mcounts),
        (dm[0], dm[2], dm[3], dm[1], mcounts, height, width, mrules, None,
         None, (dm[4], dm[5])), report, exact=True)
    ab_times(torch, "morph_affine_sweep_rows B4 (morph_affine1080)",
             morph_rows, "swfsweep")
    out["grouped"] = grouped_run(torch, np, "direct1080",
                                 *planes["direct1080"], report)
    dense_g = grouped_run(torch, np, "dense1080", *planes["dense1080"],
                          report)
    out["grouped"]["max_abs_err"] = max(out["grouped"]["max_abs_err"],
                                        dense_g["max_abs_err"])
    return out


def phase_tilings(torch, np, report):
    worst = tilings_random(torch, np)
    worst["grouped"] = grouped_random(torch, np)
    launches = {}
    kernels = tilings_full_width(torch, np, report, launches)
    names = {"affine_rows": "affine_sweep_rows",
             "morph_affine_rows": "morph_affine_sweep_rows",
             "affine_compact": "affine_sweep_compact",
             "grouped": "coverage_grouped"}
    for key, k in kernels.items():
        k.update(name=names[key], launches=launches[key],
                 max_abs_err=max(k["max_abs_err"], worst[key]))
    return kernels


# ---------------------------------------------------------------------------
# Phase 11: probes — exp_split's variants of B1, exp_bw, exp_scatter D
# ---------------------------------------------------------------------------

# (layers, group, width) of the random variant scenes: 2 frames x 40 rows.
PROBE_CASES = tuple((layers, group, width) for layers in (1, 4, 16)
                    for group in (6, 2) for width in (200, 1920))
BW_SHAPE = (60, 4, 137, 128, 128)   # exp_bw's F, L, NS planes, uncut


def split_random(torch, np):
    """Every variant of swf_fused_variant against its plain version (and
    full / batched / merged against render_fused_blocksn) on random
    scenes packed at one strip a plane; the ablated modes into buffers
    filled with -7, so an unwritten word shows; the observe guard: place
    writes B1's words, none the xor of its loads."""
    from swf_renderer_tpu_torch.ops.flatblock import render_fused_blocksn
    from swf_renderer_tpu_torch.tools import exp_split
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    rng = np.random.default_rng(23)
    frames, height, n = 2, 40, 0
    for layers, group, width in PROBE_CASES:
        tables, colors = build_scene_edges(frames, layers, height, width,
                                           shapes_per_layer=6,
                                           seed=int(rng.integers(1 << 30)))
        d = exp_split.pack(tables, height, width, DEVICE, group=group)
        cols = torch.as_tensor(colors, device=DEVICE)
        ns, nc = d["ns"], d["nc"]
        args = kernel_args(d) + (cols, frames, layers, ns, nc)
        b1 = render_fused_blocksn(*args, group=group)[:, :ns]
        calls = exp_split.variants(d, cols, frames, layers, group=group)
        if len(calls) != 9:
            fail(f"probes: {sorted(calls)} for L={layers} group={group}")
        for name, v in calls.items():
            what = f"probes: {name} L={layers} group={group} w={width}"
            got = v.call()[:, :ns]
            _equal_words(torch, what, got, v.plain()[:, :ns])
            if v.words:
                _equal_words(torch, f"{what} vs render_fused_blocksn", got,
                             b1)
            else:
                buf = torch.full((frames, ns + 1, 8, nc * 128), -7,
                                 dtype=torch.int32, device=DEVICE)
                arrays = args[:7] if name != "none0" else (
                    args[0], args[1], None, None, None, None, cols)
                exp_split._launch(name, *arrays, frames, layers, ns, nc,
                                  group, out=buf)
                _equal_words(torch, f"{what} (every word written)",
                             buf[:, :ns], torch.zeros_like(b1))
            n += 1
        place = exp_split._launch("place", *args[:7], frames, layers, ns, nc,
                                  group, observe=True)
        _equal_words(torch, f"probes: place observed L={layers}",
                     place[:, :ns], b1)
        none = exp_split._launch("none", *args[:7], frames, layers, ns, nc,
                                 group, observe=True)[:, :ns].cpu().numpy()
        seen = np.bitwise_xor.reduce(np.bitwise_xor.reduce(
            none.reshape(frames, ns, 8, nc, 128), axis=4), axis=2)
        want = exp_split.none_observed_plain(*kernel_args(d), frames, layers,
                                             ns, group).numpy()
        if not want.any() or not (seen == want[..., None]).all():
            fail(f"probes: none observed L={layers} group={group}: the "
                 f"loads' xor differs on {(seen != want[..., None]).sum()} "
                 f"of {seen.size} chunk blocks")
        log(f"probes: L={layers} group={group} width={width}: {len(calls)} "
            f"variants equal their plain versions, observe guards hold")
    return n


def split_headline(torch, np, report, launches):
    """The variants on the headline scene at one strip a plane: each
    driven once through its wrapper (its counter set to 0 just before,
    read just after), then timed beside B1 on the same arrays."""
    from swf_renderer_tpu_torch.ops.flatblock import (
        LANE, STRIP_H, render_fused_blocksn,
    )
    from swf_renderer_tpu_torch.tools import exp_split
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    frames, layers, height, width = HEADLINE
    if "headline_scene" not in _HELD:   # phase 3 did not run first
        _HELD["headline_scene"] = build_scene_edges(frames, layers, height,
                                                    width, seed=7)
    tables, colors = _HELD["headline_scene"]
    t0 = time.perf_counter()
    d = exp_split.pack(tables, height, width, DEVICE)
    t_pack = time.perf_counter() - t0
    cols = torch.as_tensor(colors, device=DEVICE)
    ns, nc = d["ns"], d["nc"]
    args = kernel_args(d) + (cols, frames, layers, ns, nc)
    calls = exp_split.variants(d, cols, frames, layers)
    outs = {}
    for name, v in calls.items():
        v.wrapper.launches = 0
        torch.cuda.synchronize()
        outs[name] = v.call()[:, :ns]
        torch.cuda.synchronize()
        launches[name] = v.wrapper.launches
        if launches[name] < 1:
            fail(f"probes: {name} did not launch its kernel")

    def b1():
        return render_fused_blocksn(*args, group=exp_split.GROUP)

    b1_words = b1()[:, :ns]
    ms_b1 = [time_ms(torch, b1)]
    in_bytes = sum(t.numel() * t.element_size() for t in kernel_args(d))
    out_bytes = frames * ns * STRIP_H * nc * LANE * 4
    words_bound = bound(*work_counts(torch, d, frames, layers, 1,
                                     (0,) * layers, colors=cols))
    bounds = {"place": bound(in_bytes + out_bytes, valid_updates(torch, d)),
              "none": bound(in_bytes + out_bytes, 0),
              "resolve": bound(out_bytes, 0), "none0": bound(out_bytes, 0)}
    pixels = frames * height * width
    words_shape = (frames, ns + 1, STRIP_H, nc * LANE)

    def library():   # what the ablated variants compute, in one call
        return torch.zeros(words_shape, dtype=torch.int32, device=DEVICE)

    out = {}
    for name, v in calls.items():
        want = b1_words if v.words else torch.zeros_like(b1_words)
        _equal_words(torch, f"probes: headline {name}", outs[name], want)
        ms = time_ms(torch, v.call)
        ab_times(torch, f"exp_split {name} (headline, one strip a plane)",
                 v.call)
        plain_ms = time_ms(torch, v.plain, reps=3)
        # No single call places and resolves: full, batched and merged
        # have no library yardstick.
        library_ms = None if v.words else time_ms(torch, library)
        bound_ms, bound_by = bounds.get(name, words_bound)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "max_abs_err": 0,
                     "library_ms": library_ms}
        lib = "" if library_ms is None else \
            f", torch.zeros {library_ms:.3f} ms"
        log(f"probes: headline {name}: {ms:.3f} ms "
            f"({pixels / ms / 1e6:.3f} Gpx/s), plain {plain_ms:.3f} ms"
            f"{lib}, bound {bound_ms:.4f} ms ({bound_by}), launches "
            f"{launches[name]}")
    del outs
    ms_b1.append(time_ms(torch, b1))
    ms = {k: v["ms"] for k, v in out.items()}
    decomposition = {
        "none0": ms["none0"], "none - none0": ms["none"] - ms["none0"],
        "place - none": ms["place"] - ms["none"],
        "resolve - none0": ms["resolve"] - ms["none0"], "full": ms["full"],
        "b1_before_after": ms_b1}
    log(f"probes: headline decomposition (ms, one strip a plane, "
        f"{int(d['urc'].shape[0])} groups, packing {t_pack * 1e3:.1f} ms): "
        + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else
                    f"{k} {v[0]:.3f} / {v[1]:.3f}"
                    for k, v in decomposition.items()))
    report["split_headline"] = {"groups": int(d["urc"].shape[0]),
                                "packing_ms": t_pack * 1e3,
                                "variants": out,
                                "decomposition": decomposition}
    return out


def probes_bandwidth(torch, np, report, launches):
    """exp_bw at (60, 4, 137, 128, 128) and exp_scatter D at 16384 and
    131072 steps: each kernel driven once through its wrapper (counter
    set to 0 before, read after), held equal to its plain version, timed
    beside it and beside its one-call library yardstick: each a median of
    single calls (``ms``, ``library_ms``) and a run of back-to-back calls
    (``b2b_ms``, ``library_b2b_ms``; ``enqueue_ms`` and
    ``library_enqueue_ms`` the host time a call), the kernel also as a
    run of bare launches into one buffer (``launch_b2b_ms``: no wrapper,
    no allocation), which separates the wrapper's enqueue from the
    kernel; with --parent an A/B of the wrapper against the parent's
    libswfprobes, both ways."""
    from swf_renderer_tpu_torch.tools import exp_bw, exp_scatter

    x, x_t = exp_bw.planes(DEVICE, shape=BW_SHAPE)
    buf = torch.empty_like(x)
    n_f, n_s, n_l, r, c = x_t.shape
    sums = torch.empty((n_f, n_s, r, c), device=DEVICE)

    def bare(fn, src, out, geo, *strides):
        return lambda: exp_bw.launch_probe(fn, src, out, geo, *strides)

    probes = {
        "bw_lns": (exp_bw.passthrough, lambda: exp_bw.passthrough(x, "lns"),
                   lambda: exp_bw.passthrough_plain(x),
                   lambda: torch.add(x, 1.0),
                   bare("swf_passthrough", x, buf,
                        exp_bw.geometry(tuple(x.shape), "lns")),
                   2 * x.numel() * 4),
        "bw_nsl": (exp_bw.passthrough,
                   lambda: exp_bw.passthrough(x_t, "nsl"),
                   lambda: exp_bw.passthrough_plain(x_t),
                   lambda: torch.add(x_t, 1.0),
                   bare("swf_passthrough", x_t, buf,
                        exp_bw.geometry(tuple(x_t.shape), "nsl")),
                   2 * x.numel() * 4),
        "bw_read_sum": (exp_bw.read_sum, lambda: exp_bw.read_sum(x_t),
                        lambda: exp_bw.read_sum_plain(x_t),
                        lambda: torch.sum(x_t, dim=2),
                        bare("swf_read_sum", x_t, sums,
                             exp_bw.geometry(tuple(x_t.shape), "nsl"),
                             n_s * r * c, r * c),
                        x.numel() * 4 * (1 + 1 / x.shape[1]))}
    steps = {}
    for n in exp_scatter.STEPS:
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(n)
        steps[n] = torch.randn((n, 8, 128), generator=gen, device=DEVICE)
        probes[f"step_{n}"] = (
            exp_scatter.step_probe,
            lambda s=steps[n]: exp_scatter.step_probe(s),
            lambda s=steps[n]: s + 1.0, lambda s=steps[n]: torch.add(s, 1.0),
            bare("swf_passthrough", steps[n], buf,
                 exp_bw.geometry((1, n, 1, 8, 128), "nsl")),
            2 * steps[n].numel() * 4)
    out = {}
    peak = PEAK_BYTES_PER_S / 1e9
    for name, (fn, kernel, plain, library, launch, nbytes) in probes.items():
        fn.launches = 0
        torch.cuda.synchronize()
        got = kernel()
        torch.cuda.synchronize()
        launches[name] = fn.launches
        if fn.launches < 1:
            fail(f"probes: {name} did not launch its kernel")
        want = plain()
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"probes: {name} differs from its plain version")
        launch()
        torch.cuda.synchronize()
        dest = sums if fn is exp_bw.read_sum else \
            buf.view(-1)[:want.numel()].view(want.shape)
        if not torch.equal(dest, want):
            fail(f"probes: {name}'s bare launch differs from its plain "
                 "version")
        del dest, got, want
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch, plain)
        library_ms = time_ms(torch, library)
        run = max(20, min(1000, int(20 / ms)))
        b2b_ms, enqueue_ms = time_run_ms(torch, kernel, run)
        launch_b2b_ms, _ = time_run_ms(torch, launch, run)
        library_b2b_ms, library_enqueue_ms = time_run_ms(torch, library,
                                                         run)
        bound_ms, bound_by = bound(nbytes, 0)
        ab = ab_times(torch, f"probe {name}", kernel, lib="swfprobes",
                      run=run)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "max_abs_err": 0.0, "gb_s": nbytes / ms / 1e6,
                     "run": run, "b2b_ms": b2b_ms, "enqueue_ms": enqueue_ms,
                     "launch_b2b_ms": launch_b2b_ms,
                     "library_b2b_ms": library_b2b_ms,
                     "library_enqueue_ms": library_enqueue_ms,
                     "b2b_share_of_peak": nbytes / b2b_ms / 1e6 / peak,
                     "parent_ms": None if ab is None else
                     statistics.mean(ab["parent_ms"]),
                     "change_ms": None if ab is None else
                     statistics.mean(ab["change_ms"])}
        log(f"probes: {name}: {ms:.4f} ms = {nbytes / ms / 1e6:.0f} GB/s "
            f"({nbytes / ms / 1e6 / peak:.1%} of "
            f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s; {nbytes / 1e9:.3f} GB), "
            f"plain {plain_ms:.3f} ms, library {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms, launches {launches[name]}; {run} back to "
            f"back: wrapper {b2b_ms:.4f} ms a call "
            f"({nbytes / b2b_ms / 1e6 / peak:.1%}; enqueue "
            f"{enqueue_ms:.4f} ms), bare launches {launch_b2b_ms:.4f} "
            f"({nbytes / launch_b2b_ms / 1e6 / peak:.1%}), library "
            f"{library_b2b_ms:.4f} "
            f"({nbytes / library_b2b_ms / 1e6 / peak:.1%}; enqueue "
            f"{library_enqueue_ms:.4f} ms)")
        log("probes: " + json.dumps({"row": name, **out[name]}))
    del x, x_t, buf, sums, steps, probes
    torch.cuda.empty_cache()
    report["probes_bandwidth"] = out
    return out


def phase_probes(torch, np, report):
    n = split_random(torch, np)
    log(f"probes: {n} random variant checks equal")
    launches = {}
    kernels = split_headline(torch, np, report, launches)
    kernels.update(probes_bandwidth(torch, np, report, launches))
    for key, k in kernels.items():
        k.update(name=probe_meta(key)[0], launches=launches[key])
    return {f"probe_{key}": k for key, k in kernels.items()}


# Phase 11's keys -> (kernels-line name, the TPU kernel it replaces).
PROBE_META = {
    "full": ("exp_split_full", "tools/exp_split.py:36"),
    "place": ("exp_split_place", "tools/exp_split.py:36"),
    "resolve": ("exp_split_resolve", "tools/exp_split.py:36"),
    "none": ("exp_split_none", "tools/exp_split.py:36"),
    "none0": ("exp_split_none0", "tools/exp_split.py:159"),
    "batched4": ("exp_split_batched_kk4", "tools/exp_split.py:245"),
    "batched8": ("exp_split_batched_kk8", "tools/exp_split.py:245"),
    "batched16": ("exp_split_batched_kk16", "tools/exp_split.py:245"),
    "merged": ("exp_split_merged", "tools/exp_split.py:379"),
    "bw_lns": ("exp_bw_passthrough_lns", "tools/exp_bw.py:63"),
    "bw_nsl": ("exp_bw_passthrough_nsl", "tools/exp_bw.py:63"),
    "bw_read_sum": ("exp_bw_read_sum", "tools/exp_bw.py:84"),
    "step": ("exp_scatter_step", "tools/exp_scatter.py:121"),
}


# Phase 11's streaming rows add these to their entries of the kernels
# line: the back-to-back runs and, with --parent, the A/B means.
PROBE_RUN_KEYS = ("b2b_ms", "launch_b2b_ms", "enqueue_ms", "library_b2b_ms",
                  "library_enqueue_ms", "parent_ms", "change_ms")


def probe_meta(key):
    """(name, replaces) of a phase 11 key; "step_<n>" keys name n."""
    if key.startswith("step_"):
        name, replaces = PROBE_META["step"]
        return f"{name}_{key[5:]}", replaces
    return PROBE_META[key]


# ---------------------------------------------------------------------------
# Phase 12: products — placement as a matrix product (exp_int8, exp_k3,
# exp_lmask) and the merged read at any rule and spp (exp_dmamerge)
# ---------------------------------------------------------------------------

PRODUCT_CONFIGS = ("headline", "flat256", "gradients")   # exp_dmamerge's
ENVELOPE_SHARE = 1e-4     # B1's envelope: differing straight bytes
PEAK_BF16_OPS_PER_S = 989e12
PEAK_INT8_OPS_PER_S = 1979e12
PRODUCT_META = {   # phase 12's keys -> (kernels-line name, TPU kernel)
    "int8": ("exp_int8", "tools/exp_int8.py:53"),
    "k3_three": ("exp_k3_three", "tools/exp_k3.py:53"),
    "k3_concat": ("exp_k3_concat", "tools/exp_k3.py:53"),
    "lmask": ("exp_lmask", "tools/exp_lmask.py:36"),
    "dmamerge": ("exp_dmamerge", "tools/exp_dmamerge.py:59"),
}


def envelope(torch, what, got, want):
    """A bf16 product form against its plain version: within B1's
    envelope — premultiplied bytes at most 1 level apart and at most
    ENVELOPE_SHARE of the straight bytes differing; the straight levels
    are logged (un-premultiplying scales a premultiplied level by 255 /
    alpha, so B1's 5 levels are a reading of one scene, not a bound).
    Returns the straight levels."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    diff = got != want
    a = got[diff].contiguous().view(torch.uint8).view(-1, 4).to(torch.int32)
    b = want[diff].contiguous().view(torch.uint8).view(-1, 4).to(torch.int32)
    if not a.numel():
        return 0

    def premul(x):
        return torch.cat([(x[:, :3] * x[:, 3:] + 127) // 255, x[:, 3:]], 1)

    per_px = (a - b).abs().max(dim=1).values
    straight = int(per_px.max().item())
    alpha = int(b[int(per_px.argmax().item()), 3].item())
    pm = int((premul(a) - premul(b)).abs().max().item())
    share = float((a != b).sum().item()) / (got.numel() * 4)
    log(f"products: {what}: straight {straight} levels (a pixel of alpha "
        f"{alpha}), premultiplied {pm}, differing bytes {share:.3g}"
        + (" (over B1's 5 straight levels: ROADMAP.md queue C)"
           if straight > 5 else ""))
    if pm > 1 or share > ENVELOPE_SHARE:
        fail(f"{what}: outside B1's envelope ({pm} premultiplied levels, "
             f"differing bytes {share:.3g})")
    return straight


def product_calls(d, limbs, cols, frames, layers, group):
    """key -> (wrapper, call, plain call, exact) of the four product
    forms on ``exp_split.pack``'s arrays ``d`` and their int8 limbs."""
    import functools

    from swf_renderer_tpu_torch.tools import exp_int8, exp_k3, exp_lmask
    from swf_renderer_tpu_torch.ops.flatblock import fusedn_plain

    a = kernel_args(d) + (cols, frames, layers, d["ns"], d["nc"])
    a8 = kernel_args(d)[:5] + tuple(limbs) + a[6:]
    part = functools.partial
    return {
        "int8": (exp_int8.run_int8, part(exp_int8.run_int8, *a8, group),
                 part(exp_int8.int8_plain, *a8, group), True),
        "k3_three": (exp_k3.run_variant,
                     part(exp_k3.run_variant, *a, group, False),
                     part(fusedn_plain, *a, group=group), False),
        "k3_concat": (exp_k3.run_variant,
                      part(exp_k3.run_variant, *a, group, True),
                      part(fusedn_plain, *a, group=group), False),
        "lmask": (exp_lmask.render_lmask,
                  part(exp_lmask.render_lmask, *a, group=group),
                  part(exp_lmask.lmask_plain, *a, group=group), False),
    }


def products_random(torch, np):
    """The four product forms against their plain versions on phase 11's
    random scenes (one strip a plane): int8 equal, the bf16 forms within
    B1's envelope; the merged read (render_rv) at each scene's own strips
    per plane under the nonzero, even-odd and a mixed rule, equal to its
    plain version and to render_fused_blocksn."""
    from swf_renderer_tpu_torch.ops.flatblock import render_fused_blocksn
    from swf_renderer_tpu_torch.tools import exp_dmamerge, exp_int8, exp_split
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    rng = np.random.default_rng(29)
    frames, height, n, worst = 2, 40, 0, 0
    for layers, group, width in PROBE_CASES:
        tables, colors = build_scene_edges(frames, layers, height, width,
                                           shapes_per_layer=6,
                                           seed=int(rng.integers(1 << 30)))
        cols = torch.as_tensor(colors, device=DEVICE)
        d = exp_split.pack(tables, height, width, DEVICE, group=group)
        ns = d["ns"]
        limbs = exp_int8.limbs_to_device(d)
        for key, (_, call, plain, exact) in product_calls(
                d, limbs, cols, frames, layers, group).items():
            what = f"{key} L={layers} group={group} w={width}"
            got, want = call()[:, :ns], plain()[:, :ns]
            if exact:
                _equal_words(torch, f"products: {what}", got, want)
            else:
                worst = max(worst, envelope(torch, what, got, want))
            n += 1
        d, urv, spp = exp_dmamerge.pack_rv(tables, height, width, DEVICE,
                                           group=group)
        ns, nc = d["ns"], d["nc"]
        mixed = tuple(int(x) for x in rng.integers(0, 2, layers))
        for rule in (0, 1, mixed):
            geo = (cols, frames, layers, ns, nc)
            got = exp_dmamerge.render_rv(d["sidx"], d["flags"], d["lays"],
                                         urv, d["ucm"], *geo, group, rule,
                                         spp)[:, :ns]
            what = f"products: rv spp={spp} L={layers} group={group} rule=" \
                   f"{rule if isinstance(rule, int) else 'mixed'}"
            _equal_words(torch, what, got, exp_dmamerge.rv_plain(
                d["sidx"], d["flags"], d["lays"], urv, d["ucm"], *geo, group,
                rule, spp)[:, :ns])
            _equal_words(torch, f"{what} vs render_fused_blocksn", got,
                         render_fused_blocksn(*kernel_args(d), *geo,
                                              group=group, fill_rule=rule,
                                              spp=spp)[:, :ns])
            n += 1
        log(f"products: L={layers} group={group} width={width}: four "
            f"product forms and rv at spp {spp} under three rules checked")
    return n, worst


def tensor_core_useful_ops(torch, d):
    """Useful tensor-core operations of a product form, 2 x M x N x K with
    M = 128 columns, N = 8 rows and K the valid updates, three products
    (hi / mid / lo or three limbs) each: the same count for every form.
    What the tiles issue is more — K padded to the tile's depth, and the
    layer-masked form's products of masked layers — and is not counted."""
    k = valid_updates(torch, d)
    return 2 * 128 * 8 * 3 * k, k


def products_headline(torch, np, report, launches):
    """The four product forms on phase 3's headline scene at one strip a
    plane, and render_rv on exp_dmamerge's headline, flat256 and gradients
    scenes at their strips per plane: each wrapper driven once (its
    counter set to 0 just before, read just after), held against its
    plain version and B1, then timed beside B1 on the same arrays."""
    from swf_renderer_tpu_torch.ops.flatblock import render_fused_blocksn
    from swf_renderer_tpu_torch.tools import exp_dmamerge, exp_int8, exp_split
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    frames, layers, height, width = HEADLINE
    if "headline_scene" not in _HELD:   # phase 3 did not run first
        _HELD["headline_scene"] = build_scene_edges(frames, layers, height,
                                                    width, seed=7)
    tables, colors = _HELD["headline_scene"]
    cols = torch.as_tensor(colors, device=DEVICE)
    d = exp_split.pack(tables, height, width, DEVICE)
    limbs = exp_int8.limbs_to_device(d)
    ns, nc = d["ns"], d["nc"]
    args = kernel_args(d) + (cols, frames, layers, ns, nc)

    def b1():
        return render_fused_blocksn(*args, group=exp_split.GROUP)

    b1_words = b1()[:, :ns]
    ms_b1 = [time_ms(torch, b1)]
    nbytes, ops = work_counts(torch, d, frames, layers, 1, (0,) * layers,
                              colors=cols)
    pixels = frames * height * width
    tc_ops, k = tensor_core_useful_ops(torch, d)
    out = {}
    for key, (wrapper, call, plain, exact) in product_calls(
            d, limbs, cols, frames, layers, exp_split.GROUP).items():
        wrapper.launches = 0
        torch.cuda.synchronize()
        got = call()[:, :ns]
        torch.cuda.synchronize()
        launches[key] = wrapper.launches
        if launches[key] < 1:
            fail(f"products: {key} did not launch its kernel")
        want = plain()[:, :ns]
        if exact:
            err = _equal_words(torch, f"products: headline {key}", got, want)
        else:
            err = envelope(torch, f"headline {key}", got, want)
        dmax_b1, share_b1 = byte_diff(got, b1_words)
        del got, want
        ms = time_ms(torch, call)
        ab = ab_times(torch, f"products {key} headline", call)
        plain_ms = time_ms(torch, plain, reps=3)
        kbytes = nbytes
        if key == "int8":   # 3 B of limbs a slot in place of a 4 B value
            kbytes += sum(t.numel() for t in limbs) - d["uval"].numel() * 4
        bound_ms, bound_by = bound(kbytes, ops)
        peak = PEAK_INT8_OPS_PER_S if key == "int8" else PEAK_BF16_OPS_PER_S
        out[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "max_abs_err": err,
                    "library_ms": None, "tc_useful_ops": tc_ops,
                    "tc_useful_ms_at_peak": tc_ops / peak * 1e3,
                    "valid_updates": k, "vs_b1_levels": dmax_b1,
                    "vs_b1_share": share_b1}
        if ab is not None:
            out[key]["ab"] = ab
        log(f"products: headline {key}: {ms:.3f} ms "
            f"({pixels / ms / 1e6:.3f} Gpx/s), plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), useful tensor-core "
            f"work {tc_ops / 1e9:.2f} Gop ({tc_ops / peak * 1e3:.4f} ms at "
            f"peak; the tiles issue more), vs B1 {dmax_b1} levels on "
            f"{share_b1:.3g} of the bytes, launches {launches[key]}")
    ms_b1.append(time_ms(torch, b1))
    del b1_words, limbs, d
    torch.cuda.empty_cache()

    merged = {}
    for cfg in PRODUCT_CONFIGS:
        f, lyr, h, w = (HEADLINE if cfg == "headline"
                        else exp_dmamerge.CONFIGS[cfg])
        tbl, clr = ((tables, colors) if cfg == "headline"
                    else build_scene_edges(f, lyr, h, w, seed=7))
        c = torch.as_tensor(clr, device=DEVICE)
        dm, urv, spp = exp_dmamerge.pack_rv(tbl, h, w, DEVICE)
        geo = (c, f, lyr, dm["ns"], dm["nc"])

        def rv(dm=dm, urv=urv, geo=geo, spp=spp):
            return exp_dmamerge.render_rv(dm["sidx"], dm["flags"],
                                          dm["lays"], urv, dm["ucm"], *geo,
                                          spp=spp)

        def base(dm=dm, geo=geo, spp=spp):
            return render_fused_blocksn(*kernel_args(dm), *geo, spp=spp)

        def plain(dm=dm, urv=urv, geo=geo, spp=spp):
            return exp_dmamerge.rv_plain(dm["sidx"], dm["flags"], dm["lays"],
                                         urv, dm["ucm"], *geo, spp=spp)

        exp_dmamerge.render_rv.launches = 0
        torch.cuda.synchronize()
        got = rv()[:, :dm["ns"]]
        torch.cuda.synchronize()
        key = f"dmamerge_{cfg}"
        launches[key] = exp_dmamerge.render_rv.launches
        if launches[key] < 1:
            fail(f"products: {key} did not launch its kernel")
        _equal_words(torch, f"products: {key}", got, plain()[:, :dm["ns"]])
        _equal_words(torch, f"products: {key} vs render_fused_blocksn", got,
                     base()[:, :dm["ns"]])
        del got
        ms_base = time_ms(torch, base)
        ms = time_ms(torch, rv)
        plain_ms = time_ms(torch, plain, reps=3)
        bound_ms, bound_by = bound(*work_counts(torch, dm, f, lyr, spp,
                                                (0,) * lyr, colors=c))
        out[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "max_abs_err": 0,
                    "library_ms": None}
        merged[cfg] = {"spp": spp, "ms": ms, "b1_ms": ms_base}
        log(f"products: {key} ({f}x{lyr}x{h}x{w}, spp {spp}): {ms:.3f} ms "
            f"beside B1 {ms_base:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), launches {launches[key]}")
    log("products: headline at one strip a plane, B1 before / after "
        f"{ms_b1[0]:.3f} / {ms_b1[1]:.3f} ms; "
        + ", ".join(f"{k} {v['ms']:.3f}" for k, v in out.items()
                    if not k.startswith("dmamerge")))
    report["products_headline"] = {"groups": int(args[0].shape[0]),
                                   "b1_before_after": ms_b1,
                                   "forms": out, "merged": merged}
    return out


def sass_bodies():
    """``cuobjdump -sass`` of the built fused library -> {mangled kernel
    name: its SASS}, read once a run."""
    from swf_renderer_tpu_torch.ops import cuda_lib

    if "sass" not in _HELD:
        _HELD["sass"] = sass_of(cuda_lib.lib_path("swfkernels"))
    return _HELD["sass"]


def sass_check():
    """Every product form issues warpgroup products and no warp-level
    ones, at both layer classes: the bf16 forms (k3 three and concat, the
    layer-masked form) HGMMA, the int8 form IGMMA, each nothing else of
    HMMA, HGMMA, IMMA and IGMMA, so that neither a scalar fallback, a
    warp-level product nor the other type passes.  The null HGMMA that
    ptxas adds where a group is committed (destination RZ) is no product
    and is not counted.  Returns {form: (HMMA, HGMMA, IMMA, IGMMA)
    counts}."""
    ops = ("HMMA", "HGMMA", "IMMA", "IGMMA")
    counts = {}
    for name, body in sass_bodies().items():
        form = re.search(r"product_kernelILi(\d+)ELi(\d+)E", name)
        if not form:
            continue
        key = int(form.group(1)), int(form.group(2))
        counts[key] = tuple(len(re.findall(rf"\b{op}\.\S+\s+(?!RZ\b)",
                                           body)) for op in ops)
    names = {}
    for var, form, want in ((7, "k3_three", 1), (8, "k3_concat", 1),
                            (9, "lmask", 1), (10, "int8", 3)):
        names[(var, 4)] = (form, want)
        names[(var, 16)] = (f"{form} at 16 layers", want)
    for key, (name, want) in names.items():
        got = counts.get(key, (0,) * len(ops))
        if any((n > 0) != (i == want) for i, n in enumerate(got)):
            fail(f"SASS: product form {name} issues "
                 + ", ".join(f"{n} {op}" for n, op in zip(got, ops)))
        log(f"products: SASS of {name}: "
            + ", ".join(f"{n} {op}" for n, op in zip(got, ops)))
    return {name: counts[key] for key, (name, _) in names.items()}


def phase_products(torch, np, report):
    sass = sass_check()
    n, worst = products_random(torch, np)
    log(f"products: {n} random checks held, bf16 forms' straight levels at "
        f"most {worst}")
    launches = {}
    kernels = products_headline(torch, np, report, launches)
    report["products_sass"] = sass
    report["ptxas"] = _HELD.get("ptxas", {})
    out = {}
    for key, k in kernels.items():
        base = "dmamerge" if key.startswith("dmamerge") else key
        name, replaces = PRODUCT_META[base]
        if base == "dmamerge":
            name = f"{name}_{key[len('dmamerge_'):]}"
        k.update(name=name, replaces=replaces, launches=launches[key])
        if base != "dmamerge" and base != "int8":
            k["max_abs_err"] = max(k["max_abs_err"], worst)
        out[f"product_{key}"] = k
    return out


# ---------------------------------------------------------------------------
# Phase 13: windows and coarse steps — window-targeted placement
# (exp_winplace) and coarse steps with explicit output copies (exp_dma)
# ---------------------------------------------------------------------------

WIN_CONFIGS = ("headline", "flat256", "gradients", "textured")
# (height, width) of the random windowed scenes, 2 frames: 1, 2, 5 and 8
# strips a plane.
WIN_CASES = ((40, 2560), (40, 1920), (40, 200), (64, 96))
COARSE_TAG = "UBLKCP"   # the SASS of cp.async.bulk shared -> global


def win_random(torch, np):
    """render_win against win_plain and render_fused_blocksn (the pooled
    packing at the same strips per plane) on random scenes: 1, 4 and 16
    layers, 1, 2, 5 and 8 strips a plane (at 16 layers and 5 or 8 the
    blocks' strip slices are smaller than the plane, so blocks skip
    windows), nonzero, even-odd and a mixed rule; byte-equal."""
    from swf_renderer_tpu_torch.ops import cuda_lib
    from swf_renderer_tpu_torch.ops.flatblock import render_fused_blocksn
    from swf_renderer_tpu_torch.tools import exp_split, exp_winplace
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    lib = cuda_lib.load()
    rng = np.random.default_rng(31)
    frames, n = 2, 0
    for height, width in WIN_CASES:
        for layers in (1, 4, 16):
            tables, colors = build_scene_edges(
                frames, layers, height, width, shapes_per_layer=6,
                seed=int(rng.integers(1 << 30)))
            d, spp = exp_winplace.pack(tables, height, width, DEVICE)
            spb = lib.swf_strips_per_block(layers, spp, 0)
            if layers == 16 and spp >= 5 and spb >= spp:
                fail(f"windows: the 16-layer case at {spp} strips a plane "
                     f"does not split its strips (strips per block {spb})")
            base = exp_split.pack(tables, height, width, DEVICE, spp=spp)
            cols = torch.as_tensor(colors, device=DEVICE)
            ns = d["ns"]
            geo = (cols, frames, layers, ns, d["nc"])
            win_args = tuple(d[k] for k in ("sidx", "flags", "lays", "wins",
                                            "urc", "ucm", "uval")) + geo
            mixed = tuple(int(x) for x in rng.integers(0, 2, layers))
            for rule in (0, 1, mixed):
                tag = rule if isinstance(rule, int) else "mixed"
                what = (f"windows: {height}x{width} spp={spp} spb={spb} "
                        f"L={layers} rule={tag}")
                got = exp_winplace.render_win(*win_args, fill_rule=rule,
                                              spp=spp)[:, :ns]
                _equal_words(torch, what, got, exp_winplace.win_plain(
                    *win_args, fill_rule=rule, spp=spp)[:, :ns])
                _equal_words(torch, f"{what} vs render_fused_blocksn", got,
                             render_fused_blocksn(*kernel_args(base), *geo,
                                                  fill_rule=rule,
                                                  spp=spp)[:, :ns])
                n += 1
            log(f"windows: {height}x{width} spp={spp} spb={spb} L={layers}: "
                f"{int(base['sidx'].shape[0])} pooled / {d['ng']} windowed "
                f"groups, three rules equal")
    return n


def coarse_random(torch, np):
    """The coarse kernel at coarse 1, 2 and 4 against dma_plain and
    render_fused_blocksn on phase 11's random scenes (one strip a plane):
    through its wrapper run_variant, and through one launch into a buffer
    filled with -7, where every strip is written and the sentinel strip
    block stays -7 (the bulk copies write nothing else)."""
    from swf_renderer_tpu_torch.ops.flatblock import render_fused_blocksn
    from swf_renderer_tpu_torch.tools import exp_dma, exp_split
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    rng = np.random.default_rng(37)
    frames, height, n = 2, 40, 0
    for layers, group, width in PROBE_CASES:
        tables, colors = build_scene_edges(frames, layers, height, width,
                                           shapes_per_layer=6,
                                           seed=int(rng.integers(1 << 30)))
        d = exp_split.pack(tables, height, width, DEVICE, group=group)
        cols = torch.as_tensor(colors, device=DEVICE)
        ns, nc = d["ns"], d["nc"]
        args = kernel_args(d) + (cols, frames, layers, ns, nc)
        want = exp_dma.dma_plain(*args, group)[:, :ns]
        _equal_words(torch, f"coarse: B1 L={layers} group={group}",
                     render_fused_blocksn(*args, group=group)[:, :ns], want)
        for coarse in exp_dma.COARSES:
            what = f"coarse: c={coarse} L={layers} group={group} w={width}"
            _equal_words(torch, f"{what} run_variant",
                         exp_dma.run_variant(*args, group, coarse)[:, :ns],
                         want)
            buf = torch.full((frames, ns + 1, 8, nc * 128), -7,
                             dtype=torch.int32, device=DEVICE)
            exp_dma._launch(*args, group, coarse, out=buf)
            _equal_words(torch, what, buf[:, :ns], want)
            if not bool((buf[:, ns] == -7).all().item()):
                fail(f"{what}: the sentinel strip block was written")
            n += 1
        log(f"coarse: L={layers} group={group} width={width}: coarse "
            f"{exp_dma.COARSES} equal B1, sentinel untouched")
    return n


def coarse_sass_check():
    """The coarse kernel's SASS at both layer classes, for coarse 1 and
    above, holds the bulk copy (COARSE_TAG) and no 64-bit
    compare-and-swap (the loop a 64-bit shared atomicAdd becomes: the
    carry is two 32-bit atomics, as B1's), and B1's holds no bulk copy.
    Returns {kernel: (bulk copies, 64-bit CAS)}."""
    counts = {}
    for name, body in sass_bodies().items():
        lc = re.search(r"coarse_kernelILi(\d+)ELb(\d)E", name)
        if not lc and PTXAS_WATCH["B1 fused_block<solid>"] not in name:
            continue
        key = (f"coarse{lc.group(1)}" + ("_one" if lc.group(2) == "1"
                                         else "")) if lc else "b1"
        cas = re.findall(r"\b(ATOMS?\.CAS\S*)", body)
        counts[key] = (len(re.findall(rf"\b{COARSE_TAG}\b", body)),
                       sum(1 for op in cas if "64" in op))
        ops = sorted(set(re.findall(r"\b(\w*BLK\w*)(?:\.\w+)*", body)))
        log(f"windows: SASS of {key}: {counts[key][0]} {COARSE_TAG}, "
            f"{counts[key][1]} 64-bit CAS (CAS forms {sorted(set(cas))}); "
            f"bulk mnemonics {ops}")
    coarse = [v for k, v in counts.items() if k.startswith("coarse")]
    if len(coarse) != 4 or any(n < 1 or cas for n, cas in coarse) or \
            counts.get("b1", (1, 0))[0] != 0:
        fail(f"SASS: {COARSE_TAG} and 64-bit CAS counts {counts} (the "
             f"coarse kernel must issue bulk copies and no 64-bit CAS "
             f"loop)")
    return counts


def win_full_width(torch, np, report, launches):
    """render_win on exp_winplace's headline (spp 2), flat256, gradients
    and textured scenes, uncut: the windowed packing timed, each wrapper
    driven once (its counter set to 0 just before, read just after), held
    against win_plain and B1 at the same strips per plane, then timed
    beside B1 on the same scene."""
    from swf_renderer_tpu_torch.ops.flatblock import render_fused_blocksn
    from swf_renderer_tpu_torch.tools import exp_split, exp_winplace
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    out = {}
    for cfg in WIN_CONFIGS:
        f, lyr, h, w = exp_winplace.CONFIGS[cfg]
        if cfg == "headline":
            if (f, lyr, h, w) != HEADLINE:
                fail(f"windows: headline config {(f, lyr, h, w)}")
            if "headline_scene" not in _HELD:   # phase 3 did not run first
                _HELD["headline_scene"] = build_scene_edges(f, lyr, h, w,
                                                            seed=7)
            tbl, clr = _HELD["headline_scene"]
        else:
            tbl, clr = build_scene_edges(f, lyr, h, w, seed=7)
        c = torch.as_tensor(clr, device=DEVICE)
        t0 = time.perf_counter()
        d, spp = exp_winplace.pack(tbl, h, w, DEVICE)
        torch.cuda.synchronize()
        t_pack = time.perf_counter() - t0
        base = exp_split.pack(tbl, h, w, DEVICE, spp=spp)
        geo = (c, f, lyr, d["ns"], d["nc"])
        win_args = tuple(d[k] for k in ("sidx", "flags", "lays", "wins",
                                        "urc", "ucm", "uval")) + geo

        def win(a=win_args, spp=spp):
            return exp_winplace.render_win(*a, spp=spp)

        def plain(a=win_args, spp=spp):
            return exp_winplace.win_plain(*a, spp=spp)

        def b1(base=base, geo=geo, spp=spp):
            return render_fused_blocksn(*kernel_args(base), *geo, spp=spp)

        key = f"win_{cfg}"
        exp_winplace.render_win.launches = 0
        torch.cuda.synchronize()
        got = win()[:, :d["ns"]]
        torch.cuda.synchronize()
        launches[key] = exp_winplace.render_win.launches
        if launches[key] < 1:
            fail(f"windows: {key} did not launch its kernel")
        _equal_words(torch, f"windows: {key}", got, plain()[:, :d["ns"]])
        _equal_words(torch, f"windows: {key} vs render_fused_blocksn", got,
                     b1()[:, :d["ns"]])
        del got
        ms_b1 = time_ms(torch, b1)
        ms = time_ms(torch, win)
        ms_b1_after = time_ms(torch, b1)
        plain_ms = time_ms(torch, plain, reps=3)
        nbytes, ops = work_counts(torch, d, f, lyr, spp, (0,) * lyr,
                                  colors=c)
        nbytes += d["wins"].numel() * d["wins"].element_size()
        bound_ms, bound_by = bound(nbytes, ops)
        # Groups without padding (flags 0) and with it, pooled and windowed.
        groups = {"base": int((base["flags"] != 0).sum().item()),
                  "base_padded": int(base["sidx"].shape[0]),
                  "windowed": d["ng"],
                  "windowed_padded": int(d["sidx"].shape[0])}
        out[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "max_abs_err": 0,
                    "library_ms": None, "b1_ms": [ms_b1, ms_b1_after],
                    "spp": spp, "groups": groups,
                    "pack_windowed_ms": t_pack * 1e3}
        log(f"windows: {key} ({f}x{lyr}x{h}x{w}, spp {spp}): {ms:.3f} ms "
            f"beside B1 {ms_b1:.3f} / {ms_b1_after:.3f} ms "
            f"({ms / ((ms_b1 + ms_b1_after) / 2) - 1:+.1%}), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
            f"groups pooled {groups['base']} (padded "
            f"{groups['base_padded']}), windowed {groups['windowed']} "
            f"(padded {groups['windowed_padded']}; "
            f"{groups['windowed'] / groups['base'] - 1:+.1%}), windowed "
            f"packing {t_pack * 1e3:.1f} ms; launches {launches[key]}")
        del d, base, win_args
        torch.cuda.empty_cache()
    return out


def coarse_headline(torch, np, report, launches):
    """exp_dma's run_variant at coarse 1, 2 and 4 on phase 3's headline at
    one strip a plane: each driven once (its counter set to 0 just before,
    read just after), held against dma_plain and B1, the sentinel strip
    block of a -7 buffer checked, then timed beside B1."""
    from swf_renderer_tpu_torch.ops.flatblock import render_fused_blocksn
    from swf_renderer_tpu_torch.tools import exp_dma, exp_split
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    frames, layers, height, width = HEADLINE
    if "headline_scene" not in _HELD:   # phase 3 did not run first
        _HELD["headline_scene"] = build_scene_edges(frames, layers, height,
                                                    width, seed=7)
    tables, colors = _HELD["headline_scene"]
    cols = torch.as_tensor(colors, device=DEVICE)
    d = exp_split.pack(tables, height, width, DEVICE)
    ns, nc = d["ns"], d["nc"]
    args = kernel_args(d) + (cols, frames, layers, ns, nc)
    ng = int(d["sidx"].shape[0])

    def b1():
        return render_fused_blocksn(*args, group=exp_split.GROUP)

    def plain():
        return exp_dma.dma_plain(*args, exp_split.GROUP)

    want = plain()[:, :ns]
    _equal_words(torch, "coarse: headline B1", b1()[:, :ns], want)
    ms_b1 = [time_ms(torch, b1)]
    plain_ms = time_ms(torch, plain, reps=3)
    bound_ms, bound_by = bound(*work_counts(torch, d, frames, layers, 1,
                                            (0,) * layers, colors=cols))
    out = {}
    for coarse in exp_dma.COARSES:
        def call(coarse=coarse):
            return exp_dma.run_variant(*args, exp_split.GROUP, coarse)

        key = f"dma_c{coarse}"
        exp_dma.run_variant.launches = 0
        torch.cuda.synchronize()
        got = call()[:, :ns]
        torch.cuda.synchronize()
        launches[key] = exp_dma.run_variant.launches
        if launches[key] < 1:
            fail(f"coarse: {key} did not launch its kernel")
        _equal_words(torch, f"coarse: headline {key}", got, want)
        del got
        buf = torch.full((frames, ns + 1, 8, nc * 128), -7,
                         dtype=torch.int32, device=DEVICE)
        exp_dma._launch(*args, exp_split.GROUP, coarse, out=buf)
        _equal_words(torch, f"coarse: headline {key} into -7", buf[:, :ns],
                     want)
        if not bool((buf[:, ns] == -7).all().item()):
            fail(f"coarse: headline {key}: the sentinel strip block was "
                 f"written")
        del buf
        ms = time_ms(torch, call)
        ab = ab_times(torch, f"coarse {coarse} headline", call)
        out[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "max_abs_err": 0,
                    "library_ms": None, "steps": ng // coarse}
        if ab is not None:
            out[key]["ab"] = ab
        log(f"coarse: headline {key} ({ng // coarse} steps of {ng} groups, "
            f"{ng // coarse * nc} blocks): {ms:.3f} ms "
            f"({frames * height * width / ms / 1e6:.3f} Gpx/s), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"launches {launches[key]}")
    ms_b1.append(time_ms(torch, b1))
    log(f"coarse: headline at one strip a plane, B1 before / after "
        f"{ms_b1[0]:.3f} / {ms_b1[1]:.3f} ms; "
        + ", ".join(f"{k} {v['ms']:.3f} "
                    f"({v['ms'] / ((ms_b1[0] + ms_b1[1]) / 2) - 1:+.1%})"
                    for k, v in out.items()))
    report["coarse_headline"] = {"groups": ng, "b1_before_after": ms_b1,
                                 "forms": out}
    del want, d
    torch.cuda.empty_cache()
    return out


def phase_windows(torch, np, report):
    sass = coarse_sass_check()
    n = win_random(torch, np)
    m = coarse_random(torch, np)
    log(f"windows: {n} random windowed and {m} random coarse checks equal")
    launches = {}
    kernels = win_full_width(torch, np, report, launches)
    report["win_full_width"] = dict(kernels)
    kernels.update(coarse_headline(torch, np, report, launches))
    report["coarse_sass"] = sass
    out = {}
    for key, k in kernels.items():
        if key.startswith("win_"):
            name = f"exp_winplace_{key[4:]}"
            replaces = "tools/exp_winplace.py:75"
        else:
            name, replaces = f"exp_{key}", "tools/exp_dma.py:39"
        k.update(name=name, replaces=replaces, launches=launches[key])
        out[f"window_{key}"] = k
    return out


# ---------------------------------------------------------------------------
# Phase 14: movies — .swf files built by the port's emitter, parsed on the
# host and rendered through the renderer's routes (B3, B6, B2 + B8), and
# the command-line renderer
# ---------------------------------------------------------------------------

MOVIE_SIZE = (1920, 1080)   # width, height: a 38400 x 21600 twip RECT
MOVIE_FRAMES = 60           # movie_anim1080, 30 fps
MORPH_MOVIE_FRAMES = 16     # movie_morph1080's ratio track


class _Recorder:
    """Record every launch of the styled kernel (``ops.flatblock.
    _launch`` with ``styled``) and of the texfield kernel (``ops.texfield.
    _launch``) with its arguments and output, until ``restore``; like
    ``_record_sweeps``, recording launches nothing and counts nothing."""

    def __init__(self):
        from swf_renderer_tpu_torch.ops import flatblock, texfield

        self.mods = (flatblock, texfield)
        self.orig = (flatblock._launch, texfield._launch)
        self.styled, self.tex = [], []

        def styled(*args, **kwargs):
            out = self.orig[0](*args, **kwargs)
            if args[0]:
                self.styled.append((args, kwargs, out))
            return out

        def tex(*args, **kwargs):
            out = self.orig[1](*args, **kwargs)
            self.tex.append((args, kwargs, out))
            return out

        flatblock._launch, texfield._launch = styled, tex

    def restore(self):
        self.mods[0]._launch, self.mods[1]._launch = self.orig

    def clear(self):
        self.styled.clear()
        self.tex.clear()


def _styled_plain_args(args, kwargs):
    """``ops.flatblock._launch``'s arguments -> ``fused_styled_plain``'s."""
    (_styled, sidx, flags, lays, urc, ucm, uval, colors, fields, paints,
     frames, layers, n_strips, n_chunks, group, fill_rule, spp) = args
    return ((sidx, flags, lays, urc, ucm, uval, colors, fields, frames,
             layers, n_strips, n_chunks, paints),
            dict(group=group, fill_rule=fill_rule, spp=spp, **kwargs))


def _recorded_equal_plain(torch, what, rec):
    """Each recorded styled launch equals ``fused_styled_plain`` word for
    word, each texfield launch ``texfield_plain`` within TEX_TOL -> (max
    abs difference, words and field values compared)."""
    from swf_renderer_tpu_torch.ops.flatblock import fused_styled_plain
    from swf_renderer_tpu_torch.ops.texfield import texfield_plain

    worst, n = 0.0, 0
    for args, kwargs, out in list(rec.styled):
        a, k = _styled_plain_args(args, kwargs)
        want = fused_styled_plain(*a, **k)
        if out.shape != want.shape or not torch.equal(out, want):
            fail(f"{what}: the styled kernel's words differ from "
                 "fused_styled_plain")
        n += out.numel()
    for args, _kwargs, out in list(rec.tex):
        img, invs, height, width, sub, repeating, smoothed, canvas = args
        want = texfield_plain(img, invs, height, width, sub, repeating,
                              smoothed, "canvas" if canvas else "flash")
        worst = max(worst, _check_fields(torch, what, out, want))
        n += out.numel()
    return worst, n


def _replay_split(torch, np, wall_ms, launches, frames, background):
    """A render's wall split by replaying its recorded launches: kernel =
    CUDA-event time of each launch again, upload = the pageable
    host-to-card copy of the inputs the host built (its paint tables and
    fields excluded), download = the pageable copy of the returned
    frames' bytes from the card, composite = the renderer's host
    compositing of the stage background under the frames
    (``_composite_background``, numpy), host = the rest of the wall
    (parse, stage build, plan, lowering, packing)."""
    from swf_renderer_tpu_torch.runtime.renderer import (
        _composite_background,
    )

    t0 = time.perf_counter()
    _composite_background(frames, background if frames.ndim == 3
                          else [background] * frames.shape[0])
    composite = (time.perf_counter() - t0) * 1e3
    dev = torch.device(DEVICE)
    kernel = sum(time_ms(torch, lambda f=getattr(mod, name), a=a, k=k:
                         f(*a, **k), reps=3)
                 for mod, name, a, k, _ins in launches)
    host_inputs = [t.cpu() for *_call, ins in launches for t in ins
                   if t is not None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in host_inputs:
        t.to(dev)
    torch.cuda.synchronize()
    upload = (time.perf_counter() - t0) * 1e3
    on_card = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card.cpu()
    download = (time.perf_counter() - t0) * 1e3
    return {"wall_ms": wall_ms, "kernel_ms": kernel, "upload_ms": upload,
            "download_ms": download, "composite_ms": composite,
            "host_ms": wall_ms - kernel - upload - download - composite,
            "upload_bytes": sum(t.numel() * t.element_size()
                                for t in host_inputs)}


def _sweep_launches(sweep, calls):
    """Recorded sweep launches -> replayable (module, launcher name,
    args, kwargs, inputs the host built); replayed once recording ends."""
    return [(sweep, "_launch_sweep", args, kwargs,
             [t for t in args[:6] if t is not None])
            for args, kwargs, _o in calls]


def _styled_launches(rec):
    flatblock, texfield = rec.mods
    out = [(flatblock, "_launch", a, k, a[1:8]) for a, k, _o in rec.styled]
    out += [(texfield, "_launch", a, k, a[:2]) for a, k, _o in rec.tex]
    return out


def _log_split(what, split, card, phase="movies"):
    log(f"{phase}: {what}: wall {split['wall_ms']:.1f} ms = host (parse, "
        f"plan, lowering) {split['host_ms']:.1f} + upload "
        f"{split['upload_ms']:.2f} ({split['upload_bytes']} B) + kernel "
        f"{split['kernel_ms']:.3f} + download {split['download_ms']:.1f} + "
        f"background composite on the host {split['composite_ms']:.1f} "
        f"(replayed) [{card}]")


def _load_timed(torch, data, movie, timeline):
    """(parse ms, stage-build ms) of one movie, medians of 5:
    ``parse_movie`` alone, then the loader (which parses again) less
    it."""
    from swf_renderer_tpu_torch.models.swf_binary import parse_movie

    load = movie.load_movie_timeline if timeline else movie.load_movie_stage

    def median_ms(fn):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn(data)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    parse = median_ms(parse_movie)
    return parse, median_ms(load) - parse


def movies_anim(torch, np, report, route, card):
    """movie_anim1080 in FWS (three calls), CWS and ZWS through
    ``render_movie_timeline``: each one B3 launch and no B2, the frames
    equal word for word to ``render_batch`` of the stages built by hand
    and the route's launch to ``sweep_plain`` on its own tables."""
    from swf_renderer_tpu_torch.models.swf_binary import compress_movie
    from swf_renderer_tpu_torch.ops import transform as sweep
    from swf_renderer_tpu_torch.runtime import movie
    from swf_renderer_tpu_torch.runtime.renderer import TorchRenderer
    from swf_renderer_tpu_torch.utils import movie_scenes

    width, height = MOVIE_SIZE
    data, stages = movie_scenes.anim_movie(
        movie_scenes.port_mods(), width, height, frames=MOVIE_FRAMES)
    parse_ms, build_ms = _load_timed(torch, data, movie, True)
    calls, restore = _record_sweeps(sweep)
    walls, outs, words = [], {}, 0
    try:
        for sig in ("FWS", "FWS", "FWS", "CWS", "ZWS"):
            src = data if sig == "FWS" else compress_movie(data, sig)
            frames, wall, got = route(movie.render_movie_timeline, src)
            if got["affine"] != 1 or got["styled"] != 0:
                fail(f"movies: movie_anim1080 ({sig}) launched {got}: one "
                     "B3 launch and no B2 expected")
            if sig == "FWS":
                walls.append(wall)
                last = _sweep_launches(sweep, calls)
            words += _route_equals_plain(torch, sweep,
                                         f"movie_anim1080 ({sig})", calls)
            if frames.shape != (MOVIE_FRAMES, height, width, 4):
                fail(f"movies: movie_anim1080 frames {frames.shape}")
            outs.setdefault(sig, frames)
            if not np.array_equal(frames, outs["FWS"]):
                fail(f"movies: movie_anim1080 {sig} frames differ from FWS")
        renderer = TorchRenderer(width, height, device=DEVICE)
        hand = renderer.render_batch(stages)
        words += _route_equals_plain(torch, sweep, "movie_anim1080 (hand)",
                                     calls)
    finally:
        restore()
    if renderer.last_stats.path != "transform-sweep":
        fail(f"movies: movie_anim1080 path {renderer.last_stats.path!r}")
    if not np.array_equal(hand, outs["FWS"]):
        fail("movies: movie_anim1080 differs from render_batch of the "
             "hand-built stages")
    wall = statistics.median(walls)
    split = _replay_split(torch, np, wall, last, outs["FWS"],
                          stages[0].background_color)
    _log_split(f"movie_anim1080 ({MOVIE_FRAMES} x {height}x{width}, "
               "render_movie_timeline, median of 3)", split, card)
    log(f"movies: movie_anim1080: parse {parse_ms:.2f} ms, stage build "
        f"{build_ms:.2f} ms; FWS {len(data)} B, walls "
        f"{', '.join(f'{w:.1f}' for w in walls)} ms; CWS and ZWS frames "
        f"equal; {words} words equal sweep_plain; frames equal the "
        f"hand-built stages' [{card}]")
    report["movie_anim1080"] = dict(split, parse_ms=parse_ms,
                                    stage_build_ms=build_ms, walls_ms=walls,
                                    bytes=len(data), words_checked=words)
    return data, outs["FWS"]


def movies_morph(torch, np, report, route, card):
    from swf_renderer_tpu_torch.ops import transform as sweep
    from swf_renderer_tpu_torch.runtime import movie
    from swf_renderer_tpu_torch.runtime.renderer import TorchRenderer
    from swf_renderer_tpu_torch.utils import movie_scenes

    width, height = MOVIE_SIZE
    data, stages = movie_scenes.morph_movie(
        movie_scenes.port_mods(), width, height, frames=MORPH_MOVIE_FRAMES)
    parse_ms, build_ms = _load_timed(torch, data, movie, True)
    calls, restore = _record_sweeps(sweep)
    try:
        frames, wall, got = route(movie.render_movie_timeline, data)
        if got["morph_affine"] != 1 or got["styled"] != 0:
            fail(f"movies: movie_morph1080 launched {got}: one B6 launch "
                 "expected")
        last = _sweep_launches(sweep, calls)
        words = _route_equals_plain(torch, sweep, "movie_morph1080", calls)
        renderer = TorchRenderer(width, height, device=DEVICE)
        hand = renderer.render_batch(stages)
        words += _route_equals_plain(torch, sweep, "movie_morph1080 (hand)",
                                     calls)
    finally:
        restore()
    if renderer.last_stats.path != "transform-sweep":
        fail(f"movies: movie_morph1080 path {renderer.last_stats.path!r}")
    if frames.shape != (MORPH_MOVIE_FRAMES, height, width, 4) \
            or not np.array_equal(hand, frames):
        fail("movies: movie_morph1080 differs from render_batch of the "
             "hand-built stages")
    split = _replay_split(torch, np, wall, last, frames,
                          stages[0].background_color)
    _log_split(f"movie_morph1080 ({MORPH_MOVIE_FRAMES} x {height}x{width}, "
               "3 morphs)", split, card)
    log(f"movies: movie_morph1080: parse {parse_ms:.2f} ms, stage build "
        f"{build_ms:.2f} ms; {words} words equal sweep_plain; frames equal "
        f"the hand-built stages' [{card}]")
    report["movie_morph1080"] = dict(split, parse_ms=parse_ms,
                                     stage_build_ms=build_ms,
                                     words_checked=words)


def movies_still(torch, np, report, route, card):
    """movie_still1080 through ``render_movie``: B2 and B8 launched, each
    launch equal to its plain version, the frame equal to ``render`` of
    the stage built by hand."""
    from swf_renderer_tpu_torch.runtime import movie
    from swf_renderer_tpu_torch.runtime.renderer import TorchRenderer
    from swf_renderer_tpu_torch.utils import movie_scenes

    width, height = MOVIE_SIZE
    data, stage, bitmaps = movie_scenes.still_movie(
        movie_scenes.port_mods(), width, height)
    parse_ms, build_ms = _load_timed(torch, data, movie, False)
    rec = _Recorder()
    try:
        frame, wall, got = route(movie.render_movie, data)
        if got["styled"] < 1 or got["texfield"] < 1:
            fail(f"movies: movie_still1080 launched {got}: B2 and B8 "
                 "expected")
        last = _styled_launches(rec)
        tex_err, n = _recorded_equal_plain(torch, "movies: movie_still1080",
                                            rec)
        rec.clear()
        renderer = TorchRenderer(width, height, device=DEVICE)
        for b in bitmaps:
            renderer.add_bitmap(b)
        hand = renderer.render(stage)
        _recorded_equal_plain(torch, "movies: movie_still1080 (hand)", rec)
    finally:
        rec.restore()
    if renderer.last_stats.path != "flatblock":
        fail(f"movies: movie_still1080 path {renderer.last_stats.path!r}")
    if frame.shape != (height, width, 4) or not np.array_equal(hand, frame):
        fail("movies: movie_still1080 differs from render of the "
             "hand-built stage")
    split = _replay_split(torch, np, wall, last, frame,
                          stage.background_color)
    _log_split("movie_still1080 (text, sprite, scale-9, rotated bitmap)",
               split, card)
    log(f"movies: movie_still1080: parse {parse_ms:.2f} ms, stage build "
        f"{build_ms:.2f} ms; launches {got}; {n} words and field values "
        f"equal their plain versions (texfield max abs {tex_err:.3g}); the "
        f"frame equals the hand-built stage's [{card}]")
    report["movie_still1080"] = dict(split, parse_ms=parse_ms,
                                     stage_build_ms=build_ms, launches=got,
                                     texfield_max_abs=tex_err)
    return data, frame, got, tex_err


def movies_cli(np, report, anim, anim_frames, still, still_frame, card):
    """``python3 -m swf_renderer_tpu_torch`` in a subprocess on the card:
    ``--frames DIR --stats`` on movie_anim1080 and ``-o`` on
    movie_still1080, the PNGs read back equal to the in-process frames."""
    from swf_renderer_tpu_torch.utils.png import read_png

    out = OUT_DIR / "movies"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    (out / "movie_anim1080.swf").write_bytes(anim)
    (out / "movie_still1080.swf").write_bytes(still)
    walls = {}
    for what, args in (
            ("frames", ["movie_anim1080.swf", "--frames", "frames",
                        "--stats"]),
            ("still", ["movie_still1080.swf", "-o", "still.png"])):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "swf_renderer_tpu_torch"] + args,
            cwd=out, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(ROOT)))
        walls[what] = (time.perf_counter() - t0) * 1e3
        if proc.returncode != 0:
            fail(f"movies: the CLI ({' '.join(args)}) exited "
                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        if what == "frames":
            stats = json.loads(proc.stderr.strip().splitlines()[-1])
    pngs = sorted((out / "frames").glob("*.png"))
    if len(pngs) != len(anim_frames):
        fail(f"movies: the CLI wrote {len(pngs)} PNGs")
    for p, f in zip(pngs, anim_frames):
        if not np.array_equal(read_png(p), f):
            fail(f"movies: the CLI's {p.name} differs from the in-process "
                 "frame")
    if not np.array_equal(read_png(out / "still.png"), still_frame):
        fail("movies: the CLI's still.png differs from render_movie's")
    log(f"movies: CLI --frames ({len(pngs)} PNGs) wall "
        f"{walls['frames']:.0f} ms "
        f"(its --stats: render {stats['seconds'] * 1e3:.1f} ms), -o "
        f"still.png wall {walls['still']:.0f} ms; every PNG equals the "
        f"in-process frame [{card}]")
    report["movies_cli"] = {"frames_wall_ms": walls["frames"],
                            "still_wall_ms": walls["still"],
                            "render_seconds": stats["seconds"]}
    shutil.rmtree(out / "frames")


def phase_movies(torch, np, report):
    """Phase 14 -> launches of B2, B3, B6 and B8 on the movie routes, and
    the worst texfield difference."""
    from swf_renderer_tpu_torch.ops import transform as sweep
    from swf_renderer_tpu_torch.ops.flatblock import render_fused_styled
    from swf_renderer_tpu_torch.ops.texfield import bitmap_field_planes

    wrappers = {"styled": render_fused_styled,
                "affine": sweep.render_affine_sweep,
                "morph_affine": sweep.render_morph_affine_sweep,
                "texfield": bitmap_field_planes}

    launches = dict.fromkeys(wrappers, 0)

    def route(entry, src):
        """One call of a movie entry point on the card, the counts set
        to 0 just before and read just after -> (result, wall ms, the
        launches of this call, also added to the phase's)."""
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        out = entry(src, device=DEVICE)
        wall = (time.perf_counter() - t0) * 1e3
        got = {k: w.launches for k, w in wrappers.items()}
        for k, n in got.items():
            launches[k] += n
        return out, wall, got

    card = card_line()
    anim, anim_frames = movies_anim(torch, np, report, route, card)
    movies_morph(torch, np, report, route, card)
    still, still_frame, _got, tex_err = movies_still(torch, np, report,
                                                     route, card)
    log(f"movies: launches on the movie routes {launches}")
    movies_cli(np, report, anim, anim_frames, still, still_frame, card)
    return launches, tex_err


# ---------------------------------------------------------------------------
# Phase 15: the service and the mesh
# ---------------------------------------------------------------------------

SERVICE_SIZE = (1920, 1080)   # width, height: the movies' frame
SERVICE_FRAMES = 60
SERVICE_LAYERS = (0, 1, 2, 6)   # anim_movie's shapes: 3 solids, a gradient
SHARD_SPLITS = (2, 4)           # column shards of the sweeps' frames


def _counted(torch, wrappers, fn, *args, **kwargs):
    """One entry-point call, the wrappers' counts set to 0 just before and
    read just after -> (result, wall ms, {key: launches})."""
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return out, wall, {k: w.launches for k, w in wrappers.items()}


def service_run(torch, np, report, card):
    """``RendererService`` on the card over a 4-layer styled scene built
    in code (anim_movie's shapes, three solids and a linear gradient, by
    asset id, on the service's transparent background): ``render_refs``
    (B2), ``animate_refs`` and ``render_batch`` of 60 moving-matrix frames
    (one B3 launch each), each byte-equal to the same call on a
    ``TorchRenderer`` and each recorded launch to its plain version; walls
    split by replaying the launches -> launches."""
    import swf_renderer_tpu_torch as swf
    from swf_renderer_tpu_torch.models import ast, display
    from swf_renderer_tpu_torch.ops import transform as sweep
    from swf_renderer_tpu_torch.ops.flatblock import (
        render_fused_blocksn, render_fused_styled,
    )
    from swf_renderer_tpu_torch.ops.texfield import bitmap_field_planes
    from swf_renderer_tpu_torch.runtime.service import StoredShapeRef
    from swf_renderer_tpu_torch.utils import movie_scenes

    width, height = SERVICE_SIZE
    _, movie_stages = movie_scenes.anim_movie(
        movie_scenes.port_mods(), width, height, frames=SERVICE_FRAMES)
    bg = ast.StraightSRgba8(0, 0, 0, 0)   # the service's default
    rows = [[st.children[i] for i in SERVICE_LAYERS] for st in movie_stages]
    stages = [display.Stage(
        width=width, height=height, background_color=bg,
        children=tuple(display.ShapeInstance(definition=c.definition,
                                             matrix=c.matrix) for c in row))
        for row in rows]
    svc = swf.RendererService()
    ids = [svc.assets.register_shape(c.definition) for c in rows[0]]
    refs = [[StoredShapeRef(sid, matrix=c.matrix) for sid, c in zip(ids, row)]
            for row in rows]
    handle = svc.create_renderer(width, height)
    direct = swf.TorchRenderer(width, height)
    wrappers = {"styled": render_fused_styled, "solid": render_fused_blocksn,
                "affine": sweep.render_affine_sweep,
                "texfield": bitmap_field_planes}
    launches = dict.fromkeys(wrappers, 0)
    runs = {}   # name -> (wall ms, launches, replayable launches, frames)

    rec = _Recorder()
    try:
        frame, wall, got = _counted(torch, wrappers, svc.render_refs,
                                    handle, refs[0])
        if got != {"styled": 1, "solid": 0, "affine": 0, "texfield": 0}:
            fail(f"service: render_refs launched {got}: one B2 expected")
        runs["render_refs"] = (wall, got, _styled_launches(rec), frame)
        words = {"render_refs": _recorded_equal_plain(
            torch, "service: render_refs", rec)[1]}
        rec.clear()
        want = direct.render(stages[0])
    finally:
        rec.restore()
    if not np.array_equal(frame, want):
        fail("service: render_refs differs from TorchRenderer.render")

    calls, restore = _record_sweeps(sweep)
    try:
        for name, fn, arg in (("animate_refs", svc.animate_refs, refs),
                              ("render_batch", svc.render_batch, stages)):
            frames, wall, got = _counted(torch, wrappers, fn, handle, arg)
            path = svc._get(handle).last_stats.path
            if got != {"styled": 0, "solid": 0, "affine": 1, "texfield": 0} \
                    or path != "transform-sweep":
                fail(f"service: {name} launched {got} on {path!r}: one B3 "
                     "launch on the transform sweep expected")
            runs[name] = (wall, got, _sweep_launches(sweep, calls), frames)
            words[name] = _route_equals_plain(torch, sweep,
                                              f"service {name}", calls)
            want = direct.render_batch(stages)
            calls.clear()
            if frames.shape != (SERVICE_FRAMES, height, width, 4) or \
                    not np.array_equal(frames, want):
                fail(f"service: {name} differs from "
                     "TorchRenderer.render_batch")
    finally:
        restore()
    for name, (wall, got, replay, frames) in runs.items():
        for k, n in got.items():
            launches[k] += n
        split = _replay_split(torch, np, wall, replay, frames, bg)
        n = frames.shape[0] if frames.ndim == 4 else 1
        _log_split(f"{name} ({n} x {height}x{width}, 4 layers; "
                   f"{words[name]} words equal their plain version)", split,
                   card, phase="service")
        report[f"service_{name}"] = dict(split, launches=got)
    log(f"service: launches {launches}; render_refs, animate_refs and "
        "render_batch byte-equal to TorchRenderer's")
    return launches


def mesh_world_one(torch, np, report, card):
    """``parallel.mesh`` on a NCCL group of one rank (a FileStore in a
    temporary directory): ``render_fused_dp`` on the headline (B13),
    ``render_styled_dp`` on the headline's geometry under gradient paints
    (B2), and the three tile-sharded sweeps on the full-width sweep scenes
    (B3, B6, B7 at origin 0), each byte-equal to the single-device call
    -> launches of B13, B2, B3, B6 and B7."""
    import tempfile

    import torch.distributed as dist

    from swf_renderer_tpu_torch.native.bindings import (
        pack_blocks_native, pack_grouped_native,
    )
    from swf_renderer_tpu_torch.ops import flatblock as fb
    from swf_renderer_tpu_torch.ops import style as style_ops
    from swf_renderer_tpu_torch.ops import transform as sweep
    from swf_renderer_tpu_torch.ops.morph import render_morph_sweep
    from swf_renderer_tpu_torch.ops.pipeline import (
        kernel_paints_for, lower_update_lists,
    )
    from swf_renderer_tpu_torch.parallel import mesh as pm
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    frames, layers, height, width = HEADLINE
    if "headline_scene" not in _HELD:
        _HELD["headline_scene"] = build_scene_edges(frames, layers, height,
                                                    width, seed=7)
    tables, colors = _HELD["headline_scene"]
    updates = lower_update_lists(tables, height, width)
    launches = {}
    log("mesh: one card: a NCCL group of one rank, so no collective "
        "crosses GPUs here; the collectives (the winding carry over tp, "
        "the gathers, the tile origins) are held on the CPU over gloo "
        "ranks (tests/test_torch_parallel.py)")
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            mesh = pm.make_mesh()
            wrappers = {"fused1": fb.render_fused_blocks}
            out, wall, got = _counted(torch, wrappers, pm.render_fused_dp,
                                      mesh, updates, colors, height, width)
            launches.update(got)
            _, nc, ns = fb.plane_geometry(height, width)
            blocks = fb.sort_blocks_fused(
                *pack_blocks_native(updates, height, width,
                                    block_pad_multiple=128)[:5],
                layers, ns, block_pad_multiple=128)
            want = fb.render_fused_blocks(*blocks, colors, frames, layers, ns,
                                          nc, device=DEVICE)
            if got["fused1"] != 1 or not torch.equal(
                    out, want[:, :ns].reshape(out.shape)):
                fail(f"mesh: render_fused_dp (launches {got}) differs from "
                     "render_fused_blocks")
            log(f"mesh: render_fused_dp on the headline ({frames} x "
                f"{layers} x {height}x{width}): {wall:.1f} ms, one B13 "
                "launch, byte-equal to render_fused_blocks")
            report["mesh_fused_dp"] = {"wall_ms": wall, "launches": got}

            paints = [style_ops.solid_paint(tuple(c)) for c in colors[0]]
            paints[1] = style_ops.Paint(
                kind=style_ops.PAINT_LINEAR,
                inv_matrix=(2.0 * 16384.0 / width, 0.0, 0.0,
                            2.0 * 16384.0 / width, -16384.0, -8000.0),
                stop_ratios=np.array([0.0, 1.0], np.float32),
                stop_colors=np.array([[1, 0, 0, 1], [0, 0, 1, 1]],
                                     np.float32))
            spp = fb.strips_per_plane(nc, ns)
            packed = pack_grouped_native(updates, height, width, group=6,
                                         spp=spp)
            kpaints, fields, _ = kernel_paints_for(paints, height, width,
                                                   spp=spp, device=DEVICE)
            ns_p, nc_p = packed[6], packed[7]
            wrappers = {"styled": fb.render_fused_styled}
            out, wall, got = _counted(
                torch, wrappers, pm.render_styled_dp, mesh,
                *(x[None] for x in packed[:6]), colors[None], fields, frames,
                layers, ns_p, nc_p, kpaints, group=6, spp=spp)
            launches.update(got)
            ints = [torch.as_tensor(x, dtype=torch.int32, device=DEVICE)
                    for x in packed[:3]]
            want = fb.render_fused_styled(
                *ints, *(_up(torch, np, x) for x in packed[3:6]),
                _up(torch, np, colors), fields, frames, layers, ns_p, nc_p,
                kpaints, group=6, spp=spp)
            if got["styled"] != 1 or out.shape != want.shape or \
                    not torch.equal(out, want):
                fail(f"mesh: render_styled_dp (launches {got}) differs from "
                     "render_fused_styled")
            log(f"mesh: render_styled_dp on the headline's geometry (a "
                f"gradient layer, {len(fields)} field planes): {wall:.1f} "
                "ms, one B2 launch, byte-equal to render_fused_styled")
            report["mesh_styled_dp"] = {"wall_ms": wall, "launches": got}

            for key, (tile_fn, single, args) in _tile_calls(
                    torch, np, sweep, render_morph_sweep, pm).items():
                wrappers = {key: {
                    "affine": sweep.render_affine_sweep,
                    "morph_affine": sweep.render_morph_affine_sweep,
                    "morph": render_morph_sweep}[key]}
                out, _, got = _counted(torch, wrappers, tile_fn, mesh, *args)
                launches.update(got)
                if got[key] != 1 or not torch.equal(out, single()):
                    fail(f"mesh: the tile-sharded {key} sweep (launches "
                         f"{got}) differs from the unsharded sweep")
                log(f"mesh: the tile-sharded {key} sweep at world 1: one "
                    "launch, byte-equal to the unsharded sweep")
        finally:
            dist.destroy_process_group()
    log(f"mesh: launches {launches} [{card}]")
    return launches


def _tile_calls(torch, np, sweep, render_morph_sweep, pm):
    """The three tile-sharded sweeps' (mesh function, single-device call,
    its arguments after the mesh) on the full-width scenes of phase 5."""
    from swf_renderer_tpu_torch.ops.morph import morph_pieces
    from swf_renderer_tpu_torch.utils.scenes import anim_scene

    height, width = SWEEP_SIZE
    tables, colors, mats = anim_scene(height, width, SWEEP_FRAMES)
    parts = sweep.affine_pieces(tables, colors, mats)
    d = [_up(torch, np, x) for x in (mats,) + tuple(parts)]
    pairs = morph_pairs(np)
    m16 = mats[:MORPH_RATIOS]
    ratios = np.linspace(0.0, 1.0, MORPH_RATIOS, dtype=np.float32)
    mparts = sweep.morph_affine_pieces(pairs, m16)
    dm = [_up(torch, np, x) for x in (m16, ratios) + tuple(mparts)]
    rparts = morph_pieces(pairs)
    dr = [_up(torch, np, x) for x in (ratios,) + tuple(rparts)]
    return {
        "affine": (pm.render_affine_sweep_tile_sharded,
                   lambda: sweep.render_affine_sweep(*d, height, width),
                   (mats, parts, height, width)),
        "morph_affine": (pm.render_morph_affine_sweep_tile_sharded,
                         lambda: sweep.render_morph_affine_sweep(
                             *dm, height, width),
                         (m16, ratios, mparts, height, width)),
        "morph": (pm.render_morph_sweep_tile_sharded,
                  lambda: render_morph_sweep(*dr, height, width),
                  (ratios, rparts, height, width)),
    }


def _origin_scenes(torch, np, sweep):
    """The full-width sweep scenes of phase 5 for the column shards ->
    {name: (key, run(width, x_shift, fields_slice), plain(width, x_shift,
    fields_slice), counts_args(width, x_shift))}: run launches the
    wrapper (x_shift None: a whole frame)."""
    from swf_renderer_tpu_torch.ops import style as style_ops
    from swf_renderer_tpu_torch.ops.morph import (
        morph_pieces, render_morph_sweep,
    )
    from swf_renderer_tpu_torch.utils.scenes import anim_scene

    height, width = SWEEP_SIZE
    tables, colors, mats = anim_scene(height, width, SWEEP_FRAMES)
    layers = len(tables)
    rules = (0,) * layers
    tab, colarr = sweep.affine_pieces(tables, colors, mats)
    counts = sweep.layer_piece_counts(tab)
    d_mats, d_tab, d_col = (_up(torch, np, x) for x in (mats, tab, colarr))
    paints = [style_ops.solid_paint(tuple(c)) for c in colors]
    paints[1] = style_ops.Paint(
        kind=style_ops.PAINT_LINEAR,
        inv_matrix=(2.0 * 16384.0 / width, 0.0, 0.0, 2.0 * 16384.0 / width,
                    -16384.0, -16384.0 * height / width),
        stop_ratios=np.array([0.0, 0.5, 1.0], np.float32),
        stop_colors=np.array([[1, 0.2, 0, 1], [0, 1, 0.5, 0.8],
                              [0.2, 0, 1, 1]], np.float32))
    kpaints, grad_mats = sweep.sweep_paints(paints, mats)
    d_gm = _up(torch, np, grad_mats)
    pairs = morph_pairs(np)
    m16 = mats[:MORPH_RATIOS]
    ratios = np.linspace(0.0, 1.0, MORPH_RATIOS, dtype=np.float32)
    tab_s, tab_e, cs, ce = sweep.morph_affine_pieces(pairs, m16)
    mcounts = tuple(min(max(a, b), tab_s.shape[-1]) for a, b in zip(
        sweep.layer_piece_counts(tab_s), sweep.layer_piece_counts(tab_e)))
    dm = [_up(torch, np, x) for x in (m16, ratios, tab_s, tab_e, cs, ce)]
    rs, re_, rcs, rce = morph_pieces(pairs)
    dr = [_up(torch, np, x) for x in (ratios, rs, re_, rcs, rce)]
    full = (rs.shape[-1],) * layers

    def mats_at(m, x0):
        """Matrices moved left by x0: the shard's columns from 0 (its work
        counts)."""
        if not x0:
            return m
        m = m.clone()
        m[..., 4] -= float(x0)
        return m

    def tab_at(t, x0):
        if not x0:
            return t
        t = t.clone()
        t[:, 0::2] -= float(x0)
        return t

    return {
        "anim1080": ("affine",
                     lambda w, x0: sweep.render_affine_sweep(
                         d_mats, d_tab, d_col, height, w,
                         layer_counts=counts, x_shift=x0),
                     lambda w, x0: sweep.sweep_plain(
                         d_mats, d_tab, None, None, d_col, None, height, w,
                         rules, counts, x_shift=x0),
                     lambda w, x0: (mats_at(d_mats, x0 or 0), d_tab, None,
                                    None, counts, height, w, rules, None,
                                    None, (d_col,))),
        "anim1080_gradient": (
            "affine",
            lambda w, x0: sweep.render_affine_sweep(
                d_mats, d_tab, d_col, height, w, layer_counts=counts,
                paints=kpaints, grad_mats=d_gm, x_shift=x0),
            lambda w, x0: sweep.sweep_plain(
                d_mats, d_tab, None, None, d_col, None, height, w, rules,
                counts, paints=kpaints, grad_mats=d_gm, x_shift=x0),
            lambda w, x0: (mats_at(d_mats, x0 or 0), d_tab, None, None,
                           counts, height, w, rules, kpaints, None,
                           (d_col, d_gm))),
        "morph_affine1080": (
            "morph_affine",
            lambda w, x0: sweep.render_morph_affine_sweep(
                *dm, height, w, layer_counts=mcounts, x_shift=x0),
            lambda w, x0: sweep.sweep_plain(
                dm[0], dm[2], dm[3], dm[1], dm[4], dm[5], height, w, rules,
                mcounts, x_shift=x0),
            lambda w, x0: (mats_at(dm[0], x0 or 0), dm[2], dm[3], dm[1],
                           mcounts, height, w, rules, None, None,
                           (dm[4], dm[5]))),
        "morph1080": (
            "morph",
            lambda w, x0: render_morph_sweep(*dr, height, w, x_shift=x0),
            lambda w, x0: sweep.sweep_plain(
                None, dr[1], dr[2], dr[0], dr[3], dr[4], height, w, rules,
                full, x_shift=x0),
            lambda w, x0: (None, tab_at(dr[1], x0 or 0),
                           tab_at(dr[2], x0 or 0), dr[0], full, height, w,
                           rules, None, None, (dr[3], dr[4]))),
    }


def origin_shards(torch, np, report):
    """B3 (solid and styled), B6 and B7 on the full-width sweep scenes
    split into 2 and 4 column shards, each at its origin: each shard's
    launch equal word for word to its plain version with the origin and to
    those columns of the whole frame's launch, timed beside that launch in
    the same call (report.json ``origin_*``)."""
    from swf_renderer_tpu_torch.ops import transform as sweep

    height, width = SWEEP_SIZE
    for name, (_key, run, plain, counts_of) in _origin_scenes(
            torch, np, sweep).items():
        full_ms = time_ms(torch, lambda: run(width, None), reps=5)
        frames = run(width, None)
        for n in SHARD_SPLITS:
            ws = width // n
            ms = plain_ms = 0.0
            nbytes = ops = 0
            shard_ms = []
            for k in range(n):
                x0 = k * ws
                got = run(ws, x0)
                t = time_ms(torch, lambda x0=x0: run(ws, x0), reps=5)
                held = {}

                def plain_once(x0=x0):
                    held["want"] = plain(ws, x0)

                plain_ms += time_ms(torch, plain_once, reps=1, warmup=0)
                _check(torch, f"{name} origin {x0} of {n} shards vs plain",
                       got, held.pop("want"), exact=True)
                if not torch.equal(got, frames[..., x0:x0 + ws]):
                    fail(f"origin: {name} shard {k} of {n} differs from the "
                         "whole frame's columns")
                b, o = sweep_work_counts(torch, *counts_of(ws, x0))
                nbytes += b
                ops += o
                shard_ms.append(t)
                ms += t
            bound_ms, bound_by = bound(nbytes, ops)
            log(f"origin: {name}: {n} shards of {ws} columns "
                f"{' + '.join(f'{t:.3f}' for t in shard_ms)} = {ms:.3f} ms "
                f"beside the whole frame's {full_ms:.3f} ms; plain "
                f"{plain_ms:.1f} ms; bound {bound_ms:.4f} ms ({bound_by}); "
                "every shard equal to its plain version and to the "
                "whole frame's columns")
            report[f"origin_{name}_{n}"] = {
                "shard_ms": shard_ms, "ms": ms, "whole_ms": full_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bytes": nbytes, "ops": ops}


def phase_service_mesh(torch, np, report):
    """Phase 15 -> launches of B2, B3, B6, B7 and B13 on the service and
    mesh routes.  With --parent, every kernel of the sweep library but
    the column sweeps (which now read the shard origin; phase 5 times
    them against the parent's) keeps the parent's SASS."""
    card = card_line()
    service = service_run(torch, np, report, card)
    mesh = mesh_world_one(torch, np, report, card)
    origin_shards(torch, np, report)
    if "parent_libs" in _HELD:
        sweep_ab = report["ab_sass"]["swfsweep"]
        moved = [k for k in sweep_ab["differ"]
                 if not k.startswith("_ZN3swf17sweep_tile_kernel")]
        if moved or sweep_ab["only_change"] or sweep_ab["only_parent"]:
            fail(f"origin: sweep kernels besides the column sweeps moved: "
                 f"{sweep_ab}")
        log(f"origin: the sweep library's {sweep_ab['identical']} other "
            "kernels keep the parent's SASS; the column sweeps' "
            f"{len(sweep_ab['differ'])} differ (they read the origin)")
    return {"styled": service["styled"] + mesh["styled"],
            "affine": service["affine"] + mesh["affine"],
            "morph_affine": mesh["morph_affine"], "morph": mesh["morph"],
            "fused1": mesh["fused1"]}


# ---------------------------------------------------------------------------
# Phase 16: the sound movie through the CLI, and the coverage oracle
# ---------------------------------------------------------------------------

SOUND_SIZE = (1920, 1080)   # width, height: the movies' frame
SOUND_FRAMES = 60           # movie_sound1080: 2.5 s at 24 fps
SOUND_LONG_FRAMES = 240     # soundtrack10s: a 10 s track, mixed, no render
ORACLE_TOL = 1e-4           # coverage kernel vs coverage_numpy, max abs
ORACLE_CASES = ((64, 64, 64), (128, 192, 256), (256, 256, 512))  # H, W, E
ORACLE_DIRECT_PLANES = 2    # direct1080's planes held (printed, not gated)
# ``python -m swf_renderer_tpu_torch ARGS`` with the launch counts of the
# kernel wrappers set to 0 before the CLI runs and written to the file
# named first when it ends (the counts live in the CLI's own process).
CLI_PROBE = r"""
import json, runpy, sys
from swf_renderer_tpu_torch.ops import flatblock, morph, texfield, transform
counters = {"styled": flatblock.render_fused_styled,
            "affine": transform.render_affine_sweep,
            "morph_affine": transform.render_morph_affine_sweep,
            "morph": morph.render_morph_sweep,
            "texfield": texfield.bitmap_field_planes}
for c in counters.values():
    c.launches = 0
out = sys.argv[1]
sys.argv = ["swf_renderer_tpu_torch"] + sys.argv[2:]
try:
    runpy.run_module("swf_renderer_tpu_torch", run_name="__main__",
                     alter_sys=True)
finally:
    with open(out, "w") as f:
        json.dump({k: c.launches for k, c in counters.items()}, f)
"""


def _sound_cli(out, args):
    """``python -m swf_renderer_tpu_torch ARGS`` in ``out`` through
    CLI_PROBE -> (wall ms, the CLI's launches by kernel)."""
    counts = out / "launches.json"
    counts.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CLI_PROBE, str(counts)] + args, cwd=out,
        capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    wall = (time.perf_counter() - t0) * 1e3
    if proc.returncode != 0:
        fail(f"sound: the CLI ({' '.join(args)}) exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    return wall, json.loads(counts.read_text())


def sound_run(torch, np, report, card):
    """movie_sound1080 (``sound_movie``: the morph movie's timeline at 24
    fps with an MP3 stream, an ADPCM and an MP3 event sound) through
    ``python -m swf_renderer_tpu_torch movie.swf --wav out.wav --frames
    DIR``: one B6 launch in the CLI's process, every PNG equal to an
    in-process ``render_movie_timeline`` (its launch equal to
    ``sweep_plain`` word for word), out.wav equal to an in-process
    ``wav_bytes(mix_movie_audio(...))``; then soundtrack10s (240 frames)
    through ``--wav`` alone: no launch, no PNG, the WAV equal.  MP3
    decode, mix, WAV write and CLI walls timed -> B6's launches in the
    CLI."""
    from swf_renderer_tpu_torch.models.mp3 import decode_mp3
    from swf_renderer_tpu_torch.models.swf_binary import parse_movie
    from swf_renderer_tpu_torch.ops import transform as sweep
    from swf_renderer_tpu_torch.runtime import movie
    from swf_renderer_tpu_torch.runtime.audio import mix_movie_audio
    from swf_renderer_tpu_torch.utils import movie_scenes
    from swf_renderer_tpu_torch.utils.png import read_png
    from swf_renderer_tpu_torch.utils.wav import wav_bytes, write_wav

    width, height = SOUND_SIZE
    out = OUT_DIR / "sound"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    b6 = 0
    for what, frames in (("movie_sound1080", SOUND_FRAMES),
                         ("soundtrack10s", SOUND_LONG_FRAMES)):
        render = what == "movie_sound1080"
        t0 = time.perf_counter()
        data, _stages = movie_scenes.sound_movie(
            movie_scenes.port_mods(), width, height, frames=frames)
        build_ms = (time.perf_counter() - t0) * 1e3
        (out / f"{what}.swf").write_bytes(data)
        t0 = time.perf_counter()
        parsed = parse_movie(data)
        parse_ms = (time.perf_counter() - t0) * 1e3
        mpeg = b"".join(blk[4:] for _f, blk in
                        sorted(parsed.sound_stream.blocks.items()))
        t0 = time.perf_counter()
        pcm, rate = decode_mp3(mpeg)
        decode_ms = (time.perf_counter() - t0) * 1e3
        seconds = pcm.shape[0] / rate
        t0 = time.perf_counter()
        track = mix_movie_audio(parsed)
        mix_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        write_wav(out / f"{what}.in_process.wav", track)
        wav_ms = (time.perf_counter() - t0) * 1e3
        want_wav = wav_bytes(track)
        if not (np.isfinite(track).all() and track.ndim == 2
                and track.shape[1] == 2 and np.abs(track).max() > 0.05
                and track.shape[0] >= int(frames * 44100
                                          / movie_scenes.SOUND_FPS)):
            fail(f"sound: {what}'s track {track.shape} is not a stereo "
                 "soundtrack of the timeline's length")
        args = [f"{what}.swf", "--wav", f"{what}.wav"]
        if render:
            args += ["--frames", "frames"]
        cli_ms, got = _sound_cli(out, args)
        if (out / f"{what}.wav").read_bytes() != want_wav:
            fail(f"sound: the CLI's {what}.wav differs from wav_bytes("
                 "mix_movie_audio(...)) in process")
        rec = {"build_ms": build_ms, "parse_ms": parse_ms,
               "mp3_decode_ms": decode_ms, "mp3_seconds": seconds,
               "mp3_ms_per_s": decode_ms / seconds, "mix_ms": mix_ms,
               "wav_write_ms": wav_ms, "wav_bytes": len(want_wav),
               "cli_ms": cli_ms, "cli_launches": got}
        if render:
            if got["morph_affine"] < 1 or sum(got.values()) != got[
                    "morph_affine"]:
                fail(f"sound: the CLI's render launched {got}: B6 only "
                     "expected")
            b6 += got["morph_affine"]
            calls, restore = _record_sweeps(sweep)
            try:
                t0 = time.perf_counter()
                want = movie.render_movie_timeline(data, device=DEVICE)
                rec["in_process_render_ms"] = (time.perf_counter() - t0) * 1e3
                rec["words_checked"] = _route_equals_plain(
                    torch, sweep, f"sound: {what} (in process)", calls)
            finally:
                restore()
            pngs = sorted((out / "frames").glob("*.png"))
            if len(pngs) != frames or want.shape != (frames, height, width,
                                                     4):
                fail(f"sound: {len(pngs)} PNGs, frames {want.shape}")
            for p, f in zip(pngs, want):
                if not np.array_equal(read_png(p), f):
                    fail(f"sound: the CLI's {p.name} differs from the "
                         "in-process frame")
            shutil.rmtree(out / "frames")
        elif sum(got.values()) or (out / "frames").exists():
            fail(f"sound: the audio-only CLI rendered: {got}")
        log(f"sound: {what} ({frames} frames, {seconds:.2f} s of MPEG-1 "
            f"Layer III stream at {rate} Hz): MP3 decode {decode_ms:.1f} ms "
            f"({decode_ms / seconds:.1f} ms a second of audio), mix "
            f"{mix_ms:.1f} ms, WAV write {wav_ms:.2f} ms ({len(want_wav)} B), "
            f"parse {parse_ms:.1f} ms; CLI {' '.join(args)}: wall "
            f"{cli_ms:.0f} ms, launches {got}; the WAV equals the "
            f"in-process one" + ("; every PNG equals the in-process frame"
                                 if render else "; nothing rendered")
            + f" [{card}]")
        report[what] = rec
    return b6


def oracle_check(torch, np, report, card):
    """B9, B10 and B11 on the card against ``coverage_numpy`` (the
    reference's f64 oracle, one edge at a time) on closed random paths
    (64x64 to 256x256, up to 512 edges, both rules): max abs within
    ORACLE_TOL; then direct1080's first ORACLE_DIRECT_PLANES planes
    through B9 against the oracle, printed only."""
    import concurrent.futures

    from swf_renderer_tpu_torch.ops import coverage as cov
    from swf_renderer_tpu_torch.utils.scenes import (
        build_scene_edges, closed_edge_planes,
    )

    kernels = {"banded": cov.coverage_banded, "tiled": cov.coverage_tiled,
               "grouped": cov.coverage_grouped}
    worst = dict.fromkeys(kernels, 0.0)
    rng = np.random.default_rng(61)
    for height, width, n in ORACLE_CASES:
        e_pad = -(-n // 128) * 128
        t = closed_edge_planes(rng, 2, n, e_pad, height, width)
        d = _up(torch, np, t)
        for rule in (0, 1):
            want = np.stack([cov.coverage_numpy(p.T[(p != 0).any(0)],
                                                height, width, rule)
                             for p in t])
            for name, fn in kernels.items():
                got = fn(d, height, width, rule).cpu().numpy()
                err = float(np.abs(got - want).max())
                if not err <= ORACLE_TOL:
                    fail(f"oracle: {name} {height}x{width} E={n} rule="
                         f"{rule}: max abs {err} against coverage_numpy")
                worst[name] = max(worst[name], err)
    tables, _colors = build_scene_edges(1, 4, *DIRECT[2:], seed=7)
    planes = tables[0][:ORACLE_DIRECT_PLANES]
    got = cov.coverage_banded(_up(torch, np, cov.split_pad_tables(planes)),
                              *DIRECT[2:], 0).cpu().numpy()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(planes)) as pool:
        want = list(pool.map(lambda e: cov.coverage_numpy(e, *DIRECT[2:]),
                             planes))
    oracle_s = time.perf_counter() - t0
    direct = float(max(np.abs(g - w).max() for g, w in zip(got, want)))
    log(f"oracle: against coverage_numpy, max abs banded (B9) "
        f"{worst['banded']:.3g}, tiled (B10) {worst['tiled']:.3g}, grouped "
        f"(B11) {worst['grouped']:.3g} (limit {ORACLE_TOL:g}; "
        f"{len(ORACLE_CASES)} sizes x 2 planes x 2 rules); direct1080's "
        f"{len(planes)} planes through B9: max abs {direct:.3g} (not gated; "
        f"the oracle took {oracle_s:.1f} s on the host) [{card}]")
    report["oracle"] = dict(worst, tol=ORACLE_TOL, direct1080=direct,
                            direct1080_planes=len(planes))


def phase_sound(torch, np, report):
    """Phase 16 -> B6's launches by the sound movie's CLI render."""
    card = card_line()
    b6 = sound_run(torch, np, report, card)
    oracle_check(torch, np, report, card)
    return {"morph_affine": b6}


def main() -> None:
    import numpy as np
    import torch

    global PARENT_ROOT
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="a checkout of the parent commit: its kernels are "
                         "built too and timed beside these (A/B)")
    PARENT_ROOT = ap.parse_args().parent
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t_start = time.perf_counter()
    report = {}
    phase_build()
    ab_sass(report)
    worst = phase_kernels(torch, np)
    kernels = {"fusedn": phase_headline(torch, np, report),
               "styled": phase_renderer(torch, np, report)}
    for key, k in kernels.items():
        k["max_abs_err"] = max(k["max_abs_err"], worst[key])
    kernels.update(phase_sweeps(torch, np, report))
    bitmaps = phase_bitmaps(torch, np, report)
    # B3's user routes: phase 5's render_batch, phase 6's render_batch,
    # render_shape_animation and interactive loop.
    kernels["affine"]["launches"] += bitmaps.pop("affine_launches")
    kernels.update(bitmaps)
    kernels.update(phase_layered(torch, np, report))
    kernels.update(phase_flat_blocks(torch, np, report))
    kernels.update(phase_deep_masked(torch, np, report))
    kernels.update(phase_tilings(torch, np, report))
    kernels.update(phase_probes(torch, np, report))
    kernels.update(phase_products(torch, np, report))
    kernels.update(phase_windows(torch, np, report))
    movies, tex_err = phase_movies(torch, np, report)
    for key, n in movies.items():
        kernels[key]["launches"] += n
    kernels["texfield"]["max_abs_err"] = max(
        kernels["texfield"]["max_abs_err"], tex_err)
    for key, n in phase_service_mesh(torch, np, report).items():
        kernels[key]["launches"] += n
    for key, n in phase_sound(torch, np, report).items():
        kernels[key]["launches"] += n

    flatblock_cu = "swf_renderer_tpu_torch/csrc/flatblock.cu"
    sweep_cu = "swf_renderer_tpu_torch/csrc/sweep.cu"
    planes_cu = "swf_renderer_tpu_torch/csrc/planes.cu"
    coverage_cu = "swf_renderer_tpu_torch/csrc/coverage.cu"
    meta = {   # kernel -> (source, TPU kernel it replaces)
        "fusedn": (flatblock_cu, "swf_renderer_tpu/ops/flatblock.py:784"),
        "styled": (flatblock_cu, "swf_renderer_tpu/ops/flatblock.py:1083"),
        "affine": (sweep_cu, "swf_renderer_tpu/ops/transform.py:586"),
        "morph_affine": (sweep_cu, "swf_renderer_tpu/ops/transform.py:1875"),
        "morph": (sweep_cu, "swf_renderer_tpu/ops/morph.py:98"),
        "texfield": ("swf_renderer_tpu_torch/csrc/texfield.cu",
                     "swf_renderer_tpu/ops/texfield.py:186"),
        "banded": (coverage_cu, "swf_renderer_tpu/ops/coverage.py:559"),
        "tiled": (coverage_cu, "swf_renderer_tpu/ops/coverage.py:169"),
        "resolve": ("swf_renderer_tpu_torch/csrc/resolve.cu",
                    "swf_renderer_tpu/ops/resolve.py:53"),
        "place": (planes_cu, "swf_renderer_tpu/ops/flatblock.py:486"),
        "resolve_u32": (planes_cu, "swf_renderer_tpu/ops/flatblock.py:556"),
        "resolve_u32_dma": (planes_cu,
                            "swf_renderer_tpu/ops/flatblock.py:1364"),
        "fused1": (flatblock_cu, "swf_renderer_tpu/ops/flatblock.py:618"),
        "styled_chain": (flatblock_cu,
                         "swf_renderer_tpu/ops/flatblock.py:1083"),
        "affine_rows": (sweep_cu, "swf_renderer_tpu/ops/transform.py:1012"),
        "morph_affine_rows": (sweep_cu,
                              "swf_renderer_tpu/ops/transform.py:1012"),
        "affine_compact": (sweep_cu, "swf_renderer_tpu/ops/transform.py:586"),
        "grouped": (coverage_cu, "swf_renderer_tpu/ops/coverage.py:404"),
    }
    for key in kernels:
        if key.startswith("probe_"):
            meta[key] = ("swf_renderer_tpu_torch/csrc/probes.cu"
                         if key.startswith(("probe_bw_", "probe_step_"))
                         else flatblock_cu, probe_meta(key[6:])[1])
        elif key.startswith(("product_", "window_")):
            meta[key] = (flatblock_cu, kernels[key]["replaces"])
    line = {"kernels": [
        dict(name=k["name"], route="cuda", source=meta[key][0],
             replaces=meta[key][1], launches=k["launches"],
             max_abs_err=k["max_abs_err"], ms=k["ms"],
             plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
             bound_by=k["bound_by"], library_ms=k.get("library_ms"),
             **{x: k[x] for x in PROBE_RUN_KEYS if x in k})
        for key, k in kernels.items()]}
    card = card_line()
    if "ab" in _HELD:
        report["ab"] = _HELD["ab"]
    report.update(kernels=line["kernels"], card=card,
                  seconds=time.perf_counter() - t_start)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "report.json").write_text(json.dumps(report, indent=1))
    log(json.dumps(line))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
