"""The sweep kernels as redesigned for the H100 — the column sweeps (B3:
affine, solid and styled; B6: morph + affine; B7: morph ratio) and the
row bands (B4: solid, styled, morph + affine) — run on the CPU under the
g++ emulation of ``tests/test_torch_kernel_emulated.py`` against their
unchanged plain version ``sweep_plain``.

``csrc/sweep_device.cuh`` ``tile_sweep_block``: row bounds of 16-piece
chunks (the morph forms' pre-pass also staging every device-space
piece), differences added as two 32-bit atomics with the low word's
carry-out, a piece wholly left of a tile adding its dy to its row's
carry (a tile no piece crosses and whose carries are all 0 writes
zeros), a warp scanning each row, the solid composite in registers at up
to 4 layers and the styled / 16-layer resolve layer by layer.  Held here
at 1, 3 and 16 layers, both rules, ragged tiles on both axes, on a
table built for the edge cases (pieces wider than 128 columns, pieces
wholly left of a tile, vertical pieces whose span is under 1e-9, pieces
ending an ulp past a row, off-frame pieces), styled linear, focal and
field layers, B4 carrying each row across three 256-column chunks and
its morph + affine form; B6 and B7 at ratios 0, 0.37 and 1, also on a
morph of the edge-case table (pieces degenerate at one ratio endpoint
only, pieces wholly left of a tile at one ratio and crossing it at
another).  Five mutants of the new body must each fail on the case
named for it, and one case each holds B3, B6 and B7 against the JAX
package's kernels in Pallas interpret mode.  Column blocks that walk
several column tiles in turn (large grids) are forced on six cases.
The column sweeps at a tile shard's origin (``a.x_shift``, the
wrappers' ``x_shift``) run B3 styled, B6 and B7 on a shard at an origin
on no 128-column tile: equal to ``sweep_plain`` with the origin and to
those columns of the unshifted frame.

Tolerance: byte-equal to ``sweep_plain`` (``torch.equal``: it performs
the kernels' arithmetic, the same 32.32 integers summed, and g++
contracts no FMA); against the JAX kernels the envelope of
``tests/test_torch_sweep.py`` (at most 1 premultiplied level).
"""

import concurrent.futures
import ctypes
import shutil
import types

import numpy as np
import pytest
import torch

from swf_renderer_tpu.ops import morph as jmorph
from swf_renderer_tpu.ops import transform as jsweep
from swf_renderer_tpu_torch import convert
from swf_renderer_tpu_torch.ops import cuda_lib
from swf_renderer_tpu_torch.ops import flatblock as fb
from swf_renderer_tpu_torch.ops import morph as tmorph
from swf_renderer_tpu_torch.ops import transform as sweep
from swf_renderer_tpu_torch.utils.scenes import random_blobs, random_tracks
from tests.test_torch_kernel_emulated import (  # noqa: F401 (fixture)
    _build_emulator, _run_sweep, _styled_sweep_case, one_torch_thread,
)
from tests.test_torch_sweep import (
    RATIOS, _affine_scene, _pairs, _rotation_mats, assert_close, j, t,
)

SUMS = "b3_16_layers_styled"   # the case of the sums-order mutant

# Mutants of the new body, built together into one scratch copy behind a
# run-time switch (swf_mutant): (flag, anchor, replacement, the case it
# must fail).  1: add_fixed drops the low word's carry-out; 2: the lane's
# scan exclusive (a pixel's winding without its own column); 3: the
# styled resolve's sums taken top down; 4: the morph colour lerp with t
# and 1 - t swapped; 5: the piece lerp's x0 with t and 1 - t swapped.
MUTANTS = {
    "carry_out_dropped": (
        1, "    hi += old + lo < old ? 1u : 0u;\n",
        "    hi += swf_mutant == 1 ? 0u : (old + lo < old ? 1u : 0u);\n",
        "b3_3_layers_evenodd"),
    "exclusive_scan": (
        2, "          acc += d[k];\n          q[k] = acc;\n",
        "          if (swf_mutant == 2) {\n            q[k] = acc;\n"
        "            acc += d[k];\n          } else {\n"
        "            acc += d[k];\n            q[k] = acc;\n          }\n",
        "b4_edge_pieces_evenodd"),
    "sums_top_down": (
        3, "  float pm[4][3];\n  for (int l = 0; l < L; ++l) {\n",
        "  float pm[4][3];\n  for (int i_ = 0; i_ < L; ++i_) {\n"
        "    const int l = swf_mutant == 3 ? L - 1 - i_ : i_;\n",
        SUMS),
    "colour_lerp_swapped": (
        4, "      v = omt * a.colors[tid] + t * a.colors_e[tid];\n",
        "      v = swf_mutant == 4 ? t * a.colors[tid] + omt * a.colors_e[tid]"
        "\n                          : omt * a.colors[tid] + t * "
        "a.colors_e[tid];\n",
        "b7_3_layers_nonzero"),
    "piece_lerp_swapped": (
        5, "    x0 = omt * x0 + t * te[p];\n",
        "    x0 = swf_mutant == 5 ? t * x0 + omt * te[p]\n"
        "                         : omt * x0 + t * te[p];\n",
        "b6_3_layers_evenodd"),
}
# The column sweeps at an origin: emulate_sweep's arguments and x_shift
# (the emulator's run_tiles_lc over the column tiling).
SHIFT_EXTRA = """
extern "C" int emulate_sweep_shift(
    int mode, const float* mats, const float* tab_s, const float* tab_e,
    const float* ratios, const float* colors, const float* colors_e,
    const int* counts, const int* rules, const int* pint, const float* pflt,
    const float* grad_mats, const float* stop_colors, const float* fields,
    float* bounds, int* out, int frames, int layers, int ep, int height,
    int width, int mats_per_layer, int colors_per_frame, int n_stop_slots,
    int x_shift) {
  swf::SweepArgs a{};
  a.mats = mats; a.tab_s = tab_s; a.tab_e = tab_e; a.ratios = ratios;
  a.colors = colors; a.colors_e = colors_e; a.counts = counts;
  a.rules = rules; a.pint = pint; a.pflt = pflt; a.grad_mats = grad_mats;
  a.stop_colors = stop_colors; a.fields = fields; a.out = out;
  a.bounds = bounds;
  a.frames = frames; a.layers = layers; a.ep = ep; a.height = height;
  a.width = width; a.mats_per_layer = mats_per_layer;
  a.colors_per_frame = colors_per_frame; a.n_stop_slots = n_stop_slots;
  a.x_shift = x_shift;
  if (mode == 0 && pint) return run_tiles_lc<false, true, true, swf::kLane>(a);
  if (mode == 0) return run_tiles_lc<false, true, false, swf::kLane>(a);
  if (mode == 1) return run_tiles_lc<true, true, false, swf::kLane>(a);
  return run_tiles_lc<true, false, false, swf::kLane>(a);
}
"""
# The sums' first term follows the loop, not the layer, in the mutant.
_FIRST = ("      if (l == 0) {\n        alpha_out[k] = wgt;\n",
          "      if ((swf_mutant == 3 ? i_ : l) == 0) {\n"
          "        alpha_out[k] = wgt;\n")


@pytest.fixture(scope="module")
def emulators(tmp_path_factory):
    """(the committed csrc's emulator, the mutants' emulator), built
    together."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    d_base = tmp_path_factory.mktemp("cuda_emu_sweep")
    d_mut = tmp_path_factory.mktemp("cuda_emu_sweep_mutants")
    csrc = d_mut / "csrc"
    shutil.copytree(cuda_lib.CSRC_DIR, csrc)
    header = csrc / "sweep_device.cuh"
    text = header.read_text()
    for name, (_, before, after, _) in MUTANTS.items():
        assert text.count(before) == 1, name
        text = text.replace(before, after)
    assert text.count(_FIRST[0]) == 1
    text = text.replace(*_FIRST)
    header.write_text(text.replace(
        "#pragma once\n", "#pragma once\nextern int swf_mutant;\n", 1))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        base = pool.submit(_build_emulator, d_base, cuda_lib.CSRC_DIR,
                           SHIFT_EXTRA)
        mut = pool.submit(_build_emulator, d_mut, csrc, """
int swf_mutant = 0;
extern "C" void set_mutant(int m) { swf_mutant = m; }
""")
        base, mut = base.result(), mut.result()
    mut.set_mutant.restype = None
    mut.set_mutant.argtypes = [ctypes.c_int]
    base.emulate_sweep_shift.restype = ctypes.c_int
    base.emulate_sweep_shift.argtypes = [ctypes.c_int] + [
        ctypes.c_void_p] * 15 + [ctypes.c_int] * 9
    return base, mut


def tile_rows(layers, tile_w):
    """csrc tile_rows: the most rows (a power of two <= 32) whose planes
    of tile_w long longs fit 100 KB."""
    rows = 32
    while rows > 1 and layers * rows * tile_w * 8 > 100 * 1024:
        rows //= 2
    return rows


def edge_pieces(height, width):
    """(2, 4, 1, EP) device-space pieces and their counts: pieces wider
    than 128 columns both ways (|dy| < 1), short pieces wholly left of
    every tile but the first, vertical pieces (span 0), pieces ending an
    ulp past a row or starting an ulp under one, pieces off every side
    of the frame; layer 1 the same moved and reversed; zeros past the
    counts."""
    f32 = np.float32
    up = f32(np.inf)
    pieces = []
    for i, py in enumerate((3.2, 7.0, 20.5, 33.7)):
        pieces.append((-40.0 + 7 * i, py, width + 20.0 - 9 * i, py + 0.6))
        pieces.append((width + 25.0, py + 0.3, -33.0, py - 0.35))
    for r in range(0, height, 2):
        x = 5.0 + (7 * r) % 60
        pieces.append((x, r + 0.1, x + 0.5, r + 1.05))
        pieces.append((x + 40.0, r + 0.95, x + 39.25, r + 0.02))
    for r in range(0, height - 1, 3):
        pieces.append((130.0, r, 130.0, r + 1.0))
        pieces.append((255.5, r + 1.5, 255.5, r + 0.5))
    for py in (4, 9, 17, 31):
        if py >= height:
            continue
        pieces.append((40.5, py - 0.8, 41.2, np.nextafter(f32(py), up)))
        pieces.append((300.3, np.nextafter(f32(py), -up), 299.0, py - 0.99))
        pieces.append((170.0, np.nextafter(f32(py), up), 171.5, py + 0.7))
    pieces += [(50.0, -5.0, 51.0, -4.2), (50.0, height + 2.0, 51.0,
                                          height + 2.9),
               (-80.0, 10.0, -79.0, 11.0), (width + 50.0, 10.0,
                                            width + 51.0, 11.0)]
    a = np.asarray(pieces, f32)
    b = a[:, [2, 3, 0, 1]] + np.asarray((97.3, 1.4, 97.3, 1.4), f32)
    n = len(a)
    ep = -(-n // 64) * 64 + 64
    tab = np.zeros((2, 4, 1, ep), f32)
    tab[0, :, 0, :n] = a.T
    tab[1, :, 0, :n] = b.T
    return tab, (n, n)


def morph_edge_pieces(rng, height, width):
    """(tab_s, tab_e, counts): edge_pieces' table as the start pieces,
    each piece moved by up to 150 columns and 2 rows (its dy kept) at the
    end, so a piece wholly left of a tile at one ratio crosses it at
    another; every 7th piece degenerate (a point) at the start only, every
    7th from the 4th at the end only."""
    tab_s, counts = edge_pieces(height, width)
    n = counts[0]
    shift = np.zeros_like(tab_s)
    shift[:, 0::2, 0, :n] = rng.uniform(-150, 150, (2, 1, n))
    shift[:, 1::2, 0, :n] = rng.uniform(-2, 2, (2, 1, n))
    tab_e = tab_s + shift
    tab_s[:, 2:, 0, 0:n:7] = tab_s[:, :2, 0, 0:n:7]
    tab_e[:, 2:, 0, 3:n:7] = tab_e[:, :2, 0, 3:n:7]
    return tab_s, tab_e, counts


def left_then_crossing(tab_s, tab_e, counts, tile_w=128):
    """Pieces of layer 0 wholly left of the second column tile at one
    ratio endpoint and crossing its columns at the other."""
    n = counts[0]
    xs = [np.sort(tb[0, 0::2, 0, :n], axis=0) for tb in (tab_s, tab_e)]

    def left(x):
        return x[1] < tile_w

    def crossing(x):
        return (x[1] >= tile_w) & (x[0] < 2 * tile_w)

    return int(np.sum((left(xs[0]) & crossing(xs[1]))
                      | (left(xs[1]) & crossing(xs[0]))))


def _blobs(rng, layers, height, width, frames, per_layer, blobs):
    tables = random_blobs(rng, layers, height, width, blobs=blobs)
    mats = random_tracks(rng, frames, layers, height, width)
    if not per_layer:
        mats = mats[:, 0]
    tab, _ = sweep.affine_pieces(tables, [(0,) * 4] * layers, mats)
    return tab, mats


def case(name):
    """-> (sweep_plain's positional arguments, its keywords, row bands)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    frames = 2
    rows = name.startswith("b4")
    if name.startswith(("b6", "b7")):
        return morph_case(name, rng), {}, False
    if "edge_pieces" in name:
        height, width = 40, 700 if rows else 300
        tab, counts = edge_pieces(height, width)
        mats = np.asarray([(1, 0, 0, 1, 0, 0),
                           (1, 0, 0, 1, 0.37, -0.21)], np.float32)
        colors = np.asarray([(0.9, 0.3, 0.1, 0.7), (0.2, 0.5, 0.9, 0.6)],
                            np.float32)
        rule = 1 if name.endswith("evenodd") else 0
        return ((torch.as_tensor(mats), torch.as_tensor(tab), None, None,
                 torch.as_tensor(colors), None, height, width, (rule, rule),
                 counts), {}, rows)
    layers = int(name.split("_")[1]) if name.split("_")[1].isdigit() else 3
    height, width = {1: (70, 300), 3: (90, 200), 4: (37, 200),
                     16: (40, 150)}[layers]
    if rows:
        height, width = (50, 700) if layers != 16 else (24, 600)
    if "morph" in name:
        tables = random_blobs(rng, layers, height, width, blobs=8)
        mats = random_tracks(rng, frames + 1, layers, height, width)
        pairs = [(t_, t_ + rng.uniform(-9, 9, t_.shape).astype(np.float32),
                  rng.uniform(0.1, 1, 4), rng.uniform(0.1, 1, 4))
                 for t_ in tables]
        tab_s, tab_e, cs, ce = sweep.morph_affine_pieces(pairs, mats)
        counts = tuple(min(max(a, b), tab_s.shape[-1]) for a, b in zip(
            sweep.layer_piece_counts(tab_s), sweep.layer_piece_counts(tab_e)))
        return ((torch.as_tensor(mats), torch.as_tensor(tab_s),
                 torch.as_tensor(tab_e),
                 torch.as_tensor(np.array([0.0, 0.37, 1.0], np.float32)),
                 torch.as_tensor(cs), torch.as_tensor(ce), height, width,
                 tuple(int(x) for x in rng.integers(0, 2, layers)), counts),
                {}, rows)
    tab, mats = _blobs(rng, layers, height, width, frames,
                       per_layer=layers != 1,
                       blobs=8 if rows or name == SUMS else 3)
    rules = {"nonzero": (0,) * layers, "evenodd": (1,) * layers}.get(
        name.split("_")[-1], tuple(int(x) for x in rng.integers(0, 2,
                                                                layers)))
    colors = rng.uniform(0.1, 1, (frames, layers, 4)).astype(np.float32)
    kw = {}
    if "styled" in name and layers <= 4:
        kw = _styled_sweep_case(rng, frames, 4, height, width)
        kw = dict(kw, paints=kw["paints"][:layers], grad_mats=kw[
            "grad_mats"][:, :layers], stop_colors=kw["stop_colors"][
            :, :layers], fields=None if rows else kw["fields"])
        if rows:   # the row bands take no field paints
            kw["paints"] = tuple(fb.KernelPaint.color() if p.kind ==
                                 fb.KPAINT_FIELD else p
                                 for p in kw["paints"])
    elif "styled" in name:
        # 16 translucent layers: colours, a linear, a focal and a field;
        # 8 blobs a layer (most pixels under several layers) and colour
        # channels from -3000 to 3000, so the premultiplied sums cancel
        # and their order shows in the words.
        base = _styled_sweep_case(rng, frames, 4, height, width)
        paints = [fb.KernelPaint.color()] * layers
        paints[5], paints[9], paints[13] = base["paints"][1:4]
        gm = np.zeros((frames, layers, 6), np.float32)
        gm[:, 5] = base["grad_mats"][:, 1].numpy()
        gm[:, 9] = base["grad_mats"][:, 2].numpy()
        colors[..., :3] = rng.uniform(-3000.0, 3000.0, (frames, layers, 3))
        colors[..., 3] = rng.uniform(0.15, 0.6, (frames, layers))
        kw = dict(paints=tuple(paints), grad_mats=torch.as_tensor(gm),
                  fields=base["fields"])
    counts = sweep.layer_piece_counts(tab)
    return ((torch.as_tensor(mats), torch.as_tensor(tab), None, None,
             torch.as_tensor(colors), None, height, width, rules, counts),
            kw, rows)


def morph_case(name, rng):
    """The column morph sweeps: B6 (morph + affine, per-layer matrices
    above one layer) and B7 (morph ratio), 3 ratios with 0 and 1 exact,
    on random blobs morphing into moved copies or on morph_edge_pieces.
    -> sweep_plain's positional arguments."""
    ratios = torch.as_tensor(np.array([0.0, 0.37, 1.0], np.float32))
    affine = name.startswith("b6")
    if "edge_pieces" in name:
        height, width = 40, 300
        tab_s, tab_e, counts = morph_edge_pieces(rng, height, width)
        layers = 2
        mats = np.asarray([(1, 0, 0, 1, 0, 0), (1, 0, 0, 1, 0.37, -0.21),
                           (1, 0, 0, 1, -0.5, 0.3)], np.float32)
        cs, ce = (rng.uniform(0.1, 1, (layers, 4)).astype(np.float32)
                  for _ in range(2))
    else:
        layers = int(name.split("_")[1])
        height, width = {1: (70, 300), 3: (90, 200), 16: (40, 150)}[layers]
        tables = random_blobs(rng, layers, height, width, blobs=8)
        pairs = [(t_, t_ + rng.uniform(-9, 9, t_.shape).astype(np.float32),
                  rng.uniform(0.1, 1, 4), rng.uniform(0.1, 1, 4))
                 for t_ in tables]
        if affine:
            mats = random_tracks(rng, 3, layers, height, width)
            if layers == 1:
                mats = mats[:, 0]
            tab_s, tab_e, cs, ce = sweep.morph_affine_pieces(pairs, mats)
            counts = tuple(min(max(a, b), tab_s.shape[-1]) for a, b in zip(
                sweep.layer_piece_counts(tab_s),
                sweep.layer_piece_counts(tab_e)))
        else:
            tab_s, tab_e, cs, ce = tmorph.morph_pieces(pairs)
            counts = (tab_s.shape[-1],) * layers   # as render_morph_sweep
    rules = {"nonzero": (0,) * layers, "evenodd": (1,) * layers}.get(
        name.split("_")[-1], tuple(int(x) for x in rng.integers(0, 2,
                                                                layers)))
    return (torch.as_tensor(mats) if affine else None,
            torch.as_tensor(tab_s), torch.as_tensor(tab_e), ratios,
            torch.as_tensor(cs), torch.as_tensor(ce), height, width, rules,
            counts)


CASES = ["b3_1_layer_nonzero", "b3_3_layers_evenodd", "b3_16_layers_mixed",
         "b3_edge_pieces_nonzero", "b3_edge_pieces_evenodd",
         "b3_4_layers_styled", "b3_16_layers_styled", "b4_3_layers_mixed",
         "b4_16_layers_mixed", "b4_edge_pieces_evenodd", "b4_3_layers_styled",
         "b4_3_layers_morph_affine", "b6_1_layer_nonzero",
         "b6_3_layers_evenodd", "b6_16_layers_mixed", "b7_3_layers_nonzero",
         "b7_3_layers_evenodd", "b6_morph_edge_pieces_evenodd",
         "b7_morph_edge_pieces_nonzero"]


@pytest.mark.parametrize("name", CASES)
def test_redesigned_sweep_equals_plain_version(emulators, name):
    """Every case byte-equal to sweep_plain, in the tile shape the
    launcher picks; the scene really drawn."""
    args, kw, rows = case(name)
    want = sweep.sweep_plain(*args, **kw)
    got, n_rows = _run_sweep(emulators[0], *args, rows=rows, **kw)
    layers = args[1].shape[0]
    assert n_rows == tile_rows(layers, 256 if rows else 128)
    assert torch.equal(got, want)
    assert float((want != 0).float().mean()) > 0.01


@pytest.mark.parametrize("name,run", [
    ("b3_3_layers_evenodd", 2), ("b3_edge_pieces_nonzero", 2),
    ("b3_edge_pieces_evenodd", 3), ("b3_4_layers_styled", 3),
    ("b6_3_layers_evenodd", 2), ("b7_morph_edge_pieces_nonzero", 2)])
def test_redesigned_sweep_tile_runs_equal_plain_version(emulators, name,
                                                        run):
    """Column blocks (B3, B6, B7) walking 2 or 3 column tiles of their
    band in turn (the launcher's choice for large grids, forced here; a
    ragged last run): byte-equal to sweep_plain."""
    args, kw, rows = case(name)
    emu = emulators[0]
    try:
        emu.set_tile_run(run)
        got, _ = _run_sweep(emu, *args, rows=rows, **kw)
    finally:
        emu.set_tile_run(0)
    assert torch.equal(got, sweep.sweep_plain(*args, **kw))


@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_redesigned_sweep_mutants_are_caught(emulators, mutant):
    """Each mutant of the new body breaks the case named for it; the
    mutants' build with the switch off equals the plain version there."""
    flag, _, _, name = MUTANTS[mutant]
    args, kw, rows = case(name)
    want = sweep.sweep_plain(*args, **kw)
    mut = emulators[1]
    try:
        mut.set_mutant(0)
        got, _ = _run_sweep(mut, *args, rows=rows, **kw)
        assert torch.equal(got, want)
        mut.set_mutant(flag)
        got, _ = _run_sweep(mut, *args, rows=rows, **kw)
        assert not torch.equal(got, want), mutant
    finally:
        mut.set_mutant(0)


def test_redesigned_sweep_matches_jax_kernel(emulators):
    """B3 under the emulation against the JAX package's ``_xform_kernel``
    (``render_affine_sweep``, Pallas interpret mode) on the rotation scene
    of tests/test_torch_sweep.py, at that file's envelope."""
    height, width, tables, mats, colors, kw = _affine_scene("evenodd")
    tab, subxy, _ = jsweep.affine_pieces(tables, [(0,) * 4] * len(tables),
                                         mats)
    counts = jsweep.layer_piece_counts(tab, multiple=128)
    want = jmorph.morph_frames_to_u8(jsweep.render_affine_sweep(
        j(mats), j(tab), j(subxy), j(colors), height, width,
        layer_counts=counts, **kw), height, width)
    got, _ = _run_sweep(
        emulators[0], t(mats),
        convert.sweep_table_to_device(tab, subxy, device="cpu"), None, None,
        t(colors), None, height, width, (kw["fill_rule"],) * len(tables),
        counts)
    assert_close(want, tmorph.morph_frames_to_u8(got, height, width), 0)


def test_morph_edge_pieces_hold_their_cases():
    """The morph edge-case table has pieces degenerate at one ratio
    endpoint only (each way) and pieces wholly left of a tile at one
    ratio that cross it at another."""
    tab_s, tab_e, counts = morph_edge_pieces(np.random.default_rng(3), 40,
                                             300)
    n = counts[0]

    def point(tab):
        return ((tab[0, 0, 0, :n] == tab[0, 2, 0, :n])
                & (tab[0, 1, 0, :n] == tab[0, 3, 0, :n]))

    assert (point(tab_s) & ~point(tab_e)).any()
    assert (point(tab_e) & ~point(tab_s)).any()
    assert left_then_crossing(tab_s, tab_e, counts) > 0


@pytest.mark.parametrize("form", ["morph_affine", "morph"])
def test_redesigned_morph_sweeps_match_jax_kernels(emulators, form):
    """B6 and B7 under the emulation against the JAX package's
    ``render_morph_affine_sweep`` / ``render_morph_sweep`` (Pallas
    interpret mode) on the pairs of tests/test_torch_sweep.py, at that
    file's envelope."""
    if form == "morph_affine":
        height, width = 80, 100
        pairs = _pairs()
        mats = _rotation_mats(4, 50.0, 40.0, 1.1)
        ts, ss, te, se, cs, ce = jsweep.morph_affine_pieces(pairs, mats)
        counts = tuple(max(a, b) for a, b in zip(
            jsweep.layer_piece_counts(ts), jsweep.layer_piece_counts(te)))
        rules = (0, 1)
        want = jsweep.render_morph_affine_sweep(
            j(mats), j(RATIOS), j(ts), j(ss), j(te), j(se), j(cs), j(ce),
            height, width, fill_rule=rules, layer_counts=counts)
    else:
        height, width = 72, 110
        pairs = _pairs(seed=8, layers=3)
        ts, te, ss, se, cs, ce = jmorph.morph_pieces(pairs)
        mats = None
        rules = (1, 0, 1)
        counts = (ts.shape[-1],) * len(pairs)
        want = jmorph.render_morph_sweep(
            j(RATIOS), j(ts), j(te), j(ss), j(se), j(cs), j(ce), height,
            width, fill_rule=rules)
    got, _ = _run_sweep(
        emulators[0], t(mats),
        convert.sweep_table_to_device(ts, ss, device="cpu"),
        convert.sweep_table_to_device(te, se, device="cpu"), t(RATIOS),
        t(cs), t(ce), height, width, rules, counts)
    assert_close(jmorph.morph_frames_to_u8(want, height, width),
                 tmorph.morph_frames_to_u8(got, height, width), 0)


@pytest.mark.parametrize("name", ["b3_4_layers_styled",
                                  "b6_3_layers_evenodd",
                                  "b7_morph_edge_pieces_nonzero"])
def test_origin_forms_equal_plain_version(emulators, name):
    """The column sweeps on the shard of columns [45, width - 30) (its
    origin on no tile): byte-equal to sweep_plain with the origin, and to
    those columns of the unshifted frame (field planes read at the
    shard's columns)."""
    args, kw, _ = case(name)
    width = args[7]
    x0, ws = 45, width - 75
    full = sweep.sweep_plain(*args, **kw)
    shard_args = args[:7] + (ws,) + args[8:]
    if kw.get("fields") is not None:
        kw = dict(kw, fields=kw["fields"][..., x0:x0 + ws, :].contiguous())
    want = sweep.sweep_plain(*shard_args, **kw, x_shift=x0)
    assert torch.equal(want, full[..., x0:x0 + ws])
    emu = emulators[0]
    shifted = types.SimpleNamespace(
        emulate_sweep=lambda *a: emu.emulate_sweep_shift(*a, x0))
    got, _ = _run_sweep(shifted, *shard_args, **kw)
    assert torch.equal(got, want)
    assert float((want != 0).float().mean()) > 0.01
