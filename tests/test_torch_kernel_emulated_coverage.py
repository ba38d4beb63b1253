"""The direct coverage kernels as redesigned for the H100 — banded (B9),
tiled (B10) and grouped (B11) — run on the CPU under the g++ emulation
of ``tests/test_torch_kernel_emulated.py`` against their unchanged
plain versions ``banded_plain`` / ``tiled_plain`` / ``grouped_plain``.

``csrc/coverage_device.cuh`` ``banded_block`` / ``tiled_block`` /
``grouped_block``: the y-only terms of every (edge, row) of a tile
staged in shared memory, B9's rows walking only the window edges whose
computed dy is nonzero (rounds of ``kBandChunk`` edges), B10's rows
only the trips of four edges that hold one and B11's only the 8-edge
groups that hold one (their merge trees kept; B11's two 8-row strips a
block each tested against the bounds), and a pixel right of an edge
adding dy alone.  Held here on ``_random_edges`` and
``closed_edge_planes`` tables and on a table built for the edge cases
(endpoints an ulp past a row, vertical, horizontal, |dy| under 1e-9,
long unsplit and off-frame edges), both rules, ragged tiles and strips
on both axes, B9 windows of one to 32 rounds (2048 edges), rows crossed
by more than 128 edges, B11 blocks whose bounds reach one of a tile's
two strips only; B9 blocks with one column tile and walking two.  Six
mutants of the new bodies must fail, and one case for each of B9 and
B10 holds it against the JAX package's own kernel in Pallas interpret
mode.

Tolerance: byte-equal to the plain versions (``torch.equal``: they
perform the kernels' arithmetic and g++ contracts no FMA); against the
JAX kernels 1e-5, the envelope of ``tests/test_torch_coverage.py``
(XLA on the CPU contracts multiply-adds).
"""

import concurrent.futures
import ctypes
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swf_renderer_tpu.ops import coverage as jc
from swf_renderer_tpu_torch.ops import coverage as cov
from swf_renderer_tpu_torch.ops import cuda_lib
from swf_renderer_tpu_torch.utils.scenes import closed_edge_planes
from tests.test_torch_kernel_emulated import (  # noqa: F401 (fixture)
    _build_emulator, _random_edges, one_torch_thread,
)

JAX_TOL = 1e-5

# Mutants of the new bodies, built together into one scratch copy behind
# a run-time switch (swf_mutant): (flag, anchor, replacement, the case
# it must fail).  1 and 4: the crossing test on the raw y-range
# (ymin below the row's end and ymin + |dy| past its start: the extent
# rounds), in B9 and in B10; 2: the right-of-edge path taken at
# rel_mx < 1; 3: B10's trip merged left to right; 5: the right-of-edge
# path of B10's and B11's per-pixel half taken at rel_mx < 1; 6: B11's
# group merged left to right.
_RAW = ("(fminf(y0, y1) < py + 1.0f && "
        "fminf(y0, y1) + fabsf(y1 - y0) > py)")
MUTANTS = {
    "b9_raw_y_range": (
        1, "  const unsigned below = (1u << lane) - 1u;\n",
        "  const unsigned below = (1u << lane) - 1u;\n"
        "  auto raw = [](float y0, float y1, float py) {\n"
        f"    return {_RAW};\n  }};\n", "b9_edges_evenodd"),
    "b9_raw_y_range_rows": (
        1, "    const unsigned m0 = __ballot_sync(0xffffffffu, valid && "
           "t0.x != 0.0f);\n    const unsigned m1 = __ballot_sync("
           "0xffffffffu, valid && t1.x != 0.0f);\n",
        "    const float py0 = band_y0 + static_cast<float>(warp);\n"
        "    const float py1 = band_y0 + static_cast<float>(warp + 8);\n"
        "    const unsigned m0 = __ballot_sync(0xffffffffu, valid && "
        "(swf_mutant == 1 ? raw(y0, y1, py0) : t0.x != 0.0f));\n"
        "    const unsigned m1 = __ballot_sync(0xffffffffu, valid && "
        "(swf_mutant == 1 ? raw(y0, y1, py1) : t1.x != 0.0f));\n",
        "b9_edges_evenodd"),
    "right_of_edge_below_1": (
        2, "  if (rel_mx <= 0.0f) return t.x;   // right of the edge: dy * 1\n"
           "  const float rel_mn = t.y - px;\n  const float span",
        "  if (swf_mutant == 2 ? rel_mx < 1.0f : rel_mx <= 0.0f) return t.x;\n"
        "  const float rel_mn = t.y - px;\n  const float span", "b9_closed"),
    "b10_trip_left_to_right": (
        3, "          part[c] = part[c] + ((tiled_pixel(t0, px) + "
           "tiled_pixel(t1, px)) +\n                               "
           "(tiled_pixel(t2, px) + tiled_pixel(t3, px)));\n",
        "          part[c] = part[c] + (swf_mutant == 3\n"
        "              ? ((tiled_pixel(t0, px) + tiled_pixel(t1, px)) +\n"
        "                 tiled_pixel(t2, px)) + tiled_pixel(t3, px)\n"
        "              : ((tiled_pixel(t0, px) + tiled_pixel(t1, px)) +\n"
        "                 (tiled_pixel(t2, px) + tiled_pixel(t3, px))));\n",
        "b10_random"),
    "b10_raw_y_range": (
        4, "        const bool cross = t.x != 0.0f;\n",
        "        const float py = tile_y0 + static_cast<float>(row);\n"
        "        const bool cross = swf_mutant == 4\n"
        f"            ? {_RAW}\n            : t.x != 0.0f;\n",
        "b10_edges_evenodd"),
    "b11_right_of_edge_below_1": (
        5, "  if (rel_mx <= 0.0f) return t.x;   // right of the edge: dy * 1\n"
           "  const float rel_mn = t.y - px;\n  const float mean",
        "  if (swf_mutant == 5 ? rel_mx < 1.0f : rel_mx <= 0.0f) return t.x;\n"
        "  const float rel_mn = t.y - px;\n  const float mean", "b11_closed"),
    "b11_group_left_to_right": (
        6, "        const float pv = (l0 ? tiled_pixel(t0, px[c]) : 0.0f) +\n"
           "                         (l1 ? tiled_pixel(t1, px[c]) : 0.0f);\n"
           "        half[c] = pr == 0 ? pv : half[c] + pv;\n",
        "        const float a0 = l0 ? tiled_pixel(t0, px[c]) : 0.0f;\n"
        "        const float a1 = l1 ? tiled_pixel(t1, px[c]) : 0.0f;\n"
        "        half[c] = pr == 0 ? a0 + a1\n"
        "            : (swf_mutant == 6 ? (half[c] + a0) + a1\n"
        "                               : half[c] + (a0 + a1));\n",
        "b11_random"),
}
FLAGS = {1: "b9_raw_y_range", 2: "right_of_edge_below_1",
         3: "b10_trip_left_to_right", 4: "b10_raw_y_range",
         5: "b11_right_of_edge_below_1", 6: "b11_group_left_to_right"}


@pytest.fixture(scope="module")
def emulators(tmp_path_factory):
    """(the committed csrc's emulator, the mutants' emulator), built
    together."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    d_base = tmp_path_factory.mktemp("cuda_emu_coverage")
    d_mut = tmp_path_factory.mktemp("cuda_emu_coverage_mutants")
    csrc = d_mut / "csrc"
    shutil.copytree(cuda_lib.CSRC_DIR, csrc)
    header = csrc / "coverage_device.cuh"
    text = header.read_text()
    for name, (_, before, after, _) in MUTANTS.items():
        assert text.count(before) == 1, name
        text = text.replace(before, after)
    header.write_text(text.replace(
        "#pragma once\n", "#pragma once\nextern int swf_mutant;\n", 1))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        base = pool.submit(_build_emulator, d_base, cuda_lib.CSRC_DIR)
        mut = pool.submit(_build_emulator, d_mut, csrc, """
int swf_mutant = 0;
extern "C" void set_mutant(int m) { swf_mutant = m; }
""")
        base, mut = base.result(), mut.result()
    mut.set_mutant.restype = None
    mut.set_mutant.argtypes = [ctypes.c_int]
    return base, mut


def edge_case_table(height, width, e_pad):
    """(1, 4, e_pad): long edges from y -30 or -1000 ending one or two
    ulps past a row start (their extent ymax - ymin rounds to the row),
    edges starting an ulp under a row end, vertical, horizontal (on a
    row and between rows), |dy| under 1e-9, long unsplit, off-frame on
    every side, endpoints on integers; the rest padding."""
    f32 = np.float32
    e = []
    for i, py in enumerate((3, 5, 9, 17)):
        if py >= height:
            continue
        past = np.nextafter(f32(py), f32(np.inf))
        if i % 2:
            past = np.nextafter(past, f32(np.inf))
        x = f32(10 + 25 * i)
        e.append((x, -30.0 if i < 2 else -1000.0, x + 3.5, past))
        e.append((x + 1.5, np.nextafter(f32(py + 1), f32(-np.inf)),
                  x + 9.25, py + 2.5))
    e += [
        (20.0, 20.0, 20.0, 30.0),                   # vertical: span 0
        (33.25, 19.5, 33.25, height + 40.0),        # vertical, long
        (5.0, 6.0, 60.0, 6.0),                      # horizontal on a row
        (5.0, 7.5, 60.0, 7.5),                      # horizontal between
        (40.0, 1e-3, 70.0, 1e-3 + 2e-10),           # |dy| under 1e-9
        (width * 0.3, -25.0, width * 0.7, height + 25.0),   # long
        (-40.0, 24.0, -10.0, 31.0),                 # left of the frame
        (width + 5.0, 3.0, width + 30.0, 12.0),     # right of it
        (15.0, -20.0, 25.0, -4.0),                  # above it
        (15.0, height + 3.0, 25.0, height + 19.0),  # below it
        (7.0, 4.0, 8.0, 12.0),                      # integer endpoints
        (100.0, 12.0, 96.0, 2.0),                   # upward
    ]
    t = np.zeros((1, 4, e_pad), np.float32)
    t[0, :, :len(e)] = np.asarray(e, np.float32).T
    return t


def strip_bands_table(rng, height, width):
    """(1, 4, 384): three blocks of 128 edges in narrow bands of rows —
    rows 3-7.5 (the first strip of the first 16-row tile only), 17-22
    (the first strip of the second tile only) and 38.5-41.5 (both strips
    of the third) — so B11 blocks meet bounds that reach one of their two
    strips."""
    t = np.zeros((1, 4, 384), np.float32)
    for j, (lo, hi) in enumerate(((3.0, 7.5), (17.0, 22.0), (38.5, 41.5))):
        sl = slice(128 * j, 128 * (j + 1))
        t[0, 0, sl] = rng.uniform(-5, width + 5, 128)
        t[0, 2, sl] = rng.uniform(-5, width + 5, 128)
        t[0, 1, sl] = rng.uniform(lo, hi, 128)
        t[0, 3, sl] = rng.uniform(lo, hi, 128)
    return t


def tables(name):
    """name -> (edges (planes, 4, E), height, width, rule): ragged tiles
    on both axes throughout."""
    if name.startswith("b9_"):
        rest = name[3:]
    else:
        rest = name[4:]
    if rest == "random":          # windows of 2-3 rounds (long edges)
        return _random_edges(np.random.default_rng(3), 2, 150, 256, 37,
                             150), 37, 150, 0
    if rest == "closed":
        return closed_edge_planes(np.random.default_rng(5), 2, 200, 256,
                                  37, 150), 37, 150, 1
    if rest == "closed768":
        return closed_edge_planes(np.random.default_rng(7), 1, 700, 768,
                                  40, 130), 40, 130, 0
    if rest == "edges":
        return edge_case_table(37, 150, 128), 37, 150, 0
    if rest == "edges_evenodd":
        return edge_case_table(37, 150, 128), 37, 150, 1
    if rest == "dense2048":       # 32 rounds; rows crossed by ~1000 edges
        return _random_edges(np.random.default_rng(11), 1, 2048, 2048, 21,
                             140), 21, 140, 1
    if rest == "dense2000":       # 16 blocks; rows crossed by ~1000 edges
        return _random_edges(np.random.default_rng(13), 1, 2000, 2048, 21,
                             140), 21, 140, 1
    if rest == "closed44":        # a tile whose second strip is ragged
        return closed_edge_planes(np.random.default_rng(19), 2, 300, 384,
                                  44, 150), 44, 150, 0
    if rest == "strip_bands":
        return strip_bands_table(np.random.default_rng(23), 44, 150), 44, \
            150, 1
    raise KeyError(name)


def run_case(emu, name):
    """(emulated coverage, plain version's) of case ``name``."""
    tiled = name.startswith("b10_")
    t, height, width, rule = tables(name)
    planes, _, e_pad = t.shape
    tt = torch.as_tensor(t)
    es, key, pad = cov.sort_edges(tt)
    if name.startswith("b11_"):
        bounds = cov.block_bounds(es, key, pad)
        want = cov.grouped_plain(es, bounds, height, width, rule)
        es_np = np.ascontiguousarray(es.numpy())
        tab = np.ascontiguousarray(bounds.numpy())
        out = np.full((planes, height, width), np.nan, np.float32)
        emu.emulate_grouped(es_np.ctypes.data, tab.ctypes.data,
                            out.ctypes.data, planes, e_pad, height, width,
                            rule)
        return torch.as_tensor(out), want
    if tiled:
        table = cov.block_bounds(es, key, pad)
        want = cov.tiled_plain(es, table, height, width, rule)
    else:
        table = cov.band_ranges(tt, key, height)
        want = cov.banded_plain(es, table, height, width, rule)
    es_np = np.ascontiguousarray(es.numpy())
    tab = np.ascontiguousarray(table.numpy())
    out = np.full((planes, height, width), np.nan, np.float32)
    emu.emulate_coverage(
        int(tiled), es_np.ctypes.data, None if tiled else tab.ctypes.data,
        tab.ctypes.data if tiled else None, out.ctypes.data, planes, e_pad,
        height, width, rule)
    return torch.as_tensor(out), want


CASES = ["b9_random", "b9_closed", "b9_closed768", "b9_edges",
         "b9_edges_evenodd", "b9_dense2048", "b10_random", "b10_closed",
         "b10_edges", "b10_edges_evenodd", "b10_dense2000", "b11_random",
         "b11_closed", "b11_closed44", "b11_closed768", "b11_edges",
         "b11_edges_evenodd", "b11_dense2000", "b11_strip_bands"]


@pytest.mark.parametrize("name", CASES)
def test_emulated_redesign_equals_plain_version(emulators, name):
    """B9 also with one block walking both column tiles of its band (a
    one-round window staged once for both, a longer one restaged)."""
    emu = emulators[0]
    for grid_x in ((0, 1) if name.startswith("b9_") else (0,)):
        emu.set_band_grid_x(grid_x)
        try:
            got, want = run_case(emu, name)
        finally:
            emu.set_band_grid_x(0)
        assert torch.equal(got, want), grid_x
    assert float(want.std()) > 0.05   # not a flat plane


def test_case_tables_reach_the_rounds_and_rows_they_name():
    """The 2048-edge tables: B9 windows of 32 rounds, rows crossed by
    more than 128 edges; the random table's windows span several
    rounds; the edge-case table's ulp-past edges are ones the raw
    y-range misses."""
    t, height, width, _ = tables("b9_dense2048")
    tt = torch.as_tensor(t)
    es, key, _ = cov.sort_edges(tt)
    ranges = cov.band_ranges(tt, key, height)
    assert int((ranges[..., 1] - ranges[..., 0]).max()) == 2048
    py = torch.arange(height, dtype=torch.float32)[:, None]
    dy, _, _ = cov.edge_row_span(es[0, 0], es[0, 1], es[0, 2], es[0, 3], py)
    assert int((dy != 0).sum(dim=1).min()) > 128
    t, height, _, _ = tables("b9_random")
    tt = torch.as_tensor(t)
    ranges = cov.band_ranges(tt, cov.sort_edges(tt)[1], height)
    assert int((ranges[..., 1] - ranges[..., 0]).max()) > 2 * 64
    e = torch.as_tensor(edge_case_table(37, 150, 128)[0])
    ymin = torch.minimum(e[1], e[3])
    missed = 0
    for py in range(37):
        dy, _, _ = cov.edge_row_span(e[0], e[1], e[2], e[3],
                                     torch.tensor(float(py)))
        raw = (ymin < py + 1.0) & (ymin + torch.abs(e[3] - e[1]) > py)
        missed += int(((dy != 0) & ~raw).sum())
    assert missed >= 2


def test_grouped_tables_reach_what_they_name():
    """B11's cases: the strip-band table's blocks reach one strip of the
    first two 16-row tiles and both of the third; the edge-case table's
    pairs include spans under 1e-9 and dy-zero pairs in hit blocks; the
    closed tables hold pixels right of an edge."""
    t, height, _, _ = tables("b11_strip_bands")
    tt = torch.as_tensor(t)
    es, key, pad = cov.sort_edges(tt)
    b = cov.block_bounds(es, key, pad)[0]
    s0 = torch.arange(-(-height // 8), dtype=torch.float32) * 8
    hit = (b[:, 1, None] > s0) & (b[:, 0, None] < s0 + 8)    # (3, strips)
    assert hit.tolist()[0][:2] == [True, False]
    assert hit.tolist()[1][2:4] == [True, False]
    assert hit.tolist()[2][4:6] == [True, True]
    e = torch.as_tensor(edge_case_table(37, 150, 128)[0])[:, None, :]
    py = torch.arange(37, dtype=torch.float32)[:, None]
    dy, xmn, xmx, span, _ = cov.grouped_row_terms(e, py)
    cross = dy != 0
    assert bool((cross & (span < 1e-9)).any()) and bool((~cross).any())
    t, height, width, _ = tables("b11_closed")
    tt = torch.as_tensor(t)
    es = cov.sort_edges(tt)[0]
    dy, _, xmx, _, _ = cov.grouped_row_terms(
        es[0][:, :, None], torch.arange(height, dtype=torch.float32))
    assert bool(((dy != 0) & (xmx < width - 1)).any())


@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_emulated_coverage_mutants_are_caught(emulators, flag):
    """Each mutant differs from the plain version on its case; with the
    switch off the same build is equal."""
    emu = emulators[1]
    name = MUTANTS[FLAGS[flag]][3]
    emu.set_mutant(0)
    assert torch.equal(*run_case(emu, name))
    emu.set_mutant(flag)
    try:
        assert not torch.equal(*run_case(emu, name))
    finally:
        emu.set_mutant(0)


@pytest.mark.parametrize("tiled", [False, True])
def test_emulated_redesign_matches_reference_kernel(emulators, tiled):
    """2 planes of closed paths at 37x150 (even-odd): the emulated kernel
    against ``coverage_banded`` / ``coverage_pallas`` (scalar-loop body)
    in interpret mode."""
    height, width, rule = 37, 150, 1
    t = closed_edge_planes(np.random.default_rng(17), 2, 200, 256, height,
                           width)
    tt = torch.as_tensor(t)
    es, key, pad = cov.sort_edges(tt)
    table = (cov.block_bounds(es, key, pad) if tiled
             else cov.band_ranges(tt, key, height))
    es_np = np.ascontiguousarray(es.numpy())
    tab = np.ascontiguousarray(table.numpy())
    got = np.full((2, height, width), np.nan, np.float32)
    emulators[0].emulate_coverage(
        int(tiled), es_np.ctypes.data, None if tiled else tab.ctypes.data,
        tab.ctypes.data if tiled else None, got.ctypes.data, 2, 256, height,
        width, rule)
    if tiled:
        want = jc.coverage_pallas(jnp.asarray(t), height, width, rule,
                                  interpret=True, scalar_loop=True)
    else:
        want = jc.coverage_banded(jnp.asarray(t), height, width, rule,
                                  interpret=True)
    assert np.abs(np.asarray(want) - got).max() <= JAX_TOL
    assert float(got.std()) > 0.05
