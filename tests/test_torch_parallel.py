"""The port's multi-device renderer (``swf_renderer_tpu_torch.parallel.
mesh`` over ``torch.distributed``) on gloo ranks on the CPU, and the
sweeps' tile-shard origin (``x_shift=``).

A module fixture starts two groups of rank processes once
(``tests/torch_parallel_ranks.py``, over a ``FileStore`` in a temporary
directory): four ranks as dp 2 x tp 2 and two as dp 2.  Each rank runs
the steps of ``entry.dryrun_multichip`` at its world, then every case of
``CASES`` at a small size — the scenes of
``tests/test_parallel.py`` — and rank 0 writes the results.  Each result
is held byte-equal to the port's single-device route on the CPU (the
deep passes to the same pass fold on one device, and within one
premultiplied level to the serial chain, as the reference pins); a
subset also byte-equal to the JAX package's sharded functions on its
8-device virtual CPU mesh (``tests/conftest.py``).  The ranks load
neither JAX nor the JAX package.

The origin: ``sweep_plain(x_shift=)`` against the JAX kernels' origin in
Pallas interpret mode (the sweep envelope of tests/test_torch_sweep.py,
at most 1 premultiplied level), a shard's columns equal to those of the
unshifted frame at any origin, and the other tilings' refusals.
"""

import functools
import inspect
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from swf_renderer_tpu.ops import morph as jmorph
from swf_renderer_tpu.ops import transform as jsweep
from swf_renderer_tpu.ops.flatblock import frames_u32_to_u8
from swf_renderer_tpu.parallel import mesh as jmesh
from swf_renderer_tpu_torch.ops import morph as tmorph
from swf_renderer_tpu_torch.ops import transform as tsweep
from swf_renderer_tpu_torch.parallel import mesh as tmesh
from tests.torch_parallel_ranks import (
    CASES, build_deep, morph_pairs, rotations, styled_sweep_scene,
)
from tests.test_torch_renderer import levels

RANKS = pathlib.Path(__file__).resolve().parent / "torch_parallel_ranks.py"
MESHES = {"dp2xtp2": (4, 2), "dp2": (2, 1)}


def _as_array(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _u8(words):
    words = np.ascontiguousarray(_as_array(words))
    return words.view(np.uint8).reshape(*words.shape, 4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The single-device routes run on one intra-op thread here, as the
    ranks do: the tensors are small, and the test run's workers and the
    ranks share the machine's cores.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    """{mesh name: {case: rank 0's result}}: both groups run at once."""
    runs = {}
    for name, (world, tp) in MESHES.items():
        d = tmp_path_factory.mktemp(f"ranks_{name}")
        procs = [subprocess.Popen(
            [sys.executable, str(RANKS), str(r), str(world), str(tp),
             str(d / "store"), str(d / "out.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
        runs[name] = (d / "out.npz", procs)
    out = {}
    for name, (path, procs) in runs.items():
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-4000:]
        with np.load(path) as data:
            out[name] = dict(data)
    return out


@functools.lru_cache(maxsize=None)
def _single(case):
    build, _, single = CASES[case]
    return _as_array(single(build()))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_equals_single_device_route(rank_results, mesh, case):
    """Every mesh function on gloo ranks: byte-equal to the port's
    single-device route on the same inputs; the scene really drawn."""
    got = rank_results[mesh][case]
    want = _single(case)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (want != 0).mean() > 0.01


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ranks_load_neither_jax_nor_the_jax_package(rank_results, mesh):
    assert rank_results[mesh]["foreign_modules"].size == 0


def test_deep_passes_within_one_level_of_the_serial_chain():
    """The pass fold of render_deep_passes_sharded (24 layers, two passes
    of 12) against the single-device chained multipass: at most one
    premultiplied level, as the reference pins its own."""
    from swf_renderer_tpu_torch.ops import style as style_ops
    from swf_renderer_tpu_torch.ops.pipeline import render_batch_styled

    tables, colors, h, w = build_deep()
    want = render_batch_styled(
        tables, [style_ops.solid_paint((1, 1, 1, 1))] * len(tables[0]), h,
        w, colors=colors, device="cpu")
    got = _single("deep_passes_sharded")
    _, pmax, _ = levels(want, got)
    assert pmax <= 1


# ---------------------------------------------------------------------------
# Against the JAX package's sharded functions (8-device virtual CPU mesh)
# ---------------------------------------------------------------------------


def test_solid_batch_and_scanline_match_jax_sharded(rank_results):
    got = rank_results["dp2xtp2"]
    mesh = jmesh.make_mesh(n_devices=4, tp=2)
    edges_t, colors, h, w = CASES["batch_dp_tp"][0]()
    np.testing.assert_array_equal(
        got["batch_dp_tp"],
        np.asarray(jmesh.render_batch_dp_tp(mesh, edges_t, colors, h, w)))
    cells, colors, h, w = CASES["scanline_dp_tp"][0]()
    sr, sc, sd = jmesh.partition_cells_by_column(cells, w, tp=2)
    np.testing.assert_array_equal(
        got["scanline_dp_tp"],
        np.asarray(jmesh.render_scanline_dp_tp(mesh, sr, sc, sd, colors, h,
                                               w)))


def test_fused_dp_matches_jax_sharded(rank_results):
    updates, colors, h, w = CASES["fused_dp"][0]()
    want = np.asarray(jmesh.render_fused_dp(
        jmesh.make_mesh(n_devices=2, tp=1), updates, colors, h, w))
    for name in MESHES:
        got = rank_results[name]["fused_dp"].view(np.uint32)
        np.testing.assert_array_equal(frames_u32_to_u8(got, h, w),
                                      frames_u32_to_u8(want, h, w))


def test_tile_sharded_morph_affine_sweep_matches_jax_sharded(rank_results):
    """The tile-sharded sweep's plain version across ranks against the JAX
    kernel's x_shift on 4 devices (Pallas interpret mode)."""
    mats, ratios, _, h, w = CASES["morph_affine_sweep_tile_sharded"][0]()
    parts = jsweep.morph_affine_pieces(morph_pairs(h, w), mats)
    want = jmorph.morph_frames_to_u8(np.asarray(
        jmesh.render_morph_affine_sweep_tile_sharded(
            jmesh.make_mesh(n_devices=4, tp=2), mats, ratios, parts, h, w)),
        h, w)
    np.testing.assert_array_equal(
        _u8(rank_results["dp2xtp2"]["morph_affine_sweep_tile_sharded"]),
        want)


def test_every_reference_mesh_function_has_a_counterpart():
    """The reference's functions by name; its TPU block layout
    (_tile_shard_layout) and plane converter (now
    ops.flatblock.premul_planes_to_frames) are not carried."""
    def functions(mod):
        return {n for n, f in inspect.getmembers(mod, inspect.isfunction)
                if f.__module__ == mod.__name__}

    missing = functions(jmesh) - functions(tmesh)
    assert missing == {"_tile_shard_layout", "_premul_planes_to_frames"}


# ---------------------------------------------------------------------------
# The origin (x_shift=) of the column sweeps
# ---------------------------------------------------------------------------


def test_origin_plain_version_matches_jax_kernel():
    """sweep_plain through render_affine_sweep / render_morph_sweep with
    x_shift=64 on a 128-column shard of a 256-wide frame, against the JAX
    kernels' x_shift in interpret mode: the sweep envelope (at most 1
    premultiplied level on 1e-4 of the bytes)."""
    h, w, x0 = 40, 128, 64
    mats = rotations(2, 128.0, 20.0, 0.3)
    pairs = morph_pairs(h, 2 * w)
    tables = [pairs[0][0].copy()]
    tables[0][:, 0::2] += np.float32(60.0)
    colors = [(0.9, 0.3, 0.2, 0.8)]
    tab, subxy, cj = jsweep.affine_pieces(tables, colors, mats)
    want = jmorph.morph_frames_to_u8(np.asarray(jsweep.render_affine_sweep(
        jnp.asarray(mats), jnp.asarray(tab), jnp.asarray(subxy),
        jnp.asarray(cj), h, w, x_shift=np.float32([x0]))), h, w)
    ttab, tcol = tsweep.affine_pieces(tables, colors, mats)
    got = tmorph.morph_frames_to_u8(tsweep.render_affine_sweep(
        torch.as_tensor(mats), torch.as_tensor(ttab), torch.as_tensor(tcol),
        h, w, x_shift=x0), h, w)
    smax, pmax, share = levels(want, got)
    assert pmax <= 1 and share <= 1e-4 and got[..., 3].max() > 150

    ratios = np.float32([0.0, 0.4, 1.0])
    jparts = jmorph.morph_pieces(pairs)
    want = jmorph.morph_frames_to_u8(np.asarray(jmorph.render_morph_sweep(
        jnp.asarray(ratios), *map(jnp.asarray, jparts), h, w,
        x_shift=np.float32([x0]))), h, w)
    got = tmorph.morph_frames_to_u8(tmorph.render_morph_sweep(
        ratios, *tmorph.morph_pieces(pairs), h, w, x_shift=x0,
        device="cpu"), h, w)
    smax, pmax, share = levels(want, got)
    assert pmax <= 1 and share <= 1e-4 and got[..., 3].max() > 150


@functools.lru_cache(maxsize=None)
def _wide_styled_sweep():
    """styled_sweep_scene 160 wide, two frames, and its unsharded
    frames."""
    mats, parts, kw, h, w = styled_sweep_scene(w=160, frames=2)
    full = tsweep.render_affine_sweep(
        torch.as_tensor(mats), *map(torch.as_tensor, parts), h, w,
        paints=kw["paints"], grad_mats=torch.as_tensor(kw["grad_mats"]),
        fields=kw["fields"])
    return mats, parts, kw, h, full


@pytest.mark.parametrize("x0,ws", [(45, 83), (105, 55)])
def test_origin_gives_the_unshifted_frames_columns(x0, ws):
    """Origins and widths on no 128-column tile (the rank cases cover the
    aligned shards), the last shard ending at the frame's edge: the styled
    sweep's words (solid, gradient under global matrices, bitmap field
    read at the shard's columns) equal those columns of the full frame."""
    mats, parts, kw, h, full = _wide_styled_sweep()
    shard = tsweep.render_affine_sweep(
        torch.as_tensor(mats), *map(torch.as_tensor, parts), h, ws,
        paints=kw["paints"], grad_mats=torch.as_tensor(kw["grad_mats"]),
        fields=kw["fields"][:, :, :, x0:x0 + ws].contiguous(),
        x_shift=torch.tensor([float(x0)]))
    assert torch.equal(shard, full[:, :, x0:x0 + ws])
    assert (shard != 0).float().mean() > 0.05


def test_origin_refusals():
    """B4 (row bands) and B5 (compacted) take no origin, as the
    reference's; the origin is a whole column."""
    mats = torch.as_tensor(rotations(2, 10.0, 10.0, 0.2))
    tab, colors = tsweep.affine_pieces(
        [morph_pairs(20, 20)[0][0]], [(1, 0, 0, 1)], mats.numpy())
    tab, colors = torch.as_tensor(tab), torch.as_tensor(colors)
    with pytest.raises(ValueError, match="column-grid"):
        tsweep.render_affine_sweep(mats, tab, colors, 20, 20, row_grid=True,
                                   x_shift=4)
    with pytest.raises(ValueError, match="column-grid non-compact"):
        tsweep.render_affine_sweep(mats, tab, colors, 20, 20,
                                   compact_counts=(256,), x_shift=4)
    with pytest.raises(ValueError, match="whole column"):
        tsweep.render_affine_sweep(mats, tab, colors, 20, 20, x_shift=0.5)
    with pytest.raises(ValueError, match="one origin"):
        tsweep.render_affine_sweep(mats, tab, colors, 20, 20,
                                   x_shift=[1.0, 2.0])


# ---------------------------------------------------------------------------
# Entry points: the mesh, one rank in process, and the dry run
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_needs_a_group_and_enough_ranks(one_rank, monkeypatch):
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.size == 1
    with pytest.raises(ValueError, match="has 1 ranks"):
        tmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="runs NCCL"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        tmesh.make_mesh(device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()


def test_make_mesh_without_a_process_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(device="cpu")


def test_world_one_mesh_equals_single_device(one_rank):
    """One rank: the fused, styled and tile-sharded routes are the
    single-device ones (the card's phase 15 runs the same at 1080p)."""
    mesh = tmesh.make_mesh(device="cpu")
    updates, colors, h, w = CASES["fused_dp"][0]()
    np.testing.assert_array_equal(
        _as_array(tmesh.render_fused_dp(mesh, updates, colors, h, w)),
        _single("fused_dp"))
    inputs = CASES["morph_sweep_tile_sharded"][0]()
    np.testing.assert_array_equal(
        _as_array(tmesh.render_morph_sweep_tile_sharded(mesh, *inputs)),
        _single("morph_sweep_tile_sharded"))


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu_ranks(rank_results, n):
    """The dry run's steps (the dp x tp solid batch, the scanline dp x tp
    with its winding carry, the fused kernel dp-sharded) ran and passed
    their checks on every rank of the n-rank group."""
    name = {world: name for name, (world, _) in MESHES.items()}[n]
    assert int(rank_results[name]["dryrun_world"]) == n


def test_dryrun_multichip_spawns_its_ranks():
    """dryrun_multichip itself: it spawns its gloo ranks (one here; the
    fixture's groups run its steps at 2 and 4) and joins them."""
    from swf_renderer_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(1, device="cpu")


def test_dryrun_multichip_without_a_card_raises(monkeypatch):
    from swf_renderer_tpu_torch.entry import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)
