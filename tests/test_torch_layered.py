"""The layered backends of the port against the JAX package, on the CPU:
``TorchRenderer`` with ``backend="direct"`` / ``"scanline"``,
``quality="flash-pointaa"`` and ``validate=True``, and the batch
pipelines ``render_solid_batch``, ``render_morph_batch`` and
``render_styled_layered``.

On the CPU the JAX package's direct backend runs ``coverage_xla`` and the
port's the banded kernel's plain version: another summation order and no
FMA contraction, coverage within 1e-5 (``test_torch_coverage.py``).
Frames: at most one premultiplied level, on at most 3e-3 of the bytes;
straight bytes pinned per stage at what was measured: byte-equal
everywhere except the focal gradient (3 levels, its field's FMA
contraction, as on the fused route) and the bitmap fill (2 levels, its
field's contraction order).  ``render_solid_batch`` composites in XLA
on the reference's side (``c * cov + dst * (1 - a * cov)`` contracted
into FMAs): one pixel of alpha 10 moves 26 straight levels under nonzero
(share 2.1e-5), pinned.

Every case starts in the process's default floating-point environment
(``tests/torch_fpenv.py``: MXCSR 0x1F80 and x87 control word 0x037F on
the calling thread), and a frame comparison that fails reports both
packages' frame hashes, that environment, torch's intra-op threads and
the test files that ran before it in this worker (ROADMAP.md queue C
item 1: the direct-focal case failed once, cause not found).
"""

import dataclasses
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swf_renderer_tpu.ops import pipeline as jpl
from swf_renderer_tpu.runtime.renderer import TpuRenderer
from swf_renderer_tpu_torch.convert import paint_from_numpy
from swf_renderer_tpu_torch.ops import coverage as tcov
from swf_renderer_tpu_torch.ops import pipeline as tpl
from swf_renderer_tpu_torch.runtime.renderer import TorchRenderer
from swf_renderer_tpu_torch.utils.scenes import build_scene_edges
from tests import torch_fpenv
from tests.test_torch_renderer import (
    JAX, PORT, H, W, _bitmap_tag, _linear, _scene, _solid, _stage,
    assert_close, levels,
)

BACKENDS = {
    "direct": {"backend": "direct"},
    "scanline": {"backend": "scanline"},
    "pointaa": {"quality": "flash-pointaa"},
    "validate": {"validate": True},
}
PATHS = {"direct": "direct", "scanline": "scanline", "pointaa": "pointaa",
         "validate": "scanline"}
SCENES = ["solid-background", "linear", "focal", "bitmap", "mixed-rules",
          "morph"]
STRAIGHT_ENVELOPE = {"focal": 3, "bitmap": 2}


@pytest.fixture(autouse=True)
def default_fp_env():
    """Each case starts with the default rounding, flush and mask bits."""
    err = torch_fpenv.default_env_error()
    assert err is None, err


def _earlier_files(request):
    """The test files whose cases set up in this worker before this one
    (pytest's skipping plugin stamps each item it sets up)."""
    from _pytest.skipping import xfailed_key

    files = []
    for item in request.session.items:
        if item is request.node:
            break
        name = item.nodeid.split("::")[0]
        if xfailed_key in item.stash and name not in files:
            files.append(name)
    return files


def fault_report(request, want, got):
    """What the next failure of a frame comparison should tell."""
    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    return (f"JAX frame sha256 {digest(want)}, port frame sha256 "
            f"{digest(got)}; {torch_fpenv.describe()}; torch intra-op "
            f"threads {torch.get_num_threads()}; earlier test files in "
            f"this worker: {_earlier_files(request)}")


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("route", list(BACKENDS))
def test_layered_render_matches_tpu_renderer(route, name, request):
    jstage, kw = _scene(JAX, name)
    tstage, _ = _scene(PORT, name)
    jr = TpuRenderer(W, H, **BACKENDS[route], **kw)
    tr = TorchRenderer(W, H, device="cpu", **BACKENDS[route], **kw)
    if name.startswith("bitmap"):
        jr.add_bitmap(_bitmap_tag(JAX))
        tr.add_bitmap(_bitmap_tag(PORT))
    want = jr.render(jstage)
    got = tr.render(tstage)
    assert jr.last_stats.path == tr.last_stats.path == PATHS[route]
    assert got[..., 3].max() > 0
    try:
        assert_close(want, got, STRAIGHT_ENVELOPE.get(name, 0))
    except AssertionError as exc:
        raise AssertionError(
            f"{exc}; {fault_report(request, want, got)}") from None


def test_fp_env_guard_sees_a_changed_rounding_mode(request):
    """The entry check and the fault report read the calling thread's
    MXCSR: round-toward-zero is named, and restored after."""
    if not torch_fpenv.available():
        pytest.skip("MXCSR unreadable: not x86-64 or no g++")
    saved = torch_fpenv.mxcsr()
    try:
        torch_fpenv.set_mxcsr(torch_fpenv.DEFAULT_MXCSR | 0x6000)
        err = torch_fpenv.default_env_error()
        report = fault_report(request, np.zeros(2, np.uint8),
                              np.ones(2, np.uint8))
    finally:
        torch_fpenv.set_mxcsr(saved)
    assert err is not None and "MXCSR 0x7f" in err
    assert "MXCSR 0x7f" in report and "torch intra-op threads" in report
    assert torch_fpenv.default_env_error() is None


@pytest.mark.parametrize("route", list(BACKENDS))
def test_layered_render_batch_goes_stage_by_stage(route):
    """Moving stages: the explicit layered choices keep every batch off
    the fused kernel and off the sweeps, as in the reference."""
    def stages(mods):
        return [_stage(mods, [(_linear(mods), None),
                              (_solid(mods), mods[0].Matrix(
                                  scale_x=mods[2].from_value(1.0),
                                  scale_y=mods[2].from_value(1.0),
                                  rotate_skew0=mods[2].from_value(0.0),
                                  rotate_skew1=mods[2].from_value(0.0),
                                  translate_x=200 * f, translate_y=40 * f))])
                for f in range(3)]

    jr = TpuRenderer(W, H, **BACKENDS[route])
    tr = TorchRenderer(W, H, device="cpu", **BACKENDS[route])
    want = jr.render_batch(stages(JAX))
    got = tr.render_batch(stages(PORT))
    assert tr.last_stats.path == jr.last_stats.path
    assert tr.last_stats.path.startswith("per-stage:")
    assert_close(want, got, 0)
    # render() in a loop of moved matrices stays on the layered path too.
    for stage in stages(PORT):
        tr.render(stage)
        assert tr.last_stats.path == PATHS[route]


def test_validate_raises_on_bad_coverage():
    """An edge whose x-extent overflows f32 makes NaN coverage: the
    validating renderer raises, as the reference's does."""
    tr = TorchRenderer(W, H, backend="direct", validate=True, device="cpu")
    draw = tr._compiler().compile_stage(_scene(PORT, "linear")[0])[0]
    bad = dataclasses.replace(draw, edges=np.asarray(
        [[1e38, 5.0, -1e38, 20.0], [-1e38, 20.0, 1e38, 5.0]], np.float32))
    with pytest.raises(FloatingPointError, match="NaN"):
        tr.execute([bad])
    quiet = TorchRenderer(W, H, backend="direct", device="cpu")
    assert quiet.execute([bad]).shape == (H, W, 4)


def _split_padded(tables):
    flat = tcov.split_pad_tables([t for per in tables for t in per])
    return flat.reshape(len(tables), len(tables[0]), 4, -1)


@pytest.mark.parametrize("rule", [0, 1])
def test_render_solid_batch_matches_reference(rule):
    tables, colors = build_scene_edges(2, 3, 40, 150, shapes_per_layer=6,
                                       seed=rule)
    edges_t = _split_padded(tables)
    want = np.asarray(jpl.render_solid_batch(jnp.asarray(edges_t),
                                             jnp.asarray(colors), 40, 150,
                                             fill_rule=rule))
    got = tpl.render_solid_batch(edges_t, colors, 40, 150, rule,
                                 device="cpu")
    assert got.shape == (2, 40, 150, 4) and got.dtype == np.uint8
    assert_close(want, got, (26, 0)[rule])
    assert got[..., 3].max() > 0


def test_render_solid_batch_takes_the_tiled_kernel_above_2048_edges():
    """A table of 2176 edges: the tiled kernel's plain version (B10), the
    same frames within the tolerance."""
    tables, colors = build_scene_edges(1, 2, 24, 100, shapes_per_layer=272,
                                       seed=3)
    edges_t = _split_padded(tables)
    assert edges_t.shape[-1] > tcov.SMEM_EDGE_CAP
    want = np.asarray(jpl.render_solid_batch(jnp.asarray(edges_t),
                                             jnp.asarray(colors), 24, 100))
    got = tpl.render_solid_batch(torch.from_numpy(edges_t),
                                 torch.from_numpy(colors), 24, 100)
    assert_close(want, got, 1)


def test_render_morph_batch_matches_reference():
    tables, colors = build_scene_edges(2, 2, 32, 120, shapes_per_layer=4,
                                       seed=8)
    start, end = _split_padded(tables)   # frame 0 morphs into frame 1
    ratios = np.array([0.0, 0.25, 0.8, 1.0], np.float32)
    want = np.asarray(jpl.render_morph_batch(
        jnp.asarray(start), jnp.asarray(end), jnp.asarray(colors[0]),
        jnp.asarray(colors[1]), jnp.asarray(ratios), 32, 120))
    got = tpl.render_morph_batch(start, end, colors[0], colors[1], ratios, 32,
                                 120, device="cpu")
    assert got.shape == (4, 32, 120, 4)
    assert_close(want, got, 2)


def test_render_styled_layered_matches_reference():
    from tests.test_torch_pipeline import _paints

    height, width = 24, 140
    tables, colors = build_scene_edges(2, 4, height, width,
                                       shapes_per_layer=4, seed=12)
    jpaints = _paints()
    rules = (0, 1, 0, 1)
    want = jpl.render_styled_layered(tables, jpaints, height, width,
                                     colors=colors, fill_rule=rules)
    got = tpl.render_styled_layered(tables,
                                    [paint_from_numpy(p) for p in jpaints],
                                    height, width, colors=colors,
                                    fill_rule=rules, device="cpu")
    smax, pmax, share = levels(want, got)
    assert pmax <= 1 and smax <= 1 and share <= 1e-3, (smax, pmax, share)
