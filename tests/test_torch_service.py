"""The package's public surface and the service, on the CPU: the lazy
top-level exports against the reference's ``__all__``,
``runtime.service`` (``AssetStore``, ``StoredShapeRef``,
``RendererService``) against the JAX package's service, and
``render_shape_tag_to_png`` against the reference's on an ``ast.json``
written by the test.

Tolerance: the envelopes tests/test_torch_renderer.py and
tests/test_torch_animation.py pin for the same stages — ``render_refs``
of solids, a linear gradient and a morph byte-equal; ``animate_refs``
through the transform sweep within 1 premultiplied level, straight bytes
within 2 levels on 1e-3 of the bytes.
"""

import concurrent.futures
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import swf_renderer_tpu as jswf
import swf_renderer_tpu_torch as tswf
from swf_renderer_tpu.runtime import renderer as jrenderer
from swf_renderer_tpu.runtime import service as jservice
from swf_renderer_tpu_torch.convert import to_plain
from swf_renderer_tpu_torch.runtime import renderer as trenderer
from swf_renderer_tpu_torch.runtime import service as tservice
from swf_renderer_tpu_torch.utils.png import read_png
from tests.test_torch_animation import assert_matches_reference
from tests.test_torch_renderer import (
    JAX, PORT, H, W, _linear, _matrix, _morph, _solid, assert_close,
)

# The reference's exports the port does not have (none: the audio mixer
# is ported), each with its queue item (ROADMAP.md), and the one the
# port names differently.
MISSING = {}
RENAMED = {"TpuRenderer": "TorchRenderer"}


# ---------------------------------------------------------------------------
# The top-level surface
# ---------------------------------------------------------------------------


def test_top_level_exports_are_the_references_that_the_port_has():
    want = {RENAMED.get(n, n) for n in jswf.__all__} - set(MISSING)
    assert set(tswf.__all__) == want
    assert len(tswf.__all__) == len(jswf.__all__) - len(MISSING)
    for name in MISSING:
        with pytest.raises(AttributeError):
            getattr(tswf, name)
    for name in RENAMED:   # no alias of the reference's name
        with pytest.raises(AttributeError):
            getattr(tswf, name)
    assert tswf.TorchRenderer is trenderer.TorchRenderer
    assert tswf.RendererService is tservice.RendererService
    for name in tswf.__all__:
        obj = getattr(tswf, name)
        assert obj.__module__.startswith("swf_renderer_tpu_torch."), name


def test_import_loads_no_renderer_until_a_name_is_used():
    """``import swf_renderer_tpu_torch`` stays cheap: the renderer and
    torch load with the first exported name that needs them; decoding
    needs neither."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['swf_renderer_tpu'] = None\n"
        "import swf_renderer_tpu_torch as swf\n"
        "assert 'torch' not in sys.modules, 'torch'\n"
        "swf.decode_shape, swf.load_tag\n"
        "assert 'swf_renderer_tpu_torch.runtime.renderer' not in "
        "sys.modules\n"
        "assert swf.render_shape.__module__.endswith('runtime.renderer')\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=str(__import__("pathlib").Path(
                              __file__).resolve().parent.parent))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_usage_of_the_documented_surface():
    """docs/API.md's usage on the port: decode and render through the
    top-level names, as the renderer itself does."""
    tag = _linear(PORT)
    assert to_plain(tswf.decode_shape(tag)) == to_plain(
        jswf.decode_shape(_linear(JAX)))
    stage = PORT[1].stage_for_shape(tag)
    assert isinstance(stage, tswf.Stage)
    want = tswf.TorchRenderer(stage.width, stage.height,
                              device="cpu").render(stage)
    assert np.array_equal(tswf.render_shape(tag, device="cpu"), want)


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------


def _errors(service):
    """The KeyError texts of a service's lookups of unknown ids."""
    out = []
    for call in (lambda: service.render(99, None),
                 lambda: service.assets.get_shape(5),
                 lambda: service.assets.get_morph_shape(6),
                 lambda: service.renderer_size(98)):
        with pytest.raises(KeyError) as exc:
            call()
        out.append(str(exc.value))
    return out


def test_service_lifecycle_and_errors():
    svc = tservice.RendererService()
    h1 = svc.create_renderer(W, H, device="cpu")
    h2 = svc.create_renderer(64, 32, device="cpu", backend="scanline")
    assert (h1, h2) == (1, 2) and len(svc) == 2
    assert svc.renderer_size(h2) == (64, 32)
    assert svc.bitmap_service(h1) is svc._get(h1).bitmap_service
    svc.destroy_renderer(h1)
    svc.destroy_renderer(h1)   # a second destroy does nothing
    assert len(svc) == 1
    assert _errors(svc) == _errors(jservice.RendererService())
    assert _errors(svc) == [
        "'RendererNotFound: 99'", "'ShapeNotFound: 5'",
        "'MorphShapeNotFound: 6'", "'RendererNotFound: 98'"]


def test_create_renderer_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svc = tservice.RendererService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc.create_renderer(W, H)
    assert len(svc) == 0
    svc.create_renderer(W, H, device="cpu")


def test_asset_store_ids_and_decoded_caches():
    store = tservice.AssetStore()
    sid = store.register_shape(_solid(PORT))
    mid = store.register_morph_shape(_morph(PORT))
    assert (sid, mid) == (1, 2)
    shape = store.decoded_shape(sid)
    assert store.decoded_shape(sid) is shape
    morph = store.decoded_morph_shape(mid)
    assert store.decoded_morph_shape(mid) is morph
    jstore = jservice.AssetStore()
    jstore.register_shape(_solid(JAX))
    jstore.register_morph_shape(_morph(JAX))
    assert to_plain(shape) == to_plain(jstore.decoded_shape(1))
    assert to_plain(morph) == to_plain(jstore.decoded_morph_shape(2))
    with pytest.raises(KeyError, match="ShapeNotFound"):
        store.decoded_shape(mid)


def test_threads_create_render_and_decode_at_once():
    """Eight threads: each creates a renderer, renders refs through it and
    decodes the shared assets; handles are distinct, frames equal one
    render alone and every thread sees one decoded object."""
    svc = tservice.RendererService()
    sid = svc.assets.register_shape(_solid(PORT))
    refs = [tservice.StoredShapeRef(sid, matrix=_matrix(PORT, 40, 20))]
    alone = trenderer.TorchRenderer(W, H, device="cpu")
    want = alone.render(svc._ref_stage(alone, refs, None))

    def work(_):
        handle = svc.create_renderer(W, H, device="cpu")
        return (handle, svc.render_refs(handle, refs),
                svc.assets.decoded_shape(sid))

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        results = list(pool.map(work, range(8)))
    assert sorted(r[0] for r in results) == list(range(1, 9))
    assert len(svc) == 8
    assert all(np.array_equal(r[1], want) for r in results)
    assert len({id(r[2]) for r in results}) == 1


def _service_scene(mods, service_mod, device_kw):
    """A service with a solid, a linear gradient and a morph registered,
    one renderer, and refs placing them."""
    svc = service_mod.RendererService()
    ids = (svc.assets.register_shape(_solid(mods)),
           svc.assets.register_shape(_linear(mods)),
           svc.assets.register_morph_shape(_morph(mods)))
    handle = svc.create_renderer(W, H, **device_kw)
    ref = service_mod.StoredShapeRef

    def refs(i):
        return [ref(ids[1], matrix=_matrix(mods, 30 * i, -20 * i)),
                ref(ids[0], matrix=_matrix(mods, 200 * i, 100, 0.6)),
                ref(ids[2], morph_ratio=0.25 * i)]

    return svc, handle, refs


def test_render_refs_matches_reference_service():
    bg = (30, 60, 90, 200)
    jsvc, jh, jrefs = _service_scene(JAX, jservice, {})
    tsvc, th, trefs = _service_scene(PORT, tservice, {"device": "cpu"})
    for i in (0, 1):
        want = jsvc.render_refs(jh, jrefs(i), JAX[0].StraightSRgba8(*bg))
        got = tsvc.render_refs(th, trefs(i), PORT[0].StraightSRgba8(*bg))
        assert_close(want, got, 0)
    assert tsvc._get(th).last_stats.path == jsvc._get(jh).last_stats.path


def test_animate_refs_matches_reference_service():
    """Four frames of moving refs (solid and gradient: the morph is left
    out so the frames ride one affine sweep) through animate_refs and
    render_batch."""
    jsvc, jh, jrefs = _service_scene(JAX, jservice, {})
    tsvc, th, trefs = _service_scene(PORT, tservice, {"device": "cpu"})
    want = jsvc.animate_refs(jh, [jrefs(i)[:2] for i in range(4)])
    got = tsvc.animate_refs(th, [trefs(i)[:2] for i in range(4)])
    assert tsvc._get(th).last_stats.path == "transform-sweep"
    assert jsvc._get(jh).last_stats.path == "transform-sweep"
    assert_matches_reference(want, got, 2)
    stages = [tsvc._ref_stage(tsvc._get(th), trefs(i)[:2], None)
              for i in range(4)]
    assert np.array_equal(tsvc.render_batch(th, stages), got)


# ---------------------------------------------------------------------------
# render_shape_tag_to_png
# ---------------------------------------------------------------------------


def _ast_json(kind):
    """An ast.json (swf-tree JSON) of a gradient-filled polygon, or of a
    morph shape between two quads."""
    color = {"r": 250, "g": 90, "b": 30, "a": 230}
    if kind == "define-shape":
        fill = {"type": "linear-gradient", "matrix": {
            "scale_x": 5000, "scale_y": 5000, "rotate_skew0": 800,
            "rotate_skew1": -800, "translate_x": 900, "translate_y": 500},
            "gradient": {"spread": "pad", "color_space": "s-rgb",
                         "colors": [{"ratio": 0, "color": color},
                                    {"ratio": 255, "color": {
                                        "r": 10, "g": 40, "b": 240,
                                        "a": 255}}]}}
        edges = [(1500, 200), (200, 900), (-1600, 100), (-100, -1200)]
        return {"type": "define-shape", "id": 1,
                "bounds": {"x_min": 0, "x_max": 2000, "y_min": 0,
                           "y_max": 1400},
                "shape": {"initial_styles": {"fill": [fill], "line": []},
                          "records": [{"type": "style-change",
                                       "move_to": {"x": 100, "y": 100},
                                       "left_fill": 1}]
                          + [{"type": "edge", "delta": {"x": x, "y": y}}
                             for x, y in edges]}}
    quad = [(1200, 0), (300, 1000), (-1200, 0), (-300, -1000)]
    return {"type": "define-morph-shape", "id": 2,
            "bounds": {"x_min": 0, "x_max": 2000, "y_min": 0,
                       "y_max": 1200},
            "morph_bounds": {"x_min": 0, "x_max": 2000, "y_min": 0,
                             "y_max": 1200},
            "shape": {"initial_styles": {"fill": [{
                "type": "solid", "color": color,
                "morph_color": {"r": 0, "g": 200, "b": 90, "a": 255}}],
                "line": []},
                "records": [{"type": "style-change",
                             "move_to": {"x": 300, "y": 100},
                             "morph_move_to": {"x": 500, "y": 200},
                             "left_fill": 1}]
                + [{"type": "edge", "delta": {"x": x, "y": y},
                    "morph_delta": {"x": x // 2, "y": y}}
                   for x, y in quad]}}


@pytest.mark.parametrize("kind", ["define-shape", "define-morph-shape"])
def test_render_shape_tag_to_png_matches_reference(tmp_path, kind):
    path = tmp_path / "ast.json"
    path.write_text(json.dumps(_ast_json(kind)))
    want = jrenderer.render_shape_tag_to_png(str(path),
                                             str(tmp_path / "want.png"))
    got = trenderer.render_shape_tag_to_png(str(path),
                                            str(tmp_path / "got.png"),
                                            device="cpu")
    assert_close(want, got, 0)
    assert np.array_equal(read_png(str(tmp_path / "got.png")), got)
    assert got[..., 3].max() > 200


def test_render_shape_tag_to_png_refuses_other_tags(tmp_path):
    path = tmp_path / "ast.json"
    path.write_text(json.dumps({"type": "define-bitmap", "id": 3,
                                "width": 1, "height": 1,
                                "media_type": "image/png", "data": ""}))
    with pytest.raises(ValueError, match="cannot render tag"):
        trenderer.render_shape_tag_to_png(str(path), str(tmp_path / "o.png"),
                                          device="cpu")
