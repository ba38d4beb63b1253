"""Embedding service: handle-based renderer sessions + asset stores.

Covers two reference seams:

* the wasm embedding API — a global handle table mapping ids to live
  renderers with create/render/destroy (reference rs/src/wasm.rs:12-76,
  ``createRenderer``/``render``/``destroyRenderer``),
* the client/server asset-store split — register a shape/morph-shape/bitmap
  once, get an id, reference it from retained stages (reference
  rs/src/asset.rs:3-20 ``ClientAssetStore``/``ServerAssetStore`` and the
  ``ShapeStore`` keyed by character id, rs/src/renderer.rs:24-64).

Thread-safe like the reference's ``Mutex<RendererStore>``.  Port of
``swf_renderer_tpu/runtime/service.py`` over ``TorchRenderer``: a renderer
lives on the card unless ``create_renderer`` is given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

import numpy as np

from ..models import ast, display
from ..models.decode_morph_shape import decode_morph_shape
from ..models.decode_shape import decode_shape
from .renderer import TorchRenderer


class AssetStore:
    """Server-side asset registry: definitions in, ids out.

    The reference sketched (and left unfinished) this split so a client
    could drive a remote renderer by id (asset.rs:9-20); here it is the
    working registry behind :class:`RendererService`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next_id = 1
        self._shapes: Dict[int, ast.DefineShape] = {}
        self._morph_shapes: Dict[int, ast.DefineMorphShape] = {}
        self._decoded_shapes: Dict[int, object] = {}
        self._decoded_morphs: Dict[int, object] = {}

    def register_shape(self, tag: ast.DefineShape) -> int:
        with self._lock:
            shape_id = self._next_id
            self._next_id += 1
            self._shapes[shape_id] = tag
            return shape_id

    def register_morph_shape(self, tag: ast.DefineMorphShape) -> int:
        with self._lock:
            shape_id = self._next_id
            self._next_id += 1
            self._morph_shapes[shape_id] = tag
            return shape_id

    def get_shape(self, shape_id: int) -> ast.DefineShape:
        shape = self._shapes.get(shape_id)
        if shape is None:
            raise KeyError(f"ShapeNotFound: {shape_id}")
        return shape

    def get_morph_shape(self, shape_id: int) -> ast.DefineMorphShape:
        shape = self._morph_shapes.get(shape_id)
        if shape is None:
            raise KeyError(f"MorphShapeNotFound: {shape_id}")
        return shape

    def decoded_shape(self, shape_id: int):
        """Decoded-IR cache keyed by ASSET id — the service-level analog
        of renderer.rs ShapeStore.define_shape's decode step.  (The render
        path has its own tag-identity cache inside SceneCompiler; this one
        serves direct decode API users and keeps the store's registered
        tags the cache anchor.)"""
        with self._lock:
            hit = self._decoded_shapes.get(shape_id)
        if hit is not None:
            return hit
        decoded = decode_shape(self.get_shape(shape_id))
        with self._lock:
            # First decoder wins so callers always observe ONE object.
            return self._decoded_shapes.setdefault(shape_id, decoded)

    def decoded_morph_shape(self, shape_id: int):
        with self._lock:
            hit = self._decoded_morphs.get(shape_id)
        if hit is not None:
            return hit
        decoded = decode_morph_shape(self.get_morph_shape(shape_id))
        with self._lock:
            return self._decoded_morphs.setdefault(shape_id, decoded)


@dataclasses.dataclass
class StoredShapeRef:
    """Display-list node referencing a registered shape by id
    (the retained-stage analog of rs/src/stage.rs StoredShape:40-53)."""

    shape_id: int
    matrix: Optional[ast.Matrix] = None
    morph_ratio: Optional[float] = None  # set for morph shapes


class RendererService:
    """Handle table of live renderers (reference rs/src/wasm.rs:12-49)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next_handle = 1
        self._renderers: Dict[int, TorchRenderer] = {}
        self.assets = AssetStore()

    def create_renderer(self, width: int, height: int, **kwargs) -> int:
        """A new TorchRenderer -> its handle; ``kwargs`` (``device=``,
        ``backend=``, ``quality=`` ...) go to TorchRenderer."""
        with self._lock:
            handle = self._next_handle
            self._next_handle += 1
            self._renderers[handle] = TorchRenderer(width, height, **kwargs)
            return handle

    def _get(self, handle: int) -> TorchRenderer:
        renderer = self._renderers.get(handle)
        if renderer is None:
            raise KeyError(f"RendererNotFound: {handle}")
        return renderer

    def add_bitmap(self, handle: int, tag: ast.DefineBitmap) -> None:
        self._get(handle).add_bitmap(tag)

    def bitmap_service(self, handle: int):
        """The handle's bitmap registry (runtime.bitmap_service) — lets
        one-shot helpers like render_shape_animation reuse bitmaps
        registered on a server handle."""
        return self._get(handle).bitmap_service

    def render(self, handle: int, stage: display.Stage) -> np.ndarray:
        return self._get(handle).render(stage)

    def _ref_stage(self, renderer: TorchRenderer, refs, background):
        """A stage of ``renderer``'s size over StoredShapeRef nodes."""
        children = []
        for ref in refs:
            if ref.morph_ratio is None:
                children.append(display.ShapeInstance(
                    definition=self.assets.get_shape(ref.shape_id),
                    matrix=ref.matrix))
            else:
                children.append(display.MorphShapeInstance(
                    definition=self.assets.get_morph_shape(ref.shape_id),
                    ratio=ref.morph_ratio, matrix=ref.matrix))
        return display.Stage(
            width=renderer.width,
            height=renderer.height,
            background_color=background or ast.StraightSRgba8(0, 0, 0, 0),
            children=tuple(children),
        )

    def render_refs(self, handle: int, refs, background=None) -> np.ndarray:
        """Render a retained stage of :class:`StoredShapeRef` nodes."""
        renderer = self._get(handle)
        return renderer.render(self._ref_stage(renderer, refs, background))

    def renderer_size(self, handle: int):
        """(width, height) of a live renderer (embedding surfaces route
        work by size without touching internals)."""
        r = self._get(handle)
        return r.width, r.height

    def render_batch(self, handle: int, stages) -> np.ndarray:
        """Render a stage sequence as one fused device batch (moving-
        matrix animations auto-route to the on-device transform sweep;
        see TorchRenderer.render_batch)."""
        return self._get(handle).render_batch(stages)

    def animate_refs(self, handle: int, refs_per_frame,
                     background=None) -> np.ndarray:
        """Render a SEQUENCE of retained-ref frames — the embedding
        analog of the frame server's animate loop.  Each element of
        ``refs_per_frame`` is a list of StoredShapeRef; returns
        (F, H, W, 4) uint8."""
        renderer = self._get(handle)
        return renderer.render_batch(
            [self._ref_stage(renderer, refs, background)
             for refs in refs_per_frame])

    def destroy_renderer(self, handle: int) -> None:
        with self._lock:
            self._renderers.pop(handle, None)

    def __len__(self) -> int:
        return len(self._renderers)
