"""The renderer front-end: ``render(stage)`` / ``render_batch(stages)``.

Port of ``swf_renderer_tpu/runtime/renderer.py`` for the fused path:
scene compilation -> native lowering and packing -> one fused styled
kernel launch per batch -> u8 readback.  Every stage renders through the
fused flat-block kernel; the other routes of the reference raise
``NotImplementedError`` naming their ROADMAP.md item (queue A):

* the transform / morph sweeps of moving-matrix batches and repeated
  interactive renders (this port re-lowers every frame instead);
* ``backend="scanline"`` / ``"direct"``, ``quality="flash-pointaa"`` and
  ``validate=True``;
* masks, blend modes and filters; draw lists deeper than one kernel pass;
  frames wider than 8191 px.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import List, Optional

import numpy as np

from ..models import ast, display
from ..models.geometry import CURVE_TOLERANCE
from ..ops import style as style_ops
from ..utils.device import resolve_device
from .bitmap_service import BitmapService
from .scene import Draw, SceneCompiler

logger = logging.getLogger("swf_renderer_tpu_torch")


@dataclasses.dataclass
class RenderStats:
    """Per-frame observability: draw/edge counts, wall seconds and the
    execution path ("flatblock", "batched-styled", "empty" or
    "per-stage:<reason>")."""

    draws: int = 0
    edges: int = 0
    width: int = 0
    height: int = 0
    seconds: float = 0.0
    path: str = ""

    @property
    def mpx_per_s(self) -> float:
        if self.seconds <= 0:
            return 0.0
        return self.width * self.height / self.seconds / 1e6


def _uniform_layer_structure(per_frame_draws) -> bool:
    """True when every frame has the same layer structure: equal draw
    counts and fill rules, and non-solid paints identical per layer
    (solid colors may vary per frame — they batch through ``colors``)."""
    first = per_frame_draws[0]
    for draws in per_frame_draws:
        if len(draws) != len(first):
            return False
        for d, d0 in zip(draws, first):
            p, p0 = d.paint, d0.paint
            if d.fill_rule != d0.fill_rule or p.kind != p0.kind:
                return False
            if p.kind == style_ops.PAINT_SOLID:
                continue
            if (p.inv_matrix != p0.inv_matrix
                    or p.focal_point != p0.focal_point
                    or p.spread != p0.spread
                    or p.repeating != p0.repeating
                    or p.smoothed != p0.smoothed
                    or p.edge_mode != p0.edge_mode
                    or p.color_space != p0.color_space):
                return False
            for a, b in ((p.stop_ratios, p0.stop_ratios),
                         (p.stop_colors, p0.stop_colors),
                         (p.image, p0.image)):
                if (a is None) != (b is None):
                    return False
                if a is not None and not (a is b or np.array_equal(a, b)):
                    return False
    return True


def _composite_background(frames: np.ndarray, bgs) -> np.ndarray:
    """Source-over rendered frame(s) onto stage background color(s), over
    the QUANTIZED frame, with the shared premultiplied-u8 quantization.

    ``frames``: (H, W, 4) or (F, H, W, 4) u8; ``bgs``: one
    ast.StraightSRgba8 or a sequence of F of them."""
    from ..ops.composite import premul_to_straight_u8

    single = frames.ndim == 3
    if single:
        frames, bgs = frames[None], [bgs]
    bg_arr = np.asarray([[b.r, b.g, b.b, b.a] for b in bgs],
                        np.float32) / 255.0  # (F, 4) straight
    if not bg_arr[:, 3].any():
        return frames[0] if single else frames
    a = frames[..., 3:4].astype(np.float32) / 255.0
    ba = bg_arr[:, None, None, 3:4]
    bg_pm = bg_arr[:, None, None, :3] * ba
    res_a = a + ba * (1.0 - a)
    res_pm = (frames[..., :3].astype(np.float32) / 255.0 * a
              + bg_pm * (1.0 - a))
    out = premul_to_straight_u8(np.concatenate([res_pm, res_a], axis=-1))
    return out[0] if single else out


class TorchRenderer:
    """Renders retained stages to RGBA frames on the card (or, with
    ``device="cpu"``, through the kernels' plain versions).  ``render``
    returns the frame as an (H, W, 4) uint8 array."""

    def __init__(self, width: int, height: int, backend: str = "auto",
                 quality: str = "canvas", validate: bool = False,
                 honor_fill_winding: bool = False, device=None):
        if quality not in ("canvas", "flash", "flash-pointaa"):
            raise ValueError(f"unknown quality {quality!r}")
        if backend not in ("auto", "scanline", "direct"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend != "auto":
            raise NotImplementedError(
                f"backend={backend!r} needs the coverage kernels: "
                "ROADMAP.md queue A (scanline/direct backends)")
        if quality == "flash-pointaa":
            raise NotImplementedError(
                "point-sampled AA needs the scanline point kernels: "
                "ROADMAP.md queue A (pointaa backend)")
        if validate:
            raise NotImplementedError(
                "validate=True inspects raw coverage of the layered "
                "backends: ROADMAP.md queue A (scanline/direct backends)")
        self.device = resolve_device(device)
        self.honor_fill_winding = honor_fill_winding
        self.width = width
        self.height = height
        self.quality = quality
        self.bitmap_service = BitmapService()
        self._shape_cache: dict = {}
        self._morph_cache: dict = {}
        from .cache import DrawListCache, PackedSceneCache

        self._packed_cache = PackedSceneCache(capacity=16)
        self._draws_cache = DrawListCache()
        self.frame: Optional[np.ndarray] = None
        self.last_stats = RenderStats()
        self._exec_path = ""
        self._render_lock = threading.RLock()

    # -- reference API ------------------------------------------------------

    def add_bitmap(self, tag: ast.DefineBitmap) -> None:
        self.bitmap_service.add_bitmap(tag)

    def _compiler(self, clip=None) -> SceneCompiler:
        flash_like = self.quality.startswith("flash")
        return SceneCompiler(
            self.bitmap_service, self._shape_cache, self._morph_cache,
            curve_tolerance=CURVE_TOLERANCE,
            curve_pow2=flash_like,
            honor_swf_caps=flash_like,
            honor_fill_winding=self.honor_fill_winding,
            clip=clip,
            draws_cache=self._draws_cache,
        )

    def render(self, stage: display.Stage) -> np.ndarray:
        with self._render_lock:
            t0 = time.perf_counter()
            draws = self._compiler().compile_stage(stage)
            self.frame = _composite_background(self.execute(draws),
                                               stage.background_color)
            self.last_stats = RenderStats(
                draws=len(draws),
                edges=sum(d.edges.shape[0] for d in draws),
                width=self.width, height=self.height,
                seconds=time.perf_counter() - t0,
                path=self._exec_path,
            )
            return self.frame

    def render_batch(self, stages) -> np.ndarray:
        """Render a SEQUENCE of stages as one fused device batch (one
        kernel launch) when every frame has the same layer structure;
        otherwise stage by stage, each through the fused kernel.  Returns
        (len(stages), H, W, 4) uint8."""
        with self._render_lock:
            return self._render_batch_locked(list(stages))

    def _render_batch_locked(self, stages) -> np.ndarray:
        t0 = time.perf_counter()
        if not stages:
            return np.zeros((0, self.height, self.width, 4), np.uint8)
        per_frame_draws = [
            self._compiler(
                clip=((stage.exact_width, stage.exact_height)
                      if stage.exact_width is not None else None)
            ).compile_stage(stage)
            for stage in stages]
        if any(d.mask_of is not None or d.mask_ids
               for draws in per_frame_draws for d in draws):
            raise NotImplementedError(
                "clip groups, blend modes and filters run the masked "
                "program: ROADMAP.md queue A (masks/blends/filters)")
        reason = None
        if not per_frame_draws[0]:
            reason = "empty draw list"
        elif not _uniform_layer_structure(per_frame_draws):
            reason = "non-uniform layer structure across frames"
        if reason is None:
            from ..ops.pipeline import render_batch_styled

            paints = [d.paint for d in per_frame_draws[0]]
            colors = np.zeros((len(stages), len(paints), 4), np.float32)
            for f, draws in enumerate(per_frame_draws):
                for l, d in enumerate(draws):
                    if d.paint.kind == style_ops.PAINT_SOLID:
                        colors[f, l] = d.paint.color
            out = render_batch_styled(
                [[d.edges for d in draws] for draws in per_frame_draws],
                paints, self.height, self.width, colors=colors,
                fill_rule=tuple(d.fill_rule for d in per_frame_draws[0]),
                cache=self._packed_cache, device=self.device)
            path = "batched-styled"
        else:
            logger.warning(
                "render_batch: rendering stage by stage (%s)", reason)
            out = np.stack([self.execute(draws)
                            for draws in per_frame_draws])
            path = f"per-stage:{reason}"
        if any(s.background_color.a != 0 for s in stages):
            out = _composite_background(
                out, [s.background_color for s in stages])
        self.last_stats = RenderStats(
            draws=sum(len(d) for d in per_frame_draws),
            edges=sum(d.edges.shape[0] for draws in per_frame_draws
                      for d in draws),
            width=self.width, height=self.height,
            seconds=time.perf_counter() - t0,
            path=path,
        )
        return out

    # -- execution ----------------------------------------------------------

    def execute(self, draws: List[Draw]) -> np.ndarray:
        """One compiled draw list -> (H, W, 4) u8 through the fused
        styled kernel."""
        from ..ops.pipeline import render_batch_styled

        if not draws:
            self._exec_path = "empty"
            return np.zeros((self.height, self.width, 4), dtype=np.uint8)
        if any(d.mask_of is not None or d.mask_ids for d in draws):
            raise NotImplementedError(
                "clip groups, blend modes and filters run the masked "
                "program: ROADMAP.md queue A (masks/blends/filters)")
        fill_rules = sorted({d.fill_rule for d in draws})
        rule = (fill_rules[0] if len(fill_rules) == 1
                else tuple(d.fill_rule for d in draws))
        self._exec_path = "flatblock"
        return render_batch_styled(
            [[d.edges for d in draws]], [d.paint for d in draws],
            self.height, self.width, fill_rule=rule,
            cache=self._packed_cache, device=self.device)[0]


# ---------------------------------------------------------------------------
# Convenience one-shot entry points (the renderShape/renderMorphShape surface)
# ---------------------------------------------------------------------------


def render_shape(tag: ast.DefineShape,
                 bitmaps: Optional[List[ast.DefineBitmap]] = None,
                 device=None, **kwargs) -> np.ndarray:
    """Render a DefineShape the way the reference render tests do: stage of
    size ceil(bounds/20) with the shape translated to the origin."""
    stage = display.stage_for_shape(tag)
    renderer = TorchRenderer(stage.width, stage.height, device=device,
                             **kwargs)
    for bmp in bitmaps or []:
        renderer.add_bitmap(bmp)
    return renderer.render(stage)


def render_morph_shape(tag: ast.DefineMorphShape, ratio: float,
                       device=None, **kwargs) -> np.ndarray:
    stage = display.stage_for_morph_shape(tag, ratio)
    renderer = TorchRenderer(stage.width, stage.height, device=device,
                             **kwargs)
    return renderer.render(stage)
