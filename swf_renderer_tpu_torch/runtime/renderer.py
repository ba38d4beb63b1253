"""The renderer front-end: ``render(stage)`` / ``render_batch(stages)``.

Port of ``swf_renderer_tpu/runtime/renderer.py``: scene compilation ->
native lowering and packing -> one fused styled kernel launch per batch
-> u8 readback; a batch whose frames show the same definitions under
moving matrices, fading colour transforms or morph ratios compiles ONCE
to local-space pieces and renders through one sweep kernel launch
(``ops/transform.py``), so its host work does not grow with the frame
count.  Bitmap layers bake their per-frame field planes on the card
(``bake_sweep_fields``).  Repeated ``render(stage)`` calls over the same
definitions under moved matrices switch, from the second call on, to an
F = 1 sweep over pieces cached on the card (``last_stats.path ==
"transform-sweep-1f"``).

Draw lists deeper than one kernel pass chain passes on the card; clip
groups (``display.MaskedGroup``), blend modes and filters run the masked
program of premultiplied planes (``ops.pipeline.render_batch_styled``
with the scene's group tree).  Draw lists the fused kernel does not take
— ``backend="scanline"`` / ``"direct"``, ``quality="flash-pointaa"``,
``validate=True`` and frames wider than 8191 px — run the layered
backends: per-draw coverage planes (scanline scatter + prefix, 4x4
point sampling, or the direct coverage kernels), composited over each
draw's paint field, group by group where the scene has groups
(``_composite_masked``).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..models import ast, display
from ..models import ir as ir_mod
from ..models.geometry import CURVE_TOLERANCE, TWIPS_PER_PX, Affine
from ..ops import composite as composite_ops
from ..ops import style as style_ops
from ..ops.coverage import (
    FILL_RULE_NONZERO, coverage, normalize_fill_rule, split_pad_tables,
)
from ..utils.device import resolve_device
from .bitmap_service import BitmapService
from .scene import Draw, SceneCompiler

logger = logging.getLogger("swf_renderer_tpu_torch")


@dataclasses.dataclass
class RenderStats:
    """Per-frame observability: draw/edge counts, wall seconds and the
    execution path ("flatblock", "batched-styled", "transform-sweep",
    "transform-sweep-1f", "scanline", "direct", "pointaa", "empty" or
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


def _fractional_exact_clip(stage) -> bool:
    """True when the stage needs SUB-PIXEL exact clipping the on-device
    sweeps don't implement.  An exact extent equal to the integer raster
    clips nothing the raster crop doesn't; either axis set alone defaults
    the other to the raster size."""
    if stage.exact_width is None and stage.exact_height is None:
        return False
    ew = stage.width if stage.exact_width is None else stage.exact_width
    eh = stage.height if stage.exact_height is None else stage.exact_height
    return not (ew == stage.width and eh == stage.height)


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


def _device_affine(matrix):
    """SWF instance matrix (twips space) -> device-pixel affine:
    S . A . S^-1 with S = scale(1/20), so applying it to geometry already
    compiled at ctm = S equals compiling at ctm = S . A."""
    if matrix is None:
        return Affine.identity()
    s = Affine.scaling(1.0 / TWIPS_PER_PX, 1.0 / TWIPS_PER_PX)
    return s.then(Affine.from_swf_matrix(matrix)).then(
        Affine.scaling(TWIPS_PER_PX, TWIPS_PER_PX))


def _layer_mats(devs, per_child):
    """Per-(frame, leaf) affines -> (F, L, 6) f32, each leaf's matrix
    repeated for every layer (draw) it compiled to."""
    return np.asarray(
        [[m for ci, row_m in enumerate(row)
          for m in [row_m] * len(per_child[ci])]
         for row in devs], np.float32)


def _upload(array, device):
    return torch.from_numpy(
        np.ascontiguousarray(array, np.float32)).to(device)


class TorchRenderer:
    """Renders retained stages to RGBA frames on the card (or, with
    ``device="cpu"``, through the kernels' plain versions).  ``render``
    returns the frame as an (H, W, 4) uint8 array.

    backend: 'auto' | 'scanline' | 'direct'.  'auto' takes the fused
    kernel where it applies and scanline coverage elsewhere; 'scanline'
    lowers draws to pixel-cell lists and rasterizes them with scatter +
    prefix sum; 'direct' runs the direct coverage kernels.  quality:
    'canvas' (the reference TS renderer's strokes), 'flash' (the SWF line
    styles, finer curve flattening) or 'flash-pointaa' (also Flash's
    quality-high 4x4 point-sampled antialiasing).  validate: check every
    coverage plane for NaN/Inf and values outside [0, 1]."""

    def __init__(self, width: int, height: int, backend: str = "auto",
                 quality: str = "canvas", validate: bool = False,
                 honor_fill_winding: bool = False, device=None):
        if quality not in ("canvas", "flash", "flash-pointaa"):
            raise ValueError(f"unknown quality {quality!r}")
        if backend not in ("auto", "scanline", "direct"):
            raise ValueError(f"unknown backend {backend!r}")
        self.device = resolve_device(device)
        self.backend = backend
        self.validate = validate
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
        # Single-frame interactive sweep: after two consecutive render()
        # calls over the SAME definitions with moved matrices, further
        # frames ride an F = 1 sweep with cached local-space pieces (see
        # _render_frame_sweep).
        self._frame_sweep_state = None      # (key, state | None, defs)
        self._frame_sweep_candidate = None  # (key, mats_row, defs)
        self._render_lock = threading.RLock()

    # -- reference API ------------------------------------------------------

    def add_bitmap(self, tag: ast.DefineBitmap) -> None:
        self.bitmap_service.add_bitmap(tag)

    def _compiler(self, clip=None,
                  curve_tolerance=CURVE_TOLERANCE) -> SceneCompiler:
        flash_like = self.quality.startswith("flash")
        return SceneCompiler(
            self.bitmap_service, self._shape_cache, self._morph_cache,
            curve_tolerance=curve_tolerance,
            curve_pow2=flash_like,
            honor_swf_caps=flash_like,
            honor_fill_winding=self.honor_fill_winding,
            clip=clip,
            draws_cache=self._draws_cache,
        )

    def render(self, stage: display.Stage) -> np.ndarray:
        with self._render_lock:
            t0 = time.perf_counter()
            fast = self._render_frame_sweep(stage, t0)
            if fast is not None:
                return fast
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
        """Render a SEQUENCE of stages as one device batch: one sweep
        kernel launch when the frames show the same definitions and only
        matrices, colour transforms or morph ratios move; one fused
        kernel launch when every frame has the same layer structure;
        otherwise stage by stage, each through the fused kernel.  Returns
        (len(stages), H, W, 4) uint8."""
        with self._render_lock:
            return self._render_batch_locked(list(stages))

    def _render_batch_locked(self, stages) -> np.ndarray:
        t0 = time.perf_counter()
        if not stages:
            return np.zeros((0, self.height, self.width, 4), np.uint8)
        plan = self._transform_animation_plan(stages)
        if plan is not None:
            out = plan()
            if any(s.background_color.a != 0 for s in stages):
                out = _composite_background(
                    out, [s.background_color for s in stages])
            self.last_stats = RenderStats(
                draws=plan.draws, edges=plan.edges,
                width=self.width, height=self.height,
                seconds=time.perf_counter() - t0,
                path="transform-sweep",
            )
            return out
        per_frame_draws = [
            self._compiler(
                clip=((stage.exact_width, stage.exact_height)
                      if stage.exact_width is not None else None)
            ).compile_stage(stage)
            for stage in stages]
        reason = (None if not per_frame_draws[0]
                  else self._flatblock_refusal(per_frame_draws[0]))
        mask_tree = None
        if not _uniform_layer_structure(per_frame_draws):
            reason = "non-uniform layer structure across frames"
        elif any(d.mask_of is not None or d.mask_ids
                 for draws in per_frame_draws for d in draws):
            tags0 = [(d.mask_of, tuple(d.mask_ids))
                     for d in per_frame_draws[0]]
            if all([(d.mask_of, tuple(d.mask_ids)) for d in draws] == tags0
                   for draws in per_frame_draws[1:]):
                from .scene import build_mask_tree

                mask_tree = build_mask_tree(per_frame_draws[0])
            else:
                # The group structure changes across frames: stage by
                # stage, each through the masked program.
                reason = "non-uniform clip/blend groups across frames"
        if per_frame_draws[0] and reason is None:
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
                cache=self._packed_cache, mask_tree=mask_tree,
                device=self.device)
            path = "batched-styled"
        else:
            reason = reason or "empty draw list"
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

    # -- animation sweeps ---------------------------------------------------

    def _transform_animation_plan(self, stages):
        """Detect a moving-MATRIX animation: every frame shows the SAME
        shape/morph leaves (identical definitions) and only the instance
        matrices, colour transforms or morph ratios differ.  Such a batch
        renders fully on device through the transform sweep
        (ops/transform.py) — compile once, one kernel launch, O(edges)
        host work independent of frame count.  Returns a zero-arg closure
        that renders the batch, or None when the batch doesn't fit the
        pattern."""
        first = stages[0]
        if len(stages) < 2 or not first.children:
            return None
        # The sweep is an analytic-AA fused path: the explicit layered
        # choices (backend, validation, point-sampled AA) opt out of it.
        if self._layered_only():
            return None
        if any(_fractional_exact_clip(s) for s in stages):
            return None  # sub-pixel exact clipping isn't in the sweep
        if any(s.width != self.width or s.height != self.height
               for s in stages):
            return None
        leaves_per_stage = []
        for s in stages:
            leaves = self._stage_leaves(s)
            if leaves is None:
                return None
            leaves_per_stage.append(leaves)
        first_leaves = leaves_per_stage[0]
        if not first_leaves:
            return None
        n = len(first_leaves)
        any_differs = False
        ratio_varies = [False] * n
        for leaves in leaves_per_stage:
            if len(leaves) != n:
                return None
            for ci, ((c0, dev0, ct0), (c, dev, ct)) in enumerate(
                    zip(first_leaves, leaves)):
                if c.definition is not c0.definition:
                    return None
                if (isinstance(c, display.MorphShapeInstance)
                        and c.ratio != c0.ratio):
                    ratio_varies[ci] = True
                    any_differs = True
                if dev.as_tuple() != dev0.as_tuple() or ct != ct0:
                    any_differs = True
        if not any_differs:
            return None  # identical frames: the fused batch handles it
        if any(ratio_varies):
            return self._morph_transform_plan(stages, leaves_per_stage,
                                              ratio_varies)

        devs, s_aff, compiler = self._sweep_prelude(leaves_per_stage)
        # Compile each leaf ONCE with no color transform; per-frame cts
        # fold into per-frame kernel colors below (solid layers), into
        # static gradient stops (constant-ct gradient layers) or into
        # per-frame stops (fading gradient layers).
        gradient_kinds = (style_ops.PAINT_LINEAR, style_ops.PAINT_FOCAL)
        from .scene import _apply_color_transform

        child_draws = []
        dyn_children = set()  # children whose gradient stops fade
        for ci, (c, _dev, ct0) in enumerate(first_leaves):
            start = len(compiler.draws)
            if isinstance(c, display.MorphShapeInstance):
                compiler._draw_morph_shape(c.definition, c.ratio, s_aff,
                                           None)
            else:
                compiler._draw_shape(c.definition, s_aff, None)
            draws = compiler.draws[start:]
            if not draws:
                return None
            if any(d.paint.kind in gradient_kinds for d in draws):
                if any(leaves[ci][2] != ct0 for leaves in leaves_per_stage):
                    dyn_children.add(ci)
                elif ct0 is not None:
                    # Constant ct: fold into static stop colors — this
                    # matches compiling WITH the ct exactly
                    # (scene._paint_for_fill clamps per stop).
                    draws = [
                        d if d.paint.kind not in gradient_kinds else
                        dataclasses.replace(d, paint=dataclasses.replace(
                            d.paint, stop_colors=np.asarray(
                                [_apply_color_transform(tuple(sc), ct0)
                                 for sc in d.paint.stop_colors],
                                np.float32)))
                        for d in draws
                    ]
            child_draws.append(draws)
        all_draws = [d for draws in child_draws for d in draws]
        # Kernel layer order = all_draws order; mixed scenes pass one
        # rule per layer.
        sweep_rule = normalize_fill_rule(
            tuple(d.fill_rule for d in all_draws), len(all_draws))
        mats = _layer_mats(devs, child_draws)  # (F, L, 6)
        from ..ops.flatblock import KPAINT_FOCAL, KPAINT_LINEAR
        from ..ops.transform import sweep_paints

        try:
            kpaints, grad_mats, field_specs = sweep_paints(
                [d.paint for d in all_draws], mats, allow_fields=True)
        except ValueError:
            return None  # a layer under a singular frame matrix

        stop_colors = None
        dyn_layers = set()
        if dyn_children:
            # Dynamic stop colors override EVERY gradient layer, so
            # constant-ct gradient layers replicate their static stops.
            k_max = max(len(d.paint.stop_ratios) for d in all_draws
                        if d.paint.kind in gradient_kinds)
            stop_colors = np.zeros(
                (len(stages), len(all_draws), k_max, 4), np.float32)
            li = 0
            for ci, draws in enumerate(child_draws):
                for d in draws:
                    if d.paint.kind in gradient_kinds:
                        nk = len(d.paint.stop_ratios)
                        if ci in dyn_children:
                            dyn_layers.add(li)
                            for f, leaves in enumerate(leaves_per_stage):
                                stop_colors[f, li, :nk] = [
                                    _apply_color_transform(
                                        tuple(sc), leaves[ci][2])
                                    for sc in d.paint.stop_colors]
                        else:
                            stop_colors[:, li, :nk] = np.asarray(
                                d.paint.stop_colors, np.float32)
                    li += 1

        # Per-frame fades split by evaluation site: in-kernel gradient
        # layers read per-frame stop records; field-baked (linear-RGB)
        # gradient layers fold the fade into their baked planes.
        stop_tracks = None
        if field_specs and stop_colors is not None:
            stop_tracks = [
                (stop_colors[:, spec.layer, :len(spec.paint.stop_ratios)]
                 if spec.layer in dyn_layers else None)
                for spec in field_specs
            ]
            if all(t is None for t in stop_tracks):
                stop_tracks = None
        if stop_colors is not None and not any(
                kpaints[li].kind in (KPAINT_LINEAR, KPAINT_FOCAL)
                for li in dyn_layers):
            stop_colors = None  # no in-kernel layer consumes the stops

        def run():
            from ..ops.morph import morph_frames_to_u8
            from ..ops.transform import (
                affine_pieces, bake_sweep_fields, layer_piece_counts,
                render_affine_sweep,
            )

            colors = np.asarray(
                [[(_apply_color_transform(d.paint.color, ct)
                   if d.paint.kind == style_ops.PAINT_SOLID
                   else (0.0, 0.0, 0.0, 0.0))
                  for ci, (_c, _dev, ct) in enumerate(leaves)
                  for d in child_draws[ci]]
                 for leaves in leaves_per_stage], np.float32)  # (F, L, 4)
            tab, _ = affine_pieces(
                [d.edges for d in all_draws], [(0.0,) * 4] * len(all_draws),
                mats)
            fields = (bake_sweep_fields(field_specs, self.height,
                                        self.width, stop_tracks=stop_tracks,
                                        device=self.device)
                      if field_specs else None)
            dev = self.device
            out = render_affine_sweep(
                _upload(mats, dev), _upload(tab, dev), _upload(colors, dev),
                self.height, self.width, fill_rule=sweep_rule,
                paints=kpaints, layer_counts=layer_piece_counts(tab),
                grad_mats=(None if grad_mats is None
                           else _upload(grad_mats, dev)),
                stop_colors=(None if stop_colors is None
                             else _upload(stop_colors, dev)),
                fields=fields)
            return morph_frames_to_u8(out, self.height, self.width)

        run.draws = len(all_draws) * len(stages)
        run.edges = sum(d.edges.shape[0] for d in all_draws) * len(stages)
        return run

    def _stage_leaves(self, stage):
        """Flatten a display tree to its shape/morph LEAVES with effective
        (device affine, color transform) accumulated down container
        chains — animated sprite hierarchies then ride the sweeps like
        flat children.  Returns [(instance, Affine, ct)] or None when the
        tree holds an unsupported node type."""
        from .scene import _compose_color_transform

        s = Affine.scaling(1.0 / TWIPS_PER_PX, 1.0 / TWIPS_PER_PX)
        s_inv = Affine.scaling(TWIPS_PER_PX, TWIPS_PER_PX)
        leaves = []

        def walk(obj, chain, ct) -> bool:
            if getattr(obj, "blend_mode", None) not in (None, "normal",
                                                        "layer"):
                return False  # blend groups don't ride the sweeps
            if getattr(obj, "filters", None):
                return False  # filter groups don't ride the sweeps
            if obj.matrix is not None:
                chain = chain.then(Affine.from_swf_matrix(obj.matrix))
            ct = _compose_color_transform(ct, obj.color_transform)
            if isinstance(obj, display.Container):
                return all(walk(child, chain, ct)
                           for child in obj.children)
            if isinstance(obj, (display.ShapeInstance,
                                display.MorphShapeInstance)):
                leaves.append((obj, s.then(chain).then(s_inv), ct))
                return True
            return False  # unsupported node type

        for child in stage.children:
            if not walk(child, Affine.identity(), None):
                return None
        return leaves

    def _sweep_prelude(self, leaves_per_stage):
        """Shared setup of both sweep plans: per-(frame, leaf) device
        affines, the flattening tolerance that survives the most
        magnifying frame (exact spectral norm — translate/rotate-only
        animations keep smax == 1 so the sweep flattens curves at the
        SAME tolerance as per-frame renders), and ONE compiler across
        leaves (the lineWidth state threads through the whole display
        list, like compile_stage's walk)."""
        s_aff = Affine.scaling(1.0 / TWIPS_PER_PX, 1.0 / TWIPS_PER_PX)
        devs = []
        smax = 1.0
        for leaves in leaves_per_stage:
            row = []
            for _, dev, _ct in leaves:
                smax = max(smax, dev.norm2())
                row.append(dev.as_tuple())
            devs.append(row)
        return devs, s_aff, self._compiler(
            curve_tolerance=CURVE_TOLERANCE / smax)

    def _morph_transform_plan(self, stages, leaves_per_stage,
                              ratio_varies):
        """Ratio-varying timeline through the combined morph + transform
        sweep (ops.transform.render_morph_affine_sweep): every layer
        becomes a (start, end) piece pair — varying-ratio morph leaves
        contribute their real pairs (fills only; stroke outlines aren't
        linear in the ratio), static leaves contribute degenerate
        start==end pairs — and one shared per-frame ratio track lerps them
        all.  Returns a zero-arg render closure or None."""
        from ..models.morph_geometry import morph_fill_edge_pairs
        from .scene import _apply_color_transform

        first_leaves = leaves_per_stage[0]
        # One shared ratio track (the kernel lerps every layer by the
        # same per-frame t); constant color transforms (no per-frame
        # color folding on the morph path).
        tracks = set()
        for ci, varies in enumerate(ratio_varies):
            if varies:
                tracks.add(tuple(float(leaves[ci][0].ratio)
                                 for leaves in leaves_per_stage))
        if len(tracks) != 1:
            return None
        ratios = np.asarray(next(iter(tracks)), np.float32)
        for leaves in leaves_per_stage:
            for (_c0, _d0, ct0), (_c, _d, ct) in zip(first_leaves, leaves):
                if ct != ct0:
                    return None

        def ct_saturates(color, ct):
            """The per-frame path CLAMPS after lerping, the sweep lerps
            clamped endpoints; the two agree only when the transform
            keeps both endpoints inside [0, 1]."""
            if ct is None:
                return False
            return any(not (-1e-9 <= ch * m + a <= 1.0 + 1e-9)
                       for ch, m, a in zip(color, ct.mult, ct.add))

        devs, s_aff, compiler = self._sweep_prelude(leaves_per_stage)
        child_pairs = []
        pair_rules = []  # one rule per pair, in kernel layer order
        for ci, (c, _dev, ct) in enumerate(first_leaves):
            if ratio_varies[ci]:
                compiled = compiler._compiled_morph_shape(c.definition)
                if any(p.line is not None for p in compiled.paths):
                    return None  # stroke outlines aren't linear in ratio
                if any(p.fill is not None
                       and not isinstance(p.fill, ir_mod.MorphSolidFill)
                       for p in compiled.paths):
                    # Extended (gradient/bitmap) morph fills lerp paints
                    # per frame — not expressible as the sweep's color
                    # pair; render per frame.
                    return None
                raw = morph_fill_edge_pairs(
                    compiled, s_aff, tolerance=compiler.curve_tolerance)
                if not raw or any(
                        ct_saturates(cs, ct) or ct_saturates(ce, ct)
                        for _, _, cs, ce in raw):
                    return None
                pairs = [
                    (es, ee,
                     _apply_color_transform(cs, ct),
                     _apply_color_transform(ce, ct))
                    for es, ee, cs, ce in raw
                ]
                # Morph fills compile with the default nonzero rule
                # (scene._emit_fill).
                pair_rules.extend([FILL_RULE_NONZERO] * len(pairs))
            else:
                start = len(compiler.draws)
                if isinstance(c, display.MorphShapeInstance):
                    compiler._draw_morph_shape(c.definition, c.ratio,
                                               s_aff, ct)
                else:
                    compiler._draw_shape(c.definition, s_aff, ct)
                draws = compiler.draws[start:]
                if not draws or any(
                        d.paint.kind != style_ops.PAINT_SOLID
                        for d in draws):
                    return None
                pairs = [(d.edges, d.edges, d.paint.color, d.paint.color)
                         for d in draws]
                pair_rules.extend(d.fill_rule for d in draws)
            child_pairs.append(pairs)
        all_pairs = [p for pairs in child_pairs for p in pairs]
        fill_rule = normalize_fill_rule(tuple(pair_rules), len(all_pairs))

        def run():
            from ..ops.morph import morph_frames_to_u8
            from ..ops.transform import (
                layer_piece_counts, morph_affine_pieces,
                render_morph_affine_sweep,
            )

            mats = _layer_mats(devs, child_pairs)  # (F, L, 6)
            tab_s, tab_e, colors_s, colors_e = morph_affine_pieces(
                all_pairs, mats)
            dev = self.device
            out = render_morph_affine_sweep(
                _upload(mats, dev), _upload(ratios, dev),
                _upload(tab_s, dev), _upload(tab_e, dev),
                _upload(colors_s, dev), _upload(colors_e, dev),
                self.height, self.width, fill_rule=fill_rule,
                # a piece may be degenerate at one ratio endpoint only:
                # count whichever table keeps it real
                layer_counts=tuple(
                    max(a, b) for a, b in zip(layer_piece_counts(tab_s),
                                              layer_piece_counts(tab_e))))
            return morph_frames_to_u8(out, self.height, self.width)

        run.draws = len(all_pairs) * len(stages)
        run.edges = sum(np.asarray(p[0]).shape[0]
                        for p in all_pairs) * len(stages)
        return run

    # -- single-frame interactive sweep -------------------------------------

    def _frame_sweep_gates(self, stage) -> bool:
        return not (self._layered_only() or _fractional_exact_clip(stage)
                    or stage.width != self.width
                    or stage.height != self.height)

    def _render_frame_sweep(self, stage, t0):
        """Interactive novel-matrix render(): once two consecutive calls
        draw the SAME definitions under moved matrices, further frames
        rasterize through an F = 1 affine sweep over local-space pieces
        kept on the card — per-frame host work drops to an O(edges)
        split-validity check.  Returns the frame, or None for the normal
        path.  Cached pieces carry 1.5x split/tolerance headroom, so
        zooming within it revalidates without re-splitting; beyond it the
        state rebuilds monotonically."""
        if not self._frame_sweep_gates(stage):
            return None
        leaves = self._stage_leaves(stage)
        if not leaves:
            return None
        key = tuple(
            (id(c.definition),
             float(c.ratio) if isinstance(c, display.MorphShapeInstance)
             else None)
            for c, _dev, _ct in leaves)
        mats_row = tuple(dev.as_tuple() for _c, dev, _ct in leaves)
        state = self._frame_sweep_state
        if state is not None and state[0] == key:
            if state[1] is None:
                return None  # known-unsweepable definitions
            return self._run_frame_sweep(state[1], stage, leaves, t0)
        cand = self._frame_sweep_candidate
        if cand is not None and cand[0] == key and cand[1] != mats_row:
            built = self._build_frame_sweep_state(key, leaves)
            # The definitions stay pinned EVEN when the build fails (None):
            # the id()-based key must never alias a new object after the
            # originals are collected.
            self._frame_sweep_state = (
                key, built, [c.definition for c, _d, _ct in leaves])
            if built is not None:
                return self._run_frame_sweep(built, stage, leaves, t0)
            return None
        self._frame_sweep_candidate = (
            key, mats_row, [c.definition for c, _d, _ct in leaves])
        return None

    def _build_frame_sweep_state(self, key, leaves, smax_hint=None):
        """Compile the leaves ONCE in local space and split their edge
        tables into a matrix-validated piece cache (margin 1.5), uploaded
        to the card."""
        from ..ops.transform import (
            affine_pieces, layer_piece_counts, sweep_paints,
        )

        gradient_kinds = (style_ops.PAINT_LINEAR, style_ops.PAINT_FOCAL)
        # Flatten at the CURRENT scale as _sweep_prelude does; a zoom-past
        # rebuild brings a 1.5x-escalated hint so rebuilds stay rare.
        smax = max(1.0, max(dev.norm2() for _c, dev, _ct in leaves))
        smax = max(smax, (smax_hint or 0.0) * 1.5)
        s_aff = Affine.scaling(1.0 / TWIPS_PER_PX, 1.0 / TWIPS_PER_PX)
        compiler = self._compiler(curve_tolerance=CURVE_TOLERANCE / smax)
        child_counts = []
        try:
            for c, _dev, _ct in leaves:
                start = len(compiler.draws)
                if isinstance(c, display.MorphShapeInstance):
                    compiler._draw_morph_shape(c.definition, c.ratio,
                                               s_aff, None)
                else:
                    compiler._draw_shape(c.definition, s_aff, None)
                child_counts.append(len(compiler.draws) - start)
        except (KeyError, NotImplementedError):
            return None  # missing bitmap / unsupported fill
        draws = compiler.draws
        sweep_kinds = gradient_kinds + (style_ops.PAINT_SOLID,
                                        style_ops.PAINT_BITMAP)
        if not draws or any(d.paint.kind not in sweep_kinds
                            for d in draws):
            return None
        # The reference's layer-size gate (its per-layer VMEM
        # accumulators), kept so both packages take the same route for
        # the same call sequence.
        hp = -(-self.height // 128) * 128
        wblock = 256 if hp <= 640 else 128
        if len(draws) > 16 or len(draws) * wblock * hp * 4 > 8 * 2**20:
            return None
        mats0 = self._frame_sweep_mats(leaves, child_counts)
        try:
            sweep_paints([d.paint for d in draws], mats0, allow_fields=True)
        except ValueError:
            return None  # singular frame matrix
        # Split straight to the closed-form rotation bound: |dy'| of an
        # edge under ANY rotation at scale <= smax is at most smax *
        # hypot(dx, dy), so a spin keeps one piece table.
        edge_vecs = []
        for d in draws:
            e = np.asarray(d.edges, np.float64)
            edge_vecs.append((e[:, 2] - e[:, 0], e[:, 3] - e[:, 1]))
        mins = [np.maximum(np.ceil(smax * 1.05 * np.hypot(dx, dy)),
                           1.0).astype(int)
                for dx, dy in edge_vecs]
        tab, _colors, splits = affine_pieces(
            [d.edges for d in draws], [(0.0,) * 4] * len(draws), mats0,
            split_margin=1.5, min_splits=mins, return_splits=True)
        k_max = max((len(d.paint.stop_ratios) for d in draws
                     if d.paint.kind in gradient_kinds), default=0)
        return {
            "key": key,
            "smax": smax,
            "defs": [c.definition for c, _d, _ct in leaves],  # pin ids
            "draws": draws,
            "child_counts": child_counts,
            "rule": normalize_fill_rule(
                tuple(d.fill_rule for d in draws), len(draws)),
            "tab": _upload(tab, self.device),
            "layer_counts": layer_piece_counts(tab),
            "splits": splits,
            "edge_vecs": edge_vecs,
            "k_max": k_max,
        }

    @staticmethod
    def _frame_sweep_mats(leaves, child_counts):
        """(1, L, 6) per-layer device affines (children replicated over
        their draw counts)."""
        return np.asarray(
            [[m for ci, (_c, dev, _ct) in enumerate(leaves)
              for m in [dev.as_tuple()] * child_counts[ci]]],
            np.float32)

    def _run_frame_sweep(self, state, stage, leaves, t0):
        from ..ops.flatblock import KPAINT_FOCAL, KPAINT_LINEAR
        from ..ops.morph import morph_frames_to_u8
        from ..ops.transform import (
            affine_pieces, bake_sweep_fields, layer_piece_counts,
            render_affine_sweep, sweep_paints,
        )
        from .scene import _apply_color_transform

        gradient_kinds = (style_ops.PAINT_LINEAR, style_ops.PAINT_FOCAL)
        smax_now = max(dev.norm2() for _c, dev, _ct in leaves)
        # 0.1% slack: Sfixed16P16-quantized rotations jitter norm2 by
        # float epsilons from frame to frame.
        if smax_now > state["smax"] * 1.001:
            # Zoomed past the compiled flatten tolerance: rebuild with the
            # new bound (monotone — the margin keeps this rare).
            state = self._build_frame_sweep_state(
                state["key"], leaves, smax_hint=smax_now)
            self._frame_sweep_state = (
                self._frame_sweep_state[0], state,
                [c.definition for c, _d, _ct in leaves])
            if state is None:
                return None
        draws = state["draws"]
        mats = self._frame_sweep_mats(leaves, state["child_counts"])
        # Per-edge split validity: piece |dy'| stays <= 1 iff each edge's
        # |b dx + d dy| stays within its stored split count.
        for li, (dx, dy) in enumerate(state["edge_vecs"]):
            b, d = float(mats[0, li, 1]), float(mats[0, li, 3])
            if dx.size and (np.abs(b * dx + d * dy)
                            > state["splits"][li] + 1e-9).any():
                # Jump straight to the full-rotation bound at this scale,
                # so a continuous spin re-splits exactly once.
                mins = []
                for lj, (dxj, dyj) in enumerate(state["edge_vecs"]):
                    rot_bound = (np.hypot(float(mats[0, lj, 1]),
                                          float(mats[0, lj, 3]))
                                 * np.hypot(dxj, dyj) * 1.05)
                    tgt = np.maximum(np.ceil(rot_bound), 1.0).astype(int)
                    mins.append(np.maximum(tgt, state["splits"][lj]))
                tab, _c2, splits = affine_pieces(
                    [dd.edges for dd in draws], [(0.0,) * 4] * len(draws),
                    mats, min_splits=mins, return_splits=True)
                state["tab"] = _upload(tab, self.device)
                state["splits"] = splits
                state["layer_counts"] = layer_piece_counts(tab)
                break
        try:
            kpaints, grad_mats, field_specs = sweep_paints(
                [d.paint for d in draws], mats, allow_fields=True)
        except ValueError:
            return None  # singular matrix this frame: normal path
        # Per-layer colour transforms: solids through (1, L, 4) colours,
        # in-kernel gradients through the (1, L, K, 4) stop window,
        # linear-RGB field layers through the bake's stop track; bitmap
        # fills ignore colour transforms (scene._paint_for_fill).
        colors = np.zeros((1, len(draws), 4), np.float32)
        stop_colors = (np.zeros((1, len(draws), state["k_max"], 4),
                                np.float32) if state["k_max"] else None)
        ct_by_layer = []
        li = 0
        for ci, (_c, _dev, ct) in enumerate(leaves):
            for _ in range(state["child_counts"][ci]):
                d = draws[li]
                ct_by_layer.append(ct)
                if d.paint.kind == style_ops.PAINT_SOLID:
                    colors[0, li] = _apply_color_transform(
                        d.paint.color, ct)
                elif d.paint.kind in gradient_kinds:
                    nk = len(d.paint.stop_ratios)
                    stop_colors[0, li, :nk] = (
                        [_apply_color_transform(tuple(sc), ct)
                         for sc in d.paint.stop_colors] if ct is not None
                        else np.asarray(d.paint.stop_colors, np.float32))
                li += 1
        stop_tracks = None
        if field_specs:
            stop_tracks = [
                np.asarray([[_apply_color_transform(tuple(sc),
                                                    ct_by_layer[spec.layer])
                             for sc in spec.paint.stop_colors]], np.float32)
                if (spec.paint.kind in gradient_kinds
                    and ct_by_layer[spec.layer] is not None) else None
                for spec in field_specs]
            if all(t is None for t in stop_tracks):
                stop_tracks = None
        # The stop window only when an in-kernel gradient layer reads it.
        if stop_colors is not None and not any(
                kp.kind in (KPAINT_LINEAR, KPAINT_FOCAL) for kp in kpaints):
            stop_colors = None
        dev = self.device
        fields = (bake_sweep_fields(field_specs, self.height, self.width,
                                    stop_tracks=stop_tracks, device=dev)
                  if field_specs else None)
        out = render_affine_sweep(
            _upload(mats, dev), state["tab"], _upload(colors, dev),
            self.height, self.width, fill_rule=state["rule"],
            paints=kpaints, layer_counts=state["layer_counts"],
            grad_mats=None if grad_mats is None else _upload(grad_mats, dev),
            stop_colors=(None if stop_colors is None
                         else _upload(stop_colors, dev)),
            fields=fields)
        frame = morph_frames_to_u8(out, self.height, self.width)[0]
        self.frame = _composite_background(frame, stage.background_color)
        self.last_stats = RenderStats(
            draws=len(draws),
            edges=sum(d.edges.shape[0] for d in draws),
            width=self.width, height=self.height,
            seconds=time.perf_counter() - t0,
            path="transform-sweep-1f",
        )
        return self.frame

    # -- execution ----------------------------------------------------------

    def _layered_only(self) -> bool:
        """An explicit choice of the layered backends: a legacy backend,
        coverage validation or point-sampled AA."""
        return (self.backend in ("scanline", "direct") or self.validate
                or self.quality == "flash-pointaa")

    def _use_scanline(self) -> bool:
        # 'auto' prefers scanline coverage: the native cell splitter is
        # part of this package (the reference checks that it loaded).
        return self.backend != "direct"

    def _flatblock_refusal(self, draws: List[Draw]) -> Optional[str]:
        """Why the fused kernel can't run this draw list (None when it
        can): the layered backends take over for an explicit backend,
        point-sampled AA, coverage validation, or a frame stride beyond
        the chunk-major layout."""
        if self.backend in ("scanline", "direct"):
            return f"explicit backend={self.backend!r}"
        if self.quality == "flash-pointaa":
            return "point-sampled AA quality"
        if self.validate:
            return "validate=True inspects raw coverage"
        from ..ops.flatblock import LANE, MAX_CHUNKS, plane_geometry

        stride, _, _ = plane_geometry(self.height, self.width)
        if stride > MAX_CHUNKS * LANE:
            return f"width stride {stride} > {MAX_CHUNKS * LANE}"
        return None

    def execute(self, draws: List[Draw]) -> np.ndarray:
        """One compiled draw list -> (H, W, 4) u8: through the fused
        styled kernel (the masked program where the list has groups), or
        the layered backends when it refuses."""
        from ..ops.pipeline import render_batch_styled
        from .scene import build_mask_tree

        h, w = self.height, self.width
        if not draws:
            self._exec_path = "empty"
            return np.zeros((h, w, 4), dtype=np.uint8)
        grouped = any(d.mask_of is not None or d.mask_ids for d in draws)
        fill_rules = sorted({d.fill_rule for d in draws})
        rule = (fill_rules[0] if len(fill_rules) == 1
                else tuple(d.fill_rule for d in draws))
        refusal = self._flatblock_refusal(draws)
        if refusal is None:
            self._exec_path = "flatblock"
            return render_batch_styled(
                [[d.edges for d in draws]], [d.paint for d in draws], h, w,
                fill_rule=rule, cache=self._packed_cache,
                mask_tree=build_mask_tree(draws) if grouped else None,
                device=self.device)[0]
        logger.debug("fused path unavailable: %s", refusal)
        if self.quality == "flash-pointaa":
            self._exec_path = "pointaa"
            coverages = self._coverage_points(draws, rule)
        elif self._use_scanline():
            self._exec_path = "scanline"
            coverages = self._coverage_scanline(draws, rule)
        else:
            self._exec_path = "direct"
            coverages = self._coverage_direct(draws)
        if self.validate:
            if not bool(torch.isfinite(coverages).all()):
                raise FloatingPointError("coverage contains NaN/Inf")
            lo, hi = float(coverages.min()), float(coverages.max())
            if lo < -1e-4 or hi > 1.0 + 1e-4:
                raise FloatingPointError(
                    f"coverage out of range [{lo}, {hi}]")
        if grouped:
            return self._composite_masked(draws, coverages)
        colors = torch.stack([style_ops.paint_field(d.paint, h, w,
                                                    device=self.device)
                              for d in draws])
        return composite_ops.composite_to_u8(coverages, colors)

    def _composite_masked(self, draws: List[Draw], coverages) -> np.ndarray:
        """Group-level composite of the layered backends: each clip
        group's content composites SEPARATELY, scales by the mask's union
        coverage (source-over of unit-alpha fills, 1 - prod(1 - c)) and
        goes over the accumulator — Flash clips the composed group, not
        each member; blend groups go through blend_premul and filter
        groups through ops.filters — the fused route's semantics."""
        from .scene import build_mask_tree

        h, w = self.height, self.width

        def exec_items(items):
            acc = torch.zeros((h, w, 4), dtype=torch.float32,
                              device=coverages.device)
            for item in items:
                if item[0] == "draw":
                    i = item[1]
                    color = style_ops.paint_field(draws[i].paint, h, w,
                                                  device=self.device)
                    acc = composite_ops.over_premul(acc, color,
                                                    coverages[i])
                elif item[0] == "mask":
                    _, mask_idxs, content_items = item
                    mask_a = torch.zeros((h, w), dtype=torch.float32,
                                         device=coverages.device)
                    for i in mask_idxs:
                        mask_a = (mask_a + coverages[i]
                                  - mask_a * coverages[i])
                    content = exec_items(content_items)
                    scaled = content * mask_a[..., None]
                    acc = scaled + acc * (1.0 - scaled[..., 3:4])
                elif item[0] == "blend":
                    _, mode, content_items = item
                    content = exec_items(content_items)
                    acc = composite_ops.blend_premul(acc, content, mode)
                else:
                    from ..ops.filters import apply_filters

                    _, filters, content_items = item
                    content = apply_filters(exec_items(content_items),
                                            filters)
                    acc = content + acc * (1.0 - content[..., 3:4])
            return acc

        return composite_ops.premul_to_straight_u8(
            exec_items(build_mask_tree(draws)))

    def _coverage_scanline(self, draws: List[Draw], fill_rule):
        from ..native.bindings import cells_split_native
        from ..ops import scanline as scanline_ops

        cells = [cells_split_native(d.edges, self.height, self.width)
                 for d in draws]
        return scanline_ops.coverage_scanline(
            *scanline_ops.pack_cells(cells), self.height, self.width,
            fill_rule, device=self.device)

    def _coverage_points(self, draws: List[Draw], fill_rule, ss: int = 4):
        """Flash quality-high antialiasing: 4x4 point-sampled winding."""
        from ..ops import scanline as scanline_ops

        cells = [scanline_ops.edges_to_point_cells(d.edges, self.height,
                                                   self.width, ss)
                 for d in draws]
        count = max(1, max(r.shape[0] for r, _, _ in cells))
        n = ((count + 511) // 512) * 512
        rows = np.zeros((len(cells), n), np.int32)
        cols = np.zeros((len(cells), n), np.int32)
        delta = np.zeros((len(cells), n), np.float32)
        for i, (r, c, d) in enumerate(cells):
            k = r.shape[0]
            rows[i, :k] = r
            cols[i, :k] = np.minimum(c, self.width * ss)
            delta[i, :k] = d
        return scanline_ops.coverage_scanline_points(
            rows, cols, delta, self.height, self.width, fill_rule, ss,
            device=self.device)

    def _coverage_direct(self, draws: List[Draw]):
        """The direct coverage kernels over every draw's edges."""
        h, w = self.height, self.width
        edges_t = torch.from_numpy(split_pad_tables(
            [d.edges for d in draws])).to(self.device)
        fill_rules = {d.fill_rule for d in draws}
        if len(fill_rules) == 1:
            return coverage(edges_t, h, w, fill_rule=fill_rules.pop())
        return torch.cat([coverage(edges_t[i:i + 1], h, w,
                                   fill_rule=d.fill_rule)
                          for i, d in enumerate(draws)])


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


def render_shape_animation(tag: ast.DefineShape, matrices, width: int,
                           height: int, quality: str = "canvas",
                           bitmaps: Optional[List[ast.DefineBitmap]] = None,
                           bitmap_service: Optional[BitmapService] = None,
                           device=None) -> np.ndarray:
    """Animate ONE shape under per-frame matrices, fully on device: the
    shape compiles ONCE to local-space edge pieces, every frame's affine
    applies in the sweep kernel, and the whole animation rasterizes in
    one launch — host work is O(edges), independent of frame count.

    ``matrices``: sequence of ast.Matrix (SWF twips transforms) or an
    (F, 6) array of device-space affines.  Solid fills/strokes and sRGB
    linear/focal gradient fills evaluate in-kernel under each frame's
    composed matrix; bitmap fills (register them through ``bitmaps``, or
    pass an existing ``bitmap_service``) and linear-RGB gradients bake
    per-frame field planes on device (ops.transform.bake_sweep_fields).
    Returns (F, H, W, 4) uint8."""
    from ..ops.morph import morph_frames_to_u8
    from ..ops.transform import (
        affine_pieces, bake_sweep_fields, layer_piece_counts,
        render_affine_sweep, sweep_paints,
    )

    device = resolve_device(device)
    s = Affine.scaling(1.0 / TWIPS_PER_PX, 1.0 / TWIPS_PER_PX)
    if len(matrices) and isinstance(matrices[0], ast.Matrix):
        devs = [_device_affine(m) for m in matrices]
        mats = np.asarray([m.as_tuple() for m in devs], np.float32)
        smax = max(m.norm2() for m in devs)
    else:
        mats = np.asarray(matrices, np.float32)
        smax = max(
            1e-6,
            max(Affine(*m).norm2() for m in np.asarray(mats, float)))

    flash_like = quality.startswith("flash")
    service = bitmap_service if bitmap_service is not None else BitmapService()
    for bmp in bitmaps or []:
        service.add_bitmap(bmp)
    compiler = SceneCompiler(
        service, {}, {},
        # Flatten in LOCAL space at a tolerance that holds after the most
        # magnifying frame transform.
        curve_tolerance=CURVE_TOLERANCE / max(1.0, smax),
        curve_pow2=flash_like,
        honor_swf_caps=flash_like,
    )
    compiler._draw_shape(tag, s, None)
    draws = compiler.draws
    if not draws:
        return np.zeros((len(mats), height, width, 4), np.uint8)
    try:
        kpaints, grad_mats, field_specs = sweep_paints(
            [d.paint for d in draws], mats, allow_fields=True)
    except ValueError as exc:
        raise NotImplementedError(
            "render_shape_animation needs invertible frame matrices; "
            f"render degenerate frames via render_batch ({exc})") from exc
    rule = normalize_fill_rule(tuple(d.fill_rule for d in draws),
                               len(draws))
    piece_colors = [
        d.paint.color if d.paint.kind == style_ops.PAINT_SOLID
        else (0.0, 0.0, 0.0, 0.0) for d in draws]
    tab, colors = affine_pieces([d.edges for d in draws], piece_colors, mats)
    fields = (bake_sweep_fields(field_specs, height, width, device=device)
              if field_specs else None)
    out = render_affine_sweep(
        _upload(mats, device), _upload(tab, device), _upload(colors, device),
        height, width, fill_rule=rule, paints=kpaints,
        layer_counts=layer_piece_counts(tab),
        grad_mats=None if grad_mats is None else _upload(grad_mats, device),
        fields=fields)
    return morph_frames_to_u8(out, height, width)


def render_shape_tag_to_png(ast_path: str, out_path: str,
                            device=None) -> np.ndarray:
    """ast.json of a DefineShape (or a DefineMorphShape, at ratio 0) ->
    its frame, written to ``out_path`` as a PNG; returns the (H, W, 4)
    uint8 frame.  Renders on the card unless ``device="cpu"``."""
    from ..models.ast_io import load_tag
    from ..utils.png import write_png

    tag = load_tag(ast_path)
    if isinstance(tag, ast.DefineShape):
        frame = render_shape(tag, device=device)
    elif isinstance(tag, ast.DefineMorphShape):
        frame = render_morph_shape(tag, 0.0, device=device)
    else:
        raise ValueError(f"cannot render tag: {tag!r}")
    write_png(out_path, frame)
    return frame
