"""Scene compiler: display tree -> flat draw list (edge tables + paints).

This replaces the reference's recursive Canvas2D drawing
(reference ts/src/lib/renderers/canvas-renderer.ts:80-145): instead of
issuing stateful context calls, the tree walk flattens the matrix stack and
produces, per styled path, a device-space edge table plus a resolved paint.
The draw list is order-preserving (painter's algorithm).

Canvas2D semantics preserved:

* global twips->px scale 1/20 applied before children
  (canvas-renderer.ts:74),
* ``lineWidth`` state machine: non-positive widths are ignored and the
  previous value (initially 1.0) persists — the reference inherits this
  Canvas2D quirk by assigning ``ctx.lineWidth`` directly
  (canvas-renderer.ts:255, 342),
* static strokes use Canvas defaults (butt cap, miter join, limit 10);
  morph strokes use round/round (canvas-renderer.ts:263-264).  Under
  honor_swf_caps (quality='flash'), v1-default round/round styles take
  the MEASURED player model butt/miter(3) instead (PERF.md round 4),
* morph paths lerp every coordinate, color and width by the ratio
  (canvas-renderer.ts:207-266).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..models import ast, display, ir
from ..models.decode_morph_shape import decode_morph_shape
from ..models.decode_shape import decode_shape
from ..models.geometry import (
    CURVE_TOLERANCE,
    Affine,
    TWIPS_PER_PX,
    clip_edges_rect,
    path_to_subpaths,
    deoverlap_edges,
    polygons_to_edges,
    stroke_subpath,
    subpaths_to_fill_edges,
)
from ..ops import style as style_ops
from ..ops.coverage import FILL_RULE_NONZERO
from .bitmap_service import BitmapService

# The reference renders missing bitmaps with this placeholder
# (canvas-renderer.ts:299-304).
PLACEHOLDER_COLOR = (0.2, 0.6, 0.8, 0.9)


def _border_subtraction_rings(dev_subpaths, half_w: float, clip_wh,
                              inset_factor: float = 1.0):
    """Flash-player border-stroke model (PERF.md round-2 border study):
    where a stroked path segment runs ALONG a stage border and its outer
    half falls off-stage, the player draws only the INNER half — the
    coverage boundary sits at the path position, not the clipped outer
    edge (measured: hb1 column 0 alpha 143 vs our full-stroke 255).

    Returns negative-winding rectangle rings (reverse of the de-overlap
    union orientation) that cancel the outer half along such stretches.
    Segment endpoints are inset by ``inset_factor * half_w`` so join/cap
    footprints at junctions keep the full stroke (the player shows alpha
    255 at the junction pixel).  The rects' outer bounds are off-stage by
    construction (only triggered when the stroke crosses the border), so
    any sub-pixel mismatch with the stroke outline is clipped away."""
    w, h = clip_wh
    eps = 1e-6
    inset = inset_factor * half_w
    rings = []

    def rect(xa, ya, xb, yb):
        pts = np.asarray([(xa, ya), (xa, yb), (xb, yb), (xb, ya)],
                         np.float32)
        closed = np.concatenate([pts, pts[:1]])
        return np.concatenate([closed[:-1], closed[1:]], axis=1)

    for pts in dev_subpaths:
        for i in range(len(pts) - 1):
            x0, y0 = pts[i]
            x1, y1 = pts[i + 1]
            if abs(x1 - x0) < eps and abs(y1 - y0) > eps:  # vertical
                x = float(x0)
                lo, hi = sorted((float(y0), float(y1)))
                lo, hi = lo + inset, hi - inset
                if hi <= lo:
                    continue
                if -eps <= x < half_w - eps:
                    rings.append(rect(x - half_w, lo, x, hi))
                elif w - half_w + eps < x <= w + eps:
                    rings.append(rect(x, lo, x + half_w, hi))
            elif abs(y1 - y0) < eps and abs(x1 - x0) > eps:  # horizontal
                y = float(y0)
                lo, hi = sorted((float(x0), float(x1)))
                lo, hi = lo + inset, hi - inset
                if hi <= lo:
                    continue
                if -eps <= y < half_w - eps:
                    rings.append(rect(lo, y - half_w, hi, y))
                elif h - half_w + eps < y <= h + eps:
                    rings.append(rect(lo, y, hi, y + half_w))
    return rings

_SPREAD_TO_INT = {
    ast.GradientSpread.PAD: style_ops.SPREAD_PAD,
    ast.GradientSpread.REFLECT: style_ops.SPREAD_REFLECT,
    ast.GradientSpread.REPEAT: style_ops.SPREAD_REPEAT,
}


@dataclasses.dataclass
class Draw:
    """One rasterization unit: a set of edges filled with one paint.

    ``mask_of``: this draw is part of mask group N's coverage (it is
    NOT painted).  ``mask_ids``: groups whose coverage multiplies this
    draw's coverage (outermost first; a mask draw nested inside another
    mask carries the outer ids).  Both empty on unmasked scenes."""

    edges: np.ndarray  # (E, 4) float32, device pixels
    paint: style_ops.Paint
    fill_rule: int = FILL_RULE_NONZERO
    mask_of: Optional[int] = None
    mask_ids: Tuple[int, ...] = ()


def build_mask_tree(draws: Sequence["Draw"]):
    """Parse a compiled draw list's group tags into a composition tree.

    Returns a list of items:

    - ``("draw", i)`` — paint layer i (source-over);
    - ``("mask", mask_idxs, items)`` — composite ``items`` separately,
      scale by the union coverage of ``mask_idxs``, alpha-over
      (group-level masking — Flash clips the composed group, not each
      member);
    - ``("blend", mode, items)`` — composite ``items`` separately, then
      combine with the backdrop via ops.composite.blend_premul.

    The compiler's path tokens (``("mask", gid)`` / ``("blend", gid,
    mode)`` in ``Draw.mask_ids``, mask coverage draws flagged by
    ``Draw.mask_of``) form a well-nested parenthesization in draw
    order; anything else raises."""

    def parse(items, path):
        d = len(path)
        out = []
        while items:
            li, mo, mids = items[0]
            if mids == path and mo is None:
                out.append(("draw", items.pop(0)[0]))
            elif mo is not None and mids == path:
                gid = mo
                mask_idxs = []
                while items and items[0][1] == gid and items[0][2] == path:
                    mask_idxs.append(items.pop(0)[0])
                inner = path + (("mask", gid),)
                content = []
                while items and items[0][2][: d + 1] == inner:
                    content.append(items.pop(0))
                out.append(("mask", mask_idxs, parse(content, inner)))
            elif (len(mids) > d and mids[:d] == path
                  and mids[d][0] in ("blend", "filter")):
                token = mids[d]
                inner = path + (token,)
                content = []
                while items and items[0][2][: d + 1] == inner:
                    content.append(items.pop(0))
                out.append((token[0], token[2], parse(content, inner)))
            else:
                raise ValueError(
                    f"non-well-nested group tags at layer {li}: "
                    f"mask_of={mo} mask_ids={mids} path={path}")
        return out

    infos = [(i, d.mask_of, tuple(d.mask_ids)) for i, d in enumerate(draws)]
    return parse(infos, ())


def lerp(a: float, b: float, t: float) -> float:
    return b * t + a * (1.0 - t)


def lerp_rgba(a, b, t: float):
    return tuple(lerp(x, y, t) for x, y in zip(a, b))


def lerp_morph_commands(
    commands: Sequence[ir.MorphCommand], ratio: float
) -> List[ir.Command]:
    """Interpolate a morph path's commands at ``ratio``
    (canvas-renderer.ts:214-239)."""
    out: List[ir.Command] = []
    for cmd in commands:
        if isinstance(cmd, ir.MorphMoveTo):
            out.append(
                ir.MoveTo(x=lerp(cmd.x[0], cmd.x[1], ratio),
                          y=lerp(cmd.y[0], cmd.y[1], ratio))
            )
        elif isinstance(cmd, ir.MorphLineTo):
            out.append(
                ir.LineTo(end_x=lerp(cmd.end_x[0], cmd.end_x[1], ratio),
                          end_y=lerp(cmd.end_y[0], cmd.end_y[1], ratio))
            )
        elif isinstance(cmd, ir.MorphCurveTo):
            out.append(
                ir.CurveTo(
                    control_x=lerp(cmd.control_x[0], cmd.control_x[1], ratio),
                    control_y=lerp(cmd.control_y[0], cmd.control_y[1], ratio),
                    end_x=lerp(cmd.end_x[0], cmd.end_x[1], ratio),
                    end_y=lerp(cmd.end_y[0], cmd.end_y[1], ratio),
                )
            )
        else:
            raise ValueError(f"UnexpectedMorphCommand: {cmd!r}")
    return out


@dataclasses.dataclass(frozen=True)
class _LerpedMatrix:
    """A float affine standing in for ast.Matrix inside ir fills (the
    lerp of two fixed-point SWF matrices is not representable in
    Sfixed16P16); Affine.from_swf_matrix only calls ``to_affine``."""

    affine: Tuple[float, float, float, float, float, float]

    def to_affine(self):
        return self.affine


def _lerp_matrix(a, b, t: float) -> _LerpedMatrix:
    return _LerpedMatrix(tuple(
        lerp(x, y, t) for x, y in zip(a.to_affine(), b.to_affine())))


def _lerp_extended_fill(fill: "ir.MorphExtendedFill",
                        t: float) -> ir.FillStyle:
    """Interpolate a [start, end] static-fill pair at ratio ``t`` —
    matrix components, gradient stop ratios/colors, and focal points
    lerp independently (the player's morph semantics for gradient and
    bitmap fills, the per-coordinate twin of lerp_morph_commands)."""
    s, e = fill.start, fill.end
    if isinstance(s, ir.BitmapFill):
        return dataclasses.replace(s, matrix=_lerp_matrix(s.matrix,
                                                          e.matrix, t))
    stops = tuple(
        ir.ColorStop(ratio=lerp(ss.ratio, es.ratio, t),
                     color=lerp_rgba(ss.color, es.color, t))
        for ss, es in zip(s.gradient.colors, e.gradient.colors))
    grad = dataclasses.replace(s.gradient, colors=stops)
    out = dataclasses.replace(s, matrix=_lerp_matrix(s.matrix, e.matrix, t),
                              gradient=grad)
    if isinstance(s, ir.FocalGradientFill):
        out = dataclasses.replace(
            out, focal_point=lerp(s.focal_point, e.focal_point, t))
    return out


def _apply_color_transform(color, ct: Optional[display.ColorTransform]):
    if ct is None:
        return color
    return tuple(
        min(max(c * m + a, 0.0), 1.0)
        for c, m, a in zip(color, ct.mult, ct.add)
    )


def _compose_color_transform(
    outer: Optional[display.ColorTransform],
    inner: Optional[display.ColorTransform],
) -> Optional[display.ColorTransform]:
    """Flash composes color transforms down the display tree: the effective
    transform applies the child first, then the parent —
    ``outer(inner(c)) = c * (mo*mi) + (mo*ai + ao)`` per channel."""
    if outer is None:
        return inner
    if inner is None:
        return outer
    return display.ColorTransform(
        mult=tuple(mo * mi for mo, mi in zip(outer.mult, inner.mult)),
        add=tuple(mo * ai + ao
                  for mo, ai, ao in zip(outer.mult, inner.add, outer.add)),
    )


class SceneCompiler:
    """Walks a display tree and emits the flat draw list."""

    def __init__(
        self,
        bitmaps: BitmapService,
        shape_cache: dict,
        morph_cache: dict,
        curve_tolerance: float = CURVE_TOLERANCE,
        curve_pow2: bool = False,
        honor_fill_winding: bool = False,
        honor_swf_caps: bool = False,
        clip: Optional[Tuple[float, float]] = None,
        draws_cache=None,
        border_inner_half: bool = False,
    ) -> None:
        """``honor_swf_caps``: use the SWF line styles' caps/joins (what the
        Flash player renders) instead of Canvas2D defaults (what the
        reference Canvas renderer does by ignoring them).

        ``clip``: exact stage extent (width, height) in pixels; draws are
        clipped to [0, w] x [0, h] (the Flash player clips at the exact —
        generally fractional — stage bounds).

        ``draws_cache``: optional runtime.cache.DrawListCache — memoizes
        each instance's compiled draw list by (definition, CTM, color
        transform, quality knobs), so re-rendering an unchanged stage does
        zero flatten/stroke/deoverlap work."""
        self.bitmaps = bitmaps
        self.shape_cache = shape_cache
        self.morph_cache = morph_cache
        self.curve_tolerance = curve_tolerance
        self.curve_pow2 = curve_pow2
        # SWF fill-rule semantics: even-odd by default, nonzero when the
        # DefineShape4 fill-winding flag is set.  The reference ignores
        # the flag (Canvas fill() is always nonzero,
        # canvas-renderer.ts:335), so this is opt-in; parity default off.
        self.honor_fill_winding = honor_fill_winding
        self.honor_swf_caps = honor_swf_caps
        self.clip = clip
        self.draws_cache = draws_cache
        # Player-measured inner-half stroke along stage borders
        # (quality='flash'; see _border_subtraction_rings).
        self.border_inner_half = border_inner_half
        self.draws: List[Draw] = []
        # Clip-group state (display.MaskedGroup): the group currently
        # being compiled as a MASK, the groups clipping the current
        # subtree, and the number of groups allocated so far.
        self._mask_target: Optional[int] = None
        self._active_masks: Tuple[int, ...] = ()
        self.mask_count = 0
        # Canvas2D context state: lineWidth starts at 1.0 (user-space units
        # = twips here) and ignores non-positive assignments.
        self.line_width_state = 1.0

    # -- public ------------------------------------------------------------

    def compile_stage(self, stage: display.Stage) -> List[Draw]:
        if self.clip is None and stage.exact_width is not None:
            self.clip = (stage.exact_width, stage.exact_height)
        base = Affine.scaling(1.0 / TWIPS_PER_PX, 1.0 / TWIPS_PER_PX)
        for child in stage.children:
            self._walk(child, base, None)
        return self.draws

    def _clip(self, edges: np.ndarray) -> np.ndarray:
        if self.clip is None or edges.shape[0] == 0:
            return edges
        return clip_edges_rect(edges, self.clip[0], self.clip[1])

    # -- tree walk ----------------------------------------------------------

    def _walk(self, obj: display.DisplayObject, ctm: Affine,
              ct: Optional[display.ColorTransform]) -> None:
        bm = getattr(obj, "blend_mode", None)
        if bm in ("alpha", "erase"):
            # Flash's layer-alpha modes rewrite the buffer they are
            # drawn INTO (alpha = soft mask, erase = alpha knockout).
            # They only act when an enclosing group composites
            # offscreen — the player documents "parent must be LAYER";
            # every token on our path (mask content, blend group,
            # filter group) IS an offscreen sub-composite.  With none,
            # the player draws nothing, and so do we.
            if not self._active_masks:
                return
            return self._walk_blend_group(obj, ctm, ct, bm)
        if bm is not None and bm not in ("normal", "layer"):
            # A blended object composes as a GROUP against the backdrop
            # (PlaceObject3 semantics): its draws carry a blend token and
            # the executors composite the group's planes with
            # ops.composite.blend_premul instead of source-over.
            from ..ops.composite import BLEND_MODES

            if bm not in BLEND_MODES:
                raise NotImplementedError(
                    f"NotImplementedBlendMode: {bm!r}")
            return self._walk_blend_group(obj, ctm, ct, bm)
        if bm == "layer" and self._needs_layer_buffer(obj):
            # "layer" composites its subtree offscreen first.  With
            # leaf-folded color transforms, source-over associativity
            # makes that unobservable — EXCEPT when the subtree carries
            # alpha/erase children that read the group buffer; only
            # then does the group materialize (mode "layer" =
            # source-over in ops.composite.blend_premul).
            return self._walk_blend_group(obj, ctm, ct, "layer")
        self._walk_filter(obj, ctm, ct)

    def _walk_blend_group(self, obj, ctm, ct, mode: str) -> None:
        gid = self.mask_count
        self.mask_count += 1
        prev = self._active_masks
        self._active_masks = prev + (("blend", gid, mode),)
        try:
            self._walk_filter(obj, ctm, ct)
        finally:
            self._active_masks = prev

    def _needs_layer_buffer(self, obj) -> bool:
        """Does this subtree contain an alpha/erase child that would
        read THIS object's layer buffer?  Children that composite their
        own offscreen group (non-normal blends incl. nested layers,
        filters, masked groups) shield their subtrees — alpha/erase
        under them targets their buffer, not this one."""
        for child in getattr(obj, "children", ()):
            bm = getattr(child, "blend_mode", None)
            if bm in ("alpha", "erase"):
                return True
            if bm not in (None, "normal") or getattr(child, "filters",
                                                     None):
                continue
            if isinstance(child, display.MaskedGroup):
                continue
            if self._needs_layer_buffer(child):
                return True
        return False

    def _walk_filter(self, obj: display.DisplayObject, ctm: Affine,
                     ct: Optional[display.ColorTransform]) -> None:
        filters = tuple(getattr(obj, "filters", None) or ())
        if filters:
            # Filters apply to the object's COMPOSED image, INSIDE any
            # blend against the backdrop (PlaceObject3 semantics).
            gid = self.mask_count
            self.mask_count += 1
            prev = self._active_masks
            self._active_masks = prev + (("filter", gid, filters),)
            try:
                self._walk_grouped(obj, ctm, ct)
            finally:
                self._active_masks = prev
            return
        self._walk_grouped(obj, ctm, ct)

    def _walk_grouped(self, obj: display.DisplayObject, ctm: Affine,
                      ct: Optional[display.ColorTransform]) -> None:
        if isinstance(obj, display.ScaleGridGroup):
            return self._walk_scale_grid(obj, ctm, ct)
        if obj.matrix is not None:
            ctm = ctm.then(Affine.from_swf_matrix(obj.matrix))
        if getattr(obj, "color_transform", None) is not None:
            ct = _compose_color_transform(ct, obj.color_transform)
        if isinstance(obj, display.Container):
            for child in obj.children:
                self._walk(child, ctm, ct)
        elif isinstance(obj, display.MaskedGroup):
            gid = self.mask_count
            self.mask_count += 1
            prev_target = self._mask_target
            # The mask's geometry is coverage-only: color transforms are
            # irrelevant to it, and it may itself be clipped by OUTER
            # groups (self._active_masks at this point excludes gid).
            self._mask_target = gid
            start = len(self.draws)
            self._walk(obj.mask, ctm, None)
            if len(self.draws) == start:
                # A mask that emitted no geometry still clips (to
                # nothing) — a zero-edge sentinel keeps the group
                # visible to build_mask_tree.
                self.draws.append(Draw(
                    edges=np.zeros((0, 4), np.float32),
                    paint=style_ops.solid_paint((1.0, 1.0, 1.0, 1.0)),
                    mask_of=gid, mask_ids=self._active_masks))
            self._mask_target = prev_target
            prev_active = self._active_masks
            self._active_masks = prev_active + (("mask", gid),)
            for child in obj.children:
                self._walk(child, ctm, ct)
            self._active_masks = prev_active
        elif isinstance(obj, display.ShapeInstance):
            self._draw_shape(obj.definition, ctm, ct)
        elif isinstance(obj, display.MorphShapeInstance):
            self._draw_morph_shape(obj.definition, obj.ratio, ctm, ct)
        else:
            raise ValueError("UnexpectedDisplayObjectType")

    # -- scale-9 (DefineScalingGrid) ----------------------------------------

    @staticmethod
    def _scale9_bands(lo: float, hi: float, glo: float, ghi: float,
                      s: float):
        """Per-axis scale-9 bands ``[(src_lo, src_hi, slope, offset)]`` of
        the piecewise-linear map f with f(lo) = s*lo and f(hi) = s*hi:
        the outer bands translate rigidly (slope 1 — corners keep their
        natural size) and the center band absorbs the scaling.  When the
        scaled extent is smaller than the two fixed bands, the center
        collapses to slope 0 and the corner bands COMPRESS equally so
        they meet instead of overlapping (slices must stay a partition
        of the output — the merge/compositing logic depends on it)."""
        fixed = (glo - lo) + (hi - ghi)
        total = s * (hi - lo)
        if total >= fixed:
            off_l = s * lo - lo
            off_r = s * hi - hi
            cs = (total - fixed) / (ghi - glo)
            off_c = (glo + off_l) - cs * glo
            return ((lo, glo, 1.0, off_l), (glo, ghi, cs, off_c),
                    (ghi, hi, 1.0, off_r))
        k = total / fixed if fixed > 0.0 else 0.0
        off_l = s * lo - k * lo
        off_r = s * hi - k * hi
        off_c = s * lo + k * (glo - lo)
        return ((lo, glo, k, off_l), (glo, ghi, 0.0, off_c),
                (ghi, hi, k, off_r))

    def _walk_scale_grid(self, obj, ctm: Affine,
                         ct: Optional[display.ColorTransform]) -> None:
        """Compile a display.ScaleGridGroup: nine per-slice walks, each
        under its own axis-aligned affine, box-clipped to its band in
        device space.  Slices partition the bounds, so their winding
        integrals ADD — same-solid-paint slices merge into one edge table
        (seam-exact); otherwise slices emit as separate draws (disjoint
        regions, so painter's order across slices is immaterial).

        The grid engages against the OBJECT's own matrix scale — outer
        transforms (stage zoom, ancestors) scale the whole sliced result,
        corners included.  Under rotation/skew anywhere on the chain the
        player ignores scale9Grid and so do we (plain Container walk)."""
        m = (Affine.from_swf_matrix(obj.matrix) if obj.matrix is not None
             else Affine.identity())
        if getattr(obj, "color_transform", None) is not None:
            ct = _compose_color_transform(ct, obj.color_transform)
        bx0, by0, bx1, by1 = obj.bounds
        gx0, gy0, gx1, gy1 = obj.grid
        gx0, gx1 = max(gx0, bx0), min(gx1, bx1)
        gy0, gy1 = max(gy0, by0), min(gy1, by1)
        plain = (m.b != 0.0 or m.c != 0.0 or m.a <= 0.0 or m.d <= 0.0
                 or ctm.b != 0.0 or ctm.c != 0.0
                 or ctm.a <= 0.0 or ctm.d <= 0.0
                 or gx1 <= gx0 or gy1 <= gy0)
        if plain:
            full = ctm.then(m)
            for child in obj.children:
                self._walk(child, full, ct)
            return
        bands_x = self._scale9_bands(bx0, bx1, gx0, gx1, m.a)
        bands_y = self._scale9_bands(by0, by1, gy0, gy1, m.d)
        groups_before = self.mask_count
        slices = []
        for sx0, sx1, ax, ox in bands_x:
            for sy0, sy1, ay, oy in bands_y:
                if sx1 <= sx0 or sy1 <= sy0:
                    continue
                ctm_s = ctm.then(Affine(a=ax, d=ay, e=ox + m.e,
                                        f=oy + m.f))
                # Device-space image of the source band (monotonic:
                # slopes and the outer scale are non-negative).
                dx0 = ctm.a * (ax * sx0 + ox + m.e) + ctm.e
                dx1 = ctm.a * (ax * sx1 + ox + m.e) + ctm.e
                dy0 = ctm.d * (ay * sy0 + oy + m.f) + ctm.f
                dy1 = ctm.d * (ay * sy1 + oy + m.f) + ctm.f
                start = len(self.draws)
                for child in obj.children:
                    self._walk(child, ctm_s, ct)
                emitted = self.draws[start:]
                del self.draws[start:]
                slices.append([
                    dataclasses.replace(d, edges=clip_edges_rect(
                        d.edges, dx1, dy1, xmin=dx0, ymin=dy0))
                    for d in emitted])
        has_groups = self.mask_count != groups_before
        parallel = (not has_groups and slices
                    and all(len(s) == len(slices[0]) for s in slices))
        if not parallel:
            # Group-bearing subtrees must keep each slice's draw order
            # contiguous (build_mask_tree well-nesting); slices are
            # spatially disjoint so slice-major order still composes
            # correctly.
            for sl in slices:
                self.draws.extend(sl)
            return
        for i in range(len(slices[0])):
            copies = [sl[i] for sl in slices]
            nonempty = [d for d in copies if d.edges.shape[0] > 0]
            if not nonempty:
                continue
            d0 = nonempty[0]
            mergeable = all(
                d.paint.kind == style_ops.PAINT_SOLID
                and d.paint.color == d0.paint.color
                and d.fill_rule == d0.fill_rule for d in nonempty)
            if mergeable and len(nonempty) > 1:
                self.draws.append(dataclasses.replace(
                    d0, edges=np.concatenate(
                        [d.edges for d in nonempty], axis=0)))
            else:
                self.draws.extend(nonempty)

    def _compiled_shape(self, tag: ast.DefineShape) -> ir.Shape:
        # Keyed by identity like the reference's WeakMap
        # (canvas-renderer.ts:51-58); the entry RETAINS the tag so a
        # garbage-collected tag's reused id() can never alias another
        # definition's compiled geometry.
        key = id(tag)
        hit = self.shape_cache.get(key)
        if hit is None or hit[0] is not tag:
            hit = (tag, decode_shape(tag))
            self.shape_cache[key] = hit
        return hit[1]

    def _compiled_morph_shape(self, tag: ast.DefineMorphShape) -> ir.MorphShape:
        key = id(tag)
        hit = self.morph_cache.get(key)
        if hit is None or hit[0] is not tag:
            hit = (tag, decode_morph_shape(tag))
            self.morph_cache[key] = hit
        return hit[1]

    def _cache_key(self, tag, ctm: Affine,
                   ct: Optional[display.ColorTransform], extra=()):
        # Everything the emitted geometry/paints depend on beyond the tag:
        # CTM, color transform, quality knobs, exact clip rect, and the
        # incoming Canvas2D lineWidth state (zero-width strokes inherit it).
        return (id(tag), ctm.as_tuple(), ct, self.curve_tolerance,
                self.curve_pow2, self.honor_swf_caps,
                self.honor_fill_winding, self.clip,
                self.border_inner_half,
                self.line_width_state) + tuple(extra)

    def _cached_draw(self, tag, ctm, ct, emit, extra=()):
        """Emit one instance's draws through the draws cache (replay the
        memoized list + restore the outgoing lineWidth state on a hit)."""
        if (self.draws_cache is None or self._mask_target is not None
                or self._active_masks):
            # Clip-group tags (mask_of / mask_ids) are per-SCENE indices —
            # memoized draw lists would replay stale tags, so masked
            # subtrees bypass the cache.
            emit()
            return
        key = self._cache_key(tag, ctm, ct, extra)
        hit = self.draws_cache.get(key, tag)
        if hit is not None:
            draws, out_state = hit
            self.draws.extend(draws)
            self.line_width_state = out_state
            return
        start = len(self.draws)
        emit()
        self.draws_cache.put(key, tag, self.draws[start:],
                             self.line_width_state)

    def _draw_shape(self, tag: ast.DefineShape, ctm: Affine,
                    ct: Optional[display.ColorTransform]) -> None:
        self._cached_draw(tag, ctm, ct,
                          lambda: self._draw_shape_uncached(tag, ctm, ct))

    def _draw_shape_uncached(self, tag: ast.DefineShape, ctm: Affine,
                             ct: Optional[display.ColorTransform]) -> None:
        compiled = self._compiled_shape(tag)
        if self.honor_fill_winding:
            from ..ops.coverage import FILL_RULE_EVENODD
            rule = (FILL_RULE_NONZERO if tag.has_fill_winding
                    else FILL_RULE_EVENODD)
        else:
            rule = FILL_RULE_NONZERO
        for path in compiled.paths:
            if path.fill is not None:
                self._emit_fill(path.commands, path.fill, ctm, ct,
                                fill_rule=rule)
            if path.line is not None:
                if self.honor_swf_caps:
                    cap = {"none": "butt"}.get(path.line.start_cap,
                                               path.line.start_cap)
                    join = path.line.join
                    ml = float(getattr(path.line, "miter_limit", 3.0))
                    if cap == "round" and join == "round":
                        # MEASURED player model (round-4 forensics,
                        # PERF.md): the v1 LINESTYLE nominal defaults in
                        # the ast are round/round, but the Flash golden's
                        # stroke junctions match BUTT caps + MITER joins
                        # (limit 3) exactly — sharp joins show the miter
                        # spike (hb1 (169,0) reaches past the stage edge),
                        # subpath ends show no cap footprint (hb1
                        # (419,12)/(420,13) lighten to the capless value).
                        # hb1 pm-max 130 -> 52 under this model.  Styles
                        # that DECLARE other caps/joins (LINESTYLE2) are
                        # honored as written.
                        cap, join, ml = "butt", "miter", 3.0
                else:
                    cap, join, ml = "butt", "miter", 10.0  # Canvas2D
                self._emit_stroke(
                    path.commands,
                    float(path.line.width),
                    path.line.fill,
                    ctm,
                    ct,
                    cap=cap,
                    join=join,
                    miter_limit=ml,
                )

    def _draw_morph_shape(self, tag: ast.DefineMorphShape, ratio: float,
                          ctm: Affine,
                          ct: Optional[display.ColorTransform]) -> None:
        self._cached_draw(
            tag, ctm, ct,
            lambda: self._draw_morph_shape_uncached(tag, ratio, ctm, ct),
            extra=(float(ratio),))

    def _draw_morph_shape_uncached(
            self, tag: ast.DefineMorphShape, ratio: float, ctm: Affine,
            ct: Optional[display.ColorTransform]) -> None:
        compiled = self._compiled_morph_shape(tag)
        for path in compiled.paths:
            commands = lerp_morph_commands(path.commands, ratio)
            if isinstance(path.fill, ir.MorphExtendedFill):
                # Framework extension: gradient/bitmap morph fills lerp
                # their static [start, end] pair (matrix components,
                # stop ratios/colors, focal point) at the draw ratio.
                self._emit_fill(commands,
                                _lerp_extended_fill(path.fill, ratio),
                                ctm, ct)
            elif path.fill is not None:
                color = lerp_rgba(path.fill.start_color, path.fill.end_color,
                                  ratio)
                self._emit_fill(commands, ir.SolidFill(color=color), ctm, ct)
            if path.line is not None:
                width = lerp(path.line.width[0], path.line.width[1], ratio)
                color = lerp_rgba(path.line.fill.start_color,
                                  path.line.fill.end_color, ratio)
                self._emit_stroke(
                    commands,
                    width,
                    ir.SolidFill(color=color),
                    ctm,
                    ct,
                    cap="round",
                    join="round",
                )

    # -- draw emission -------------------------------------------------------

    def _emit_fill(self, commands, fill: ir.FillStyle, ctm: Affine,
                   ct: Optional[display.ColorTransform],
                   fill_rule: int = FILL_RULE_NONZERO) -> None:
        subpaths = path_to_subpaths(commands, ctm, self.curve_tolerance,
                                    self.curve_pow2)
        edges = self._clip(subpaths_to_fill_edges(subpaths))
        if edges.shape[0] == 0:
            return
        paint = self._paint_for_fill(fill, ctm, ct)
        self.draws.append(Draw(edges=edges, paint=paint,
                               fill_rule=fill_rule,
                               mask_of=self._mask_target,
                               mask_ids=self._active_masks))

    def _emit_stroke(self, commands, width: float, fill: ir.FillStyle,
                     ctm: Affine, ct: Optional[display.ColorTransform],
                     cap: str, join: str,
                     miter_limit: float = 10.0) -> None:
        if self._mask_target is not None:
            # Flash masks are built from FILLS only; a mask shape's
            # strokes contribute no clip coverage.
            return
        if not isinstance(fill, ir.SolidFill):
            raise NotImplementedError(f"NotImplementedLineStyle: {fill!r}")
        # Stroke geometry is computed in user (twip) space — Canvas2D stroke
        # outlines are defined pre-CTM — then transformed to device space.
        scale = max(ctm.max_scale(), 1e-6)
        if width > 0:
            self.line_width_state = width
        if self.honor_swf_caps and width <= 0:
            # SWF width 0 is a HAIRLINE: the player draws it one device
            # pixel wide regardless of scale.  The Canvas reference instead
            # inherits the lineWidth state machine (0 ignored, previous
            # value persists) — that's the quality='canvas' branch below.
            area_scale = abs(ctm.a * ctm.d - ctm.b * ctm.c)
            effective_width = 1.0 / max(math.sqrt(area_scale), 1e-6)
        else:
            effective_width = self.line_width_state
        local_tol = self.curve_tolerance / scale
        subpaths = path_to_subpaths(commands, Affine.identity(), local_tol,
                                    self.curve_pow2)
        polys = []
        for pts in subpaths:
            polys.extend(
                stroke_subpath(pts, effective_width, cap=cap, join=join,
                               miter_limit=miter_limit,
                               tolerance=local_tol)
            )
        polys = [ctm.apply(poly) for poly in polys]
        # Stroke outlines self-overlap (crossing loops, inner joins);
        # reduce to the union boundary so the winding-integral rasterizer
        # doesn't conflate overlaps inside AA pixels (Cairo parity).
        edges = deoverlap_edges(polygons_to_edges(polys))
        if self.border_inner_half and self.clip is not None:
            half_w_dev = effective_width * scale / 2.0
            rings = _border_subtraction_rings(
                [ctm.apply(pts) for pts in subpaths], half_w_dev,
                self.clip)
            if rings:
                edges = np.concatenate([edges] + rings)
        edges = self._clip(edges)
        if edges.shape[0] == 0:
            return
        color = _apply_color_transform(fill.color, ct)
        self.draws.append(Draw(edges=edges,
                               paint=style_ops.solid_paint(color),
                               mask_ids=self._active_masks))

    def _paint_for_fill(self, fill: ir.FillStyle, ctm: Affine,
                        ct: Optional[display.ColorTransform]) -> style_ops.Paint:
        if isinstance(fill, ir.SolidFill):
            return style_ops.solid_paint(_apply_color_transform(fill.color, ct))
        if isinstance(fill, ir.BitmapFill):
            bitmap = self.bitmaps.try_get(fill.bitmap_id)
            if bitmap is None:
                raise KeyError(f"BitmapNotFound: {fill.bitmap_id}")
            if bitmap.rgba is None:
                return style_ops.solid_paint(
                    _apply_color_transform(PLACEHOLDER_COLOR, ct)
                )
            paint_to_device = ctm.then(Affine.from_swf_matrix(fill.matrix))
            return style_ops.Paint(
                kind=style_ops.PAINT_BITMAP,
                inv_matrix=paint_to_device.inverse().as_tuple(),
                image=bitmap.rgba,
                repeating=fill.repeating,
                smoothed=fill.smoothed,
                # No-repeat patterns are transparent outside the image in
                # BOTH targets: Canvas2D by definition
                # (canvas-renderer.ts:306-309) and the player by
                # measurement — the textured golden's edge alphas match
                # the fade exactly (max 2/255 with "canvas", 62 with
                # clamp-to-edge; PERF.md round 2).
                edge_mode="canvas",
            )
        if isinstance(fill, (ir.FocalGradientFill, ir.LinearGradientFill)):
            stops = fill.gradient.colors
            ratios = np.asarray([s.ratio for s in stops], dtype=np.float32)
            colors = np.asarray(
                [_apply_color_transform(s.color, ct) for s in stops],
                dtype=np.float32,
            )
            paint_to_device = ctm.then(Affine.from_swf_matrix(fill.matrix))
            kind = (
                style_ops.PAINT_FOCAL
                if isinstance(fill, ir.FocalGradientFill)
                else style_ops.PAINT_LINEAR
            )
            return style_ops.Paint(
                kind=kind,
                inv_matrix=paint_to_device.inverse().as_tuple(),
                stop_ratios=ratios,
                stop_colors=colors,
                focal_point=getattr(fill, "focal_point", 0.0),
                spread=_SPREAD_TO_INT[fill.gradient.spread],
                color_space=fill.gradient.color_space.value,
            )
        raise NotImplementedError(f"NotImplementedFillStyle: {fill!r}")
