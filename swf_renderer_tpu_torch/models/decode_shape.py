"""SWF static shape decoder: space-optimized shape records -> styled paths.

Behavioral parity target: reference ts/src/lib/shape/decode-swf-shape.ts.
The algorithm:

* Maintain a pen position plus three style slots — left fill (fill0), right
  fill (fill1) and line style — selected by 1-based ids (0 = none).
* Every edge record appends its segment to the left-fill set as-is and to the
  right-fill set **reversed** (decode-swf-shape.ts:358-390), so each fill's
  boundary ends up consistently oriented.
* A style-change record carrying ``newStyles`` opens a fresh "style layer"
  and clears all three slots (decode-swf-shape.ts:402-408).
* Per style, segments are stitched into continuous runs by exact endpoint
  matching in a single greedy pass (decode-swf-shape.ts:203-234 — including
  its documented limitation for disordered input, which the golden files
  depend on), then emitted as MoveTo/LineTo/CurveTo commands.
* Output layer order is fills first, then lines (decode-swf-shape.ts:278-293).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from . import ast, ir


@dataclasses.dataclass
class Segment:
    """Geometry produced by one edge record.  ``control`` is None for lines."""

    start: Tuple[float, float]
    end: Tuple[float, float]
    control: Optional[Tuple[float, float]] = None

    def reversed(self) -> "Segment":
        return Segment(start=self.end, end=self.start, control=self.control)


@dataclasses.dataclass
class _SegmentSet:
    style: object  # ir.FillStyle or ir.LineStyle
    segments: List[Segment] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _StyleLayer:
    fills: List[_SegmentSet]
    lines: List[_SegmentSet]


def decode_gradient(g: ast.Gradient) -> ir.Gradient:
    """Normalize stop ratios to [0,1] (decode-swf-shape.ts:99-105)."""
    return ir.Gradient(
        spread=g.spread,
        color_space=g.color_space,
        colors=tuple(
            ir.ColorStop(ratio=stop.ratio / 0xFF, color=ir.normalize_color(stop.color))
            for stop in g.colors
        ),
    )


def decode_fill_style(style: ast.FillStyle) -> ir.FillStyle:
    """Normalize SWF fill styles to the renderer IR.

    A plain RadialGradient becomes a FocalGradient with ``focal_point = 0``
    (decode-swf-shape.ts:127-133)."""
    if isinstance(style, ast.SolidFill):
        return ir.SolidFill(color=ir.normalize_color(style.color))
    if isinstance(style, ast.BitmapFill):
        return ir.BitmapFill(
            bitmap_id=style.bitmap_id,
            matrix=style.matrix,
            repeating=style.repeating,
            smoothed=style.smoothed,
        )
    if isinstance(style, ast.FocalGradientFill):
        return ir.FocalGradientFill(
            matrix=style.matrix,
            gradient=decode_gradient(style.gradient),
            focal_point=style.focal_point,
        )
    if isinstance(style, ast.LinearGradientFill):
        return ir.LinearGradientFill(
            matrix=style.matrix, gradient=decode_gradient(style.gradient)
        )
    if isinstance(style, ast.RadialGradientFill):
        return ir.FocalGradientFill(
            matrix=style.matrix,
            gradient=decode_gradient(style.gradient),
            focal_point=0,
        )
    raise ValueError(f"UnknownFillStyle: {style!r}")


def decode_line_style(style: ast.LineStyle) -> ir.LineStyle:
    return ir.LineStyle(
        width=style.width,
        fill=decode_fill_style(style.fill),
        start_cap=style.start_cap,
        end_cap=style.end_cap,
        join=style.join.get("type", "round"),
        miter_limit=float(style.join.get("limit", 3.0)),
    )


def extract_continuous(open_set: List[Segment], key) -> List[Segment]:
    """Pop one maximal continuous run of segments from ``open_set``.

    Single greedy pass over the remaining segments in definition order,
    growing the run at either end by exact coordinate equality.  ``key`` maps
    a coordinate pair to its match key (identity for static shapes, start
    component only for morph shapes, decode-swf-morph-shape.ts:176-197).
    """
    first = open_set.pop(0)
    run = [first]
    start = key(first.start)
    end = key(first.end)
    remaining: List[Segment] = []
    for seg in open_set:
        if key(seg.start) == end:
            end = key(seg.end)
            run.append(seg)
        elif key(seg.end) == start:
            start = key(seg.start)
            run.insert(0, seg)
        else:
            remaining.append(seg)
    open_set[:] = remaining
    return run


def _identity_key(coord):
    return coord


def segments_to_commands(segments: Sequence[Segment]) -> List[ir.Command]:
    open_set = list(segments)
    commands: List[ir.Command] = []
    while open_set:
        run = extract_continuous(open_set, _identity_key)
        commands.append(ir.MoveTo(x=run[0].start[0], y=run[0].start[1]))
        for seg in run:
            if seg.control is None:
                commands.append(ir.LineTo(end_x=seg.end[0], end_y=seg.end[1]))
            else:
                commands.append(
                    ir.CurveTo(
                        control_x=seg.control[0],
                        control_y=seg.control[1],
                        end_x=seg.end[0],
                        end_y=seg.end[1],
                    )
                )
    return commands


class ShapeDecoder:
    """Stateful record consumer (reference SwfShapeDecoder:298-448)."""

    def __init__(self, styles: ast.ShapeStyles):
        self.x: float = 0
        self.y: float = 0
        self.layers: List[_StyleLayer] = []
        self.left_fill: Optional[_SegmentSet] = None
        self.right_fill: Optional[_SegmentSet] = None
        self.line_fill: Optional[_SegmentSet] = None
        self._set_new_styles(styles)

    def apply(self, record: ast.ShapeRecord) -> None:
        if isinstance(record, ast.EdgeRecord):
            self._apply_edge(record)
        elif isinstance(record, ast.StyleChangeRecord):
            self._apply_style_change(record)
        else:
            raise ValueError("UnreachableCode")

    def _apply_style_change(self, record: ast.StyleChangeRecord) -> None:
        if record.new_styles is not None:
            self._set_new_styles(record.new_styles)
        if record.left_fill is not None:
            self.left_fill = self._select(record.left_fill, fills=True)
        if record.right_fill is not None:
            self.right_fill = self._select(record.right_fill, fills=True)
        if record.line_style is not None:
            self.line_fill = self._select(record.line_style, fills=False)
        if record.move_to is not None:
            self.x = record.move_to.x
            self.y = record.move_to.y

    def _apply_edge(self, record: ast.EdgeRecord) -> None:
        end = (self.x + record.delta.x, self.y + record.delta.y)
        control = None
        if record.control_delta is not None:
            control = (self.x + record.control_delta.x, self.y + record.control_delta.y)
        seg = Segment(start=(self.x, self.y), end=end, control=control)
        if self.left_fill is not None:
            self.left_fill.segments.append(seg)
        if self.right_fill is not None:
            self.right_fill.segments.append(seg.reversed())
        if self.line_fill is not None:
            self.line_fill.segments.append(seg)
        self.x, self.y = end

    def _set_new_styles(self, styles: ast.ShapeStyles) -> None:
        layer = _StyleLayer(
            fills=[_SegmentSet(style=decode_fill_style(f)) for f in styles.fill],
            lines=[_SegmentSet(style=decode_line_style(l)) for l in styles.line],
        )
        self.layers.append(layer)
        self.left_fill = None
        self.right_fill = None
        self.line_fill = None

    def _select(self, style_id: int, fills: bool) -> Optional[_SegmentSet]:
        if style_id == 0:
            return None
        layer = self.layers[-1]
        sets = layer.fills if fills else layer.lines
        if style_id - 1 >= len(sets):
            raise ValueError("Invalid fill ID")
        return sets[style_id - 1]

    def get_shape(self) -> ir.Shape:
        paths: List[ir.Path] = []
        for layer in self.layers:
            for fill_set in layer.fills:
                commands = segments_to_commands(fill_set.segments)
                if commands:
                    paths.append(ir.Path(commands=commands, fill=fill_set.style))
            for line_set in layer.lines:
                commands = segments_to_commands(line_set.segments)
                if commands:
                    paths.append(ir.Path(commands=commands, line=line_set.style))
        return ir.Shape(paths=paths)


def decode_shape(tag: ast.DefineShape) -> ir.Shape:
    """Decode a DefineShape tag into styled paths (decode-swf-shape.ts:22-39)."""
    decoder = ShapeDecoder(tag.shape.initial_styles)
    for record in tag.shape.records:
        decoder.apply(record)
    return decoder.get_shape()
