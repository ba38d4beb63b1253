"""SWF morph shape decoder: records -> styled paths with [start, end] pairs.

Behavioral parity target: reference ts/src/lib/shape/decode-swf-morph-shape.ts.
Same record-walking algorithm as the static decoder, except:

* every coordinate is a (start, end) pair,
* continuity stitching matches on the **start** coordinates only
  (decode-swf-morph-shape.ts:176-197),
* a curved morph edge with a missing ``controlDelta`` (or morph twin)
  defaults to the midpoint ``delta / 2`` (decode-swf-morph-shape.ts:341-346),
* only solid morph fills are supported; others raise
  (decode-swf-morph-shape.ts:94-106).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from . import ast, ir
from .decode_shape import extract_continuous

Pair = Tuple[float, float]
PairPoint = Tuple[Pair, Pair]  # ((x_start, x_end), (y_start, y_end))


@dataclasses.dataclass
class MorphSegment:
    start: PairPoint
    end: PairPoint
    control: Optional[PairPoint] = None

    def reversed(self) -> "MorphSegment":
        return MorphSegment(start=self.end, end=self.start, control=self.control)


@dataclasses.dataclass
class _SegmentSet:
    style: object
    segments: List[MorphSegment] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _StyleLayer:
    fills: List[_SegmentSet]
    lines: List[_SegmentSet]


def decode_morph_fill_style(style: ast.MorphFillStyle) -> ir.MorphFillStyle:
    if isinstance(style, ast.MorphSolidFill):
        return ir.MorphSolidFill(
            start_color=ir.normalize_color(style.color),
            end_color=ir.normalize_color(style.morph_color),
        )
    if isinstance(style, ast.MorphExtendedFill):
        # Framework extension: gradient/bitmap morph fills decode as a
        # [start, end] pair of static fills (the reference throws here,
        # decode-swf-morph-shape.ts:94-106).
        from .decode_shape import decode_fill_style

        return ir.MorphExtendedFill(start=decode_fill_style(style.start),
                                    end=decode_fill_style(style.end))
    raise ValueError(f"Unknown fill type: {style!r}")


def decode_morph_line_style(style: ast.MorphLineStyle) -> ir.MorphLineStyle:
    return ir.MorphLineStyle(
        width=(style.width, style.morph_width),
        fill=decode_morph_fill_style(style.fill),
    )


def _start_key(coord: PairPoint):
    # Match continuity using the start-shape coordinates only.
    return (coord[0][0], coord[1][0])


def _segments_to_commands(segments: List[MorphSegment]) -> List[ir.MorphCommand]:
    open_set = list(segments)
    commands: List[ir.MorphCommand] = []
    while open_set:
        run = extract_continuous(open_set, _start_key)
        commands.append(ir.MorphMoveTo(x=run[0].start[0], y=run[0].start[1]))
        for seg in run:
            if seg.control is None:
                commands.append(ir.MorphLineTo(end_x=seg.end[0], end_y=seg.end[1]))
            else:
                commands.append(
                    ir.MorphCurveTo(
                        control_x=seg.control[0],
                        control_y=seg.control[1],
                        end_x=seg.end[0],
                        end_y=seg.end[1],
                    )
                )
    return commands


class MorphShapeDecoder:
    """Stateful record consumer (reference SwfMorphShapeDecoder:265-425)."""

    def __init__(self, styles: ast.MorphShapeStyles):
        self.x: Pair = (0, 0)
        self.y: Pair = (0, 0)
        self.layers: List[_StyleLayer] = []
        self.left_fill: Optional[_SegmentSet] = None
        self.right_fill: Optional[_SegmentSet] = None
        self.line_fill: Optional[_SegmentSet] = None
        self._set_new_styles(styles)

    def apply(self, record: ast.MorphShapeRecord) -> None:
        if isinstance(record, ast.MorphEdgeRecord):
            self._apply_edge(record)
        elif isinstance(record, ast.MorphStyleChangeRecord):
            self._apply_style_change(record)
        else:
            raise ValueError("UnreachableCode")

    def _apply_style_change(self, record: ast.MorphStyleChangeRecord) -> None:
        if record.left_fill is not None:
            self.left_fill = self._select(record.left_fill, fills=True)
        if record.right_fill is not None:
            self.right_fill = self._select(record.right_fill, fills=True)
        if record.line_style is not None:
            self.line_fill = self._select(record.line_style, fills=False)
        if record.move_to is not None:
            if record.morph_move_to is None:
                raise ValueError("Expected morphMoveTo to be defined")
            self.x = (record.move_to.x, record.morph_move_to.x)
            self.y = (record.move_to.y, record.morph_move_to.y)

    def _apply_edge(self, record: ast.MorphEdgeRecord) -> None:
        end_x: Pair = (self.x[0] + record.delta.x, self.x[1] + record.morph_delta.x)
        end_y: Pair = (self.y[0] + record.delta.y, self.y[1] + record.morph_delta.y)
        start: PairPoint = (self.x, self.y)
        end: PairPoint = (end_x, end_y)

        if record.control_delta is None and record.morph_control_delta is None:
            seg = MorphSegment(start=start, end=end)
        else:
            cd = record.control_delta
            if cd is None:
                cd = ast.Vector2D(x=record.delta.x / 2, y=record.delta.y / 2)
            mcd = record.morph_control_delta
            if mcd is None:
                mcd = ast.Vector2D(x=record.morph_delta.x / 2, y=record.morph_delta.y / 2)
            control: PairPoint = (
                (self.x[0] + cd.x, self.x[1] + mcd.x),
                (self.y[0] + cd.y, self.y[1] + mcd.y),
            )
            seg = MorphSegment(start=start, end=end, control=control)

        if self.left_fill is not None:
            self.left_fill.segments.append(seg)
        if self.right_fill is not None:
            self.right_fill.segments.append(seg.reversed())
        if self.line_fill is not None:
            self.line_fill.segments.append(seg)

        self.x = end_x
        self.y = end_y

    def _set_new_styles(self, styles: ast.MorphShapeStyles) -> None:
        layer = _StyleLayer(
            fills=[_SegmentSet(style=decode_morph_fill_style(f)) for f in styles.fill],
            lines=[_SegmentSet(style=decode_morph_line_style(l)) for l in styles.line],
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

    def get_shape(self) -> ir.MorphShape:
        paths: List[ir.MorphPath] = []
        for layer in self.layers:
            for fill_set in layer.fills:
                commands = _segments_to_commands(fill_set.segments)
                if commands:
                    paths.append(ir.MorphPath(commands=commands, fill=fill_set.style))
            for line_set in layer.lines:
                commands = _segments_to_commands(line_set.segments)
                if commands:
                    paths.append(ir.MorphPath(commands=commands, line=line_set.style))
        return ir.MorphShape(paths=paths)


def decode_morph_shape(tag: ast.DefineMorphShape) -> ir.MorphShape:
    """Decode a DefineMorphShape tag (decode-swf-morph-shape.ts:21-41)."""
    decoder = MorphShapeDecoder(tag.shape.initial_styles)
    for record in tag.shape.records:
        decoder.apply(record)
    return decoder.get_shape()
