"""Renderer intermediate representation: styled paths decoded from SWF shapes.

This mirrors the reference renderer IR (reference ts/src/lib/shape/path.ts,
fill-style.ts, line-style.ts and their morph twins).  The enum ordinals are
load-bearing: golden files compare the JSON serialization by exact string
equality and bake the numbers in (e.g. reference
tests/flat-shapes/triangle/shape.ts.json uses ``"type": 2/0/3``), so

* ``CommandType``: LineTo=0, CurveTo=1, MoveTo=2
  (reference ts/src/lib/shape/path.ts:4-8)
* ``FillStyleType``: Bitmap=0, FocalGradient=1, LinearGradient=2, Solid=3
  (reference ts/src/lib/shape/fill-style.ts:5-10)
* ``MorphFillStyleType``: Solid=0
  (reference ts/src/lib/shape/morph-fill-style.ts:3-5)

``to_golden()`` methods produce plain dict/list trees whose key order and
number types reproduce ``JSON.stringify`` of the reference decoder output
byte-for-byte (when printed with :mod:`..utils.jsjson`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple, Union

from . import ast


class CommandType(enum.IntEnum):
    LINE_TO = 0
    CURVE_TO = 1
    MOVE_TO = 2


class FillStyleType(enum.IntEnum):
    BITMAP = 0
    FOCAL_GRADIENT = 1
    LINEAR_GRADIENT = 2
    SOLID = 3


class MorphFillStyleType(enum.IntEnum):
    SOLID = 0
    # Framework extension (gradient/bitmap morph fills as [start, end]
    # static-fill pairs); never appears in reference goldens.
    EXTENDED = 1


# Serialization ordinals for gradient enums.  No golden file in the reference
# corpus exercises a gradient, so these follow the declaration order of the
# swf-tree TS enums (GradientSpread { Pad, Reflect, Repeat }).
_SPREAD_ORDINAL = {
    ast.GradientSpread.PAD: 0,
    ast.GradientSpread.REFLECT: 1,
    ast.GradientSpread.REPEAT: 2,
}
_COLOR_SPACE_ORDINAL = {
    ast.ColorSpace.S_RGB: 0,
    ast.ColorSpace.LINEAR_RGB: 1,
}

Rgba = Tuple[float, float, float, float]  # normalized [0, 1] floats


def normalize_color(color: ast.StraightSRgba8) -> Rgba:
    """u8 RGBA -> normalized floats (reference decode-swf-shape.ts:90-97)."""
    return (color.r / 255, color.g / 255, color.b / 255, color.a / 255)


def _color_golden(c: Rgba) -> dict:
    return {"r": c[0], "g": c[1], "b": c[2], "a": c[3]}


def _matrix_golden(m: ast.Matrix) -> dict:
    return {
        "scaleX": {"epsilons": m.scale_x.epsilons},
        "scaleY": {"epsilons": m.scale_y.epsilons},
        "rotateSkew0": {"epsilons": m.rotate_skew0.epsilons},
        "rotateSkew1": {"epsilons": m.rotate_skew1.epsilons},
        "translateX": m.translate_x,
        "translateY": m.translate_y,
    }


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ColorStop:
    ratio: float  # normalized [0, 1] (u8 ratio / 255)
    color: Rgba


@dataclasses.dataclass(frozen=True)
class Gradient:
    spread: ast.GradientSpread
    color_space: ast.ColorSpace
    colors: Sequence[ColorStop]

    def to_golden(self) -> dict:
        return {
            "spread": _SPREAD_ORDINAL[self.spread],
            "colorSpace": _COLOR_SPACE_ORDINAL[self.color_space],
            "colors": [
                {"ratio": stop.ratio, "color": _color_golden(stop.color)}
                for stop in self.colors
            ],
        }


# ---------------------------------------------------------------------------
# Fill / line styles
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SolidFill:
    color: Rgba
    type: FillStyleType = FillStyleType.SOLID

    def to_golden(self) -> dict:
        return {"type": int(self.type), "color": _color_golden(self.color)}


@dataclasses.dataclass(frozen=True)
class BitmapFill:
    bitmap_id: int
    matrix: ast.Matrix
    repeating: bool
    smoothed: bool
    type: FillStyleType = FillStyleType.BITMAP

    def to_golden(self) -> dict:
        return {
            "type": int(self.type),
            "bitmapId": self.bitmap_id,
            "matrix": _matrix_golden(self.matrix),
            "repeating": self.repeating,
            "smoothed": self.smoothed,
        }


@dataclasses.dataclass(frozen=True)
class FocalGradientFill:
    matrix: ast.Matrix
    gradient: Gradient
    focal_point: float
    type: FillStyleType = FillStyleType.FOCAL_GRADIENT

    def to_golden(self) -> dict:
        return {
            "type": int(self.type),
            "matrix": _matrix_golden(self.matrix),
            "gradient": self.gradient.to_golden(),
            "focalPoint": self.focal_point,
        }


@dataclasses.dataclass(frozen=True)
class LinearGradientFill:
    matrix: ast.Matrix
    gradient: Gradient
    type: FillStyleType = FillStyleType.LINEAR_GRADIENT

    def to_golden(self) -> dict:
        return {
            "type": int(self.type),
            "matrix": _matrix_golden(self.matrix),
            "gradient": self.gradient.to_golden(),
        }


FillStyle = Union[SolidFill, BitmapFill, FocalGradientFill, LinearGradientFill]


@dataclasses.dataclass(frozen=True)
class LineStyle:
    width: int  # twips
    fill: FillStyle
    # Cap/join carried from the SWF line style for renderers that honor them
    # (the Flash player does; the reference Canvas renderer ignores them and
    # gets Canvas defaults).  NOT part of the golden serialization, which
    # matches the reference IR exactly.
    start_cap: str = "round"
    end_cap: str = "round"
    join: str = "round"
    # SWF miterLimitFactor (LINESTYLE2); the format default is 3.
    miter_limit: float = 3.0

    def to_golden(self) -> dict:
        return {"width": self.width, "fill": self.fill.to_golden()}


# ---------------------------------------------------------------------------
# Path commands
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoveTo:
    x: float
    y: float
    type: CommandType = CommandType.MOVE_TO

    def to_golden(self) -> dict:
        return {"type": int(self.type), "x": self.x, "y": self.y}


@dataclasses.dataclass(frozen=True)
class LineTo:
    end_x: float
    end_y: float
    type: CommandType = CommandType.LINE_TO

    def to_golden(self) -> dict:
        return {"type": int(self.type), "endX": self.end_x, "endY": self.end_y}


@dataclasses.dataclass(frozen=True)
class CurveTo:
    control_x: float
    control_y: float
    end_x: float
    end_y: float
    type: CommandType = CommandType.CURVE_TO

    def to_golden(self) -> dict:
        return {
            "type": int(self.type),
            "controlX": self.control_x,
            "controlY": self.control_y,
            "endX": self.end_x,
            "endY": self.end_y,
        }


Command = Union[MoveTo, LineTo, CurveTo]


@dataclasses.dataclass(frozen=True)
class Path:
    commands: Sequence[Command]
    fill: Optional[FillStyle] = None
    line: Optional[LineStyle] = None

    def to_golden(self) -> dict:
        out: dict = {"commands": [c.to_golden() for c in self.commands]}
        if self.fill is not None:
            out["fill"] = self.fill.to_golden()
        if self.line is not None:
            out["line"] = self.line.to_golden()
        return out


@dataclasses.dataclass(frozen=True)
class Shape:
    paths: Sequence[Path]

    def to_golden(self) -> dict:
        return {"paths": [p.to_golden() for p in self.paths]}


# ---------------------------------------------------------------------------
# Morph IR (every coordinate is a [start, end] pair)
# ---------------------------------------------------------------------------

Pair = Tuple[float, float]


@dataclasses.dataclass(frozen=True)
class MorphExtendedFill:
    """Framework extension: a [start, end] pair of same-kind STATIC
    fills (gradient matrices/stops or bitmap matrices lerp at the draw
    ratio).  Ordinal 1 never appears in reference goldens — the
    reference throws on every non-solid morph fill
    (decode-swf-morph-shape.ts:94-106)."""

    start: FillStyle
    end: FillStyle
    type: MorphFillStyleType = MorphFillStyleType.EXTENDED

    def to_golden(self) -> dict:
        return {"type": int(self.type), "start": self.start.to_golden(),
                "end": self.end.to_golden()}


@dataclasses.dataclass(frozen=True)
class MorphSolidFill:
    start_color: Rgba
    end_color: Rgba
    type: MorphFillStyleType = MorphFillStyleType.SOLID

    def to_golden(self) -> dict:
        return {
            "type": int(self.type),
            "startColor": _color_golden(self.start_color),
            "endColor": _color_golden(self.end_color),
        }


MorphFillStyle = Union[MorphSolidFill, MorphExtendedFill]


@dataclasses.dataclass(frozen=True)
class MorphLineStyle:
    width: Pair
    fill: MorphFillStyle

    def to_golden(self) -> dict:
        return {"width": list(self.width), "fill": self.fill.to_golden()}


@dataclasses.dataclass(frozen=True)
class MorphMoveTo:
    x: Pair
    y: Pair
    type: CommandType = CommandType.MOVE_TO

    def to_golden(self) -> dict:
        return {"type": int(self.type), "x": list(self.x), "y": list(self.y)}


@dataclasses.dataclass(frozen=True)
class MorphLineTo:
    end_x: Pair
    end_y: Pair
    type: CommandType = CommandType.LINE_TO

    def to_golden(self) -> dict:
        return {
            "type": int(self.type),
            "endX": list(self.end_x),
            "endY": list(self.end_y),
        }


@dataclasses.dataclass(frozen=True)
class MorphCurveTo:
    control_x: Pair
    control_y: Pair
    end_x: Pair
    end_y: Pair
    type: CommandType = CommandType.CURVE_TO

    def to_golden(self) -> dict:
        return {
            "type": int(self.type),
            "controlX": list(self.control_x),
            "controlY": list(self.control_y),
            "endX": list(self.end_x),
            "endY": list(self.end_y),
        }


MorphCommand = Union[MorphMoveTo, MorphLineTo, MorphCurveTo]


@dataclasses.dataclass(frozen=True)
class MorphPath:
    commands: Sequence[MorphCommand]
    fill: Optional[MorphFillStyle] = None
    line: Optional[MorphLineStyle] = None

    def to_golden(self) -> dict:
        out: dict = {"commands": [c.to_golden() for c in self.commands]}
        if self.fill is not None:
            out["fill"] = self.fill.to_golden()
        if self.line is not None:
            out["line"] = self.line.to_golden()
        return out


@dataclasses.dataclass(frozen=True)
class MorphShape:
    paths: Sequence[MorphPath]

    def to_golden(self) -> dict:
        return {"paths": [p.to_golden() for p in self.paths]}
