"""SWF abstract-syntax-tree model (the ``swf-tree`` schema).

This is the input layer of the framework: the same role the external
``swf-tree`` package plays for the reference (reference ts/package.json:48).
Instances are read from ``ast.json`` fixtures, which use snake_case keys and
store fixed-point values as raw epsilon integers (e.g. ``"scale_x": 508060``
means 508060/65536).

Only the tags the reference consumes are modeled: ``DefineShape``,
``DefineMorphShape`` and ``DefineBitmap``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Union

from ..utils.fixed import Sfixed16P16

SFIXED8P8_PER_UNIT = 1 << 8


# ---------------------------------------------------------------------------
# Basic geometry / color
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Vector2D:
    x: int
    y: int


@dataclasses.dataclass(frozen=True)
class StraightSRgba8:
    """A color with u8 channels, straight (non-premultiplied) alpha."""

    r: int
    g: int
    b: int
    a: int


@dataclasses.dataclass(frozen=True)
class Rect:
    """Bounds rectangle in twips (20 twips = 1 px)."""

    x_min: int
    x_max: int
    y_min: int
    y_max: int


@dataclasses.dataclass(frozen=True)
class Matrix:
    """SWF affine matrix.

    ``scale_x``/``scale_y``/``rotate_skew0``/``rotate_skew1`` are Sfixed16P16;
    translate terms are integer twips.  Applied as the Canvas2D transform
    ``(a, b, c, d, e, f) = (scaleX, rotateSkew0, rotateSkew1, scaleY, tx, ty)``
    (reference ts/src/lib/renderers/canvas-renderer.ts:179-188)."""

    scale_x: Sfixed16P16
    scale_y: Sfixed16P16
    rotate_skew0: Sfixed16P16
    rotate_skew1: Sfixed16P16
    translate_x: int
    translate_y: int

    @staticmethod
    def identity() -> "Matrix":
        one = Sfixed16P16.from_value(1.0)
        zero = Sfixed16P16.from_value(0.0)
        return Matrix(one, one, zero, zero, 0, 0)

    def to_affine(self) -> tuple:
        """Return the (a, b, c, d, e, f) float affine coefficients."""
        return (
            self.scale_x.value(),
            self.rotate_skew0.value(),
            self.rotate_skew1.value(),
            self.scale_y.value(),
            float(self.translate_x),
            float(self.translate_y),
        )


# ---------------------------------------------------------------------------
# Gradients & styles
# ---------------------------------------------------------------------------


class GradientSpread(enum.Enum):
    PAD = "pad"
    REFLECT = "reflect"
    REPEAT = "repeat"


class ColorSpace(enum.Enum):
    S_RGB = "s-rgb"
    LINEAR_RGB = "linear-rgb"


@dataclasses.dataclass(frozen=True)
class GradientStop:
    ratio: int  # u8, 0..255
    color: StraightSRgba8


@dataclasses.dataclass(frozen=True)
class Gradient:
    spread: GradientSpread
    color_space: ColorSpace
    colors: Sequence[GradientStop]


@dataclasses.dataclass(frozen=True)
class SolidFill:
    color: StraightSRgba8


@dataclasses.dataclass(frozen=True)
class BitmapFill:
    bitmap_id: int
    matrix: Matrix
    repeating: bool
    smoothed: bool


@dataclasses.dataclass(frozen=True)
class LinearGradientFill:
    matrix: Matrix
    gradient: Gradient


@dataclasses.dataclass(frozen=True)
class RadialGradientFill:
    matrix: Matrix
    gradient: Gradient


@dataclasses.dataclass(frozen=True)
class FocalGradientFill:
    matrix: Matrix
    gradient: Gradient
    focal_point_epsilons: int  # Sfixed8P8

    @property
    def focal_point(self) -> float:
        return self.focal_point_epsilons / SFIXED8P8_PER_UNIT


FillStyle = Union[
    SolidFill, BitmapFill, LinearGradientFill, RadialGradientFill, FocalGradientFill
]


@dataclasses.dataclass(frozen=True)
class LineStyle:
    width: int  # twips
    start_cap: str
    end_cap: str
    join: dict
    no_h_scale: bool
    no_v_scale: bool
    no_close: bool
    pixel_hinting: bool
    fill: FillStyle


# ---------------------------------------------------------------------------
# Shape records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeStyles:
    fill: Sequence[FillStyle]
    line: Sequence[LineStyle]


@dataclasses.dataclass(frozen=True)
class EdgeRecord:
    delta: Vector2D
    control_delta: Optional[Vector2D] = None


@dataclasses.dataclass(frozen=True)
class StyleChangeRecord:
    move_to: Optional[Vector2D] = None
    left_fill: Optional[int] = None
    right_fill: Optional[int] = None
    line_style: Optional[int] = None
    new_styles: Optional[ShapeStyles] = None


ShapeRecord = Union[EdgeRecord, StyleChangeRecord]


@dataclasses.dataclass(frozen=True)
class ShapeBody:
    initial_styles: ShapeStyles
    records: Sequence[ShapeRecord]


@dataclasses.dataclass(frozen=True)
class DefineShape:
    id: int
    bounds: Rect
    shape: ShapeBody
    has_fill_winding: bool = False
    has_non_scaling_strokes: bool = False
    has_scaling_strokes: bool = False


# ---------------------------------------------------------------------------
# Morph shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MorphSolidFill:
    color: StraightSRgba8
    morph_color: StraightSRgba8


@dataclasses.dataclass(frozen=True)
class MorphExtendedFill:
    """Framework extension: a gradient or bitmap morph fill carried as
    a [start, end] pair of same-kind STATIC fills (the wire format's
    paired matrices / MORPHGRADIENT records).  The reference decoder
    throws on every non-solid morph fill
    (decode-swf-morph-shape.ts:94-106)."""

    start: FillStyle
    end: FillStyle


MorphFillStyle = Union[MorphSolidFill, MorphExtendedFill]


@dataclasses.dataclass(frozen=True)
class MorphLineStyle:
    width: int
    morph_width: int
    start_cap: str
    end_cap: str
    join: dict
    no_h_scale: bool
    no_v_scale: bool
    no_close: bool
    pixel_hinting: bool
    fill: MorphFillStyle


@dataclasses.dataclass(frozen=True)
class MorphShapeStyles:
    fill: Sequence[MorphFillStyle]
    line: Sequence[MorphLineStyle]


@dataclasses.dataclass(frozen=True)
class MorphEdgeRecord:
    delta: Vector2D
    morph_delta: Vector2D
    control_delta: Optional[Vector2D] = None
    morph_control_delta: Optional[Vector2D] = None


@dataclasses.dataclass(frozen=True)
class MorphStyleChangeRecord:
    move_to: Optional[Vector2D] = None
    morph_move_to: Optional[Vector2D] = None
    left_fill: Optional[int] = None
    right_fill: Optional[int] = None
    line_style: Optional[int] = None
    new_styles: Optional[MorphShapeStyles] = None


MorphShapeRecord = Union[MorphEdgeRecord, MorphStyleChangeRecord]


@dataclasses.dataclass(frozen=True)
class MorphShapeBody:
    initial_styles: MorphShapeStyles
    records: Sequence[MorphShapeRecord]


@dataclasses.dataclass(frozen=True)
class DefineMorphShape:
    id: int
    bounds: Rect
    morph_bounds: Rect
    shape: MorphShapeBody
    has_non_scaling_strokes: bool = False
    has_scaling_strokes: bool = False


# ---------------------------------------------------------------------------
# Bitmaps
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DefineBitmap:
    id: int
    width: int
    height: int
    media_type: str
    data: bytes
