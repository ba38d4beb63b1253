"""Display list: the retained scene tree handed to ``render(stage)``.

Mirrors the reference display model (reference ts/src/lib/display/stage.ts:7-18,
display-object.ts:5, shape.ts:5-9, morph-shape.ts:5-10,
display-object-container.ts:5-9).  ``DisplayObjectType`` ordinals are
Container=0, MorphShape=1, Shape=2 (display-object-type.ts:1-5).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple, Union

from . import ast


class DisplayObjectType(enum.IntEnum):
    CONTAINER = 0
    MORPH_SHAPE = 1
    SHAPE = 2


@dataclasses.dataclass(frozen=True)
class ColorTransform:
    """SWF color transform (framework extension; the reference display list
    carries none).  Applied to a straight-alpha color as
    ``c * mult + add`` per channel, clamped to [0, 1]."""

    mult: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    add: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class ShapeInstance:
    definition: ast.DefineShape
    matrix: Optional[ast.Matrix] = None
    color_transform: Optional[ColorTransform] = None
    # Framework extension (PlaceObject3): one of ops.composite.BLEND_MODES,
    # or None for normal source-over.
    blend_mode: Optional[str] = None
    # Framework extension (PlaceObject3 filter list): ops.filters
    # dataclasses applied to the object's composed image.
    filters: Tuple = ()
    type: DisplayObjectType = DisplayObjectType.SHAPE


@dataclasses.dataclass(frozen=True)
class MorphShapeInstance:
    definition: ast.DefineMorphShape
    ratio: float = 0.0  # [0, 1]
    matrix: Optional[ast.Matrix] = None
    color_transform: Optional[ColorTransform] = None
    blend_mode: Optional[str] = None
    filters: Tuple = ()
    type: DisplayObjectType = DisplayObjectType.MORPH_SHAPE


@dataclasses.dataclass(frozen=True)
class Container:
    children: Sequence["DisplayObject"] = ()
    matrix: Optional[ast.Matrix] = None
    color_transform: Optional[ColorTransform] = None
    blend_mode: Optional[str] = None
    filters: Tuple = ()
    type: DisplayObjectType = DisplayObjectType.CONTAINER


@dataclasses.dataclass(frozen=True)
class MaskedGroup:
    """A clip group (framework extension; the reference ignores
    PlaceObject2 clip depths): ``mask``'s FILL coverage clips
    ``children``.  Flash semantics — the mask object is not painted,
    its strokes do not contribute, and the clip follows the mask's own
    transform.  Our rasterization multiplies the children's coverage by
    the mask's antialiased coverage (the player clips hard-edged; the
    AA form is strictly better and noted as a deliberate divergence)."""

    mask: "DisplayObject"
    children: Sequence["DisplayObject"] = ()
    matrix: Optional[ast.Matrix] = None
    color_transform: Optional[ColorTransform] = None
    blend_mode: Optional[str] = None
    filters: Tuple = ()
    type: DisplayObjectType = DisplayObjectType.CONTAINER


@dataclasses.dataclass(frozen=True)
class ScaleGridGroup:
    """A 9-slice scaling group (framework extension; the reference has no
    DefineScalingGrid support).  ``grid`` is the DefineScalingGrid RECT and
    ``bounds`` the character's untransformed bounds, both in twips
    (x_min, y_min, x_max, y_max).  When the group's total transform is an
    axis-aligned positive scale, the children's geometry is remapped by the
    separable piecewise-linear scale-9 map (corner bands keep their natural
    size, the center band absorbs the scaling — Flash scale9Grid
    semantics); under rotation/skew the grid is ignored and the group
    renders as a plain Container, exactly like the player."""

    children: Sequence["DisplayObject"] = ()
    grid: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    bounds: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    matrix: Optional[ast.Matrix] = None
    color_transform: Optional[ColorTransform] = None
    blend_mode: Optional[str] = None
    filters: Tuple = ()
    type: DisplayObjectType = DisplayObjectType.CONTAINER


DisplayObject = Union[ShapeInstance, MorphShapeInstance, Container,
                      MaskedGroup, ScaleGridGroup]


@dataclasses.dataclass(frozen=True)
class Stage:
    width: int  # pixels (raster size, ceil of the exact stage extent)
    height: int  # pixels
    background_color: ast.StraightSRgba8 = ast.StraightSRgba8(0, 0, 0, 0)
    children: Sequence[DisplayObject] = ()
    # Exact stage extent in pixels (bounds twips / 20, generally fractional).
    # The Flash player clips content at THIS rect, so border pixels are only
    # partially coverable; None means clip at the integer raster size.
    exact_width: Optional[float] = None
    exact_height: Optional[float] = None


def stage_for_shape(tag: ast.DefineShape) -> Stage:
    """The canonical single-shape stage the reference render tests build:
    size ceil(bounds/20), shape translated by -bounds.min
    (reference ts/src/test/node-canvas-renderer.spec.ts:31-52)."""
    import math

    width = math.ceil((tag.bounds.x_max - tag.bounds.x_min) / 20)
    height = math.ceil((tag.bounds.y_max - tag.bounds.y_min) / 20)
    from ..utils.fixed import Sfixed16P16

    matrix = ast.Matrix(
        scale_x=Sfixed16P16.from_value(1),
        scale_y=Sfixed16P16.from_value(1),
        rotate_skew0=Sfixed16P16.from_value(0),
        rotate_skew1=Sfixed16P16.from_value(0),
        translate_x=-tag.bounds.x_min,
        translate_y=-tag.bounds.y_min,
    )
    return Stage(
        width=width,
        height=height,
        children=(ShapeInstance(definition=tag, matrix=matrix),),
        exact_width=(tag.bounds.x_max - tag.bounds.x_min) / 20,
        exact_height=(tag.bounds.y_max - tag.bounds.y_min) / 20,
    )


def stage_for_morph_shape(tag: ast.DefineMorphShape, ratio: float) -> Stage:
    """Single-morph-shape stage: union of start/end bounds
    (reference node-canvas-renderer.spec.ts:88-117)."""
    import math

    x_min = min(tag.bounds.x_min, tag.morph_bounds.x_min)
    x_max = max(tag.bounds.x_max, tag.morph_bounds.x_max)
    y_min = min(tag.bounds.y_min, tag.morph_bounds.y_min)
    y_max = max(tag.bounds.y_max, tag.morph_bounds.y_max)
    width = math.ceil((x_max - x_min) / 20)
    height = math.ceil((y_max - y_min) / 20)
    from ..utils.fixed import Sfixed16P16

    matrix = ast.Matrix(
        scale_x=Sfixed16P16.from_value(1),
        scale_y=Sfixed16P16.from_value(1),
        rotate_skew0=Sfixed16P16.from_value(0),
        rotate_skew1=Sfixed16P16.from_value(0),
        translate_x=-x_min,
        translate_y=-y_min,
    )
    return Stage(
        width=width,
        height=height,
        children=(MorphShapeInstance(definition=tag, ratio=ratio, matrix=matrix),),
        exact_width=(x_max - x_min) / 20,
        exact_height=(y_max - y_min) / 20,
    )
