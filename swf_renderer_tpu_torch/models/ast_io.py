"""Reading ``ast.json`` files (swf-tree JSON serialization) into the AST model.

The JSON schema uses snake_case keys, fixed-point values as raw epsilon
integers, and hex-encoded byte strings (the same files the reference reads
with kryo's JsonReader, e.g. reference ts/src/test/decode-shape.spec.ts:14-16).
"""

from __future__ import annotations

import json
from typing import Any, Optional

from ..utils.fixed import Sfixed16P16
from . import ast


def _vec(obj: Optional[dict]) -> Optional[ast.Vector2D]:
    if obj is None:
        return None
    return ast.Vector2D(x=obj["x"], y=obj["y"])


def _color(obj: dict) -> ast.StraightSRgba8:
    return ast.StraightSRgba8(r=obj["r"], g=obj["g"], b=obj["b"], a=obj["a"])


def _rect(obj: dict) -> ast.Rect:
    return ast.Rect(
        x_min=obj["x_min"], x_max=obj["x_max"], y_min=obj["y_min"], y_max=obj["y_max"]
    )


def _matrix(obj: dict) -> ast.Matrix:
    return ast.Matrix(
        scale_x=Sfixed16P16.from_epsilons(obj["scale_x"]),
        scale_y=Sfixed16P16.from_epsilons(obj["scale_y"]),
        rotate_skew0=Sfixed16P16.from_epsilons(obj["rotate_skew0"]),
        rotate_skew1=Sfixed16P16.from_epsilons(obj["rotate_skew1"]),
        translate_x=obj["translate_x"],
        translate_y=obj["translate_y"],
    )


def _gradient(obj: dict) -> ast.Gradient:
    return ast.Gradient(
        spread=ast.GradientSpread(obj.get("spread", "pad")),
        color_space=ast.ColorSpace(obj.get("color_space", "s-rgb")),
        colors=tuple(
            ast.GradientStop(ratio=c["ratio"], color=_color(c["color"]))
            for c in obj["colors"]
        ),
    )


def _fill_style(obj: dict) -> ast.FillStyle:
    kind = obj["type"]
    if kind == "solid":
        return ast.SolidFill(color=_color(obj["color"]))
    if kind == "bitmap":
        return ast.BitmapFill(
            bitmap_id=obj["bitmap_id"],
            matrix=_matrix(obj["matrix"]),
            repeating=obj["repeating"],
            smoothed=obj["smoothed"],
        )
    if kind == "linear-gradient":
        return ast.LinearGradientFill(
            matrix=_matrix(obj["matrix"]), gradient=_gradient(obj["gradient"])
        )
    if kind == "radial-gradient":
        return ast.RadialGradientFill(
            matrix=_matrix(obj["matrix"]), gradient=_gradient(obj["gradient"])
        )
    if kind == "focal-gradient":
        return ast.FocalGradientFill(
            matrix=_matrix(obj["matrix"]),
            gradient=_gradient(obj["gradient"]),
            focal_point_epsilons=obj["focal_point"],
        )
    raise ValueError(f"UnknownFillStyle: {kind}")


def _line_style(obj: dict) -> ast.LineStyle:
    return ast.LineStyle(
        width=obj["width"],
        start_cap=obj.get("start_cap", "round"),
        end_cap=obj.get("end_cap", "round"),
        join=obj.get("join", {"type": "round"}),
        no_h_scale=obj.get("no_h_scale", False),
        no_v_scale=obj.get("no_v_scale", False),
        no_close=obj.get("no_close", False),
        pixel_hinting=obj.get("pixel_hinting", False),
        fill=_fill_style(obj["fill"]),
    )


def _styles(obj: dict) -> ast.ShapeStyles:
    return ast.ShapeStyles(
        fill=tuple(_fill_style(f) for f in obj["fill"]),
        line=tuple(_line_style(l) for l in obj["line"]),
    )


def _record(obj: dict) -> ast.ShapeRecord:
    kind = obj["type"]
    if kind == "edge":
        return ast.EdgeRecord(
            delta=_vec(obj["delta"]), control_delta=_vec(obj.get("control_delta"))
        )
    if kind == "style-change":
        new_styles = obj.get("new_styles")
        return ast.StyleChangeRecord(
            move_to=_vec(obj.get("move_to")),
            left_fill=obj.get("left_fill"),
            right_fill=obj.get("right_fill"),
            line_style=obj.get("line_style"),
            new_styles=_styles(new_styles) if new_styles is not None else None,
        )
    raise ValueError(f"UnknownShapeRecord: {kind}")


def parse_define_shape(obj: Any) -> ast.DefineShape:
    if isinstance(obj, (str, bytes)):
        obj = json.loads(obj)
    if obj.get("type") != "define-shape":
        raise ValueError(f"expected define-shape tag, got {obj.get('type')!r}")
    shape = obj["shape"]
    return ast.DefineShape(
        id=obj["id"],
        bounds=_rect(obj["bounds"]),
        has_fill_winding=obj.get("has_fill_winding", False),
        has_non_scaling_strokes=obj.get("has_non_scaling_strokes", False),
        has_scaling_strokes=obj.get("has_scaling_strokes", False),
        shape=ast.ShapeBody(
            initial_styles=_styles(shape["initial_styles"]),
            records=tuple(_record(r) for r in shape["records"]),
        ),
    )


# ---------------------------------------------------------------------------
# Morph shapes
# ---------------------------------------------------------------------------


def _morph_fill_style(obj: dict) -> ast.MorphFillStyle:
    kind = obj["type"]
    if kind == "solid":
        return ast.MorphSolidFill(
            color=_color(obj["color"]), morph_color=_color(obj["morph_color"])
        )
    raise ValueError(f"UnknownMorphFillStyle: {kind}")


def _morph_line_style(obj: dict) -> ast.MorphLineStyle:
    return ast.MorphLineStyle(
        width=obj["width"],
        morph_width=obj["morph_width"],
        start_cap=obj.get("start_cap", "round"),
        end_cap=obj.get("end_cap", "round"),
        join=obj.get("join", {"type": "round"}),
        no_h_scale=obj.get("no_h_scale", False),
        no_v_scale=obj.get("no_v_scale", False),
        no_close=obj.get("no_close", False),
        pixel_hinting=obj.get("pixel_hinting", False),
        fill=_morph_fill_style(obj["fill"]),
    )


def _morph_styles(obj: dict) -> ast.MorphShapeStyles:
    return ast.MorphShapeStyles(
        fill=tuple(_morph_fill_style(f) for f in obj["fill"]),
        line=tuple(_morph_line_style(l) for l in obj["line"]),
    )


def _morph_record(obj: dict) -> ast.MorphShapeRecord:
    kind = obj["type"]
    if kind == "edge":
        return ast.MorphEdgeRecord(
            delta=_vec(obj["delta"]),
            morph_delta=_vec(obj["morph_delta"]),
            control_delta=_vec(obj.get("control_delta")),
            morph_control_delta=_vec(obj.get("morph_control_delta")),
        )
    if kind == "style-change":
        return ast.MorphStyleChangeRecord(
            move_to=_vec(obj.get("move_to")),
            morph_move_to=_vec(obj.get("morph_move_to")),
            left_fill=obj.get("left_fill"),
            right_fill=obj.get("right_fill"),
            line_style=obj.get("line_style"),
        )
    raise ValueError(f"UnknownMorphShapeRecord: {kind}")


def parse_define_morph_shape(obj: Any) -> ast.DefineMorphShape:
    if isinstance(obj, (str, bytes)):
        obj = json.loads(obj)
    if obj.get("type") != "define-morph-shape":
        raise ValueError(f"expected define-morph-shape tag, got {obj.get('type')!r}")
    shape = obj["shape"]
    return ast.DefineMorphShape(
        id=obj["id"],
        bounds=_rect(obj["bounds"]),
        morph_bounds=_rect(obj["morph_bounds"]),
        has_non_scaling_strokes=obj.get("has_non_scaling_strokes", False),
        has_scaling_strokes=obj.get("has_scaling_strokes", False),
        shape=ast.MorphShapeBody(
            initial_styles=_morph_styles(shape["initial_styles"]),
            records=tuple(_morph_record(r) for r in shape["records"]),
        ),
    )


def parse_define_bitmap(obj: Any) -> ast.DefineBitmap:
    if isinstance(obj, (str, bytes)):
        obj = json.loads(obj)
    if obj.get("type") != "define-bitmap":
        raise ValueError(f"expected define-bitmap tag, got {obj.get('type')!r}")
    return ast.DefineBitmap(
        id=obj["id"],
        width=obj["width"],
        height=obj["height"],
        media_type=obj["media_type"],
        data=bytes.fromhex(obj["data"]),
    )


def parse_tag(obj: Any) -> Any:
    """Parse any supported tag (JSON text or dict) by its ``type``."""
    if isinstance(obj, (str, bytes)):
        obj = json.loads(obj)
    kind = obj.get("type")
    if kind == "define-shape":
        return parse_define_shape(obj)
    if kind == "define-morph-shape":
        return parse_define_morph_shape(obj)
    if kind == "define-bitmap":
        return parse_define_bitmap(obj)
    raise ValueError(f"UnsupportedTag: {kind}")


def load_tag(path: str) -> Any:
    """Load any supported tag from an ``ast.json`` file by its ``type``."""
    with open(path, "r", encoding="utf-8") as f:
        return parse_tag(json.load(f))
