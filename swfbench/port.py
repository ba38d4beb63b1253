"""The program's content objects built from the generator's plain
numbers, for the entries that take stages rather than bytes.  Every
import of the program is inside a function, so importing this module
loads nothing of it."""

from __future__ import annotations


def rgba(c):
    from swf_renderer_tpu_torch.models import ast

    return ast.StraightSRgba8(*(int(v) for v in c))


def matrix(m):
    if m is None:
        return None
    from swf_renderer_tpu_torch.models import ast
    from swf_renderer_tpu_torch.utils.fixed import Sfixed16P16 as F

    sx, sy, r0, r1, tx, ty = m
    return ast.Matrix(scale_x=F(sx), scale_y=F(sy), rotate_skew0=F(r0),
                      rotate_skew1=F(r1), translate_x=int(tx),
                      translate_y=int(ty))


def rect(arrays, pad: int = 20):
    from swf_renderer_tpu_torch.models import ast

    lo = min(int(a.min()) for a in arrays) - pad
    hi = max(int(a.max()) for a in arrays) + pad
    return ast.Rect(lo, hi, lo, hi)


def color_transform(cx):
    if cx is None:
        return None
    from swf_renderer_tpu_torch.models import display

    mult, add = cx
    return display.ColorTransform(mult=tuple(v / 256.0 for v in mult),
                                  add=tuple(v / 255.0 for v in add))


def fill_solid(c):
    from swf_renderer_tpu_torch.models import ast

    return ast.SolidFill(color=rgba(c))


def fill_linear(m, stops):
    from swf_renderer_tpu_torch.models import ast

    return ast.LinearGradientFill(
        matrix=matrix(m),
        gradient=ast.Gradient(
            spread=ast.GradientSpread.PAD,
            color_space=ast.ColorSpace.S_RGB,
            colors=tuple(ast.GradientStop(ratio=int(r), color=rgba(c))
                         for r, c in stops)))


def stages(clip):
    """Fresh program objects for every frame of ``clip``: one definition
    per character (``char.port_definition()``), one Stage per frame."""
    from swf_renderer_tpu_torch.models import display

    defs = {id(c): c.port_definition() for c in clip.chars}
    return [display.Stage(
        width=clip.width, height=clip.height,
        background_color=rgba(clip.background),
        children=tuple(i.char.port_instance(i, defs[id(i.char)])
                       for i in row))
        for row in clip.frames]
