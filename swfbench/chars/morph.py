"""A DefineMorphShape2 with one straight-edged contour: start and end
anchors (n, 2) int twips, start and end solid colours."""

from __future__ import annotations

import dataclasses
import struct
from typing import Tuple

import numpy as np

from .. import swfwrite
from ..fills.solid import Solid


@dataclasses.dataclass
class Morph:
    cid: int
    pts0: np.ndarray
    pts1: np.ndarray
    color0: Tuple[int, int, int, int]
    color1: Tuple[int, int, int, int]

    def swf_tag(self) -> bytes:
        w = swfwrite.Bits()
        b0, b1 = swfwrite.bounds([self.pts0]), swfwrite.bounds([self.pts1])
        for b in (b0, b1, b0, b1):   # shape and edge bounds
            swfwrite.rect(w, *b)
            w.align()                # each RECT ends on a byte
        head = bytearray(struct.pack("<H", self.cid)) + w.align()
        head.append(0)               # no scaling / non-scaling strokes
        styles = bytes([1, 0x00, *self.color0, *self.color1, 0])
        w = swfwrite.Bits()
        w.ub(1, 4)                   # 1 fill bit
        w.ub(0, 4)                   # 0 line bits
        swfwrite.contour(w, self.pts0, None, None, 1, 1)
        w.ub(0, 6)
        start = w.align()
        w = swfwrite.Bits()
        w.ub(0, 4)
        w.ub(0, 4)
        swfwrite.contour(w, self.pts1, None, None, 0, 0)
        w.ub(0, 6)
        end = w.align()
        offset = len(styles) + len(start)
        return swfwrite.tag(84, bytes(head + struct.pack("<I", offset)
                                      + styles + start + end))

    def port_definition(self):
        from swf_renderer_tpu_torch.models import ast

        from ..port import rect, rgba

        n = len(self.pts0)
        recs = [ast.MorphStyleChangeRecord(
            move_to=ast.Vector2D(*(int(v) for v in self.pts0[0])),
            morph_move_to=ast.Vector2D(*(int(v) for v in self.pts1[0])),
            left_fill=1)]
        for i in range(n):
            j = (i + 1) % n
            d0, d1 = self.pts0[j] - self.pts0[i], self.pts1[j] - self.pts1[i]
            recs.append(ast.MorphEdgeRecord(
                delta=ast.Vector2D(int(d0[0]), int(d0[1])),
                morph_delta=ast.Vector2D(int(d1[0]), int(d1[1]))))
        return ast.DefineMorphShape(
            id=self.cid, bounds=rect([self.pts0]),
            morph_bounds=rect([self.pts1]),
            shape=ast.MorphShapeBody(
                initial_styles=ast.MorphShapeStyles(
                    fill=(ast.MorphSolidFill(color=rgba(self.color0),
                                             morph_color=rgba(self.color1)),),
                    line=()),
                records=tuple(recs)))

    def port_instance(self, inst, definition):
        from swf_renderer_tpu_torch.models import display

        from ..port import color_transform, matrix

        return display.MorphShapeInstance(
            definition=definition, ratio=inst.ratio / 65536.0,
            matrix=matrix(inst.matrix),
            color_transform=color_transform(inst.cxform))

    def _at(self, inst):
        r = inst.ratio / 65536.0
        c0 = np.asarray(self.color0, np.float64)
        c1 = np.asarray(self.color1, np.float64)
        return (self.pts1 * r + self.pts0 * (1.0 - r),
                Solid(tuple(c1 * r + c0 * (1.0 - r))))

    def outlines(self, inst, aff):
        pts, fill = self._at(inst)
        return [pts], fill

    def work(self, inst):
        pts, fill = self._at(inst)
        return 2 * 8 * len(self.pts0) + 32, [pts], 12, fill
