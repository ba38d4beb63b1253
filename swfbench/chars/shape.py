"""A DefineShape3: closed contours in twips with one fill on the left."""

from __future__ import annotations

import dataclasses
import struct
from typing import List

import numpy as np

from .. import swfwrite
from ..reference.frames import polyline


@dataclasses.dataclass
class Shape:
    """``pts[k]`` (n, 2) int anchors; edge i runs pts[i] -> pts[(i + 1) %
    n], through ``ctrl[k][i]`` where ``curved[k][i]``.  ``fill``: a fill
    object (``fills/``)."""

    cid: int
    pts: List[np.ndarray]
    ctrl: List[np.ndarray]
    curved: List[np.ndarray]
    fill: object

    def swf_tag(self) -> bytes:
        w = swfwrite.Bits()
        swfwrite.rect(w, *swfwrite.bounds(
            self.pts + [c for c, b in zip(self.ctrl, self.curved)
                        if b.any()]))
        body = bytearray(struct.pack("<H", self.cid)) + w.align()
        body += bytes([1]) + self.fill.swf_style() + bytes([0])
        body.append(1 << 4)          # 1 fill, 0 lines; 1 fill bit
        w = swfwrite.Bits()
        for pts, ctrl, curved in zip(self.pts, self.ctrl, self.curved):
            swfwrite.contour(w, pts, ctrl, curved, 1, 1)
        w.ub(0, 6)                   # end of shape
        return swfwrite.tag(32, bytes(body + w.align()))

    def port_definition(self):
        from swf_renderer_tpu_torch.models import ast

        from ..port import rect

        recs = []
        for pts, ctrl, curved in zip(self.pts, self.ctrl, self.curved):
            n = len(pts)
            recs.append(ast.StyleChangeRecord(
                move_to=ast.Vector2D(int(pts[0][0]), int(pts[0][1])),
                left_fill=1))
            for i in range(n):
                x0, y0 = (int(v) for v in pts[i])
                x1, y1 = (int(v) for v in pts[(i + 1) % n])
                cd = None
                if curved[i]:
                    cd = ast.Vector2D(int(ctrl[i][0]) - x0,
                                      int(ctrl[i][1]) - y0)
                recs.append(ast.EdgeRecord(
                    delta=ast.Vector2D(x1 - x0, y1 - y0), control_delta=cd))
        return ast.DefineShape(
            id=self.cid, bounds=rect(self.pts),
            shape=ast.ShapeBody(
                initial_styles=ast.ShapeStyles(fill=(self.fill.port(),),
                                               line=()),
                records=tuple(recs)))

    def port_instance(self, inst, definition):
        from swf_renderer_tpu_torch.models import display

        from ..port import color_transform, matrix

        return display.ShapeInstance(
            definition=definition, matrix=matrix(inst.matrix),
            color_transform=color_transform(inst.cxform))

    def outlines(self, inst, aff):
        return ([polyline(p, c, k, aff)
                 for p, c, k in zip(self.pts, self.ctrl, self.curved)],
                self.fill)

    def work(self, inst):
        nbytes = self.fill.nbytes() + sum(
            8 * len(p) + 8 * int(k.sum())
            for p, k in zip(self.pts, self.curved))
        return nbytes, self.pts, 0, self.fill
