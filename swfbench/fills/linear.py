"""A linear gradient fill: its matrix (SWF ints) into the gradient square
and its stops ((ratio, (r, g, b, a)), ...), pad spread, sRGB."""

from __future__ import annotations

import dataclasses
from typing import Tuple

from .. import swfwrite
from ..reference.paint import gradient


@dataclasses.dataclass
class Linear:
    matrix: Tuple[int, int, int, int, int, int]
    stops: tuple

    def swf_style(self) -> bytes:
        w = swfwrite.Bits()
        swfwrite.matrix(w, self.matrix)
        out = bytearray([0x10]) + w.align()
        out.append(len(self.stops))      # pad spread, sRGB interpolation
        for ratio, c in self.stops:
            out += bytes([ratio, *c])
        return bytes(out)

    def port(self):
        from ..port import fill_linear

        return fill_linear(self.matrix, self.stops)

    def paint(self, cxform, aff, height, width, dtype, device, geo_dtype):
        return gradient(self.matrix, aff, self.stops, cxform, height, width,
                        dtype, device, geo_dtype)

    def nbytes(self) -> int:
        return 24 + 20 * len(self.stops)

    def ops(self) -> int:
        return 13 + 24 * (len(self.stops) - 1)
