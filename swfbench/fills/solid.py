"""A solid fill: one straight RGBA colour."""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..reference.paint import color


@dataclasses.dataclass
class Solid:
    color: Tuple[float, float, float, float]

    def swf_style(self) -> bytes:
        return bytes([0x00, *self.color])

    def port(self):
        from ..port import fill_solid

        return fill_solid(self.color)

    def paint(self, cxform, aff, height, width, dtype, device, geo_dtype):
        return color(self.color, cxform, dtype, device)

    def nbytes(self) -> int:
        return 16

    def ops(self) -> int:
        return 0
