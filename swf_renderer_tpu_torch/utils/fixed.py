"""Fixed-point number types used by the SWF format.

The SWF matrix scale/skew terms are signed 16.16 fixed-point values
("Sfixed16P16").  The reference keeps them as an ``epsilons`` integer and
converts with ``.valueOf()`` (epsilons / 65536) only when applying the matrix
(see reference ts/src/lib/renderers/canvas-renderer.ts:179-188).  The decoder
goldens serialize them as ``{"epsilons": N}`` objects, so we must preserve the
raw integer exactly.
"""

from __future__ import annotations

import dataclasses

EPSILONS_PER_UNIT = 1 << 16


@dataclasses.dataclass(frozen=True)
class Sfixed16P16:
    """Signed 16.16 fixed point, stored as raw epsilons (1/65536 units)."""

    epsilons: int

    @staticmethod
    def from_value(value: float) -> "Sfixed16P16":
        return Sfixed16P16(int(round(value * EPSILONS_PER_UNIT)))

    @staticmethod
    def from_epsilons(epsilons: int) -> "Sfixed16P16":
        return Sfixed16P16(int(epsilons))

    def value(self) -> float:
        return self.epsilons / EPSILONS_PER_UNIT

    def __float__(self) -> float:
        return self.value()
