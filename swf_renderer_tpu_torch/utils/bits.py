"""Bit-level readers/writers for the SWF binary format.

SWF packs shape records as variable-width big-endian-within-byte bit fields
(signed values are two's complement in their field width).
"""

from __future__ import annotations


class BitWriter:
    def __init__(self) -> None:
        self._bytes = bytearray()
        self._bitpos = 0  # bits used in the current (last) byte

    def write_ub(self, value: int, nbits: int) -> None:
        """Write an unsigned value in ``nbits`` bits."""
        if nbits == 0:
            return
        if value < 0 or value >= (1 << nbits):
            raise ValueError(f"{value} does not fit in {nbits} unsigned bits")
        for i in range(nbits - 1, -1, -1):
            bit = (value >> i) & 1
            if self._bitpos == 0:
                self._bytes.append(0)
            self._bytes[-1] |= bit << (7 - self._bitpos)
            self._bitpos = (self._bitpos + 1) % 8

    def write_sb(self, value: int, nbits: int) -> None:
        """Write a signed value in ``nbits`` bits (two's complement)."""
        if nbits == 0:
            if value != 0:
                raise ValueError("nonzero value in 0 bits")
            return
        lo = -(1 << (nbits - 1))
        hi = (1 << (nbits - 1)) - 1
        if not (lo <= value <= hi):
            raise ValueError(f"{value} does not fit in {nbits} signed bits")
        self.write_ub(value & ((1 << nbits) - 1), nbits)

    def align(self) -> None:
        self._bitpos = 0

    def bytes(self) -> bytes:
        return bytes(self._bytes)


class BitReader:
    def __init__(self, data: bytes, pos: int = 0) -> None:
        self._data = data
        self._byte = pos
        self._bit = 0

    def read_ub(self, nbits: int) -> int:
        value = 0
        for _ in range(nbits):
            if self._byte >= len(self._data):
                raise EOFError("bit stream exhausted")
            bit = (self._data[self._byte] >> (7 - self._bit)) & 1
            value = (value << 1) | bit
            self._bit += 1
            if self._bit == 8:
                self._bit = 0
                self._byte += 1
        return value

    def read_sb(self, nbits: int) -> int:
        value = self.read_ub(nbits)
        if nbits and (value >> (nbits - 1)):
            value -= 1 << nbits
        return value

    def align(self) -> None:
        if self._bit:
            self._bit = 0
            self._byte += 1

    @property
    def byte_pos(self) -> int:
        return self._byte + (1 if self._bit else 0)


def sbits_for(*values: int) -> int:
    """Minimum signed bit width holding every value (SWF 'nbits' fields)."""
    need = 1
    for v in values:
        n = 1 if v == 0 else v.bit_length() + 1  # sign bit
        need = max(need, n)
    return need


def ubits_for(*values: int) -> int:
    need = 0
    for v in values:
        need = max(need, v.bit_length())
    return need
