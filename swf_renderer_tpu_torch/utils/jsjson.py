"""JSON serialization matching JavaScript's ``JSON.stringify(value, null, 2)``.

The reference's decoder golden files (``tests/*/shape.ts.json``) are compared
by exact string equality (reference ts/src/test/decode-shape.spec.ts:22), so
re-emitting them requires byte-exact JS number formatting:

* integral doubles print without a decimal point (``1``, not ``1.0``),
* non-integral doubles print with the shortest round-trip representation
  (Python's ``repr`` uses the same shortest-repr algorithm as V8),
* ``-0.0`` prints as ``0``.

Dict insertion order is preserved, mirroring JS object key order.
"""

from __future__ import annotations

import math
from typing import Any

_ESCAPES = {
    '"': '\\"',
    "\\": "\\\\",
    "\b": "\\b",
    "\f": "\\f",
    "\n": "\\n",
    "\r": "\\r",
    "\t": "\\t",
}


def format_number(x: Any) -> str:
    if isinstance(x, bool):  # bool is an int subclass; guard first
        return "true" if x else "false"
    if isinstance(x, int):
        return str(x)
    if isinstance(x, float):
        if math.isnan(x) or math.isinf(x):
            return "null"  # JSON.stringify(NaN) === "null"
        if x == int(x) and abs(x) < 1e21:
            return str(int(x))
        return repr(x)
    raise TypeError(f"not a number: {x!r}")


def _format_string(s: str) -> str:
    out = ['"']
    for ch in s:
        esc = _ESCAPES.get(ch)
        if esc is not None:
            out.append(esc)
        elif ord(ch) < 0x20:
            out.append(f"\\u{ord(ch):04x}")
        else:
            out.append(ch)
    out.append('"')
    return "".join(out)


def _stringify(value: Any, indent: str, depth: int, parts: list) -> None:
    pad = indent * (depth + 1)
    closing_pad = indent * depth
    if value is None:
        parts.append("null")
    elif isinstance(value, bool):
        parts.append("true" if value else "false")
    elif isinstance(value, (int, float)):
        parts.append(format_number(value))
    elif isinstance(value, str):
        parts.append(_format_string(value))
    elif isinstance(value, (list, tuple)):
        if not value:
            parts.append("[]")
            return
        parts.append("[\n")
        for i, item in enumerate(value):
            parts.append(pad)
            _stringify(item, indent, depth + 1, parts)
            parts.append(",\n" if i + 1 < len(value) else "\n")
        parts.append(closing_pad + "]")
    elif isinstance(value, dict):
        if not value:
            parts.append("{}")
            return
        parts.append("{\n")
        items = list(value.items())
        for i, (key, item) in enumerate(items):
            parts.append(pad + _format_string(str(key)) + ": ")
            _stringify(item, indent, depth + 1, parts)
            parts.append(",\n" if i + 1 < len(items) else "\n")
        parts.append(closing_pad + "}")
    else:
        raise TypeError(f"cannot stringify: {value!r}")


def stringify(value: Any, indent: int = 2) -> str:
    """Equivalent of ``JSON.stringify(value, null, indent)``."""
    parts: list = []
    _stringify(value, " " * indent, 0, parts)
    return "".join(parts)
