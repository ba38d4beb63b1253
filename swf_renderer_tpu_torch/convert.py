"""Carry the reference renderer's state into the port.

The renderer has no weights: its state is paints, draw lists and packed
scenes.  These helpers read plain attributes (numpy arrays and Python
values) from any object or dict that has the fields, so state built by
the JAX package — or loaded from disk — becomes the port's without this
module importing that package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops import flatblock as fb
from .ops import style as style_ops
from .runtime.scene import Draw
from .utils.device import resolve_device


def _get(obj, name, default=None):
    if isinstance(obj, dict):
        return obj.get(name, default)
    return getattr(obj, name, default)


def paint_from_numpy(obj) -> style_ops.Paint:
    """Any object/dict with the ``Paint`` fields -> a port ``Paint``."""
    values = {}
    for field in dataclasses.fields(style_ops.Paint):
        v = _get(obj, field.name, field.default)
        if field.name in ("stop_ratios", "stop_colors") and v is not None:
            v = np.asarray(v, np.float32)
        elif field.name == "image" and v is not None:
            v = np.asarray(v, np.uint8)
        elif field.name in ("color", "inv_matrix"):
            v = tuple(float(x) for x in v)
        values[field.name] = v
    return style_ops.Paint(**values)


def draws_from_numpy(draws):
    """A sequence of draw-like objects/dicts (edges, paint, fill_rule,
    mask_of, mask_ids) -> port ``Draw``s."""
    return [
        Draw(edges=np.asarray(_get(d, "edges"), np.float32),
             paint=paint_from_numpy(_get(d, "paint")),
             fill_rule=int(_get(d, "fill_rule", 0)),
             mask_of=_get(d, "mask_of"),
             mask_ids=tuple(_get(d, "mask_ids", ()) or ()))
        for d in draws
    ]


def packed_to_device(gsi, gfl, gla, grc, gcm, gvv, ns, nc, device):
    """Grouped packer arrays (numpy) -> the kernels' input tensors on
    ``device``: dict with sidx, flags, lays, urc, ucm, uval and the
    strip-block / chunk counts ns, nc."""
    def put(x, dtype):
        arr = np.ascontiguousarray(np.asarray(x), dtype)
        return torch.from_numpy(arr).to(device)

    return {
        "sidx": put(gsi, np.int32), "flags": put(gfl, np.int32),
        "lays": put(gla, np.int32), "urc": put(grc, np.float32),
        "ucm": put(gcm, np.float32), "uval": put(gvv, np.float32),
        "ns": int(ns), "nc": int(nc),
    }


def sweep_table_to_device(tab, sub=None, device=None) -> torch.Tensor:
    """A sweep piece table of the reference, (L, 4, 1, EP) numpy, -> the
    port's piece tensor of the same shape on ``device`` (the card unless
    the caller asks for the CPU).

    The reference carries a second, sublane-layout copy of the same
    coordinates for its row one-hot (``subxy`` (L, 4, EP, 1) from
    ``affine_pieces``, or ``suby`` (L, 2, EP, 1) — the y0, y1 channels —
    from ``morph_pieces``).  The port derives row bases from the one
    table with the same expression, so ``sub`` is only checked against
    ``tab`` and dropped."""
    tab = np.ascontiguousarray(np.asarray(tab), np.float32)
    if tab.ndim != 4 or tab.shape[1:3] != (4, 1):
        raise ValueError(f"piece table {tab.shape}, expected (L, 4, 1, EP)")
    if sub is not None:
        sub = np.asarray(sub)
        channels = (0, 1, 2, 3) if sub.shape[1] == 4 else (1, 3)
        if not np.array_equal(sub[..., 0], tab[:, channels, 0, :]):
            raise ValueError("sublane copy disagrees with the piece table")
    return torch.from_numpy(tab).to(resolve_device(device))


def kernel_paints_from_numpy(paints):
    """KernelPaint-like tuples (kind, inv_matrix, stop_ratios, stop_colors
    flat, focal, spread, slot) -> the port's ``KernelPaint`` tuple."""
    out = []
    for p in paints:
        kind, inv, ratios, colors, focal, spread, slot = p
        if kind == fb.KPAINT_COLOR:
            out.append(fb.KernelPaint.color())
        elif kind == fb.KPAINT_FIELD:
            out.append(fb.KernelPaint.field(slot))
        else:
            out.append(fb.KernelPaint.gradient(kind, inv, ratios, colors,
                                               focal=focal, spread=spread))
    return tuple(out)
