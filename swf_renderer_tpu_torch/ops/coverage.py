"""Fill-rule constants and the analytic trapezoid ramp shared by the
coverage paths.

Port of the rule helpers and of ``_h01`` / ``edge_contribution`` of
``swf_renderer_tpu/ops/coverage.py``; the coverage kernels of that module
belong to the layered backends (ROADMAP.md queue B, rows 9-11).
"""

from __future__ import annotations

import torch

FILL_RULE_NONZERO = 0
FILL_RULE_EVENODD = 1


def _h01(x):
    """Antiderivative of clamp(x, 0, 1): 0 | x^2/2 | x - 1/2."""
    return torch.where(x <= 0.0, torch.zeros_like(x),
                       torch.where(x >= 1.0, x - 0.5, 0.5 * x * x))


def edge_row_span(x0, y0, x1, y1, py):
    """The part of one edge inside pixel row ``py`` (broadcasting over all
    tensor arguments): (dy, xmn, xmx) — its signed y-extent clipped to the
    row (0 for horizontal edges and rows it misses) and the x-range it
    covers there.  Every step is one IEEE f32 operation, in the
    reference's order (``edge_contribution``, first half)."""
    sy0 = y0 - py
    sy1 = y1 - py
    cy0 = torch.clamp(sy0, 0.0, 1.0)
    cy1 = torch.clamp(sy1, 0.0, 1.0)
    dy = cy1 - cy0

    dyd = sy1 - sy0
    safe_dyd = torch.where(torch.abs(dyd) < 1e-9, torch.ones_like(dyd), dyd)
    t0 = (cy0 - sy0) / safe_dyd
    t1 = (cy1 - sy0) / safe_dyd

    dx_seg = x1 - x0
    xa = x0 + t0 * dx_seg  # absolute x at the clipped y window
    xb = x0 + t1 * dx_seg
    return dy, torch.minimum(xa, xb), torch.maximum(xa, xb)


def span_ramp(dy, xmn, xmx, px):
    """Area of pixel cell ``px`` to the right of a row span: dy * (1 - the
    mean over the span of clamp(edge_x - px, 0, 1))
    (``edge_contribution``, second half)."""
    span = xmx - xmn
    safe_span = torch.where(span < 1e-9, torch.ones_like(span), span)
    rel_mn = xmn - px
    rel_mx = xmx - px
    mean_clamped = torch.where(
        span < 1e-9,
        torch.clamp(0.5 * (rel_mn + rel_mx), 0.0, 1.0),
        (_h01(rel_mx) - _h01(rel_mn)) / safe_span,
    )
    return dy * (1.0 - mean_clamped)


def edge_contribution(x0, y0, x1, y1, px, py):
    """Signed pixel-area contribution of one edge: the area of the pixel
    row-slab to the right of the edge.  ``px``/``py`` are the pixel cell
    origins."""
    return span_ramp(*edge_row_span(x0, y0, x1, y1, py), px)


def normalize_fill_rule(fill_rule, layers: int):
    """One rule for every layer (int) or one PER LAYER (sequence — SWF
    mixes even-odd and DefineShape4 nonzero shapes in one scene).
    Returns the int form when uniform."""
    if isinstance(fill_rule, (tuple, list)):
        fill_rule = tuple(fill_rule)
        if len(fill_rule) != layers:
            raise ValueError(f"fill_rule tuple has {len(fill_rule)} "
                             f"entries for {layers} layers")
        if len(set(fill_rule)) == 1:
            return fill_rule[0]
    return fill_rule


def layer_rules(fill_rule, layers: int):
    """Normalized fill rule -> length-``layers`` per-layer rule tuple."""
    return (fill_rule if isinstance(fill_rule, tuple)
            else (fill_rule,) * layers)
