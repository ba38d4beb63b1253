"""Fill-rule constants and normalization shared by every coverage path.

Port of the rule helpers of ``swf_renderer_tpu/ops/coverage.py``; the
coverage kernels of that module are not part of the fused flat-block path.
"""

from __future__ import annotations

FILL_RULE_NONZERO = 0
FILL_RULE_EVENODD = 1


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
