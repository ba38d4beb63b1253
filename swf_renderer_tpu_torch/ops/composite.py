"""Premultiplied-u8 quantization (port of the part of
``swf_renderer_tpu/ops/composite.py`` the fused path needs: the stage
background composite).  Blend-mode compositing belongs to the masked
program, which this port does not have yet (ROADMAP.md queue A)."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.numerics import true_div

# Blend modes the scene compiler accepts as group tokens (the executors
# that composite them are out of this port's slice).
BLEND_MODES = (
    "multiply", "screen", "lighten", "darken", "difference", "add",
    "subtract", "invert", "overlay", "hardlight",
)


def premul_to_straight_u8(frame_pm) -> np.ndarray:
    """Premultiplied float RGBA -> straight u8 through PREMULTIPLIED-u8
    quantization (ARGB32 parity): round premul and alpha to bytes first,
    then un-premultiply the bytes.  Pixels whose alpha byte is 0 are
    fully zero."""
    pm = torch.as_tensor(frame_pm, dtype=torch.float32)
    a8 = torch.round(torch.clamp(pm[..., 3:4], 0.0, 1.0) * 255.0)
    pm8 = torch.minimum(torch.round(pm[..., :3] * 255.0), a8)
    rgb8 = torch.round(pm8 * true_div(255.0, torch.clamp(a8, min=1.0)))
    out = torch.cat([rgb8, a8], dim=-1).to(torch.uint8)
    return out.cpu().numpy()
