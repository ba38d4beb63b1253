"""On-device morph-sweep rasterizer: host work independent of the ratio
count.

Port of ``swf_renderer_tpu/ops/morph.py``:

* **Host, once per morph shape** (``morph_pieces``): split each matched
  start/end edge pair at uniform t so every piece's |dy| <= 1 at EVERY
  ratio (|dy(r)| is linear in r, so bounded by its endpoints).  Uniform-t
  subdivision commutes with the endpoint lerp.
* **Device, per ratio** (one CUDA kernel launch for all ratios,
  ``csrc/sweep.cu``): lerp the piece tables, evaluate each piece's exact
  analytic coverage ramp, sum per pixel, fill rule, composite, quantize.

``render_morph_sweep`` launches the kernel for tensors on the card and
takes ``ops.transform.sweep_plain`` only for tensors on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .coverage import FILL_RULE_NONZERO, layer_rules, normalize_fill_rule
from .flatblock import frames_u32_to_u8
from .transform import (
    _check_sweep, _pad_tables, _run, _shift_origin, _split_uniform,
)


def morph_pieces(pairs, e_multiple: int = 128):
    """Split matched morph edge-pair tables into row-bounded pieces.

    ``pairs``: list of (edges_start (E, 4), edges_end (E, 4), color_start,
    color_end) per draw — models.morph_geometry.morph_fill_edge_pairs
    output.  Returns (tab_s, tab_e, colors_s, colors_e): tables (L, 4, 1,
    EP) f32 — x0, y0, x1, y1 — and colours (L, 4) f32.  Padding pieces are
    all-zero (degenerate, dy = 0 -> no contribution)."""
    split_s, split_e = [], []
    for es, ee, _cs, _ce in pairs:
        es = np.asarray(es, np.float64)
        ee = np.asarray(ee, np.float64)
        dy = np.maximum(np.abs(es[:, 3] - es[:, 1]),
                        np.abs(ee[:, 3] - ee[:, 1]))
        n = np.maximum(1, np.ceil(dy)).astype(int)
        split_s.append(_split_uniform(es, n))
        split_e.append(_split_uniform(ee, n))
    tab_s = _pad_tables(split_s, e_multiple)
    tab_e = _pad_tables(split_e, e_multiple)
    colors_s = np.zeros((len(pairs), 4), np.float32)
    colors_e = np.zeros((len(pairs), 4), np.float32)
    for i, (_es, _ee, cs, ce) in enumerate(pairs):
        colors_s[i], colors_e[i] = cs, ce
    return tab_s, tab_e, colors_s, colors_e


def render_morph_sweep(ratios, tab_s, tab_e, colors_s, colors_e,
                       height: int, width: int,
                       fill_rule=FILL_RULE_NONZERO, x_shift=None,
                       device=None):
    """Rasterize a morph shape at every ratio fully on device -> (R, H, W)
    int32 packed RGBA (counterpart of the TPU ``render_morph_sweep``;
    view with ``morph_frames_to_u8``).

    Kernel: replaces ``_morph_kernel`` (swf_renderer_tpu/ops/
    morph.py:98): the column sweep's instantiation without the affine
    (csrc/sweep_device.cuh tile_sweep_block) — lerp pieces and colours
    by the ratio, analytic ramps, fixed-point row sums, composite,
    quantize.  Bound on the H100: bytes (the packed output).  On a card
    it equals ``sweep_plain`` word for word (chip_smoke.py).

    ``ratios``: (R,) f32 in [0, 1]; ``tab_s`` / ``tab_e``: (L, 4, 1, EP)
    f32 (morph_pieces); ``colors_s`` / ``colors_e``: (L, 4) f32.  Tensors
    run where they lie; host arrays (morph_pieces' output as it is) go to
    ``device`` — the card unless the caller passes ``"cpu"``.
    ``x_shift``: the tile-shard origin (ops/transform.py)."""
    x_shift = _shift_origin(x_shift)
    arrays = (ratios, tab_s, tab_e, colors_s, colors_e)
    if device is not None or not all(torch.is_tensor(x) for x in arrays):
        dev = resolve_device(device)
        ratios, tab_s, tab_e, colors_s, colors_e = (
            (x if torch.is_tensor(x) else torch.from_numpy(
                np.ascontiguousarray(x, np.float32))).to(dev)
            for x in arrays)
    frames = ratios.shape[0]
    layers, ep = tab_s.shape[0], tab_s.shape[-1]
    fill_rule = normalize_fill_rule(fill_rule, layers)
    dev = _check_sweep({
        "ratios": (ratios, ((frames,),)),
        "tab_s": (tab_s, ((layers, 4, 1, ep),)),
        "tab_e": (tab_e, ((layers, 4, 1, ep),)),
        "colors_s": (colors_s, ((layers, 4),)),
        "colors_e": (colors_e, ((layers, 4),)),
    }, frames, layers, ep)
    return _run(render_morph_sweep, dev, None, tab_s, tab_e, ratios,
                colors_s, colors_e, height, width,
                layer_rules(fill_rule, layers), (ep,) * layers,
                x_shift=x_shift)


render_morph_sweep.launches = 0


def morph_frames_to_u8(frames, height: int, width: int) -> np.ndarray:
    """Sweep output -> (F, H, W, 4) u8 frames on the host.

    The port's sweeps return (F, H, W) int32 bit patterns of packed
    little-endian RGBA, row-major and unpadded — not the reference's
    padded, transposed (F, WP, HP) uint32 — so this is one copy to the
    host and a byte view, no transpose."""
    if torch.is_tensor(frames):
        frames = frames.cpu().numpy()
    return frames_u32_to_u8(np.asarray(frames).view(np.uint32), height,
                            width)
