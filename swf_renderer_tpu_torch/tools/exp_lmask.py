"""Layer-masked placement: one product a layer over a whole group.

    python3 -m swf_renderer_tpu_torch.tools.exp_lmask

Port of the reference's ``tools/exp_lmask.py``.  In place of one update
a placement block into the block's (dynamically indexed) layer plane,
every layer takes a product over ALL of a group's slots with the values
of the other layers masked to zero, into an accumulator of its own
(static on the TPU: a compile-time index; here one warpgroup product
with the layers side by side in its N dimension, whose zeros are the
masking, into an accumulator that lives in registers across the whole
walk).  No dynamic layer index.  Every slot is placed (the reference
does not skip a group's unused slots); the planes are 128 rows, so the
frame is at most 16 chunks (2047 px) wide at one strip a plane.

On the headline scene (60 frames x 4 layers x 1088x1920,
``build_scene_edges`` seed 7, group 6, one strip a plane) ``main`` times
B1 and ``render_lmask`` with CUDA events (median of 5 after a warm-up)
and prints one JSON line each: ms, Gpx/s, ``matches`` / ``byte_dmax``
against B1 on the same arrays; then the card's name and power limit.
Needs one NVIDIA card and ``nvcc``.

``render_lmask`` launches its kernel (``csrc/flatblock.cu``
``swf_fused_variant``, ``kVarLmask``) for tensors on the card, runs
``lmask_plain`` for tensors on the CPU, and counts its launches in
``.launches``.
"""

from __future__ import annotations

import json

import torch

from ..ops import flatblock as fb
from ..ops.coverage import FILL_RULE_NONZERO
from . import exp_split

GROUP = exp_split.GROUP
pack = exp_split.pack


def lmask_plain(sidx, flags, lays, urc, ucm, uval, colors, frames: int,
                layers: int, n_strips: int, n_chunks: int, group: int = GROUP,
                fill_rule=FILL_RULE_NONZERO):
    """Plain version of ``render_lmask``: B1's plain version
    (``fusedn_plain``) with every slot of every group placed (the used-
    slot count of the flags dropped)."""
    return fb.fusedn_plain(sidx, torch.bitwise_and(flags, 3), lays, urc,
                           ucm, uval, colors, frames, layers, n_strips,
                           n_chunks, group=group, fill_rule=fill_rule)


def render_lmask(sidx, flags, lays, urc, ucm, uval, colors, frames: int,
                 layers: int, n_strips: int, n_chunks: int,
                 group: int = GROUP, fill_rule=FILL_RULE_NONZERO):
    """B1's words with layer-masked products -> (F, NS+1, 8,
    n_chunks*128) int32 (counterpart of the reference's ``render_lmask``;
    the sentinel strip block NS is left unwritten on the card).  Raises
    ValueError when the chunk-major plane is not 128 rows
    (``plane_rows_for(n_chunks) != 128``: the reference's planes are
    fixed at 128 rows) or the group holds more than 8 placement blocks.

    Kernel: replaces ``_lmask_kernel`` (tools/exp_lmask.py:36,
    pallas_call :117).  B1's grid and 32.32 carry; a group's in-chunk
    slots, whatever their block or layer, form one K run; with the layer
    folded into N, each warpgroup's ``wgmma`` m64nNk16 bf16 -> f32
    products (N = 8 x the layer class, hi / mid / lo along K) take the
    step matrix from registers and the parts' tile from shared memory
    into one accumulator kept in registers over the walk, and the
    resolve reads it there (csrc/place_mma_device.cuh ``product_block``).
    Bound: B1's bytes.  On the card it agrees with ``lmask_plain``
    within B1's envelope.  Inputs as ``render_fused_blocksn``'s at one
    strip a plane."""
    dev = exp_split._device_or_raise(fb._check_inputs(
        sidx, flags, lays, urc, ucm, uval, colors, frames, layers, group))
    exp_split.check_product(group, n_chunks)
    if dev.type == "cpu":
        return lmask_plain(sidx, flags, lays, urc, ucm, uval, colors, frames,
                           layers, n_strips, n_chunks, group, fill_rule)
    out = exp_split._launch("lmask", sidx, flags, lays, urc, ucm, uval,
                            colors, frames, layers, n_strips, n_chunks,
                            group, fill_rule=fill_rule)
    render_lmask.launches += 1
    return out


render_lmask.launches = 0


def main() -> None:
    from ..ops.flatblock import render_fused_blocksn
    from ..utils.scenes import build_scene_edges
    from .timing import card_line, time_ms

    if not torch.cuda.is_available():
        raise SystemExit("exp_lmask needs a CUDA card")
    frames, layers, height, width = exp_split.HEADLINE
    tables, colors = build_scene_edges(frames, layers, height, width)
    d = pack(tables, height, width, "cuda")
    cols = torch.as_tensor(colors, device="cuda")
    ns, nc = d["ns"], d["nc"]
    args = (d["sidx"], d["flags"], d["lays"], d["urc"], d["ucm"], d["uval"],
            cols, frames, layers, ns, nc)
    b1 = render_fused_blocksn(*args, group=GROUP)[:, :ns]
    for name, fn in (("fusedn", render_fused_blocksn),
                     ("lmask", render_lmask)):
        got = fn(*args, group=GROUP)[:, :ns]
        ms = time_ms(torch, lambda: fn(*args, group=GROUP))
        print(json.dumps({"kernel": name, "ms": ms,
                          "gpx_s": frames * height * width / ms / 1e6,
                          "matches": bool(torch.equal(got, b1)),
                          "byte_dmax": exp_split.byte_diff(got, b1)[0]}),
              flush=True)
    print(card_line())


if __name__ == "__main__":
    main()
