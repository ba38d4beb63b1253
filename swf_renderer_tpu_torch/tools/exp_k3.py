"""Placement as bf16 products on the tensor cores: three passes or one.

    python3 -m swf_renderer_tpu_torch.tools.exp_k3

Port of the reference's ``tools/exp_k3.py``.  B1 (``render_fused_blocksn``)
with each placement block's in-chunk deltas placed and prefix-summed by
products against the step matrix Step[k, c] = [cm_k <= c]: the value of a
slot splits exactly into three bf16 parts (``split3``: hi, mid, lo;
3 x 8 mantissa bits hold f32's 24), and either each part's product goes
into its own f32 accumulator, summed (hi + mid) + lo as the TPU's
``delta = delta + dot(part)`` (k3 False, "three"), or one accumulator is
fed the three parts along K (k3 True, "concat", the reference's
K-concatenated product).

On the headline scene (60 frames x 4 layers x 1088x1920,
``build_scene_edges`` seed 7, group 6, one strip a plane) ``main`` times
both forms with CUDA events (median of 5 after a warm-up) and prints one
JSON line a form: ms, Gpx/s, ``matches`` / ``byte_dmax`` against B1 on
the same arrays; then the card's name and power limit.  Needs one NVIDIA
card and ``nvcc``.

``run_variant`` launches its kernel (``csrc/flatblock.cu``
``swf_fused_variant``, ``kVarK3Three`` / ``kVarK3Concat``) for tensors on
the card, runs B1's plain version (``fusedn_plain``) for tensors on the
CPU, and counts its launches in ``.launches``.  Limits: one strip a
plane and the nonzero rule (the reference's), at most 8 placement blocks
a group (the kernel's; ValueError otherwise, on every device).
"""

from __future__ import annotations

import json

import torch

from ..ops import flatblock as fb
from . import exp_split

GROUP = exp_split.GROUP
pack = exp_split.pack


def split3(v):
    """f32 values -> (hi, mid, lo) bfloat16 parts with hi + mid + lo == v:
    hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), each
    rounded to nearest even — the reference's split (tools/exp_k3.py:40,
    swf_renderer_tpu/ops/flatblock.py:263), and the parts the kernel's
    B fragments carry."""
    hi = v.to(torch.bfloat16)
    hi32 = hi.to(torch.float32)
    mid = (v - hi32).to(torch.bfloat16)
    lo = (v - hi32 - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def run_variant(sidx, flags, lays, urc, ucm, uval, colors, frames: int,
                layers: int, n_strips: int, n_chunks: int, group: int,
                k3: bool):
    """B1's words with placement as bf16 products -> (F, NS+1, 8,
    n_chunks*128) int32 (counterpart of the reference's ``run_variant``;
    the sentinel strip block NS is left unwritten on the card).

    Kernel: replaces ``_kernel`` (tools/exp_k3.py:53, pallas_call :122),
    k3 False and True.  B1's grid and 32.32 carry; the layer-masked
    form's body (csrc/place_mma_device.cuh ``product_block``): a group's
    in-chunk slots form one K run, the layers fold into N, and each
    warpgroup's ``wgmma`` m64nNk16 bf16 -> f32 products (hi, mid, lo)
    take the step matrix from registers and the parts' tiles from shared
    memory: concat into one accumulator along K (so on this card it is
    the layer-masked form's product), three into one accumulator a part,
    combined (hi + mid) + lo at the resolve (two passes of eight layers
    at 16).  No shared float atomics, no row prefix.  Bound: B1's
    bytes.  On
    the card it agrees with ``fusedn_plain`` within B1's envelope (the
    tensor core sums a tile in its own order).  Inputs as
    ``render_fused_blocksn``'s at one strip a plane."""
    dev = exp_split._device_or_raise(fb._check_inputs(
        sidx, flags, lays, urc, ucm, uval, colors, frames, layers, group))
    exp_split.check_product(group, n_chunks)
    if dev.type == "cpu":
        return fb.fusedn_plain(sidx, flags, lays, urc, ucm, uval, colors,
                               frames, layers, n_strips, n_chunks,
                               group=group)
    out = exp_split._launch("k3_concat" if k3 else "k3_three", sidx, flags,
                            lays, urc, ucm, uval, colors, frames, layers,
                            n_strips, n_chunks, group)
    run_variant.launches += 1
    return out


run_variant.launches = 0


def main() -> None:
    from ..ops.flatblock import render_fused_blocksn
    from ..utils.scenes import build_scene_edges
    from .timing import card_line, time_ms

    if not torch.cuda.is_available():
        raise SystemExit("exp_k3 needs a CUDA card")
    frames, layers, height, width = exp_split.HEADLINE
    tables, colors = build_scene_edges(frames, layers, height, width)
    d = pack(tables, height, width, "cuda")
    cols = torch.as_tensor(colors, device="cuda")
    ns, nc = d["ns"], d["nc"]
    args = (d["sidx"], d["flags"], d["lays"], d["urc"], d["ucm"], d["uval"],
            cols, frames, layers, ns, nc)
    b1 = render_fused_blocksn(*args, group=GROUP)[:, :ns]
    for k3 in (False, True):
        got = run_variant(*args, GROUP, k3)[:, :ns]
        ms = time_ms(torch, lambda: run_variant(*args, GROUP, k3))
        print(json.dumps({"k3": k3, "ms": ms,
                          "gpx_s": frames * height * width / ms / 1e6,
                          "matches": bool(torch.equal(got, b1)),
                          "byte_dmax": exp_split.byte_diff(got, b1)[0]}),
              flush=True)
    print(card_line())


if __name__ == "__main__":
    main()
