"""Coarse steps with explicit output copies.

    python3 -m swf_renderer_tpu_torch.tools.exp_dma

Port of the reference's ``tools/exp_dma.py``.  B1
(``render_fused_blocksn``) at one strip a plane under the nonzero rule,
with ``coarse`` consecutive packed groups a step and the resolved
strips written by explicit async copies from a 2-slot ring (``N_BUF``):
on the TPU that lifted the rule of one supergroup (the run of groups
that builds one strip block of one frame) a grid step; on this card a
block of (chunk, step) resolves every supergroup that starts in its
step's groups and writes each strip's 8 x 128 words with Hopper bulk
copies from shared memory.  The words equal B1's, byte for byte.

``main`` packs the headline scene (60 frames x 4 layers x 1088x1920,
``build_scene_edges`` seed 7, the native grouped packer with group 6 at
one strip a plane: the update lists of the reference's
``cells_split_delta_native``), then for coarse 1, 2 and 4 times
``run_variant`` with CUDA events (median of 5 after a warm-up) and
prints one JSON line each: steps, ms, Gpx/s and ``matches`` against B1;
then the card's name and power limit.  Needs one NVIDIA card and
``nvcc``.

``run_variant`` launches its kernel (``csrc/flatblock.cu``
``swf_fused_coarse``, ``csrc/coarse_device.cuh``) for tensors on the
card, runs ``dma_plain`` for tensors on the CPU, and counts its launches
in ``.launches``.  The reference's assert holds on every device:
``ng % coarse == 0`` (ValueError otherwise).  The arrays must be packed
at one strip a plane; ``dma_plain`` refuses a row id past the strip
(ValueError), the card takes the arrays as packed, as B1 does.
"""

from __future__ import annotations

import json

import torch

from ..ops import flatblock as fb
from ..ops.coverage import FILL_RULE_NONZERO, layer_rules
from ..ops.flatblock import LANE, STRIP_H
from . import exp_split

N_BUF = 2       # ring slots: csrc/coarse_device.cuh kNBuf (a test pins it)
COARSES = (1, 2, 4)
GROUP = exp_split.GROUP


def dma_plain(sidx, flags, lays, urc, ucm, uval, colors, frames: int,
              layers: int, n_strips: int, n_chunks: int, group: int = GROUP):
    """Plain version of ``run_variant`` (any ``coarse``): B1's plain
    version at one strip a plane under the nonzero rule.  ValueError when
    a row id reaches n_chunks * 8: the arrays were packed at more strips
    a plane."""
    if bool((urc >= n_chunks * STRIP_H).any()):
        raise ValueError(f"row ids reach {n_chunks * STRIP_H} ({n_chunks} "
                         f"chunks): the coarse steps take arrays packed at "
                         f"one strip a plane")
    return fb.fusedn_plain(sidx, flags, lays, urc, ucm, uval, colors, frames,
                           layers, n_strips, n_chunks, group=group)


def check_coarse(ng: int, coarse: int) -> None:
    """The reference's assert: ``coarse`` divides the groups (ValueError
    otherwise)."""
    if coarse < 1 or ng % coarse:
        raise ValueError(f"coarse={coarse} must divide the {ng} groups")


def _launch(sidx, flags, lays, urc, ucm, uval, colors, frames: int,
            layers: int, n_strips: int, n_chunks: int, group: int,
            coarse: int, out=None):
    """One launch of ``swf_fused_coarse``; ``out`` (int32, (F, NS+1, 8,
    n_chunks*128)) receives the words in place of a new tensor."""
    from ..ops import cuda_lib

    tensors = (sidx, flags, lays, urc, ucm, uval, colors)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")
    dev = sidx.device
    ns1 = n_strips + 1
    shape = (frames, ns1, STRIP_H, n_chunks * LANE)
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=dev)
    elif tuple(out.shape) != shape or out.dtype != torch.int32 or \
            out.device != dev or not out.is_contiguous():
        raise ValueError(f"out: expected contiguous int32 {shape} on {dev}")
    rules = tuple(int(r) for r in layer_rules(FILL_RULE_NONZERO, layers))
    rules_t, _, _ = fb._device_tables(rules, None, dev)
    sg_index = torch.empty(2 * frames * ns1, dtype=torch.int32, device=dev)
    err = cuda_lib.load().swf_fused_coarse(
        coarse, *(t.data_ptr() for t in tensors), rules_t.data_ptr(),
        sg_index.data_ptr(), out.data_ptr(), sidx.shape[0], group, frames,
        layers, ns1, n_chunks, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"coarse fused kernel launch failed: CUDA error "
                           f"{err}")
    return out


def run_variant(sidx, flags, lays, urc, ucm, uval, colors, frames: int,
                layers: int, n_strips: int, n_chunks: int, group: int,
                coarse: int):
    """B1's words with ``coarse`` groups a step and bulk-copied strips ->
    (F, NS+1, 8, n_chunks*128) int32 (counterpart of the reference's
    ``run_variant``; the sentinel strip block NS is left unwritten on
    the card).

    Kernel: replaces ``_kernel`` (tools/exp_dma.py:39, pallas_call
    :154).  A block of (chunk, step) resolves the supergroups starting
    in its ``coarse`` groups, each strip leaving a 2-slot shared-memory
    ring by ``cp.async.bulk`` (csrc/coarse_device.cuh).  Bound: B1's
    bytes.  Inputs as ``render_fused_blocksn``'s, packed at one strip a
    plane."""
    dev = exp_split._device_or_raise(fb._check_inputs(
        sidx, flags, lays, urc, ucm, uval, colors, frames, layers, group))
    check_coarse(sidx.shape[0], coarse)
    if dev.type == "cpu":
        return dma_plain(sidx, flags, lays, urc, ucm, uval, colors, frames,
                         layers, n_strips, n_chunks, group)
    out = _launch(sidx, flags, lays, urc, ucm, uval, colors, frames, layers,
                  n_strips, n_chunks, group, coarse)
    run_variant.launches += 1
    return out


run_variant.launches = 0


def main() -> None:
    from ..ops.flatblock import render_fused_blocksn
    from ..utils.scenes import build_scene_edges
    from .timing import card_line, time_ms

    if not torch.cuda.is_available():
        raise SystemExit("exp_dma needs a CUDA card")
    frames, layers, height, width = exp_split.HEADLINE
    tables, colors = build_scene_edges(frames, layers, height, width)
    d = exp_split.pack(tables, height, width, "cuda")
    cols = torch.as_tensor(colors, device="cuda")
    ns = d["ns"]
    args = tuple(d[k] for k in ("sidx", "flags", "lays", "urc", "ucm",
                                "uval")) + (cols, frames, layers, ns, d["nc"])
    ref = render_fused_blocksn(*args, group=GROUP)[:, :ns]
    ng = int(d["sidx"].shape[0])
    for coarse in COARSES:
        out = run_variant(*args, GROUP, coarse)[:, :ns]
        ms = time_ms(torch, lambda: run_variant(*args, GROUP, coarse))
        print(json.dumps({"coarse": coarse, "steps": ng // coarse, "ms": ms,
                          "gpx_s": frames * height * width / ms / 1e6,
                          "matches": bool(torch.equal(out, ref))}),
              flush=True)
    print(card_line())


if __name__ == "__main__":
    main()
