"""rc and val of each group read as one block, at any rule and spp.

    python3 -m swf_renderer_tpu_torch.tools.exp_dmamerge [--config NAME]

Port of the reference's ``tools/exp_dmamerge.py``.  B1
(``render_fused_blocksn``) reading each group's row ids and values as
the two rows of one (NG, 2, group*128) array ``urv`` (the same bytes as
``exp_split.run_merged``'s (NG, 1, 2*group*128) row), with the frame's
own strips per plane (``strips_per_plane``) and any fill rule.  The
words equal B1's at the same spp, byte for byte.

``main`` packs the scene of ``--config`` (``CONFIGS``: frames, layers,
height, width; ``build_scene_edges`` seed 7, group 6) at its strips per
plane, times B1 and ``render_rv`` on the same arrays with CUDA events
(median of 5 after a warm-up) and prints one JSON line each: ms, Gpx/s,
``matches`` / ``byte_dmax`` against B1; then the card's name and power
limit.  Needs one NVIDIA card and ``nvcc``.

``render_rv`` launches its kernel (``csrc/flatblock.cu``
``swf_fused_variant``, ``kVarMerged``) for tensors on the card, runs
``rv_plain`` for tensors on the CPU, and counts its launches in
``.launches``.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import flatblock as fb
from ..ops.coverage import FILL_RULE_NONZERO
from ..ops.flatblock import BLK
from . import exp_split

GROUP = exp_split.GROUP
CONFIGS = {
    "headline": (60, 4, 1088, 1920),
    "flat256": (60, 4, 256, 256),
    "gradients": (60, 4, 512, 512),
    "tiny": (2, 2, 64, 96),
}


def pack_rv(tables, height: int, width: int, device, group: int = GROUP):
    """Edge tables -> (``exp_split.pack``'s dict at the frame's strips per
    plane, urv (NG, 2, group*128) = rc and val stacked, spp)."""
    _, nc, ns = fb.plane_geometry(height, width)
    spp = fb.strips_per_plane(nc, ns)
    d = exp_split.pack(tables, height, width, device, group=group, spp=spp)
    return d, torch.cat([d["urc"], d["uval"]], dim=1), spp


def _as_row(urv, group: int):
    """(NG, 2, group*128) -> the same bytes as one (NG, 1, 2*group*128)
    row (a view)."""
    ng = urv.shape[0]
    if tuple(urv.shape) != (ng, 2, group * BLK) or \
            urv.dtype != torch.float32:
        raise ValueError(f"urv: expected float32 {(ng, 2, group * BLK)}, got "
                         f"{urv.dtype} {tuple(urv.shape)}")
    if not urv.is_contiguous():
        raise ValueError("urv must be contiguous")
    return urv.view(ng, 1, 2 * group * BLK)


def rv_plain(sidx, flags, lays, urv, ucm, colors, frames: int, layers: int,
             n_strips: int, n_chunks: int, group: int = GROUP,
             fill_rule=FILL_RULE_NONZERO, spp: int = 1):
    """Plain version of ``render_rv``: ``exp_split.merged_plain`` on the
    same bytes, at ``fill_rule`` and ``spp``."""
    return exp_split.merged_plain(sidx, flags, lays, _as_row(urv, group),
                                  ucm, colors, frames, layers, n_strips,
                                  n_chunks, group, fill_rule=fill_rule,
                                  spp=spp)


def render_rv(sidx, flags, lays, urv, ucm, colors, frames: int, layers: int,
              n_strips: int, n_chunks: int, group: int = GROUP,
              fill_rule=FILL_RULE_NONZERO, spp: int = 1):
    """B1's words from rc and val in one (NG, 2, group*128) block ->
    (F, NS+1, spp*8, n_chunks*128) int32 (counterpart of the reference's
    ``render_rv``; the sentinel strip block NS is left unwritten on the
    card).

    Kernel: replaces ``_rv_kernel`` (tools/exp_dmamerge.py:59,
    pallas_call :134).  B1's body reading both rows of a group's block
    (``kVarMerged``, csrc/flatblock_device.cuh), its strips sliced over
    blocks as B1's.  Bound: B1's bytes.  Inputs as
    ``render_fused_blocksn``'s with urc and uval stacked; ``n_strips`` is
    the strip-block count when ``spp > 1``."""
    row = _as_row(urv, group)
    dev = exp_split._device_or_raise(exp_split._check_merged(
        sidx, flags, lays, row, ucm, colors, frames, layers, group))
    if dev.type == "cpu":
        return rv_plain(sidx, flags, lays, urv, ucm, colors, frames, layers,
                        n_strips, n_chunks, group, fill_rule, spp)
    out = exp_split._launch("merged", sidx, flags, lays, row, ucm, None,
                            colors, frames, layers, n_strips, n_chunks,
                            group, fill_rule=fill_rule, spp=spp)
    render_rv.launches += 1
    return out


render_rv.launches = 0


def main() -> None:
    from ..ops.flatblock import render_fused_blocksn
    from ..utils.scenes import build_scene_edges
    from .timing import card_line, time_ms

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="headline", choices=CONFIGS)
    args_cli = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("exp_dmamerge needs a CUDA card")
    frames, layers, height, width = CONFIGS[args_cli.config]
    tables, colors = build_scene_edges(frames, layers, height, width)
    d, urv, spp = pack_rv(tables, height, width, "cuda")
    cols = torch.as_tensor(colors, device="cuda")
    ns, nc = d["ns"], d["nc"]
    geo = (cols, frames, layers, ns, nc)
    b1_args = (d["sidx"], d["flags"], d["lays"], d["urc"], d["ucm"],
               d["uval"]) + geo
    rv_args = (d["sidx"], d["flags"], d["lays"], urv, d["ucm"]) + geo
    b1 = render_fused_blocksn(*b1_args, group=GROUP, spp=spp)[:, :ns]
    for name, fn, a in (("base", render_fused_blocksn, b1_args),
                        ("rv-merged", render_rv, rv_args)):
        got = fn(*a, group=GROUP, spp=spp)[:, :ns]
        ms = time_ms(torch, lambda: fn(*a, group=GROUP, spp=spp))
        print(json.dumps({"config": args_cli.config, "spp": spp,
                          "variant": name, "ms": ms,
                          "gpx_s": frames * height * width / ms / 1e6,
                          "matches": bool(torch.equal(got, b1)),
                          "byte_dmax": exp_split.byte_diff(got, b1)[0]}),
              flush=True)
    print(card_line())


if __name__ == "__main__":
    main()
