"""The sweep's three tilings timed on the animation benchmark scene.

    python3 -m swf_renderer_tpu_torch.tools.exp_sweepcost [--config anim1080|anim512|both]
        [--wblock 64 128 256] [--bps 1 2 3 4]

Needs one NVIDIA card and ``nvcc``.  On ``anim_scene`` (seed 9, 60
frames x 3 layers, a full turn) at 1088x1920 (anim1080) and 512x512
(anim512) it times, with CUDA events (median of 5 after a warm-up), the
column tiling (``render_affine_sweep``), the row-band tiling
(``row_grid=True``) and the compacted tiling for the plan's
own (wblock, blocks_per_step) and for each ``--wblock`` x ``--bps``
override: its pre-pass ``compact_pre`` and its kernel apart, and the
whole call.  Every variant's frames are held against the column
tiling's (they must be equal).  Prints one JSON object a variant, then
the card's name and power limit.

The reference's other grid knobs (``e_chunk``, ``prefix_cheap``,
``prefilter``, ``chunk_list``, ``x_split``) shape its TPU grid and do not
exist here; its ``wchunk`` is taken and checked, but the row-band kernel
sweeps 256-column chunks whatever it says (the frames cannot differ).
"""

from __future__ import annotations

import argparse
import json

from .timing import card_line, time_ms


def measure(torch, np, config, wblocks, bpss):
    from ..ops import transform as sweep
    from ..utils.scenes import anim_scene

    height, width = (1088, 1920) if config == "anim1080" else (512, 512)
    frames = 60
    tables, colors, mats = anim_scene(height, width, frames)
    tab, colarr = sweep.affine_pieces(tables, colors, mats)
    counts = sweep.layer_piece_counts(tab)

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda()

    d_mats, d_tab, d_col = up(mats), up(tab), up(colarr)
    rules = (0,) * len(tables)
    pixels = frames * height * width

    def column():
        return sweep.render_affine_sweep(d_mats, d_tab, d_col, height, width,
                                         layer_counts=counts)

    want = column()
    rows_out = []

    def emit(variant, ms, got, **extra):
        if not torch.equal(got, want):
            raise SystemExit(f"{config} {variant}: frames differ from the "
                             "column tiling's")
        row = {"config": config, "variant": variant, "ms": ms,
               "ms_per_frame": ms / frames, "gpx_s": pixels / ms / 1e6,
               **extra}
        rows_out.append(row)
        print(json.dumps(row), flush=True)

    emit("column", time_ms(torch, column), want)

    def rows():
        return sweep.render_affine_sweep(d_mats, d_tab, d_col, height, width,
                                         layer_counts=counts, row_grid=True)

    emit("rows", time_ms(torch, rows), rows())

    plans = [sweep.plan_compact_sweep(mats, tab, height, width)]
    plans += [sweep.plan_compact_sweep(mats, tab, height, width, wblock=wb,
                                       blocks_per_step=bps)
              for wb in wblocks for bps in bpss]
    seen = set()
    for plan in plans:
        if plan is None:
            continue
        key = (plan["wblock"], plan["blocks_per_step"])
        if key in seen:
            continue
        seen.add(key)

        def pre(plan=plan):
            return sweep.compact_pre(d_mats, d_tab, plan["compact_counts"],
                                     plan["wblock"], height, width)

        tables_c = pre()

        def kernel(plan=plan, tables_c=tables_c):
            return sweep._launch_sweep_compact(
                tables_c, d_col, height, width, rules,
                plan["blocks_per_step"])

        def whole(plan=plan):
            return sweep.render_affine_sweep(d_mats, d_tab, d_col, height,
                                             width, **plan)

        emit(f"compact wblock={key[0]} bps={key[1]}", time_ms(torch, whole),
             whole(), kernel_ms=time_ms(torch, kernel),
             compact_pre_ms=time_ms(torch, pre),
             compact_counts=list(plan["compact_counts"]),
             most_crossing=tables_c.crossing.amax(dim=(0, 1)).tolist())
    return rows_out


def main() -> None:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="both",
                    choices=["anim1080", "anim512", "both"])
    ap.add_argument("--wblock", type=int, nargs="*", default=[64, 128, 256])
    ap.add_argument("--bps", type=int, nargs="*", default=[1, 3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("exp_sweepcost needs a CUDA card")
    configs = (["anim1080", "anim512"] if args.config == "both"
               else [args.config])
    for config in configs:
        measure(torch, np, config, args.wblock, args.bps)
    print(card_line())


if __name__ == "__main__":
    main()
