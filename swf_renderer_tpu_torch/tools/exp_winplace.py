"""Window-targeted placement: per-strip placement blocks, local row ids.

    python3 -m swf_renderer_tpu_torch.tools.exp_winplace [--config NAME]

Port of the reference's ``tools/exp_winplace.py``.  The grouped packer
pools the ``spp`` strips of a strip block into shared placement blocks;
``pack_windowed`` packs each strip's updates into blocks of their own,
with row ids LOCAL to the strip's window of n_chunks * 8 plane rows and
a per-slot window index ``wins`` (group, NG) beside the layer table.
``render_win`` is B1 (``render_fused_blocksn``) over those blocks: the
same words, byte for byte, at any rule and strips per plane.  The TPU
shrank its one-hot product to the window; on this card the window only
replaces the division that finds a slot's strip, and the repack's extra
groups are what it costs (every chunk block of a strip block walks its
supergroup's list).

``main`` packs the scene of ``--config`` (``CONFIGS``: frames, layers,
height, width; ``build_scene_edges`` seed 7, group 6) with the native
grouped packer and with ``pack_windowed`` at the frame's strips per
plane, prints the group counts and the windowed packing time, times B1
and ``render_win`` on them with CUDA events (median of 5 after a
warm-up) and prints one JSON line each: ms, Gpx/s, ``matches`` /
``byte_dmax`` against B1; then the card's name and power limit.  Needs
one NVIDIA card and ``nvcc``.

``render_win`` launches its kernel (``csrc/flatblock.cu``
``swf_fused_win``, ``kVarWin``) for tensors on the card, runs
``win_plain`` for tensors on the CPU, and counts its launches in
``.launches``.  ``win_rows`` (the window's height) is None or n_chunks *
8 (ValueError otherwise, on every device).  The reference's default of
128 rows places wrongly at several strips a plane unless n_chunks * 8
is 128 (its window start ``win * (W // 8) * 8`` runs past the strip's
rows).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops import flatblock as fb
from ..ops.coverage import FILL_RULE_NONZERO, layer_rules
from ..ops.flatblock import BLK, LANE, STRIP_H
from . import exp_split

GROUP = exp_split.GROUP
CONFIGS = {
    "headline": (60, 4, 1088, 1920),
    "flat256": (60, 4, 256, 256),
    "gradients": (60, 4, 512, 512),
    "textured": (16, 4, 1024, 1024),
    "tiny": (2, 2, 64, 96),
}


def pack_windowed(update_lists, height: int, width: int, group: int,
                  spp: int):
    """Per-strip placement blocks with local row ids and a per-slot
    window index (a copy of the reference's ``pack_windowed``) ->
    (sidx (NG,), flags (NG,), lays (group, NG), wins (group, NG) int32,
    urc (NG, 1, group*128), ucm (NG, group*128, 1), uval (NG, 1,
    group*128) float32, strip blocks, chunks, unpadded group count), NG
    padded to a multiple of 256 with groups of flags 0 aimed at frame
    0's sentinel strip block.  ``update_lists[f][l]`` = (rows, cols,
    vals), rows ascending.  Each (frame, strip block) gets at least one
    group; within a strip the updates keep their order, so a row's
    winding sums as in the pooled packing."""
    f_n = len(update_lists)
    l_n = len(update_lists[0])
    stride, nc, ns = fb.plane_geometry(height, width)
    nsb = -(-ns // spp)
    ns1 = nsb + 1

    out_sidx, out_flags, out_lays, out_wins = [], [], [], []
    out_rc, out_cm, out_vv = [], [], []
    zero = np.zeros(BLK, np.float32)

    split = {}
    for i in range(f_n):
        for j in range(l_n):
            rows, cols, vals = update_lists[i][j]
            keep = cols < stride   # drop col == width overflow
            rows, cols, vals = rows[keep], cols[keep], vals[keep]
            strip = rows // STRIP_H if len(rows) else rows
            bounds = np.searchsorted(strip, np.arange(ns + 1))
            split[i, j] = (rows, cols, vals, bounds)

    for i in range(f_n):
        for sb in range(nsb):
            blocks = []   # (lay, win, rc, cm, vv)
            for j in range(l_n):
                rows, cols, vals, bounds = split[i, j]
                for s in range(sb * spp, min(ns, (sb + 1) * spp)):
                    lo, hi = int(bounds[s]), int(bounds[s + 1])
                    if hi == lo:
                        continue
                    nb = -(-(hi - lo) // BLK)
                    rc = np.zeros(nb * BLK, np.float32)
                    cm = np.zeros(nb * BLK, np.float32)
                    vv = np.zeros(nb * BLK, np.float32)
                    c = cols[lo:hi]
                    rc[:hi - lo] = ((c // LANE) * STRIP_H
                                    + rows[lo:hi] % STRIP_H)
                    cm[:hi - lo] = c % LANE
                    vv[:hi - lo] = vals[lo:hi]
                    for b in range(nb):
                        sl = slice(b * BLK, (b + 1) * BLK)
                        blocks.append((j, s - sb * spp, rc[sl], cm[sl],
                                       vv[sl]))
            if not blocks:
                blocks.append((0, 0, zero, zero, zero))
            padded = list(blocks)
            while len(padded) % group:
                padded.append(None)
            n_steps = len(padded) // group
            for k in range(n_steps):
                sub = padded[k * group:(k + 1) * group]
                flags = (1 if k == 0 else 0) \
                    | (2 if k == n_steps - 1 else 0) \
                    | (sum(b is not None for b in sub) << 2)
                out_sidx.append((i * l_n) * ns1 + sb)
                out_flags.append(flags)
                out_lays.append([b[0] if b is not None else 0 for b in sub])
                out_wins.append([b[1] if b is not None else 0 for b in sub])
                out_rc.append(np.concatenate(
                    [b[2] if b is not None else zero for b in sub]))
                out_cm.append(np.concatenate(
                    [b[3] if b is not None else zero for b in sub]))
                out_vv.append(np.concatenate(
                    [b[4] if b is not None else zero for b in sub]))
    ng = len(out_sidx)
    ng_pad = ((ng + 255) // 256) * 256
    for _ in range(ng_pad - ng):
        out_sidx.append(nsb)   # frame 0's sentinel strip block
        out_flags.append(0)
        out_lays.append([0] * group)
        out_wins.append([0] * group)
        out_rc.append(np.zeros(group * BLK, np.float32))
        out_cm.append(np.zeros(group * BLK, np.float32))
        out_vv.append(np.zeros(group * BLK, np.float32))
    return (np.asarray(out_sidx, np.int32),
            np.asarray(out_flags, np.int32),
            np.asarray(out_lays, np.int32).T.copy(),
            np.asarray(out_wins, np.int32).T.copy(),
            np.stack(out_rc)[:, None, :],
            np.stack(out_cm)[:, :, None],
            np.stack(out_vv)[:, None, :],
            nsb, nc, ng)


def pack(tables, height: int, width: int, device, group: int = GROUP,
         spp: int | None = None):
    """Edge tables -> (dict, spp): ``pack_windowed``'s arrays at ``spp``
    strips a plane (the frame's own by default) as tensors on ``device``
    (sidx, flags, lays, wins, urc, ucm, uval) and the counts ns (strip
    blocks), nc and ng (groups before the padding)."""
    from ..ops.pipeline import lower_update_lists

    if spp is None:
        _, nc, ns = fb.plane_geometry(height, width)
        spp = fb.strips_per_plane(nc, ns)
    packed = pack_windowed(lower_update_lists(tables, height, width),
                           height, width, group, spp)
    names = ("sidx", "flags", "lays", "wins", "urc", "ucm", "uval")
    d = {name: torch.from_numpy(np.ascontiguousarray(x)).to(device)
         for name, x in zip(names, packed[:7])}
    d.update(ns=int(packed[7]), nc=int(packed[8]), ng=int(packed[9]))
    return d, spp


def _check_wins(wins, lays):
    if wins.device != lays.device or wins.dtype != torch.int32 or \
            tuple(wins.shape) != tuple(lays.shape):
        raise ValueError(f"wins: expected int32 {tuple(lays.shape)} on "
                         f"{lays.device}, got {wins.dtype} "
                         f"{tuple(wins.shape)} on {wins.device}")


def win_plain(sidx, flags, lays, wins, urc, ucm, uval, colors, frames: int,
              layers: int, n_strips: int, n_chunks: int, group: int = GROUP,
              fill_rule=FILL_RULE_NONZERO, spp: int = 1):
    """Plain version of ``render_win``: B1's plain version
    (``fusedn_plain``) on the row ids made global, urc + win * n_chunks *
    8 for every slot (exact in f32)."""
    ng = urc.shape[0]
    off = wins.t().to(torch.float32) * float(n_chunks * STRIP_H)
    rows = urc + off.repeat_interleave(BLK, dim=1).view(ng, 1, group * BLK)
    return fb.fusedn_plain(sidx, flags, lays, rows, ucm, uval, colors,
                           frames, layers, n_strips, n_chunks, group=group,
                           fill_rule=fill_rule, spp=spp)


def _launch(sidx, flags, lays, wins, urc, ucm, uval, colors, frames: int,
            layers: int, n_strips: int, n_chunks: int, group: int,
            fill_rule, spp: int):
    """One launch of ``swf_fused_win``."""
    from ..ops import cuda_lib

    tensors = (sidx, flags, lays, wins, urc, ucm, uval, colors)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")
    dev = sidx.device
    ns1 = n_strips + 1
    out = torch.empty((frames, ns1, spp * STRIP_H, n_chunks * LANE),
                      dtype=torch.int32, device=dev)
    rules = tuple(int(r) for r in layer_rules(fill_rule, layers))
    rules_t, _, _ = fb._device_tables(rules, None, dev)
    sg_index = torch.empty(2 * frames * ns1, dtype=torch.int32, device=dev)
    err = cuda_lib.load().swf_fused_win(
        *(t.data_ptr() for t in tensors), rules_t.data_ptr(),
        sg_index.data_ptr(), out.data_ptr(), sidx.shape[0], group, frames,
        layers, ns1, n_chunks, spp, fb.plane_rows_for(n_chunks, spp),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"windowed fused kernel launch failed: CUDA "
                           f"error {err}")
    return out


def render_win(sidx, flags, lays, wins, urc, ucm, uval, colors, frames: int,
               layers: int, n_strips: int, n_chunks: int, group: int = GROUP,
               fill_rule=FILL_RULE_NONZERO, spp: int = 1, win_rows=None):
    """B1's words from per-strip placement blocks -> (F, NS+1, spp*8,
    n_chunks*128) int32 (counterpart of the reference's ``render_win``;
    the sentinel strip block NS is left unwritten on the card).

    Kernel: replaces ``_win_kernel`` (tools/exp_winplace.py:75,
    pallas_call :161).  B1's body with each slot's strip taken from
    ``wins`` and its row id local to that strip (``kVarWin``,
    csrc/flatblock_device.cuh), strips sliced over blocks as B1's.
    Bound: bytes, B1's over these arrays (``wins`` included).  Inputs:
    ``pack_windowed``'s arrays; ``n_strips`` is the strip-block count
    when ``spp > 1``."""
    if win_rows is not None and win_rows != n_chunks * STRIP_H:
        raise ValueError(f"win_rows={win_rows}: a strip window is "
                         f"{n_chunks * STRIP_H} rows ({n_chunks} chunks)")
    dev = exp_split._device_or_raise(fb._check_inputs(
        sidx, flags, lays, urc, ucm, uval, colors, frames, layers, group))
    _check_wins(wins, lays)
    if dev.type == "cpu":
        return win_plain(sidx, flags, lays, wins, urc, ucm, uval, colors,
                         frames, layers, n_strips, n_chunks, group,
                         fill_rule, spp)
    out = _launch(sidx, flags, lays, wins, urc, ucm, uval, colors, frames,
                  layers, n_strips, n_chunks, group, fill_rule, spp)
    render_win.launches += 1
    return out


render_win.launches = 0


def main() -> None:
    from ..ops.flatblock import render_fused_blocksn
    from ..utils.scenes import build_scene_edges
    from .timing import card_line, time_ms

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="headline", choices=CONFIGS)
    args_cli = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("exp_winplace needs a CUDA card")
    frames, layers, height, width = CONFIGS[args_cli.config]
    tables, colors = build_scene_edges(frames, layers, height, width)
    _, nc, ns = fb.plane_geometry(height, width)
    spp = fb.strips_per_plane(nc, ns)
    base = exp_split.pack(tables, height, width, "cuda", spp=spp)
    t0 = time.perf_counter()
    win, _ = pack(tables, height, width, "cuda", spp=spp)
    t_pack = time.perf_counter() - t0
    cols = torch.as_tensor(colors, device="cuda")
    geo = (cols, frames, layers, base["ns"], base["nc"])
    print(json.dumps({"config": args_cli.config, "spp": spp,
                      "win_rows": nc * STRIP_H,
                      "groups_base": int(base["sidx"].shape[0]),
                      "groups_windowed": win["ng"],
                      "pack_windowed_ms": t_pack * 1e3}), flush=True)
    b1_args = tuple(base[k] for k in ("sidx", "flags", "lays", "urc", "ucm",
                                      "uval")) + geo
    win_args = tuple(win[k] for k in ("sidx", "flags", "lays", "wins", "urc",
                                      "ucm", "uval")) + geo
    ns = base["ns"]
    b1 = render_fused_blocksn(*b1_args, group=GROUP, spp=spp)[:, :ns]
    for name, fn, a in (("base", render_fused_blocksn, b1_args),
                        ("windowed", render_win, win_args)):
        got = fn(*a, group=GROUP, spp=spp)[:, :ns]
        ms = time_ms(torch, lambda: fn(*a, group=GROUP, spp=spp))
        print(json.dumps({"config": args_cli.config, "variant": name,
                          "ms": ms,
                          "gpx_s": frames * height * width / ms / 1e6,
                          "matches": bool(torch.equal(got, b1)),
                          "byte_dmax": exp_split.byte_diff(got, b1)[0]}),
              flush=True)
    print(card_line())


if __name__ == "__main__":
    main()
