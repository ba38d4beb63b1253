"""The forward step of the flat-block pipeline, ready to call.

Counterpart of the reference's ``__graft_entry__.entry()``: ``entry()``
returns ``(forward, example_args)``, where ``forward`` renders a batch
of multi-layer frames through placement and resolve
(``ops.flatblock.render_flat_blocks``: one ``place_blocks`` and one
``resolve_planes_u32`` launch on the card) into packed RGBA words, and
``example_args`` are its inputs on the device.  The reference's
multi-device dry run (``dryrun_multichip``) needs a process group and
belongs to the multi-device slice (ROADMAP.md A9).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.flatblock import pack_flat_blocks, render_flat_blocks
from .ops.scanline import edges_to_cells
from .utils.device import resolve_device


def _coalesce_updates(edges, h, w, drop_zeros=False):
    """One edge table -> sorted coalesced winding delta updates (rows,
    cols, values): the numpy twin of the native splitter."""
    r, c, a, v = edges_to_cells(edges, h, w)
    rows = np.concatenate([r, r])
    cols = np.concatenate([c, c + 1])
    vals = np.concatenate([a, v - a]).astype(np.float32)
    key = rows.astype(np.int64) * (w + 2) + cols
    order = np.argsort(key, kind="stable")
    uniq, inv = np.unique(key[order], return_inverse=True)
    acc = np.zeros(len(uniq), np.float32)
    np.add.at(acc, inv, vals[order])
    keep = acc != 0.0 if drop_zeros else slice(None)
    return ((uniq[keep] // (w + 2)).astype(np.int32),
            (uniq[keep] % (w + 2)).astype(np.int32), acc[keep])


def _example_batch(b, p, e, h, w, seed=0):
    """(b, p, 4, e) edge tables of one random hexagon per (frame, layer)
    and (b, p, 4) straight colours, from a numpy seed."""
    rng = np.random.default_rng(seed)
    edges_t = np.zeros((b, p, 4, e), np.float32)
    colors = np.zeros((b, p, 4), np.float32)
    for i in range(b):
        for j in range(p):
            pts = rng.uniform(0, (w, h), size=(6, 2)).astype(np.float32)
            closed = np.concatenate([pts, pts[:1]])
            seg = np.concatenate([closed[:-1], closed[1:]], axis=1)
            edges_t[i, j, :, : len(seg)] = seg.T
            colors[i, j] = rng.uniform(0.1, 1.0, size=4)
    return edges_t, colors


def entry(device=None):
    """(forward, example_args): the flat-block forward step on 2 frames x
    3 layers x 64x256, its inputs on ``device`` (the card by default;
    raises without one unless ``device="cpu"``).

    ``forward(sidx, keep, urc, ucm, uval, colors)`` -> (2, 64, 256) int32
    packed little-endian RGBA."""
    dev = resolve_device(device)
    height, width = 64, 256
    frames, layers = 2, 3
    edges_t, colors = _example_batch(b=frames, p=layers, e=128,
                                     h=height, w=width)
    # Delta encoding: G[c] += area, G[c+1] += cover - area, coalesced and
    # sorted row-major (the native splitter's contract).
    update_lists = [
        [_coalesce_updates(edges_t[i, j].T, height, width)
         for j in range(layers)]
        for i in range(frames)
    ]
    sidx, keep, urc, ucm, uval, ns, nc = pack_flat_blocks(
        update_lists, height, width, block_pad_multiple=64)

    def forward(si, ke, rc, cm, uv, col):
        return render_flat_blocks(si, ke, rc, cm, uv, col, height, width,
                                  frames, layers, ns, nc)

    args = tuple(torch.from_numpy(x).to(dev)
                 for x in (sidx, keep, urc, ucm, uval, colors))
    return forward, args
