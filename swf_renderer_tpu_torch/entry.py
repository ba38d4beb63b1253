"""The forward step of the flat-block pipeline, ready to call.

Counterpart of the reference's ``__graft_entry__.entry()``: ``entry()``
returns ``(forward, example_args)``, where ``forward`` renders a batch
of multi-layer frames through placement and resolve
(``ops.flatblock.render_flat_blocks``: one ``place_blocks`` and one
``resolve_planes_u32`` launch on the card) into packed RGBA words, and
``example_args`` are its inputs on the device.

``dryrun_multichip(n_devices)`` is the counterpart of the reference's
multi-device dry run: it starts ``n_devices`` ranks (one a GPU over NCCL;
with ``device="cpu"`` gloo processes), joined over a ``FileStore`` in a
temporary directory, and runs one fully sharded step of each of
``parallel.mesh``'s ``render_batch_dp_tp``, ``render_scanline_dp_tp`` and
``render_fused_dp`` on them, checking shapes and that something was
drawn.
"""

from __future__ import annotations

import os
import tempfile

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


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One fully sharded render step of each mesh route on ``n_devices``
    ranks: GPUs over NCCL (raises when the machine has fewer), or gloo
    processes on the CPU with ``device="cpu"``.  Raises if a rank
    fails."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise ValueError(f"requested {n_devices} GPUs but the machine has "
                         f"{torch.cuda.device_count()}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_dryrun_rank, nprocs=n_devices, join=True,
                 args=(n_devices, os.path.join(d, "store"), dev.type))


def _dryrun_rank(rank: int, n_devices: int, store: str, device_type: str):
    import torch.distributed as dist

    if device_type == "cuda":
        torch.cuda.set_device(rank)
    else:   # the ranks share the host's cores
        torch.set_num_threads(1)
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        store=dist.FileStore(store, n_devices), rank=rank,
        world_size=n_devices)
    try:
        _dryrun_steps(n_devices, device_type)
    finally:
        dist.destroy_process_group()


def _dryrun_steps(n_devices: int, device_type: str) -> None:
    """The reference's dry run (``__graft_entry__.dryrun_multichip``): the
    dp x tp solid batch, the scanline pipeline dp x tp with its winding
    carry, and the one-block fused kernel dp-sharded over frames."""
    from .parallel.mesh import (
        make_mesh, partition_cells_by_column, render_batch_dp_tp,
        render_fused_dp, render_scanline_dp_tp,
    )

    tp = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices=n_devices, tp=tp, device=device_type)
    dp = mesh.shape["dp"]
    height, width = 32, 128 * tp
    b = dp * 2  # two frames per dp shard
    edges_t, colors = _example_batch(b=b, p=2, e=128, h=height, w=width)
    out = render_batch_dp_tp(mesh, edges_t, colors, height, width)
    assert out.shape == (b, height, width, 4), out.shape
    assert out.sum() > 0

    cell_lists = [[edges_to_cells(edges_t[i, j].T, height, width)
                   for j in range(edges_t.shape[1])] for i in range(b)]
    sr, sc, sd = partition_cells_by_column(cell_lists, width, tp=tp)
    out2 = render_scanline_dp_tp(mesh, sr, sc, sd, colors, height, width)
    assert out2.shape == (b, height, width, 4), out2.shape
    assert out2.sum() > 0

    update_lists = [
        [_coalesce_updates(edges_t[i, j].T, height, width)
         for j in range(edges_t.shape[1])]
        for i in range(b)
    ]
    out3 = render_fused_dp(mesh, update_lists, colors, height, width)
    assert tuple(out3.shape[:2]) == (b, 32), tuple(out3.shape)
    assert bool((out3 != 0).any())
