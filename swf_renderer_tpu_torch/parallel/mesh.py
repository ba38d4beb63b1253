"""Rendering sharded over a device mesh of ``torch.distributed`` ranks.

Port of ``swf_renderer_tpu/parallel/mesh.py``.  The natural axes of a
rasterizer:

* **frame data-parallelism** (``dp``): frames, ratio steps and animation
  frames are independent — each rank renders its share, no collective
  runs until the result is gathered;
* **tile parallelism** (``tp``): one large frame's columns split over the
  ranks; the edge and piece tables are small and every rank holds them.

A mesh is ``dp x tp`` ranks of an already initialised default process
group (``make_mesh``): NCCL with one rank a GPU on the card, gloo with
``device="cpu"``.  Every function runs SPMD: each rank is given the same
global host inputs (as the reference's host packers see the whole
batch), renders its (dp, tp) shard on its own device through the port's
single-device route — the kernels it runs are the route's own (B9 / B10
through ``render_solid_batch``, B13, B2, the sweeps B3 / B6 / B7 at the
shards' column origins) — and returns the whole global result on every
rank, gathered with ``all_gather_into_tensor``, in the single-device
route's layout and type.  The collectives are the reference's: the winding carry
of ``render_scanline_dp_tp`` (row totals gathered over ``tp``), the
tile shards' column origins, and the gathers of the results.

Each shard's result equals the single-device route's on its frames and
columns, with two exceptions that are the reference's own:
``render_batch_dp_tp`` / ``render_frame_tile_sharded`` shift the edges
by the shard origin and ``render_scanline_dp_tp`` carries windings
between column slabs, so both round differently from a full-width frame
(the reference pins them at one level); ``render_deep_passes_sharded``
folds whole passes, which rounds differently from the serial chain.

The tile-sharded sweeps pass each shard's origin as the sweep's
``x_shift`` (ops/transform.py): the sweeps sum 32.32 fixed-point ramps on
the global pixel grid, so a shard's words equal those columns of the
unsharded frame at any shard width.  The reference's ``_tile_shard_layout``
(its TPU column-block layout, mirrored in every shard to keep its f32
partial sums) therefore has no counterpart, nor do its ``interpret`` /
``use_pallas`` parameters; ``_premul_planes_to_frames`` is
``ops.flatblock.premul_planes_to_frames``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.coverage import FILL_RULE_NONZERO
from ..utils.device import resolve_device

AXES = ("dp", "tp")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``dp x tp`` mesh of the default group's ranks (rank r at
    coordinate (r // tp, r % tp)) and this rank's device."""

    device_mesh: object   # torch.distributed.device_mesh.DeviceMesh
    device: torch.device

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.device_mesh.mesh.shape))

    @property
    def size(self) -> int:
        return int(self.device_mesh.mesh.numel())

    @property
    def rank(self) -> int:
        return dist.get_rank()

    def coordinate(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: Optional[str] = None):
        """The process group along ``axis``; None: every rank."""
        return (dist.group.WORLD if axis is None
                else self.device_mesh.get_group(axis))


def make_mesh(n_devices: Optional[int] = None, tp: int = 1,
              device=None) -> Mesh:
    """A ``(dp, tp)`` mesh over the ranks of the initialised default
    process group, ``dp = n_devices // tp`` (``n_devices``: the group's
    size when None).

    On the card (``device`` None or CUDA) the group's backend must be
    NCCL and rank r renders on GPU r; with ``device="cpu"`` it must be
    gloo.  Raises when the group has fewer ranks, or the machine fewer
    GPUs, than ``dp x tp``, and when the group has more ranks than the
    mesh: every rank of the group is a rank of the mesh."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised default process group "
            "(torch.distributed.init_process_group)")
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if world < n:
        raise ValueError(f"requested a {n}-rank mesh but the process group "
                         f"has {world} ranks")
    if world > n:
        raise ValueError(f"a {n}-rank mesh over a group of {world} ranks: "
                         "start one rank a device of the mesh")
    if tp < 1 or n % tp:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    dev = resolve_device(device)
    backend = dist.get_backend()
    if dev.type == "cuda":
        if backend != "nccl":
            raise ValueError(f"a mesh on the card runs NCCL, not {backend}")
        if torch.cuda.device_count() < n:
            raise ValueError(f"requested a {n}-GPU mesh but the machine has "
                             f"{torch.cuda.device_count()} GPUs")
        dev = torch.device("cuda", dist.get_rank())
        torch.cuda.set_device(dev)
    elif dev.type == "cpu":
        if backend != "gloo":
            raise ValueError(f"a mesh on the CPU runs gloo, not {backend}")
    else:
        raise ValueError(f"unsupported device {dev}")
    return Mesh(init_device_mesh(dev.type, (n // tp, tp),
                                 mesh_dim_names=AXES), dev)


# ---------------------------------------------------------------------------
# Shards and gathers
# ---------------------------------------------------------------------------


def _share(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} ({n}) must divide over {parts}")
    return n // parts


def _f32(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def _gather(mesh: Mesh, local, axis: Optional[str] = None):
    """Every rank's ``local`` (equal shapes) along ``axis`` (None: all
    ranks, in rank order) -> (n, *local.shape) on this rank's device; a
    numpy ``local`` comes back as numpy."""
    host = not torch.is_tensor(local)
    t = (torch.from_numpy(np.ascontiguousarray(local)) if host
         else local).to(mesh.device).contiguous()
    group = mesh.group(axis)
    n = dist.get_world_size(group)
    # The shards concatenated along the first axis (the form gloo takes).
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    with warnings.catch_warnings():
        # Newer releases name it all_gather_single; the card's may not.
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, t, group=group)
    out = out.view((n,) + tuple(t.shape))
    return out.cpu().numpy() if host else out


def _gather_frames(mesh: Mesh, local, axis: Optional[str] = None):
    """Frame shards -> the frames in order (ranks along ``axis`` hold
    consecutive frame ranges)."""
    g = _gather(mesh, local, axis)
    return g.reshape((-1,) + tuple(g.shape[2:]))


def _gather_columns(mesh: Mesh, local):
    """(F, H, ws, ...) column shards of every rank, in rank order ->
    (F, H, n * ws, ...)."""
    g = _gather(mesh, local)        # (n, F, H, ws, ...)
    n, f, h, ws = g.shape[:4]
    rest = tuple(g.shape[4:])
    perm = (1, 2, 0, 3) + tuple(range(4, g.ndim))
    g = g.transpose(perm) if isinstance(g, np.ndarray) else g.permute(perm)
    return g.reshape((f, h, n * ws) + rest)


def _shift_x(edges_t, x_off: float):
    """Edge tables (..., 4, E) moved left by ``x_off`` pixels (x0, x1)."""
    shifted = edges_t.clone()
    shifted[..., 0, :] -= x_off
    shifted[..., 2, :] -= x_off
    return shifted


# ---------------------------------------------------------------------------
# The solid batch and the scanline pipeline (B9 / B10 through coverage)
# ---------------------------------------------------------------------------


def render_batch_dp(mesh: Mesh, edges_t, colors, height: int, width: int):
    """Frame-sharded batched render: the batch splits over ``dp`` (each
    rank renders its frames with ``ops.pipeline.render_solid_batch``), the
    only communication the gather.  ``edges_t`` (B, P, 4, E), ``colors``
    (B, P, 4); B divisible by dp.  -> (B, H, W, 4) uint8."""
    from ..ops.pipeline import render_solid_batch

    per = _share(len(edges_t), mesh.shape["dp"], "frames")
    sl = slice(mesh.coordinate("dp") * per, (mesh.coordinate("dp") + 1) * per)
    local = render_solid_batch(_f32(edges_t, mesh.device)[sl],
                               _f32(colors, mesh.device)[sl], height, width)
    return _gather_frames(mesh, local, "dp")


def render_batch_dp_tp(mesh: Mesh, edges_t, colors, height: int,
                       width: int):
    """Full 2D-sharded render step: frames split over ``dp``, columns over
    ``tp``; each rank renders its frames' column span of ``width // tp``
    columns from every edge moved left by the span's origin.  -> (B, H,
    W, 4) uint8."""
    from ..ops.pipeline import render_solid_batch

    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    per = _share(len(edges_t), dp, "frames")
    shard_w = _share(width, tp, "width")
    d, t = mesh.coordinate("dp"), mesh.coordinate("tp")
    edges = _f32(edges_t, mesh.device)[d * per:(d + 1) * per]
    local = render_solid_batch(
        _shift_x(edges, float(t * shard_w)),
        _f32(colors, mesh.device)[d * per:(d + 1) * per], height, shard_w)
    g = _gather(mesh, local)        # (dp * tp, per, H, shard_w, 4)
    g = g.reshape(dp, tp, per, height, shard_w, 4).transpose(0, 2, 3, 1, 4, 5)
    return g.reshape(dp * per, height, width, 4)


def render_scanline_dp_tp(mesh: Mesh, rows, cols, delta, colors,
                          height: int, width: int,
                          fill_rule: int = FILL_RULE_NONZERO):
    """The scanline pipeline sharded over the full mesh.

    Frames shard over ``dp``; the framebuffer width over ``tp``: each rank
    scatters its column slab's cells and prefix-sums the slab; the only
    communication is the per-row winding entering each slab from the
    left — a gather of every slab's (L, H) row totals over ``tp``.
    ``rows`` / ``cols`` / ``delta`` (B, L, TP, N): cells partitioned by
    slab (``partition_cells_by_column``, cols local to the slab);
    ``colors`` (B, L, 4).  -> (B, H, W, 4) uint8."""
    from ..ops.composite import composite_solid_layers, premul_to_straight_u8
    from ..ops.flatblock import _fill_cov

    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    w_local = _share(width, tp, "width")
    stride = w_local + 1
    b, l, tp_in, _ = np.shape(rows)
    if tp_in != tp:
        raise ValueError(f"cells for {tp_in} slabs on a mesh of tp={tp}")
    per = _share(b, dp, "frames")
    d, t = mesh.coordinate("dp"), mesh.coordinate("tp")
    dev = mesh.device
    sl = slice(d * per, (d + 1) * per)

    def mine(x, dtype):
        return torch.as_tensor(np.asarray(x)[sl, :, t], dtype=dtype,
                               device=dev)

    fr, fc, fd = (mine(rows, torch.int64), mine(cols, torch.int64),
                  mine(delta, torch.float32))
    plane_elems = height * stride
    idx = (torch.arange(per, device=dev)[:, None, None] * (l * plane_elems)
           + torch.arange(l, device=dev)[None, :, None] * plane_elems
           + fr * stride + fc)
    plane = torch.zeros(per * l * plane_elems, dtype=torch.float32,
                        device=dev).index_add_(0, idx.reshape(-1),
                                               fd.reshape(-1))
    local_cum = torch.cumsum(plane.view(per, l, height, stride), dim=3)
    totals = local_cum[..., stride - 1].contiguous()   # (per, L, H)
    gathered = _gather(mesh, totals, "tp")             # (TP, per, L, H)
    left = (torch.arange(tp, device=dev) < t)[:, None, None, None]
    carry = torch.where(left, gathered, torch.zeros_like(gathered)).sum(0)
    cov = _fill_cov(local_cum[..., :w_local] + carry[..., None], fill_rule)
    local = premul_to_straight_u8(composite_solid_layers(
        cov, _f32(colors, dev)[sl]))
    g = _gather(mesh, local)        # (dp * tp, per, H, w_local, 4)
    g = g.reshape(dp, tp, per, height, w_local, 4).transpose(
        0, 2, 3, 1, 4, 5)
    return g.reshape(b, height, width, 4)


def partition_cells_by_column(cell_lists, width: int, tp: int,
                              pad_multiple: int = 256):
    """Host helper: per-draw (rows, cols, area, cover) -> column-sharded,
    delta-encoded update arrays for :func:`render_scanline_dp_tp`.

    Returns (rows, cols_local, delta) of shape (B, L, TP, N)."""
    w_local = width // tp
    stride = w_local + 1
    b = len(cell_lists)
    l = len(cell_lists[0])
    per = [[[None] * tp for _ in range(l)] for _ in range(b)]
    max_n = 1
    for i in range(b):
        for j in range(l):
            r, c, a, v = cell_lists[i][j]
            # Delta encoding on the GLOBAL grid: updates at (r, c) and
            # (r, c+1).  An update at a shard's right edge (local col ==
            # w_local) lands in the local stride column, whose cumsum value
            # feeds the carry but not local pixels — exactly right, since
            # that cover belongs to shards further right.
            up = np.concatenate([c, c + 1])
            ur = np.concatenate([r, r])
            uv = np.concatenate([a, v - a]).astype(np.float32)
            shard = np.minimum(up // w_local, tp - 1)
            local = up - shard * w_local
            for s in range(tp):
                m = shard == s
                per[i][j][s] = (ur[m], local[m], uv[m])
                max_n = max(max_n, int(m.sum()))
    n = ((max_n + pad_multiple - 1) // pad_multiple) * pad_multiple
    rows = np.zeros((b, l, tp, n), np.int32)
    cols = np.zeros((b, l, tp, n), np.int32)
    delta = np.zeros((b, l, tp, n), np.float32)
    for i in range(b):
        for j in range(l):
            for s in range(tp):
                ur, uc, uv = per[i][j][s]
                k = len(ur)
                rows[i, j, s, :k] = ur
                cols[i, j, s, :k] = np.minimum(uc, stride - 1)
                delta[i, j, s, :k] = uv
    return rows, cols, delta


def render_frame_tile_sharded(mesh: Mesh, edges_t, colors, height: int,
                              width: int):
    """One large frame sharded by column spans across every rank: each
    rank rasterizes its ``width // n`` columns from the edges moved left
    by its span's origin.  ``edges_t`` (P, 4, E), ``colors`` (P, 4).
    -> (H, W, 4) uint8."""
    from ..ops.pipeline import render_solid_batch

    shard_w = _share(width, mesh.size, "width")
    local = render_solid_batch(
        _shift_x(_f32(edges_t, mesh.device)[None],
                 float(mesh.rank * shard_w)),
        _f32(colors, mesh.device)[None], height, shard_w)
    return _gather_columns(mesh, local)[0]


# ---------------------------------------------------------------------------
# The one-block fused kernel (B13)
# ---------------------------------------------------------------------------


def render_fused_dp(mesh: Mesh, update_lists, colors, height: int,
                    width: int):
    """Data-parallel flat-block render: frames shard over ``dp``, each rank
    running the one-block fused kernel (B13, ``render_fused_blocks``) on
    its own frames.

    ``update_lists``: [frames][layers] of (rows, cols, vals).  Each rank
    packs its shard's frames (``pack_flat_blocks``, ``sort_blocks_fused``)
    and pads them, as the reference pads every shard, to the common
    block count with blocks on the sentinel strip.  -> (F, NS*8, stride)
    int32 packed RGBA."""
    from ..ops.flatblock import (
        LANE, pack_flat_blocks, plane_geometry, render_fused_blocks,
        sort_blocks_fused,
    )

    dp = mesh.shape["dp"]
    frames = len(update_lists)
    layers = len(update_lists[0])
    per = _share(frames, dp, "frames")
    d = mesh.coordinate("dp")
    _, n_chunks, n_strips = plane_geometry(height, width)
    packed = pack_flat_blocks(update_lists[d * per:(d + 1) * per], height,
                              width, block_pad_multiple=128)
    blocks = sort_blocks_fused(*packed[:5], layers, n_strips,
                               block_pad_multiple=128)
    count = torch.tensor([blocks[0].shape[0]], device=mesh.device)
    dist.all_reduce(count, op=dist.ReduceOp.MAX, group=mesh.group("dp"))
    pad = int(count) - blocks[0].shape[0]
    if pad:
        # sidx padding targets the sentinel strip; keep 1, last 0, zeros.
        fills = (n_strips, 1, 0, 0, 0, 0)
        blocks = tuple(np.concatenate([x, np.full((pad,) + x.shape[1:], v,
                                                  x.dtype)])
                       for x, v in zip(blocks, fills))
    col = np.asarray(colors, np.float32)[d * per:(d + 1) * per]
    local = render_fused_blocks(*blocks, col, per, layers, n_strips,
                                n_chunks, device=mesh.device)
    out = _gather_frames(mesh, local, "dp")
    return out[:, :n_strips].reshape(frames, n_strips * 8, n_chunks * LANE)


# ---------------------------------------------------------------------------
# The sweeps (B3, B6, B7): frame shards and tile shards
# ---------------------------------------------------------------------------


def _frame_share(mesh: Mesh, n: int) -> slice:
    """This rank's frames when the frame axis splits over every rank."""
    per = _share(n, mesh.size, "frames")
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _tile(mesh: Mesh, width: int):
    """(shard width, this rank's column origin) of a frame split by column
    spans over every rank."""
    ws = _share(width, mesh.size, "width")
    return ws, mesh.rank * ws


def render_morph_sweep_dp(mesh: Mesh, ratios, parts, height: int,
                          width: int):
    """Ratio-sharded morph sweep over every rank (dp x tp): each renders
    its ratios with ``ops.morph.render_morph_sweep`` (B7), the piece
    tables every rank's.  ``parts``: morph_pieces output.  -> (R, H, W)
    int32 packed RGBA (``morph_frames_to_u8``)."""
    from ..ops.morph import render_morph_sweep

    ratios = _f32(ratios, mesh.device)
    local = render_morph_sweep(
        ratios[_frame_share(mesh, len(ratios))].contiguous(),
        *(_f32(p, mesh.device) for p in parts), height, width)
    return _gather_frames(mesh, local)


def render_morph_sweep_tile_sharded(mesh: Mesh, ratios, parts, height: int,
                                    width: int):
    """One wide morph ratio sweep sharded by column spans: each rank
    renders its ``width // n`` columns for every ratio, its span's origin
    the sweep's ``x_shift`` (B7).  -> (R, H, W) int32."""
    from ..ops.morph import render_morph_sweep

    ws, x0 = _tile(mesh, width)
    local = render_morph_sweep(
        _f32(ratios, mesh.device), *(_f32(p, mesh.device) for p in parts),
        height, ws, x_shift=x0)
    return _gather_columns(mesh, local)


def render_morph_affine_sweep_tile_sharded(mesh: Mesh, matrices, ratios,
                                           parts, height: int, width: int):
    """Combined morph + transform sweep sharded by column spans (B6 at
    the span's origin): the frame matrices stay global, each rank's span origin
    rides ``x_shift``.  ``parts``: morph_affine_pieces output.  -> (F, H,
    W) int32."""
    from ..ops.transform import render_morph_affine_sweep

    ws, x0 = _tile(mesh, width)
    dev = mesh.device
    local = render_morph_affine_sweep(
        _f32(matrices, dev), _f32(ratios, dev),
        *(_f32(p, dev) for p in parts), height, ws, x_shift=x0)
    return _gather_columns(mesh, local)


def render_affine_sweep_tile_sharded(mesh: Mesh, matrices, parts,
                                     height: int, width: int, paints=None,
                                     grad_mats=None, fields=None):
    """One large animated frame set sharded by column spans across every
    rank (the transform sweep's twin of ``render_frame_tile_sharded``):
    the piece tables are every rank's, each rank renders its span for
    every frame with the span's origin as ``x_shift`` (B3);
    matrices and gradient matrices stay global.  ``fields`` (NF, F, H, W,
    4) are device-space planes: each rank reads its span's columns.
    ``parts``: affine_pieces output (tab, colors).  -> (F, H, W) int32."""
    from ..ops.transform import render_affine_sweep

    ws, x0 = _tile(mesh, width)
    dev = mesh.device
    local = render_affine_sweep(
        _f32(matrices, dev), *(_f32(p, dev) for p in parts), height, ws,
        paints=paints,
        grad_mats=None if grad_mats is None else _f32(grad_mats, dev),
        fields=(None if fields is None
                else _f32(fields[:, :, :, x0:x0 + ws], dev)),
        x_shift=x0)
    return _gather_columns(mesh, local)


def render_affine_sweep_dp(mesh: Mesh, matrices, parts, height: int,
                           width: int, paints=None, grad_mats=None,
                           fields=None):
    """Frame-sharded transform sweep over every rank (dp x tp): each renders
    its frames with ``ops.transform.render_affine_sweep`` (B3), the piece
    tables every rank's; ``grad_mats`` and ``fields`` (NF, F, H, W, 4:
    axis 1 is the frame) shard with the matrices.  ``parts``:
    affine_pieces output (tab, colors).  -> (F, H, W) int32."""
    from ..ops.transform import render_affine_sweep

    dev = mesh.device
    sl = _frame_share(mesh, len(matrices))
    local = render_affine_sweep(
        _f32(np.asarray(matrices, np.float32)[sl], dev),
        *(_f32(p, dev) for p in parts), height, width, paints=paints,
        grad_mats=(None if grad_mats is None
                   else _f32(np.asarray(grad_mats, np.float32)[sl], dev)),
        fields=None if fields is None else _f32(fields[:, sl], dev))
    return _gather_frames(mesh, local)


def render_morph_affine_sweep_dp(mesh: Mesh, matrices, ratios, parts,
                                 height: int, width: int):
    """Frame-sharded combined morph + transform sweep (B6): the matrix and
    ratio tracks shard over every rank, the piece-pair tables are every
    rank's.  ``parts``: morph_affine_pieces output.  -> (F, H, W)
    int32."""
    from ..ops.transform import render_morph_affine_sweep

    dev = mesh.device
    sl = _frame_share(mesh, len(matrices))
    local = render_morph_affine_sweep(
        _f32(np.asarray(matrices, np.float32)[sl], dev),
        _f32(np.asarray(ratios, np.float32)[sl], dev),
        *(_f32(p, dev) for p in parts), height, width)
    return _gather_frames(mesh, local)


# ---------------------------------------------------------------------------
# The styled kernel's routes (B2)
# ---------------------------------------------------------------------------


def render_styled_dp(mesh: Mesh, gsi, gfl, gla, grc, gcm, gvv, colors,
                     fields, frames: int, layers: int, n_strips: int,
                     n_chunks: int, paints, group: int = 8, spp: int = 1):
    """Frame-sharded STYLED fused render: each dp rank runs the styled
    flat-block kernel (B2, ``render_fused_styled``) over its frames'
    blocks; the field planes (frame-invariant chunk-major planes) are
    every rank's.  Block arrays come packed per shard and stacked
    (each dp shard's frames packed apart with pack_grouped_native, padded
    to a common group count on the sentinel strip).

    gsi / gfl (D, NG), gla (D, group, NG), grc / gcm / gvv (D, NG, ...),
    colors (D, per, L, 4).  -> (frames, NS+1, spp*8, stride) int32."""
    from ..ops.flatblock import render_fused_styled

    _share(frames, mesh.shape["dp"], "frames")
    d = mesh.coordinate("dp")
    dev = mesh.device
    ints = [torch.as_tensor(x[d], dtype=torch.int32, device=dev)
            for x in (gsi, gfl, gla)]
    flts = [_f32(x[d], dev) for x in (grc, gcm, gvv, colors)]
    per = flts[3].shape[0]
    local = render_fused_styled(
        *ints, *flts, tuple(_f32(f, dev) for f in fields), per, layers,
        n_strips, n_chunks, paints, group=group, spp=spp)
    return _gather_frames(mesh, local, "dp")


def render_deep_passes_sharded(mesh: Mesh, edge_tables, colors,
                               height: int, width: int,
                               fill_rule: int = FILL_RULE_NONZERO,
                               group: int = 6, axis: str = "dp"):
    """Deep draw lists with the PASS axis sharded over the mesh.

    ``over`` on premultiplied planes is associative, so each rank along
    ``axis`` renders ONE consecutive layer group over transparent (B2's
    chain form, ``emit="premul"``), and the planes fold across the ranks —
    top pass g applied as ``P_g + acc * (1 - alpha_g)``, on every rank
    after the gather.  The fold applies each pass's keep product once
    instead of layer by layer, so it matches the single-device chain
    within one premultiplied level (as the reference's).

    ``edge_tables``: [frames][layers] device-space edge tables;
    ``colors``: (F, L, 4) straight RGBA (solid layers).  Layers pad up to a
    multiple of the axis with empty transparent layers.  -> (F, H, W, 4)
    uint8."""
    from ..native.bindings import pack_grouped_native
    from ..ops.composite import premul_to_straight_u8
    from ..ops.flatblock import (
        KernelPaint, plane_geometry, premul_planes_to_frames,
        render_fused_styled,
    )
    from ..ops.pipeline import lower_update_lists

    g_n = mesh.shape[axis]
    g = mesh.coordinate(axis)
    frames = len(edge_tables)
    layers = len(edge_tables[0])
    lp = -(-layers // g_n)
    colors = np.asarray(colors, np.float32)
    if colors.shape != (frames, layers, 4):
        raise ValueError(f"colors must be (F={frames}, L={layers}, 4)")
    pad_l = g_n * lp - layers
    if pad_l:
        empty = np.zeros((0, 4), np.float32)
        edge_tables = [list(per) + [empty] * pad_l for per in edge_tables]
        colors = np.concatenate(
            [colors, np.zeros((frames, pad_l, 4), np.float32)], axis=1)
    _, nc, ns = plane_geometry(height, width)
    sub = [per[g * lp:(g + 1) * lp] for per in edge_tables]
    gsi, gfl, gla, grc, gcm, gvv, _, _ = pack_grouped_native(
        lower_update_lists(sub, height, width), height, width, group=group,
        spp=1)
    dev = mesh.device
    ints = [torch.as_tensor(x, dtype=torch.int32, device=dev)
            for x in (gsi, gfl, gla)]
    planes = render_fused_styled(
        *ints, *(_f32(x, dev) for x in (grc, gcm, gvv)),
        _f32(colors[:, g * lp:(g + 1) * lp], dev), (), frames, lp, ns, nc,
        tuple(KernelPaint.color() for _ in range(lp)), group=group,
        fill_rule=fill_rule, spp=1, chain=True, bg=None, emit="premul")
    planes = _gather(mesh, planes, axis)
    acc = planes[0]
    for top in planes[1:]:
        acc = top + acc * (1.0 - top[:, :, 3:4])
    return premul_to_straight_u8(
        premul_planes_to_frames(acc, height, width, nc, 1))


def render_masked_dp(mesh: Mesh, edge_tables, paints, height: int,
                     width: int, colors, mask_tree, fill_rule=None):
    """Data-parallel MASKED / BLENDED render: frames shard over ``dp``,
    each rank running the whole group-composite program of
    ``ops.pipeline.render_batch_styled(mask_tree=)`` (B2's fused passes,
    premultiplied plane algebra, the quantizing pass) on its own frames.
    Packing is frame-local, so the result is the single-device program's
    byte for byte.  -> (F, H, W, 4) uint8."""
    from ..ops.pipeline import render_batch_styled

    per = _share(len(edge_tables), mesh.shape["dp"], "frames")
    sl = slice(mesh.coordinate("dp") * per, (mesh.coordinate("dp") + 1) * per)
    local = render_batch_styled(
        edge_tables[sl], paints, height, width,
        colors=np.asarray(colors, np.float32)[sl],
        fill_rule=FILL_RULE_NONZERO if fill_rule is None else fill_rule,
        mask_tree=mask_tree, device=mesh.device)
    return _gather_frames(mesh, local, "dp")
