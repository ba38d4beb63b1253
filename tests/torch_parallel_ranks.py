"""The rank program of tests/test_torch_parallel.py, and its cases.

Run as ``python tests/torch_parallel_ranks.py RANK WORLD TP STORE OUT``:
one gloo rank of a ``WORLD``-rank group joined over the ``FileStore``
``STORE``, on a ``(WORLD // TP, TP)`` mesh of
``swf_renderer_tpu_torch.parallel.mesh``.  Every rank runs every case of
``CASES`` (the same collectives in the same order) and rank 0 writes the
results to the ``.npz`` file ``OUT``.  The rank refuses to import JAX or
the JAX package.

``CASES`` maps a name to (build, sharded, single): ``build()`` makes the
case's inputs from a numpy seed, ``sharded(mesh, inputs)`` runs the mesh
function and ``single(inputs)`` the port's single-device route on the
CPU that it is held to.  Before the cases every rank runs the dry run of
``swf_renderer_tpu_torch.entry.dryrun_multichip`` on the same group
(its steps, which raise if a shape or a drawing check fails), and rank 0
records the world it ran at under ``dryrun_world``.
"""

import sys

import numpy as np


def _blob(rng, width, height, n=6, lo=(0, 0)):
    pts = rng.uniform(lo, (width, height), (n, 2)).astype(np.float32)
    closed = np.concatenate([pts, pts[:1]])
    return np.concatenate([closed[:-1], closed[1:]], axis=1)


def demo_batch(b=4, p=2, e=128, h=32, w=128, seed=42):
    """(B, P, 4, E) tables of one random pentagon a (frame, draw) and
    (B, P, 4) colours (tests/test_parallel.py _demo_batch)."""
    rng = np.random.default_rng(seed)
    edges_t = np.zeros((b, p, 4, e), np.float32)
    colors = np.zeros((b, p, 4), np.float32)
    for i in range(b):
        for j in range(p):
            seg = _blob(rng, w, h, n=5)
            edges_t[i, j, :, :len(seg)] = seg.T
            colors[i, j] = rng.uniform(0.2, 1.0, size=4)
    return edges_t, colors, h, w


def _lower(table, h, w, drop_zeros=False):
    from swf_renderer_tpu_torch.entry import _coalesce_updates

    return _coalesce_updates(table, h, w, drop_zeros=drop_zeros)


# --- the solid batch and the scanline pipeline -----------------------------


def build_batch():
    return demo_batch()


def sharded_batch_dp(mesh, inputs):
    from swf_renderer_tpu_torch.parallel.mesh import render_batch_dp

    return render_batch_dp(mesh, *inputs)


def sharded_batch_dp_tp(mesh, inputs):
    from swf_renderer_tpu_torch.parallel.mesh import render_batch_dp_tp

    return render_batch_dp_tp(mesh, *inputs)


def single_batch(inputs):
    from swf_renderer_tpu_torch.ops.pipeline import render_solid_batch

    edges_t, colors, h, w = inputs
    return render_solid_batch(edges_t, colors, h, w, device="cpu")


def build_frame():
    edges_t, colors, h, w = demo_batch(b=1, seed=7)
    return edges_t[0], colors[0], h, w


def sharded_frame(mesh, inputs):
    from swf_renderer_tpu_torch.parallel.mesh import (
        render_frame_tile_sharded,
    )

    return render_frame_tile_sharded(mesh, *inputs)


def single_frame(inputs):
    edges, colors, h, w = inputs
    return single_batch((edges[None], colors[None], h, w))[0]


def build_scanline():
    """Cell lists of 4 frames x 2 layers of random heptagons reaching past
    the frame (tests/test_parallel.py's scanline scene)."""
    from swf_renderer_tpu_torch.ops.scanline import edges_to_cells

    rng = np.random.default_rng(9)
    b, l, h, w = 4, 2, 32, 128
    colors = rng.uniform(0.2, 1, (b, l, 4)).astype(np.float32)
    cells = [[edges_to_cells(_blob(rng, w + 10, h + 10, n=7, lo=(-10, -10)),
                             h, w) for _ in range(l)] for _ in range(b)]
    return cells, colors, h, w


def sharded_scanline(mesh, inputs):
    from swf_renderer_tpu_torch.parallel.mesh import (
        partition_cells_by_column, render_scanline_dp_tp,
    )

    cells, colors, h, w = inputs
    tp = mesh.shape["tp"]
    return render_scanline_dp_tp(
        mesh, *partition_cells_by_column(cells, w, tp=tp), colors, h, w)


def single_scanline(inputs):
    from swf_renderer_tpu_torch.ops.scanline import (
        pack_cells, render_scanline_batch,
    )

    cells, colors, h, w = inputs
    packed = [pack_cells(per) for per in cells]
    n = max(p[0].shape[1] for p in packed)

    def stack(k, dtype):
        out = np.zeros((len(cells), len(cells[0]), n), dtype)
        for i, p in enumerate(packed):
            out[i, :, :p[k].shape[1]] = p[k]
        return out

    return render_scanline_batch(
        stack(0, np.int32), stack(1, np.int32), stack(2, np.float32),
        stack(3, np.float32), colors, h, w, device="cpu")


# --- the one-block fused kernel --------------------------------------------


def build_fused():
    rng = np.random.default_rng(13)
    frames, layers, h, w = 4, 2, 32, 200
    tables = [[_blob(rng, w, h) for _ in range(layers)]
              for _ in range(frames)]
    colors = rng.uniform(0.2, 1.0, (frames, layers, 4)).astype(np.float32)
    updates = [[_lower(t, h, w) for t in per] for per in tables]
    return updates, colors, h, w


def sharded_fused(mesh, inputs):
    from swf_renderer_tpu_torch.parallel.mesh import render_fused_dp

    return render_fused_dp(mesh, *inputs)


def single_fused(inputs):
    from swf_renderer_tpu_torch.ops.flatblock import (
        pack_flat_blocks, plane_geometry, render_fused_blocks,
        sort_blocks_fused,
    )

    updates, colors, h, w = inputs
    frames, layers = len(updates), len(updates[0])
    _, nc, ns = plane_geometry(h, w)
    packed = pack_flat_blocks(updates, h, w, block_pad_multiple=128)
    blocks = sort_blocks_fused(*packed[:5], layers, ns,
                               block_pad_multiple=128)
    out = render_fused_blocks(*blocks, colors, frames, layers, ns, nc,
                              device="cpu")
    return out[:, :ns].reshape(frames, ns * 8, -1)


# --- the sweeps ------------------------------------------------------------


def rotations(n, cx, cy, step, scale=1.0):
    mats = []
    for i in range(n):
        th = step * i
        a, b = scale * np.cos(th), scale * np.sin(th)
        mats.append((a, b, -b, a, cx - a * cx + b * cy, cy - b * cx - a * cy))
    return np.asarray(mats, np.float32)


def morph_pairs(h, w, seed=73):
    rng = np.random.default_rng(seed)
    tbl_s = _blob(rng, w / 2, h - 5, n=5, lo=(5, 5))
    tbl_e = tbl_s + rng.uniform(-6, 6, tbl_s.shape).astype(np.float32)
    return [(tbl_s, tbl_e, (1, 0, 0, 1), (0, 0.4, 1, 1))]


def build_morph():
    from swf_renderer_tpu_torch.ops.morph import morph_pieces

    h, w = 40, 128
    return (np.linspace(0, 1, 8, dtype=np.float32),
            morph_pieces(morph_pairs(h, w)), h, w)


def sharded_morph_dp(mesh, inputs):
    from swf_renderer_tpu_torch.parallel.mesh import render_morph_sweep_dp

    return render_morph_sweep_dp(mesh, *inputs)


def sharded_morph_tiles(mesh, inputs):
    from swf_renderer_tpu_torch.parallel.mesh import (
        render_morph_sweep_tile_sharded,
    )

    return render_morph_sweep_tile_sharded(mesh, *inputs)


def single_morph(inputs):
    from swf_renderer_tpu_torch.ops.morph import render_morph_sweep

    ratios, parts, h, w = inputs
    return render_morph_sweep(ratios, *parts, h, w, device="cpu")


def build_morph_affine():
    from swf_renderer_tpu_torch.ops.transform import morph_affine_pieces

    h, w = 40, 128
    mats = rotations(8, 64.0, 20.0, 2 * np.pi / 24)
    ratios = np.linspace(0, 1, 8, dtype=np.float32)
    return mats, ratios, morph_affine_pieces(morph_pairs(h, w), mats), h, w


def sharded_morph_affine_dp(mesh, inputs):
    from swf_renderer_tpu_torch.parallel.mesh import (
        render_morph_affine_sweep_dp,
    )

    return render_morph_affine_sweep_dp(mesh, *inputs)


def sharded_morph_affine_tiles(mesh, inputs):
    from swf_renderer_tpu_torch.parallel.mesh import (
        render_morph_affine_sweep_tile_sharded,
    )

    return render_morph_affine_sweep_tile_sharded(mesh, *inputs)


def single_morph_affine(inputs):
    import torch

    from swf_renderer_tpu_torch.ops.transform import (
        render_morph_affine_sweep,
    )

    mats, ratios, parts, h, w = inputs
    return render_morph_affine_sweep(
        torch.as_tensor(mats), torch.as_tensor(ratios),
        *(torch.as_tensor(p) for p in parts), h, w)


def styled_sweep_scene(h=24, w=64, frames=4, seed=71):
    """Three layers — solid, linear gradient, bitmap — under rotations
    (tests/test_parallel.py's tile-sharded scene, cut to size):
    (mats, parts, kwargs of render_affine_sweep)."""
    from swf_renderer_tpu_torch.ops import style as style_ops
    from swf_renderer_tpu_torch.ops.transform import (
        affine_pieces, bake_sweep_fields, sweep_paints,
    )

    rng = np.random.default_rng(seed)
    tables = [_blob(rng, w - 10, h - 5, lo=(10, 5)) for _ in range(3)]
    img = rng.integers(0, 256, (8, 8, 4)).astype(np.uint8)
    paints = [
        style_ops.solid_paint((0.8, 0.3, 0.2, 0.9)),
        style_ops.Paint(
            kind=style_ops.PAINT_LINEAR,
            inv_matrix=(120.0, 10.0, -10.0, 120.0, -16384.0, -2000.0),
            stop_ratios=np.array([0.0, 1.0], np.float32),
            stop_colors=np.array([[1, 0, 0, 1], [0, 0, 1, 1]],
                                 np.float32)),
        style_ops.Paint(
            kind=style_ops.PAINT_BITMAP,
            inv_matrix=(0.1, 0.02, -0.02, 0.1, 0.0, 0.0),
            image=img, repeating=True, smoothed=True, supersample=1),
    ]
    mats = rotations(frames, w / 2.0, h / 2.0, 2 * np.pi / 16)
    parts = affine_pieces(tables, [(0, 0, 0, 0)] * 3, mats)
    kpaints, grad_mats, specs = sweep_paints(paints, mats,
                                             allow_fields=True)
    fields = bake_sweep_fields(specs, h, w, device="cpu")
    return mats, parts, dict(paints=kpaints, grad_mats=grad_mats,
                             fields=fields), h, w


def fuzz_scene(seed):
    """tests/test_parallel.py's exactness fuzz scene for ``seed``."""
    from swf_renderer_tpu_torch.ops.transform import affine_pieces

    rng = np.random.default_rng(seed)
    h = int(rng.integers(24, 72))
    w = int(rng.choice([512, 1024]))
    layers = int(rng.integers(1, 4))
    tables, colors = [], []
    for _ in range(layers):
        pts = rng.uniform((2, 2), (w - 2.0, h - 2.0),
                          (int(rng.integers(4, 9)), 2)).astype(np.float32)
        closed = np.concatenate([pts, pts[:1]])
        tables.append(np.concatenate([closed[:-1], closed[1:]], axis=1))
        colors.append(tuple(rng.uniform(0.1, 1.0, 4)))
    f = int(rng.integers(2, 6))
    mats = []
    for _ in range(f):
        th = rng.uniform(0, 2 * np.pi)
        s = rng.uniform(0.6, 1.4)
        a, b = s * np.cos(th), s * np.sin(th)
        cx, cy = w / 2.0, h / 2.0
        mats.append((a, b, -b, a, cx - a * cx + b * cy,
                     cy - b * cx - a * cy))
    mats = np.asarray(mats, np.float32)
    return mats, affine_pieces(tables, colors, mats), {}, h, w


def unaligned_scene():
    """tests/test_parallel.py's unaligned fallback: 1920 wide, spans that
    fall on no 128-column tile."""
    from swf_renderer_tpu_torch.ops.transform import affine_pieces

    rng = np.random.default_rng(19)
    h, w = 24, 1920
    pts = rng.uniform((4, 2), (1900.0, 22.0), (7, 2)).astype(np.float32)
    closed = np.concatenate([pts, pts[:1]])
    tables = [np.concatenate([closed[:-1], closed[1:]], axis=1)]
    mats = rotations(3, 960.0, 12.0, 2 * np.pi / 12)
    return mats, affine_pieces(tables, [(0.9, 0.2, 0.1, 0.8)], mats), {}, h, w


def sharded_affine_tiles(mesh, inputs):
    from swf_renderer_tpu_torch.parallel.mesh import (
        render_affine_sweep_tile_sharded,
    )

    mats, parts, kw, h, w = inputs
    return render_affine_sweep_tile_sharded(mesh, mats, parts, h, w, **kw)


def sharded_affine_dp(mesh, inputs):
    from swf_renderer_tpu_torch.parallel.mesh import render_affine_sweep_dp

    mats, parts, kw, h, w = inputs
    return render_affine_sweep_dp(mesh, mats, parts, h, w, **kw)


def single_affine(inputs):
    import torch

    from swf_renderer_tpu_torch.ops.transform import render_affine_sweep

    mats, parts, kw, h, w = inputs
    kw = dict(kw)
    if kw.get("grad_mats") is not None:
        kw["grad_mats"] = torch.as_tensor(kw["grad_mats"])
    return render_affine_sweep(torch.as_tensor(mats),
                               *(torch.as_tensor(p) for p in parts), h, w,
                               **kw)


# --- the styled kernel's routes --------------------------------------------


def build_styled():
    """Four frames of a solid and an in-kernel linear gradient layer,
    packed per dp shard (2 shards) and as one batch."""
    from swf_renderer_tpu_torch.native.bindings import pack_grouped_native
    from swf_renderer_tpu_torch.ops import style as style_ops
    from swf_renderer_tpu_torch.ops.pipeline import kernel_paints_for

    rng = np.random.default_rng(31)
    frames, h, w, dp = 4, 32, 200, 2
    paints = [
        style_ops.solid_paint((0.9, 0.4, 0.1, 0.9)),
        style_ops.Paint(kind=style_ops.PAINT_LINEAR,
                        inv_matrix=(200.0, 0.0, 0.0, 200.0,
                                    -16384.0, -3000.0),
                        stop_ratios=np.array([0.0, 1.0], np.float32),
                        stop_colors=np.array([[1, 0, 0, 1], [0, 0, 1, 1]],
                                             np.float32)),
    ]
    layers = len(paints)
    updates = [[_lower(_blob(rng, w, h), h, w, drop_zeros=True)
                for _ in range(layers)] for _ in range(frames)]
    kpaints, fields, base = kernel_paints_for(paints, h, w, device="cpu")
    colors = np.broadcast_to(base, (frames, layers, 4)).copy()
    whole = pack_grouped_native(updates, h, w, group=4, group_pad_multiple=4)
    per = frames // dp
    shards = [pack_grouped_native(updates[d * per:(d + 1) * per], h, w,
                                  group=4, group_pad_multiple=4)
              for d in range(dp)]
    ng = max(s[0].shape[0] for s in shards)
    ns = whole[6]

    def pad(x, fill=0):
        out = np.full((ng,) + x.shape[1:], fill, x.dtype)
        out[:x.shape[0]] = x
        return out

    stacked = (np.stack([pad(s[0], ns) for s in shards]),
               np.stack([pad(s[1]) for s in shards]),
               np.stack([np.pad(s[2], ((0, 0), (0, ng - s[2].shape[1])))
                         for s in shards]),
               *(np.stack([pad(s[k]) for s in shards]) for k in (3, 4, 5)))
    return (whole, stacked, colors, fields, kpaints, frames, layers, whole[6],
            whole[7])


def sharded_styled(mesh, inputs):
    from swf_renderer_tpu_torch.parallel.mesh import render_styled_dp

    _, stacked, colors, fields, kpaints, frames, layers, ns, nc = inputs
    dp = 2
    if mesh.shape["dp"] != dp:
        raise ValueError("the styled case is packed for dp = 2")
    return render_styled_dp(
        mesh, *stacked, colors.reshape(dp, frames // dp, layers, 4), fields,
        frames, layers, ns, nc, kpaints, group=4)


def single_styled(inputs):
    import torch

    from swf_renderer_tpu_torch.ops.flatblock import render_fused_styled

    whole, _, colors, fields, kpaints, frames, layers, ns, nc = inputs
    ints = [torch.as_tensor(x, dtype=torch.int32) for x in whole[:3]]
    flts = [torch.as_tensor(x) for x in whole[3:6]]
    return render_fused_styled(*ints, *flts, torch.as_tensor(colors),
                               fields, frames, layers, ns, nc, kpaints,
                               group=4)


def build_deep():
    """2 frames of 24 solid layers (two passes of 12 on a dp = 2 axis)."""
    rng = np.random.default_rng(17)
    h, w, layers, frames = 32, 160, 24, 2
    colors = rng.uniform(0.1, 1.0, (frames, layers, 4)).astype(np.float32)
    tables = [[_blob(rng, w, h, n=5) for _ in range(layers)]
              for _ in range(frames)]
    return tables, colors, h, w


def sharded_deep(mesh, inputs):
    from swf_renderer_tpu_torch.parallel.mesh import (
        render_deep_passes_sharded,
    )

    return render_deep_passes_sharded(mesh, *inputs)


def deep_fold(inputs, g_n=2, group=6):
    """The pass fold of render_deep_passes_sharded on one device: each
    layer group over transparent, then the planes folded bottom up."""
    import torch

    from swf_renderer_tpu_torch.native.bindings import pack_grouped_native
    from swf_renderer_tpu_torch.ops.composite import premul_to_straight_u8
    from swf_renderer_tpu_torch.ops.flatblock import (
        KernelPaint, plane_geometry, premul_planes_to_frames,
        render_fused_styled,
    )
    from swf_renderer_tpu_torch.ops.pipeline import lower_update_lists

    tables, colors, h, w = inputs
    frames, layers = len(tables), len(tables[0])
    lp = layers // g_n
    _, nc, ns = plane_geometry(h, w)
    acc = None
    for g in range(g_n):
        sub = [per[g * lp:(g + 1) * lp] for per in tables]
        packed = pack_grouped_native(lower_update_lists(sub, h, w), h, w,
                                     group=group, spp=1)
        planes = render_fused_styled(
            *(torch.as_tensor(x, dtype=torch.int32) for x in packed[:3]),
            *(torch.as_tensor(x) for x in packed[3:6]),
            torch.as_tensor(colors[:, g * lp:(g + 1) * lp].copy()), (),
            frames, lp, ns, nc, tuple(KernelPaint.color()
                                      for _ in range(lp)),
            group=group, spp=1, chain=True, emit="premul")
        acc = planes if acc is None else planes + acc * (
            1.0 - planes[:, :, 3:4])
    return premul_to_straight_u8(premul_planes_to_frames(acc, h, w, nc, 1))


def single_deep(inputs):
    return deep_fold(inputs)


def masked_scene(tree_kind, seed):
    """8 frames of a blob, a mask rectangle and two blobs under a clip
    group (with a blend and a blur filter, or the fusible plain group)
    (tests/test_parallel.py's masked scenes, 4 frames here)."""
    from swf_renderer_tpu_torch.ops.filters import BlurFilter
    from swf_renderer_tpu_torch.ops.style import solid_paint

    rng = np.random.default_rng(seed)
    f, h, w = 4, 48, 160
    rect = np.array([[10, 0, 100, 0], [100, 0, 100, h], [100, h, 10, h],
                     [10, h, 10, 0]], np.float32)
    tables = [[_blob(rng, w, h), rect, _blob(rng, w, h), _blob(rng, w, h)]
              for _ in range(f)]
    paints = [solid_paint((0.9, 0.2, 0.2, 1.0)),
              solid_paint((1.0, 1.0, 1.0, 1.0)),
              solid_paint((0.2, 0.4, 0.9, 0.7)),
              solid_paint((0.1, 0.8, 0.3, 0.5))]
    colors = np.stack([np.stack([p.color for p in paints])
                       for _ in range(f)]).astype(np.float32)
    if tree_kind == "blend":
        tree = [("draw", 0),
                ("mask", [1], [("draw", 2),
                               ("blend", "multiply", [("draw", 3)])]),
                ("filter", (BlurFilter(blur_x=4.0, blur_y=3.0, passes=2),),
                 [("draw", 0)])]
    else:
        tree = [("draw", 0), ("mask", [1], [("draw", 2), ("draw", 3)])]
    return tables, paints, h, w, colors, tree


def sharded_masked(mesh, inputs):
    from swf_renderer_tpu_torch.parallel.mesh import render_masked_dp

    return render_masked_dp(mesh, *inputs)


def single_masked(inputs):
    from swf_renderer_tpu_torch.ops.pipeline import render_batch_styled

    tables, paints, h, w, colors, tree = inputs
    return render_batch_styled(tables, paints, h, w, colors=colors,
                               mask_tree=tree, device="cpu")


CASES = {
    "batch_dp": (build_batch, sharded_batch_dp, single_batch),
    "batch_dp_tp": (build_batch, sharded_batch_dp_tp, single_batch),
    "scanline_dp_tp": (build_scanline, sharded_scanline, single_scanline),
    "frame_tile_sharded": (build_frame, sharded_frame, single_frame),
    "fused_dp": (build_fused, sharded_fused, single_fused),
    "morph_sweep_dp": (build_morph, sharded_morph_dp, single_morph),
    "morph_sweep_tile_sharded": (build_morph, sharded_morph_tiles,
                                 single_morph),
    "morph_affine_sweep_tile_sharded": (
        build_morph_affine, sharded_morph_affine_tiles, single_morph_affine),
    "affine_sweep_tile_sharded": (styled_sweep_scene, sharded_affine_tiles,
                                  single_affine),
    "affine_fuzz_3": (lambda: fuzz_scene(3), sharded_affine_tiles,
                      single_affine),
    "affine_fuzz_17": (lambda: fuzz_scene(17), sharded_affine_tiles,
                       single_affine),
    "affine_fuzz_45": (lambda: fuzz_scene(45), sharded_affine_tiles,
                       single_affine),
    "affine_unaligned": (unaligned_scene, sharded_affine_tiles,
                         single_affine),
    "affine_sweep_dp": (lambda: styled_sweep_scene(seed=59),
                        sharded_affine_dp, single_affine),
    "morph_affine_sweep_dp": (build_morph_affine, sharded_morph_affine_dp,
                              single_morph_affine),
    "styled_dp": (build_styled, sharded_styled, single_styled),
    "deep_passes_sharded": (build_deep, sharded_deep, single_deep),
    "masked_dp": (lambda: masked_scene("blend", 11), sharded_masked,
                  single_masked),
    "masked_dp_fused_pass": (lambda: masked_scene("plain", 13),
                             sharded_masked, single_masked),
}


def main(argv):
    # The ranks stand alone: neither JAX nor the JAX package may load.
    sys.modules["jax"] = None
    sys.modules["swf_renderer_tpu"] = None
    import torch
    import torch.distributed as dist

    from swf_renderer_tpu_torch.entry import _dryrun_steps
    from swf_renderer_tpu_torch.parallel.mesh import make_mesh

    rank, world, tp = (int(x) for x in argv[:3])
    store, out = argv[3:5]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        _dryrun_steps(world, "cpu")
        results = {"dryrun_world": np.int32(world)}
        mesh = make_mesh(world, tp=tp, device="cpu")
        for name, (build, sharded, _) in CASES.items():
            got = sharded(mesh, build())
            results[name] = (got.numpy() if torch.is_tensor(got)
                             else np.asarray(got))
        loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                        and m.split(".")[0] in ("jax", "jaxlib",
                                                "swf_renderer_tpu"))
        results["foreign_modules"] = np.asarray(loaded, dtype=str)
        if rank == 0:
            np.savez(out, **results)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    import pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    main(sys.argv[1:])
