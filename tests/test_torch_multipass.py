"""Deep draw lists and the chain modes of the styled fused kernel on the
CPU: the port's plain versions against the JAX package's kernel in
Pallas interpret mode, and multi-pass composition against one long
chain.

Tolerances, each measured on these scenes:
- the chain modes, plain version against the reference kernel: packed
  words within 1 premultiplied level (measured: one straight byte of
  49,152 moves 2 levels, chain from transparent; else equal), and
  premultiplied planes within 2e-6 absolute (the port sums the
  cross-chunk carry in 32.32 fixed point, the reference in f32, and
  XLA contracts the focal solve's multiply-adds into FMAs, so coverage
  and paint can differ in their last bits);
- the plane <-> frame converters: exact, both ways, and equal to the
  reference's;
- chained passes against one 40-layer chain of the same plain version:
  byte-equal (the chain is a left fold);
- deep lists through ``render_batch_styled`` against the JAX package:
  1 premultiplied level, the differing straight share pinned per scene.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swf_renderer_tpu.ops import flatblock as jfb
from swf_renderer_tpu.ops import pipeline as jpl
from swf_renderer_tpu.ops import style as jstyle
from swf_renderer_tpu_torch.convert import packed_to_device, paint_from_numpy
from swf_renderer_tpu_torch.native import bindings
from swf_renderer_tpu_torch.ops import flatblock as tfb
from swf_renderer_tpu_torch.ops import pipeline as tpl
from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

PLANE_ATOL = 2e-6


def levels(want, got):
    """(straight max, premultiplied max, differing straight share)."""
    a = want.astype(np.int32)
    b = got.astype(np.int32)

    def premul(x):
        return np.concatenate(
            [(x[..., :3] * x[..., 3:] + 127) // 255, x[..., 3:]], -1)

    d = np.abs(a - b)
    return (int(d.max()), int(np.abs(premul(a) - premul(b)).max()),
            float((d != 0).mean()))


def _paints(module, rng):
    """Colour, linear, focal and field paints of ``module``."""
    kp = module.KernelPaint
    ratios = np.array([0.0, 0.4, 1.0], np.float32)
    stops = rng.uniform(0, 1, (3, 4)).astype(np.float32)
    return (kp.gradient(module.KPAINT_LINEAR, (150.0, 10.0, -20.0, 140.0,
                                               -16000.0, -9000.0),
                        ratios, stops, spread=1),
            kp.color(), kp.field(0),
            kp.gradient(module.KPAINT_FOCAL, (300.0, 0.0, 0.0, 300.0,
                                              -15000.0, -8000.0),
                        ratios, stops, focal=0.5, spread=0))


MODES = {
    "chain": dict(),
    "chain_bg": dict(bg=True),
    "premul": dict(emit="premul"),
    "premul_bg": dict(bg=True, emit="premul"),
    "mask_first": dict(bg=True, mask_from=1),
    "mask_last": dict(emit="premul", mask_from=3),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_chain_modes_match_reference_kernel(mode):
    height, width, layers, frames = 24, 200, 4, 2
    spp = 3
    tables, colors = build_scene_edges(frames, layers, height, width,
                                       shapes_per_layer=4, seed=31)
    packed = bindings.pack_grouped_native(
        tpl.lower_update_lists(tables, height, width), height, width,
        group=6, spp=spp)
    dev = packed_to_device(*packed, device="cpu")
    ns, nc = dev["ns"], dev["nc"]
    rows = tfb.plane_rows_for(nc, spp)
    rng = np.random.default_rng(5)
    field = rng.uniform(0, 1, (height, width, 4)).astype(np.float32)
    a = rng.uniform(0, 1, (frames, ns + 1, 1, rows, 128))
    bg = np.concatenate([rng.uniform(0, 1, a.shape[:2] + (3,) + a.shape[3:])
                         * a, a], axis=2).astype(np.float32)
    bg[:, ns] = 0.0
    bg[:, :, :, spp * nc * 8:] = 0.0
    opts = MODES[mode]
    kw = dict(chain=True, emit=opts.get("emit", "u32"),
              mask_from=opts.get("mask_from"))
    rule = (0, 1, 0, 1)
    got = tfb.render_fused_styled(
        dev["sidx"], dev["flags"], dev["lays"], dev["urc"], dev["ucm"],
        dev["uval"], torch.as_tensor(colors),
        (tfb.field_to_chunkmajor(torch.as_tensor(field), ns, nc, spp=spp),),
        frames, layers, ns, nc, _paints(tfb, np.random.default_rng(9)),
        group=6, fill_rule=rule,
        spp=spp, bg=torch.as_tensor(bg) if opts.get("bg") else None, **kw)
    want = jfb.render_fused_styled(
        *(jnp.asarray(x) for x in packed[:6]), jnp.asarray(colors),
        (jfb.field_to_chunkmajor(jnp.asarray(field), ns, nc, spp=spp),),
        frames, layers, ns, nc, _paints(jfb, np.random.default_rng(9)),
        group=6, fill_rule=rule, spp=spp,
        bg=jnp.asarray(bg) if opts.get("bg") else None, **kw)
    want = np.asarray(want)
    if kw["emit"] == "premul":
        assert got.shape == want.shape == (frames, ns + 1, 4, rows, 128)
        real = (slice(None), slice(0, ns), slice(None),
                slice(0, spp * nc * 8))
        err = np.abs(got.numpy()[real] - want[real]).max()
        assert err <= PLANE_ATOL, err
        assert (got[:, ns] == 0).all() and (got[:, :, :, spp * nc * 8:]
                                            == 0).all()
        assert got.numpy()[real][:, :, 3].max() > 0.05
    else:
        g = got.numpy().view(np.uint32)[:, :ns].view(np.uint8)
        w = want[:, :ns].view(np.uint8)
        smax, pmax, share = levels(w.reshape(-1, 4), g.reshape(-1, 4))
        # Measured: equal but for the chain from transparent (2 straight
        # levels on one byte of a low-alpha pixel).
        assert pmax <= 1 and smax <= 2 and share <= 2.1e-5, (smax, pmax,
                                                              share)


def test_fused_styled_refuses_bad_mode_combinations():
    tables, colors = build_scene_edges(1, 2, 16, 100, shapes_per_layer=2,
                                       seed=3)
    packed = bindings.pack_grouped_native(
        tpl.lower_update_lists(tables, 16, 100), 16, 100, group=6, spp=1)
    dev = packed_to_device(*packed, device="cpu")
    ns, nc = dev["ns"], dev["nc"]
    args = (dev["sidx"], dev["flags"], dev["lays"], dev["urc"], dev["ucm"],
            dev["uval"], torch.as_tensor(colors), (), 1, 2, ns, nc,
            (tfb.KernelPaint.color(),) * 2)
    bg = torch.zeros((1, ns + 1, 4, 128, 128))
    for kw, match in (({"bg": bg}, "chain"),
                      ({"emit": "premul"}, "chain"),
                      ({"emit": "rgba"}, "emit"),
                      ({"mask_from": 1}, "chain"),
                      ({"chain": True, "mask_from": 2}, "mask_from"),
                      ({"chain": True, "mask_from": 0}, "mask_from"),
                      ({"chain": True, "bg": bg[:, :1]}, "background")):
        with pytest.raises(ValueError, match=match):
            tfb.render_fused_styled(*args, **kw)


@pytest.mark.parametrize("height,width", [(40, 180), (48, 300), (24, 200)])
def test_premul_plane_converters_round_trip(height, width):
    """frames -> planes -> frames is exact, planes -> frames -> planes
    keeps every real row and zeroes the padding and sentinel (40 x 180:
    5 strips in a 128-row plane, 48 padding rows; 48 x 300: 120 rows
    used of 128), and both match the reference's converters."""
    _, nc, ns_geo = tfb.plane_geometry(height, width)
    spp = tfb.strips_per_plane(nc, ns_geo)
    ns = -(-ns_geo // spp)
    rows = tfb.plane_rows_for(nc, spp)
    rng = np.random.default_rng(height + width)
    frames = rng.uniform(0, 1, (2, height, width, 4)).astype(np.float32)
    planes = tfb.frames_to_premul_planes(torch.as_tensor(frames), nc, spp,
                                         ns, rows)
    assert planes.shape == (2, ns + 1, 4, rows, 128)
    want = np.asarray(jfb.frames_to_premul_planes(jnp.asarray(frames), nc,
                                                  spp, ns, rows))
    np.testing.assert_array_equal(planes.numpy(), want)
    back = tfb.premul_planes_to_frames(planes, height, width, nc, spp)
    np.testing.assert_array_equal(back.numpy(), frames)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(jfb.premul_planes_to_frames(jnp.asarray(want), height,
                                               width, nc, spp)))
    again = tfb.frames_to_premul_planes(back, nc, spp, ns, rows)
    assert torch.equal(again, planes)


def test_split_layer_groups_matches_reference():
    """Cuts at 16 layers and at 4 field planes (bitmaps, linear-RGB
    gradients) equal the reference's on random paint lists."""
    rng = np.random.default_rng(8)
    img = np.zeros((2, 2, 4), np.uint8)
    kinds = [
        jstyle.solid_paint((0.1, 0.2, 0.3, 1.0)),
        jstyle.Paint(kind=jstyle.PAINT_BITMAP, inv_matrix=(1, 0, 0, 1, 0, 0),
                     image=img),
        jstyle.Paint(kind=jstyle.PAINT_LINEAR,
                     inv_matrix=(1, 0, 0, 1, 0, 0),
                     stop_ratios=np.array([0.0, 1.0], np.float32),
                     stop_colors=np.ones((2, 4), np.float32),
                     color_space="linear-rgb"),
        jstyle.Paint(kind=jstyle.PAINT_FOCAL, inv_matrix=(1, 0, 0, 1, 0, 0),
                     stop_ratios=np.array([0.0, 1.0], np.float32),
                     stop_colors=np.ones((2, 4), np.float32)),
    ]
    for n in (1, 15, 16, 17, 40, 64):
        for p_field in (0.0, 0.1, 0.5):
            pick = np.where(rng.uniform(size=n) < p_field,
                            rng.integers(1, 3, n), rng.integers(0, 4, n) % 4)
            pick = np.where(pick % 4 == 3, 3, pick)
            jp = [kinds[int(k) if p_field or k in (0, 3) else 0]
                  for k in pick]
            tp = [paint_from_numpy(p) for p in jp]
            assert (tpl.split_layer_groups(tp)
                    == jpl.split_layer_groups(jp)), (n, p_field)


def _polygon_edges(rng, height, width, n=7):
    pts = rng.uniform(0, (width, height), (n, 2)).astype(np.float32)
    closed = np.concatenate([pts, pts[:1]])
    return np.concatenate([closed[:-1], closed[1:]], axis=1).astype(
        np.float32)


def test_multipass_chain_is_exact():
    """40 layers in 3 chained passes (16 + 16 + 8) equal ONE chain over
    all 40 layers (the plain version has no layer cap), byte for byte;
    tests/test_styled_fused.py:249 on the port.  The JAX package's own
    multi-pass render agrees within 1 premultiplied level."""
    rng = np.random.default_rng(47)
    height, width, frames, n_layers = 48, 180, 2, 40
    jpaints = [jstyle.solid_paint(tuple(rng.uniform(0.2, 1.0, 4)))
               for _ in range(n_layers)]
    paints = [paint_from_numpy(p) for p in jpaints]
    assert tpl.split_layer_groups(paints) == [(0, 16), (16, 32), (32, 40)]
    tables = [[_polygon_edges(rng, height, width) for _ in range(n_layers)]
              for _ in range(frames)]
    emits = []
    kernel = tpl.render_fused_styled

    def spy(*args, **kw):
        emits.append((kw["emit"], kw["bg"] is None))
        return kernel(*args, **kw)

    tpl.render_fused_styled = spy
    try:
        got = tpl.render_batch_styled(tables, paints, height, width,
                                      device="cpu")
    finally:
        tpl.render_fused_styled = kernel
    assert emits == [("premul", True), ("premul", False), ("u32", False)]

    _, nc, ns_geo = tfb.plane_geometry(height, width)
    spp = tfb.strips_per_plane(nc, ns_geo)
    packed = bindings.pack_grouped_native(
        tpl.lower_update_lists(tables, height, width), height, width,
        group=6, spp=spp)
    dev = packed_to_device(*packed, device="cpu")
    colors = np.stack([[p.color for p in paints]] * frames).astype(
        np.float32)
    out = tfb.fused_styled_plain(
        dev["sidx"], dev["flags"], dev["lays"], dev["urc"], dev["ucm"],
        dev["uval"], torch.as_tensor(colors), (), frames, n_layers,
        dev["ns"], dev["nc"], (tfb.KernelPaint.color(),) * n_layers,
        spp=spp, chain=True)
    want = tfb.packed_to_frames(out, frames, dev["ns"], dev["nc"], spp,
                                height, width)
    np.testing.assert_array_equal(got, want)
    ref = jpl.render_batch_styled(tables, jpaints, height, width)
    smax, pmax, share = levels(ref, got)
    assert pmax <= 1 and share <= 0.0, (smax, pmax, share)


def test_multipass_styled_matches_layered_and_reference():
    """48 draws with in-kernel and streamed gradients and 6 bitmaps (more
    than one pass's 4 field planes): the multi-pass fused route against
    the port's layered route within 1 level (the fused chain and the
    layered composite associate f32 operations differently), against
    the JAX package within 1 premultiplied level."""
    rng = np.random.default_rng(53)
    height, width, n_layers = 40, 150, 48
    jpaints = []
    for i in range(n_layers):
        kind = i % 8
        if kind == 5:
            jpaints.append(jstyle.Paint(
                kind=jstyle.PAINT_LINEAR,
                inv_matrix=(200.0, 0.0, 0.0, 200.0, -16384.0,
                            -4000.0 * (i % 3)),
                stop_ratios=np.array([0.0, 1.0], np.float32),
                stop_colors=np.array([[1, 0, 0, 1], [0, 1, 0, 0.6]],
                                     np.float32)))
        elif kind == 6:
            img = rng.integers(0, 256, (7, 9, 4)).astype(np.uint8)
            jpaints.append(jstyle.Paint(
                kind=jstyle.PAINT_BITMAP,
                inv_matrix=(0.3, 0.0, 0.0, 0.3, 0.0, 0.0),
                image=img, repeating=True, smoothed=True, supersample=1))
        else:
            jpaints.append(jstyle.solid_paint(
                tuple(rng.uniform(0.2, 1.0, 4))))
    paints = [paint_from_numpy(p) for p in jpaints]
    assert len(tpl.split_layer_groups(paints)) >= 3
    tables = [[_polygon_edges(rng, height, width, n=5)
               for _ in range(n_layers)]]
    got = tpl.render_batch_styled(tables, paints, height, width,
                                  device="cpu")
    layered = tpl.render_styled_layered(tables, paints, height, width,
                                        device="cpu")
    diff = np.abs(got.astype(np.int32) - layered.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    ref = jpl.render_batch_styled(tables, jpaints, height, width)
    smax, pmax, share = levels(ref, got)
    assert pmax <= 1 and share <= 0.0, (smax, pmax, share)
