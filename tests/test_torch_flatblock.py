"""The fused kernels' plain PyTorch versions against the JAX kernels
(Pallas interpret mode on the CPU) on the same packed arrays.

Tolerance: at most 1 u8 level per channel (the kernels sum the same
winding deltas in other orders: the reference through an exact-split MXU
product and a stride-8 carry ladder, the port left to right and in exact
fixed point).  Measured envelope on these scenes: the solid kernel is
byte-equal (0 differing bytes) at 3 layers over 2 chunks; at 16 layers
over 20 chunks one pixel differs by a premultiplied level (5 straight
levels at alpha 43, share 7.3e-7).  The tests pin a differing-byte share
of at most 1e-4.  On the H100 the CUDA kernels agree with these plain
versions byte for byte (chip_smoke.py).

In-kernel FOCAL gradients are the one exception: XLA on the CPU contracts
``b * b - a * cc`` of the focal solve into an FMA (the port computes op by
op, as its CUDA kernel does), so paint values differ by up to ~2e-5.  That
moves a premultiplied byte by at most 1 level, and un-premultiplying it
scales the step by 255 / alpha: measured 2 straight levels on one pixel at
alpha 68.  The styled test therefore holds the PREMULTIPLIED bytes to 1
level and pins the straight envelope at the measured 2 levels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swf_renderer_tpu.ops import flatblock as jfb
from swf_renderer_tpu.ops import pipeline as jpl
from swf_renderer_tpu_torch.convert import packed_to_device
from swf_renderer_tpu_torch.native import bindings as port_bindings
from swf_renderer_tpu_torch.ops import flatblock as tfb
from swf_renderer_tpu_torch.ops import pipeline as tpl
from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

SHARE_ENVELOPE = 1e-4


def _compare(ref_u32, got_i32, ns, premul=False):
    """(max level difference, differing share) over the real strips, in
    straight bytes or (premul=True) in the premultiplied bytes the
    pipeline rounds (pm8 = round(rgb8 * a8 / 255) inverts the
    un-premultiply exactly)."""
    a = np.asarray(ref_u32)[:, :ns].view(np.uint8).astype(np.int32)
    b = got_i32.numpy().view(np.uint32)[:, :ns].view(np.uint8).astype(
        np.int32)
    if premul:
        a = a.reshape(-1, 4)
        b = b.reshape(-1, 4)
        a = np.concatenate([(a[:, :3] * a[:, 3:] + 127) // 255, a[:, 3:]], 1)
        b = np.concatenate([(b[:, :3] * b[:, 3:] + 127) // 255, b[:, 3:]], 1)
    d = np.abs(a - b)
    return int(d.max()), float((d != 0).mean())


def _packed(height, width, layers, spp, seed, frames=2):
    tables, colors = build_scene_edges(frames, layers, height, width,
                                       shapes_per_layer=5, seed=seed)
    ul = tpl.lower_update_lists(tables, height, width)
    packed = port_bindings.pack_grouped_native(ul, height, width, group=6,
                                               spp=spp)
    return packed, colors


# -- host geometry / layout helpers: equal ----------------------------------


def test_plane_geometry_and_packing_helpers_equal():
    for h in (1, 8, 9, 48, 136, 1088, 2160):
        for w in (1, 100, 127, 128, 129, 255, 256, 1000, 1920, 2560, 3840,
                  8191):
            assert tfb.plane_geometry(h, w) == jfb.plane_geometry(h, w)
    for nc in range(1, 65):
        for ns in (1, 2, 5, 17, 136):
            assert (tfb.strips_per_plane(nc, ns)
                    == jfb.strips_per_plane(nc, ns))
        for spp in (1, 2, 3, 8):
            assert tfb.plane_rows_for(nc, spp) == jfb.plane_rows_for(nc, spp)


@pytest.mark.parametrize("height,width,spp", [(20, 200, 1), (40, 300, 2),
                                              (24, 100, 3)])
def test_field_to_chunkmajor_equal(height, width, spp):
    rng = np.random.default_rng(height)
    field = rng.uniform(0, 1, (height, width, 4)).astype(np.float32)
    _, nc, ns = tfb.plane_geometry(height, width)
    nsb = -(-ns // spp)
    want = np.asarray(jfb.field_to_chunkmajor(field, nsb, nc, spp=spp))
    got = tfb.field_to_chunkmajor(torch.as_tensor(field), nsb, nc,
                                  spp=spp).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_frames_u32_to_u8_equal():
    rng = np.random.default_rng(1)
    packed = rng.integers(0, 2 ** 32, (2, 16, 256), dtype=np.uint32)
    assert np.array_equal(tfb.frames_u32_to_u8(packed, 13, 200),
                          jfb.frames_u32_to_u8(packed, 13, 200))


# -- solid kernel -------------------------------------------------------------


@pytest.mark.parametrize("spp", [1, 2])
@pytest.mark.parametrize("rule", [0, 1, "mixed"])
def test_fusedn_plain_matches_jax_kernel(spp, rule):
    height, width, layers = 40, 256, 3
    packed, colors = _packed(height, width, layers, spp, seed=spp * 7 + 1)
    fill_rule = (0, 1, 1) if rule == "mixed" else rule
    gsi, gfl, gla, grc, gcm, gvv, ns, nc = packed
    want = jfb.render_fused_blocksn(
        *(jnp.asarray(x) for x in (gsi, gfl, gla, grc, gcm, gvv, colors)),
        2, layers, ns, nc, group=6, fill_rule=fill_rule, spp=spp)
    dev = packed_to_device(*packed, device="cpu")
    got = tfb.render_fused_blocksn(
        dev["sidx"], dev["flags"], dev["lays"], dev["urc"], dev["ucm"],
        dev["uval"], torch.as_tensor(colors), 2, layers, ns, nc, group=6,
        fill_rule=fill_rule, spp=spp)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == tuple(want.shape)
    dmax, share = _compare(want, got, ns)
    assert dmax <= 1 and share <= SHARE_ENVELOPE, (dmax, share)
    assert tfb.render_fused_blocksn.launches == 0  # CPU: plain version


@pytest.mark.parametrize("rule", [0, "mixed"])
def test_fusedn_plain_matches_jax_kernel_16_layers_wide(rule):
    """16 layers over 20 chunks (64x2560, the first 16-layer scene of
    chip_smoke.py's kernel phase), where the order of the cross-chunk
    carry shows: the reference's stride-8 f32 ladder and the port's exact
    fixed-point sum round one pixel (alpha 43) one premultiplied level
    apart under nonzero, 5 straight levels once un-premultiplied (share
    7.3e-7).  Premultiplied bytes are held to 1 level, straight bytes to
    the measured 5 levels and the shared share envelope."""
    height, width, layers, frames = 64, 2560, 16, 2
    tables, colors = build_scene_edges(frames, layers, height, width,
                                       shapes_per_layer=6, seed=75106643)
    packed = port_bindings.pack_grouped_native(
        tpl.lower_update_lists(tables, height, width), height, width,
        group=6, spp=1)
    fill_rule = ((0, 1, 1, 0, 0, 1, 1, 1, 1, 1, 0, 1, 0, 1, 1, 0)
                 if rule == "mixed" else rule)
    gsi, gfl, gla, grc, gcm, gvv, ns, nc = packed
    want = jfb.render_fused_blocksn(
        *(jnp.asarray(x) for x in (gsi, gfl, gla, grc, gcm, gvv, colors)),
        frames, layers, ns, nc, group=6, fill_rule=fill_rule, spp=1)
    dev = packed_to_device(*packed, device="cpu")
    got = tfb.render_fused_blocksn(
        dev["sidx"], dev["flags"], dev["lays"], dev["urc"], dev["ucm"],
        dev["uval"], torch.as_tensor(colors), frames, layers, ns, nc,
        group=6, fill_rule=fill_rule, spp=1)
    dmax, share = _compare(want, got, ns)
    assert dmax <= 5 and share <= SHARE_ENVELOPE, (dmax, share)
    pmax, _ = _compare(want, got, ns, premul=True)
    assert pmax <= 1, pmax


# -- styled kernel ------------------------------------------------------------


def _styled_paints(module, rng):
    """Colour, in-kernel linear (pad), in-kernel focal (pad / repeat /
    reflect) and one field paint, built with ``module``'s KernelPaint."""
    kp = module.KernelPaint
    ratios = np.array([0.0, 0.35, 1.0], np.float32)
    stops = rng.uniform(0, 1, (3, 4)).astype(np.float32)
    return (
        kp.color(),
        kp.gradient(module.KPAINT_LINEAR, (150.0, 10.0, -20.0, 140.0,
                                           -16000.0, -9000.0),
                    ratios, stops, spread=0),
        kp.gradient(module.KPAINT_FOCAL, (300.0, 0.0, 0.0, 300.0,
                                          -15000.0, -8000.0),
                    ratios, stops, focal=0.5, spread=0),
        kp.gradient(module.KPAINT_FOCAL, (200.0, 30.0, 5.0, 210.0,
                                          -12000.0, -7000.0),
                    ratios, stops, focal=-0.3, spread=2),
        kp.gradient(module.KPAINT_FOCAL, (120.0, -8.0, 4.0, 100.0,
                                          -9000.0, -5000.0),
                    np.array([0.0, 0.6, 1.0], np.float32), stops,
                    focal=0.8, spread=1),
        kp.field(0),
    )


@pytest.mark.parametrize("spp", [1, 2])
def test_fused_styled_plain_matches_jax_kernel(spp):
    height, width, layers = 40, 256, 6
    packed, colors = _packed(height, width, layers, spp, seed=40 + spp)
    gsi, gfl, gla, grc, gcm, gvv, ns, nc = packed
    field = np.random.default_rng(spp).uniform(
        0, 1, (height, width, 4)).astype(np.float32)
    rule = (0, 1, 0, 0, 1, 0)
    want = jfb.render_fused_styled(
        *(jnp.asarray(x) for x in (gsi, gfl, gla, grc, gcm, gvv, colors)),
        (jfb.field_to_chunkmajor(field, ns, nc, spp=spp),), 2, layers, ns,
        nc, _styled_paints(jfb, np.random.default_rng(9)), group=6,
        fill_rule=rule, spp=spp)
    dev = packed_to_device(*packed, device="cpu")
    got = tfb.render_fused_styled(
        dev["sidx"], dev["flags"], dev["lays"], dev["urc"], dev["ucm"],
        dev["uval"], torch.as_tensor(colors),
        (tfb.field_to_chunkmajor(torch.as_tensor(field), ns, nc, spp=spp),),
        2, layers, ns, nc, _styled_paints(tfb, np.random.default_rng(9)),
        group=6, fill_rule=rule, spp=spp)
    dmax, share = _compare(want, got, ns)
    assert dmax <= 2 and share <= SHARE_ENVELOPE, (dmax, share)
    pmax, _ = _compare(want, got, ns, premul=True)
    assert pmax <= 1, pmax
    assert tfb.render_fused_styled.launches == 0


def test_styled_refuses_out_of_slice_modes_and_too_many_stops():
    """The chain modes are ported (test_torch_multipass.py); what the
    wrapper still refuses are the combinations the reference's kernel
    has no form for, and gradients past the SWF stop count."""
    packed, colors = _packed(16, 100, 1, 1, seed=2, frames=1)
    dev = packed_to_device(*packed, device="cpu")
    args = (dev["sidx"], dev["flags"], dev["lays"], dev["urc"], dev["ucm"],
            dev["uval"], torch.as_tensor(colors), (), 1, 1, dev["ns"],
            dev["nc"])
    for kw in ({"emit": "premul"}, {"chain": True, "mask_from": 0},
               {"bg": torch.zeros(1)}):
        with pytest.raises(ValueError):
            tfb.render_fused_styled(*args, (tfb.KernelPaint.color(),), **kw)
    out = tfb.render_fused_styled(*args, (tfb.KernelPaint.color(),),
                                  chain=True, emit="premul")
    assert out.shape == (1, dev["ns"] + 1, 4, 128, 128)
    ratios = np.linspace(0, 1, 16, dtype=np.float32)
    too_many = tfb.KernelPaint.gradient(
        tfb.KPAINT_LINEAR, (1, 0, 0, 1, 0, 0), ratios,
        np.ones((16, 4), np.float32))
    with pytest.raises(ValueError, match="stops"):
        tfb.render_fused_styled(*args, (too_many,))


def test_kernel_paints_for_matches_reference_routing():
    """Gradients stream as fields within the 4-field budget and evaluate
    in the kernel past it, exactly like the reference's routing."""
    from swf_renderer_tpu.ops import style as jstyle
    from swf_renderer_tpu_torch.ops import style as tstyle

    def paints(style, n_grad):
        out = [style.solid_paint((1, 0, 0, 1))]
        for i in range(n_grad):
            out.append(style.Paint(
                kind=style.PAINT_LINEAR,
                inv_matrix=(100.0 + i, 0.0, 0.0, 100.0, -9000.0, -3000.0),
                stop_ratios=np.array([0.0, 1.0], np.float32),
                stop_colors=np.array([[1, 0, 0, 1], [0, 0, 1, 1]],
                                     np.float32)))
        return out

    for n_grad in (2, 5):
        kj, fj, cj = jpl.kernel_paints_for(paints(jstyle, n_grad), 24, 64)
        kt, ft, ct = tpl.kernel_paints_for(paints(tstyle, n_grad), 24, 64,
                                           device="cpu")
        assert [p.kind for p in kj] == [p.kind for p in kt]
        assert tuple(kj) == tuple(kt)
        assert np.array_equal(cj, ct)
        assert len(fj) == len(ft)
        for a, b in zip(fj, ft):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
