"""Blend modes and bitmap filters of the port on the CPU: the filter math
against numpy oracles and against the JAX package's ops.filters, the
blend algebra against the JAX package's ops.composite, and both through
the renderer (fused masked program against the layered compositor and
against the JAX package's TpuRenderer).  Scenes are tests/
test_blend_modes.py's and tests/test_filters.py's, built in code.

Tolerances, measured on these inputs:
- filters, port against the JAX package: 1e-6 absolute on premultiplied
  values (measured at most 6.6e-7, the gradient bevel: the blur's
  prefix sums add in another order than XLA's cumsum, and the colour
  matrix's 4-term products sum in another order);
- blend_premul, port against the JAX package: equal (measured);
- renders: fused against layered byte-equal where the reference pins it;
  against the JAX package 1 premultiplied level, differing straight
  bytes pinned at what was measured.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swf_renderer_tpu.ops import composite as jcomposite
from swf_renderer_tpu.ops import filters as jfilters
from swf_renderer_tpu.runtime.renderer import TpuRenderer
from swf_renderer_tpu_torch.ops import composite as tcomposite
from swf_renderer_tpu_torch.ops import filters as tfilters
from swf_renderer_tpu_torch.ops.filters import (
    BevelFilter, BlurFilter, ColorMatrixFilter, ConvolutionFilter,
    DropShadowFilter, GlowFilter, GradientBevelFilter, GradientGlowFilter,
    apply_filter, box_blur,
)
from swf_renderer_tpu_torch.runtime.renderer import TorchRenderer
from tests.test_torch_masks import JAX, PORT, Scene, levels

FILTER_ATOL = 1e-6


def t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _premul_image(rng, shape):
    img = rng.uniform(0, 1, shape).astype(np.float32)
    img[..., :3] *= img[..., 3:4]
    return img


# ---------------------------------------------------------------------------
# Filter math
# ---------------------------------------------------------------------------


def _np_box_blur_axis(img, radius, axis):
    """Brute-force fractional box blur, zero padding."""
    n = img.shape[axis]
    r_int = int(math.floor(radius))
    frac = radius - r_int
    width = 2 * radius + 1
    out = np.zeros_like(img)
    img_m = np.moveaxis(img, axis, 0)
    out_m = np.moveaxis(out, axis, 0)
    for i in range(n):
        lo, hi = i - r_int, i + r_int
        acc = img_m[max(lo, 0):min(hi + 1, n)].sum(axis=0)
        if frac:
            if lo - 1 >= 0:
                acc = acc + frac * img_m[lo - 1]
            if hi + 1 < n:
                acc = acc + frac * img_m[hi + 1]
        out_m[i] = acc / width
    return out


@pytest.mark.parametrize("blur", [3.0, 4.5, 9.0, 1.0])
def test_box_blur_matches_bruteforce(blur):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (12, 17, 4)).astype(np.float32)
    got = box_blur(t(img), blur, blur, passes=1).numpy()
    want = img
    if blur > 1:
        r = (blur - 1) / 2
        want = _np_box_blur_axis(want, r, axis=1)
        want = _np_box_blur_axis(want, r, axis=0)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_blur_passes_iterate_and_conserve_mass():
    rng = np.random.default_rng(2)
    img = t(rng.uniform(0, 1, (10, 10, 4)))
    once = box_blur(img, 5, 5, passes=1)
    thrice = box_blur(img, 5, 5, passes=3)
    manual = box_blur(box_blur(box_blur(img, 5, 5), 5, 5), 5, 5)
    np.testing.assert_allclose(thrice.numpy(), manual.numpy(), atol=1e-5)
    assert not np.allclose(once.numpy(), thrice.numpy())
    dot = torch.zeros((21, 21, 4))
    dot[10, 10] = 1.0
    out = box_blur(dot, 7.0, 7.0)
    np.testing.assert_allclose(out.sum(dim=(0, 1)).numpy(), [1, 1, 1, 1],
                               atol=1e-4)


def test_drop_shadow_glow_and_shift():
    img = torch.zeros((16, 16, 4))
    img[4:8, 4:8] = torch.tensor([1.0, 0.0, 0.0, 1.0])
    out = apply_filter(img, DropShadowFilter(
        color=(0.0, 0.0, 0.0, 1.0), blur_x=0.0, blur_y=0.0, angle=0.0,
        distance=4.0, strength=1.0)).numpy()
    np.testing.assert_allclose(out[4:8, 4:8], img[4:8, 4:8], atol=1e-6)
    np.testing.assert_allclose(out[4:8, 8:12, 3], 1.0, atol=1e-6)
    np.testing.assert_allclose(out[4:8, 8:12, :3], 0.0, atol=1e-6)
    assert out[4:8, :4].max() == 0
    img = torch.zeros((16, 16, 4))
    img[6:10, 6:10] = torch.tensor([0.0, 0.5, 0.0, 1.0])
    out = apply_filter(img, GlowFilter(
        color=(1.0, 0.0, 1.0, 1.0), blur_x=5.0, blur_y=5.0, strength=1.0,
        knockout=True)).numpy()
    assert out[7, 7].max() == 0 and out[6, 11, 3] > 0.05
    assert out[6, 11, 0] > 0
    dot = torch.zeros((8, 8, 4))
    dot[2, 2] = torch.tensor([0, 0, 0, 1.0])
    out = apply_filter(dot, DropShadowFilter(
        color=(0, 0, 0, 1.0), blur_x=0, blur_y=0, angle=0.0, distance=2.5,
        strength=1.0, knockout=True)).numpy()
    assert abs(out[2, 4, 3] - 0.5) < 1e-5 and abs(out[2, 5, 3] - 0.5) < 1e-5


def test_color_matrix_identity_and_channel_swap():
    rng = np.random.default_rng(3)
    img = t(_premul_image(rng, (8, 8, 4)))
    ident = ColorMatrixFilter(matrix=(1, 0, 0, 0, 0, 0, 1, 0, 0, 0,
                                      0, 0, 1, 0, 0, 0, 0, 0, 1, 0))
    np.testing.assert_allclose(apply_filter(img, ident).numpy(),
                               img.numpy(), atol=1e-5)
    swap = ColorMatrixFilter(matrix=(0, 1, 0, 0, 0, 1, 0, 0, 0, 0,
                                     0, 0, 1, 0, 0, 0, 0, 0, 1, 0))
    out = apply_filter(img, swap).numpy()
    np.testing.assert_allclose(out[..., 0], img.numpy()[..., 1], atol=1e-5)
    np.testing.assert_allclose(out[..., 1], img.numpy()[..., 0], atol=1e-5)


def test_bevel_and_gradient_filters():
    """tests/test_filters.py's bevel sides, gradient glow against the
    solid glow, and the gradient bevel's neutral midpoint."""
    img = torch.zeros((1, 40, 40, 4))
    img[:, 8:32, 12:28] = torch.tensor([0.5, 0.5, 0.5, 1.0])
    f = BevelFilter(shadow_color=(0.0, 0.0, 1.0, 1.0),
                    highlight_color=(1.0, 0.0, 0.0, 1.0), blur_x=4.0,
                    blur_y=4.0, angle=0.0, distance=2.0, strength=2.0)
    out = apply_filter(img, f).numpy()
    left, right = out[0, 20, 9], out[0, 20, 30]
    assert left[0] > 0.2 and left[2] < 0.05, left
    assert right[2] > 0.2 and right[0] < 0.05, right
    np.testing.assert_array_equal(out[0, 20, 20], img[0, 20, 20].numpy())
    out_i = apply_filter(img, dataclasses.replace(f, inner=True)).numpy()
    assert out_i[0, 20, 9, 3] == 0.0
    assert out_i[0, 20, 13, 0] > img[0, 20, 13, 0]

    sq = torch.zeros((1, 32, 32, 4))
    sq[:, 10:22, 10:22] = torch.tensor([0.0, 0.0, 0.0, 1.0])
    gg = GradientGlowFilter(colors=((1.0, 0.0, 0.0, 0.0),
                                    (1.0, 0.0, 0.0, 1.0)),
                            ratios=(0.0, 1.0), blur_x=5.0, blur_y=5.0,
                            strength=1.0)
    sg = GlowFilter(color=(1.0, 0.0, 0.0, 1.0), blur_x=5.0, blur_y=5.0,
                    strength=1.0)
    diff = apply_filter(sq, gg) - apply_filter(sq, sg)
    assert diff.abs().max() < 1 / 64.0

    flat = torch.zeros((1, 40, 40, 4))
    flat[:, 8:32, 8:32] = torch.tensor([0.3, 0.3, 0.3, 1.0])
    gb = GradientBevelFilter(
        colors=((0.0, 0.0, 1.0, 1.0), (0.0, 0.0, 0.0, 0.0),
                (1.0, 0.0, 0.0, 1.0)),
        ratios=(0.0, 0.5, 1.0), blur_x=3.0, blur_y=3.0, angle=0.0,
        distance=2.0, strength=1.0, inner=True)
    out = apply_filter(flat, gb).numpy()
    np.testing.assert_allclose(out[0, 20, 20], flat[0, 20, 20].numpy(),
                               atol=1 / 100.0)
    assert out[0, 20, 9, 0] > out[0, 20, 9, 2]
    assert out[0, 20, 30, 2] > out[0, 20, 30, 0]


def test_convolution_matches_numpy_oracle():
    rng = np.random.default_rng(7)
    straight = rng.uniform(0.0, 1.0, (6, 9, 4)).astype(np.float32)
    img = straight.copy()
    img[..., :3] *= img[..., 3:4]
    kern = np.asarray([[0.0, 1.0, 0.0], [1.0, 2.0, 1.0], [0.5, 1.0, 0.5]],
                      np.float32)
    for clamp, preserve in ((True, True), (False, False)):
        f = ConvolutionFilter(
            matrix_x=3, matrix_y=3, matrix=tuple(kern.ravel()), divisor=8.0,
            bias=4.0, default_color=(0.2, 0.4, 0.6, 0.8), clamp=clamp,
            preserve_alpha=preserve)
        got = apply_filter(t(img), f).numpy()
        if clamp:
            pad = np.pad(straight, ((1, 1), (1, 1), (0, 0)), mode="edge")
        else:
            pad = np.pad(straight, ((1, 1), (1, 1), (0, 0)))
            mask = np.pad(np.ones((6, 9, 1), np.float32),
                          ((1, 1), (1, 1), (0, 0)))
            pad = pad + (1.0 - mask) * np.asarray(f.default_color,
                                                  np.float32)
        acc = np.zeros_like(straight)
        for j in range(3):
            for i in range(3):
                acc += kern[j, i] * pad[j:j + 6, i:i + 9]
        want = np.clip(acc / 8.0 + 4.0 / 255.0, 0.0, 1.0)
        if preserve:
            want[..., 3] = straight[..., 3]
        want[..., :3] *= want[..., 3:4]
        np.testing.assert_allclose(got, want, atol=1e-5,
                                   err_msg=f"clamp={clamp}")


def _both(cls, **kw):
    """The same filter as the port's and the JAX package's dataclass."""
    return getattr(tfilters, cls)(**kw), getattr(jfilters, cls)(**kw)


FILTERS = {
    "blur": ("BlurFilter", dict(blur_x=5.0, blur_y=3.5, passes=3)),
    "shadow": ("DropShadowFilter", dict(
        color=(0.1, 0.0, 0.2, 0.8), blur_x=4.0, blur_y=6.0,
        angle=math.pi / 5, distance=3.3, strength=1.2, passes=2)),
    "inner_glow": ("GlowFilter", dict(
        color=(1.0, 0.5, 0.0, 0.9), blur_x=3.0, blur_y=3.0, strength=2.0,
        inner=True)),
    "matrix": ("ColorMatrixFilter", dict(matrix=(
        0.5, 0.3, 0.2, 0, 10, 0.1, 0.9, 0, 0, 0, 0, 0.2, 0.7, 0.1, -5,
        0, 0, 0, 0.8, 20))),
    "bevel": ("BevelFilter", dict(
        shadow_color=(0.1, 0.1, 0.3, 0.9), highlight_color=(1, 1, 0.9, 0.9),
        blur_x=3.0, blur_y=3.0, angle=math.pi / 4, distance=2.0,
        strength=1.5, inner=True)),
    "gradient_glow": ("GradientGlowFilter", dict(
        colors=((1.0, 0.2, 0.0, 0.0), (1.0, 0.9, 0.0, 0.8)),
        ratios=(0.0, 1.0), blur_x=5.0, blur_y=5.0, distance=1.5,
        angle=0.3, strength=1.0, knockout=True)),
    "gradient_bevel": ("GradientBevelFilter", dict(
        colors=((0.0, 0.0, 1.0, 1.0), (0.0, 0.0, 0.0, 0.0),
                (1.0, 0.0, 0.0, 1.0)),
        ratios=(0.0, 0.5, 1.0), blur_x=3.0, blur_y=2.0, angle=0.75,
        distance=2.0, strength=1.0, on_top=True)),
    "convolution": ("ConvolutionFilter", dict(
        matrix_x=3, matrix_y=2, matrix=(0.0, 1.0, 0.0, 1.0, 2.0, 1.0),
        divisor=5.0, bias=8.0, default_color=(0.0, 1.0, 0.0, 1.0),
        clamp=False, preserve_alpha=True)),
}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_matches_reference(name):
    """Each of the 8 kinds, port against the JAX package, on a random
    premultiplied batch of 2 images."""
    cls, kw = FILTERS[name]
    tf, jf = _both(cls, **kw)
    img = _premul_image(np.random.default_rng(len(name)), (2, 20, 24, 4))
    got = apply_filter(t(img), tf).numpy()
    want = np.asarray(jfilters.apply_filter(jnp.asarray(img), jf))
    err = np.abs(got - want).max()
    assert err <= FILTER_ATOL, err
    assert np.abs(got - img).max() > 1e-3  # the filter did something


# ---------------------------------------------------------------------------
# Blend algebra
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", tcomposite.BLEND_MODES
                         + tcomposite.GROUP_MODES)
def test_blend_premul_matches_reference(mode):
    rng = np.random.default_rng(11)
    dst = _premul_image(rng, (2, 3, 4, 8, 16)).transpose(0, 1, 4, 2, 3)
    src = _premul_image(rng, (2, 3, 4, 8, 16)).transpose(0, 1, 4, 2, 3)
    src[0, 0, 3] = 0.0      # transparent source, opaque backdrop
    dst[1, 1, 3] = 1.0
    dst, src = np.ascontiguousarray(dst), np.ascontiguousarray(src)
    got = tcomposite.blend_premul(t(dst), t(src), mode, channel_axis=2)
    want = np.asarray(jcomposite.blend_premul(jnp.asarray(dst),
                                              jnp.asarray(src), mode,
                                              channel_axis=2))
    np.testing.assert_array_equal(got.numpy(), want)
    last = tcomposite.blend_premul(t(dst).movedim(2, -1),
                                   t(src).movedim(2, -1), mode)
    assert torch.equal(last.movedim(-1, 2), got)


def test_unknown_blend_mode_raises():
    with pytest.raises(ValueError, match="blend mode"):
        tcomposite.blend_premul(torch.zeros(4), torch.zeros(4), "dodge")


# ---------------------------------------------------------------------------
# Through the renderer
# ---------------------------------------------------------------------------


def _render(mods, stage_fn, backend="auto"):
    stage = stage_fn(Scene(mods))
    if mods is PORT:
        r = TorchRenderer(stage.width, stage.height, backend=backend,
                          device="cpu")
    else:
        r = TpuRenderer(stage.width, stage.height, backend=backend)
    return r.render(stage), r


def _back(s):
    return s.rect(1, 800, 600, s.rgba(200, 100, 50))


def _blend_stage(mode, src_alpha=255):
    def build(s):
        top = s.rect(2, 400, 600, s.rgba(128, 255, 64, src_alpha))
        return s.stage([s.inst(_back(s)), s.inst(top, blend_mode=mode)])
    return build


def _expected_opaque(mode):
    cb = np.array([200, 100, 50], np.float64) / 255.0
    cs = np.array([128, 255, 64], np.float64) / 255.0
    b = {
        "multiply": cb * cs,
        "screen": cb + cs - cb * cs,
        "lighten": np.maximum(cb, cs),
        "darken": np.minimum(cb, cs),
        "difference": np.abs(cb - cs),
        "add": np.minimum(1.0, cb + cs),
        "subtract": np.maximum(0.0, cb - cs),
        "invert": 1.0 - cb,
        "overlay": np.where(cb <= 0.5, cs * 2 * cb,
                            cs + (2 * cb - 1) - cs * (2 * cb - 1)),
        "hardlight": np.where(cs <= 0.5, cb * 2 * cs,
                              cb + (2 * cs - 1) - cb * (2 * cs - 1)),
    }[mode]
    return np.round(b * 255.0).astype(np.uint8)


@pytest.mark.parametrize("mode", tcomposite.BLEND_MODES)
def test_opaque_blend_matches_formula(mode):
    got, r = _render(PORT, _blend_stage(mode))
    assert r._exec_path == "flatblock"
    np.testing.assert_array_equal(
        got[5:25, 2:18, :3],
        np.broadcast_to(_expected_opaque(mode), (20, 16, 3)))
    np.testing.assert_array_equal(
        got[5:25, 22:38, :3], np.broadcast_to([200, 100, 50], (20, 16, 3)))
    assert (got[..., 3] == 255).all()


def _grouped(s):
    a = s.rect(3, 400, 600, s.rgba(255, 0, 0, 128))
    b = s.rect(4, 400, 600, s.rgba(0, 0, 255, 128))
    return s.stage([s.inst(_back(s)), s.display.Container(
        children=(s.inst(a), s.inst(b)), blend_mode="multiply")])


def _blend_in_mask(s):
    half = s.rect(5, 400, 600, s.rgba(0, 200, 0))
    top = s.rect(6, 800, 300, s.rgba(0, 200, 0))
    mul = s.inst(s.rect(7, 700, 500, s.rgba(90, 160, 220)),
                 blend_mode="multiply")
    return s.stage([
        s.inst(_back(s)), s.masked(s.inst(half), [mul]),
        s.display.Container(children=(
            s.masked(s.inst(top), [s.inst(_back(s))]),),
            blend_mode="screen")])


def _layer_stage(child_mode, child_alpha):
    def build(s):
        knock = s.rect(9, 400, 600, s.rgba(255, 255, 255, child_alpha))
        green = s.rect(8, 800, 600, s.rgba(0, 200, 0))
        return s.stage([s.inst(_back(s)), s.display.Container(
            children=(s.inst(green), s.inst(knock, blend_mode=child_mode)),
            blend_mode="layer")])
    return build


def _nested_alpha(s):
    knock = s.rect(9, 400, 600, s.rgba(255, 255, 255, 200))
    inner = s.display.Container(children=(
        s.inst(s.rect(8, 800, 600, s.rgba(0, 200, 0))),
        s.inst(knock, blend_mode="alpha")), blend_mode="multiply")
    return s.stage([s.inst(_back(s)), s.display.Container(
        children=(inner,), blend_mode="layer")])


# name -> (stage function, port vs JAX differing straight share measured)
BLEND_SCENES = {
    "multiply_a140": (_blend_stage("multiply", 140), 0.0),
    "add_a140": (_blend_stage("add", 140), 0.0),
    "difference_a140": (_blend_stage("difference", 140), 0.0),
    "overlay_a140": (_blend_stage("overlay", 140), 0.0),
    "grouped": (_grouped, 0.0),
    "blend_in_mask": (_blend_in_mask, 0.0),
    "alpha_128": (_layer_stage("alpha", 128), 0.0),
    "alpha_255": (_layer_stage("alpha", 255), 0.0),
    "erase_255": (_layer_stage("erase", 255), 0.0),
    "erase_90": (_layer_stage("erase", 90), 0.0),
    "nested_alpha": (_nested_alpha, 0.0),
}


@pytest.mark.parametrize("name", sorted(BLEND_SCENES))
def test_blend_scene_fused_matches_layered_and_reference(name):
    build, share = BLEND_SCENES[name]
    fused, r = _render(PORT, build)
    assert r._exec_path == "flatblock"
    layered, _ = _render(PORT, build, "scanline")
    np.testing.assert_array_equal(fused, layered)
    want, _ = _render(JAX, build)
    smax, pmax, got_share = levels(want, fused)
    assert pmax <= 1 and got_share <= share, (smax, pmax, got_share)


def test_group_mode_semantics():
    """tests/test_blend_modes.py's layer-family checks on the port: a
    blended container blends its composed children once; alpha and erase
    without a group draw nothing; erase knocks out the group, not the
    backdrop; alpha is a soft mask; a nested blend buffers alpha itself;
    layer and normal are plain over."""
    grouped, _ = _render(PORT, _grouped)

    def separate(s):
        a = s.rect(3, 400, 600, s.rgba(255, 0, 0, 128))
        b = s.rect(4, 400, 600, s.rgba(0, 0, 255, 128))
        return s.stage([s.inst(_back(s)), s.inst(a, blend_mode="multiply"),
                        s.inst(b, blend_mode="multiply")])

    assert (_render(PORT, separate)[0] != grouped).any()
    bare, _ = _render(PORT, lambda s: s.stage([s.inst(_back(s))]))
    for mode in ("alpha", "erase"):
        np.testing.assert_array_equal(_render(PORT, _blend_stage(mode))[0],
                                      bare)
    got, _ = _render(PORT, _layer_stage("erase", 255))
    np.testing.assert_array_equal(
        got[5:25, 2:18], np.broadcast_to([200, 100, 50, 255], (20, 16, 4)))
    np.testing.assert_array_equal(
        got[5:25, 22:38], np.broadcast_to([0, 200, 0, 255], (20, 16, 4)))
    got, _ = _render(PORT, _layer_stage("alpha", 128))
    want = [round(200 * 127 / 255), round(200 * 128 / 255 + 100 * 127 / 255),
            round(50 * 127 / 255), 255]
    np.testing.assert_array_equal(got[5:25, 2:18],
                                  np.broadcast_to(want, (20, 16, 4)))
    np.testing.assert_array_equal(
        got[5:25, 22:38], np.broadcast_to([200, 100, 50, 255], (20, 16, 4)))
    nested, _ = _render(PORT, _nested_alpha)

    def unwrapped(s):
        return s.stage([s.inst(_back(s)), _nested_alpha(s).children[1]
                        .children[0]])

    np.testing.assert_array_equal(nested, _render(PORT, unwrapped)[0])
    plain, _ = _render(PORT, _blend_stage(None))
    for mode in ("normal", "layer"):
        np.testing.assert_array_equal(_render(PORT, _blend_stage(mode))[0],
                                      plain)


def _filtered(filters, w=40, h=30, tx=250, ty=150):
    def build(s):
        back = s.rect(1, 800, 600, s.rgba(40, 90, 200))
        dot = s.rect(2, 200, 200, s.rgba(255, 230, 0, 230))
        return s.stage([
            s.inst(back),
            s.masked(s.inst(s.rect(3, 600, 600, s.rgba(0, 200, 0))),
                     [s.inst(dot, tx, ty, filters=filters(s))])], w, h)
    return build


def _all_kinds(s):
    mod = tfilters if s.ast is PORT[0] else jfilters
    return tuple(getattr(mod, FILTERS[n][0])(**FILTERS[n][1]) for n in (
        "shadow", "bevel", "gradient_glow", "convolution", "matrix",
        "inner_glow", "gradient_bevel", "blur"))


def _blur_shadow(s):
    mod = tfilters if s.ast is PORT[0] else jfilters
    return (mod.BlurFilter(7.0, 7.0, passes=3),
            mod.DropShadowFilter(color=(0, 0, 0, 0.8), blur_x=4.0,
                                 blur_y=4.0, angle=math.pi / 4,
                                 distance=3.0))


# name -> (stage function, port vs JAX straight envelope, share measured)
FILTER_SCENES = {
    "all_kinds": (_filtered(_all_kinds), 0, 0.0),
    "blur_shadow": (_filtered(_blur_shadow), 0, 0.0),
    # 180 x 40: 5 strips in a 128-row plane, 48 padding rows.
    "padded_rows": (_filtered(_blur_shadow, 180, 40, 1500, 200), 0, 0.0),
}


@pytest.mark.parametrize("name", sorted(FILTER_SCENES))
def test_filter_scene_fused_matches_layered_and_reference(name):
    """The fused program's plane <-> image conversion around filter
    nodes reproduces the layered compositor bit for bit (coverage is
    identical across the routes and the filter math is the same)."""
    build, straight, share = FILTER_SCENES[name]
    fused, r = _render(PORT, build)
    assert r._exec_path == "flatblock"
    layered, _ = _render(PORT, build, "scanline")
    np.testing.assert_array_equal(fused, layered)
    want, _ = _render(JAX, build)
    smax, pmax, got_share = levels(want, fused)
    assert pmax <= 1 and smax <= straight and got_share <= share, (
        smax, pmax, got_share)


def test_blur_spreads_and_conserves_on_the_fused_path():
    def dot(filters):
        def build(s):
            d = s.rect(1, 200, 200, s.rgba(255, 0, 0))
            return s.stage([s.inst(d, 300, 200, filters=filters)])
        return build

    got, r = _render(PORT, dot((BlurFilter(7.0, 7.0, passes=3),)))
    assert r._exec_path == "flatblock"
    plain, _ = _render(PORT, dot(()))
    assert (got[..., 3] > 0).sum() > (plain[..., 3] > 0).sum()
    assert got[..., 3].max() < plain[..., 3].max()
    mass = (got[..., 0].astype(np.float64) * got[..., 3]).sum()
    ref = (plain[..., 0].astype(np.float64) * plain[..., 3]).sum()
    np.testing.assert_allclose(mass, ref, rtol=0.02)
