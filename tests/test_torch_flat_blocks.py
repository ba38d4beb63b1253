"""The unfused flat-block pipeline (placement, grid and pipelined plane
resolves) and the one-block fused kernel: the port's host packers and
plain versions against the JAX package, whose Pallas kernels run in
interpret mode on the CPU as ``tests/test_flatblock.py`` runs them.

Tolerances, and why:
- host packers (pack_flat_blocks, sort_blocks_fused, group_blocks_fused,
  the native packers): array-equal;
- placement: raw deltas (step=False) equal — one coalesced update per
  target, placed exactly on both sides; step=True within atol 1e-5 /
  rtol 1e-6, the reference's own bound for its MXU accumulation order
  against a sequential prefix (``tests/test_flatblock.py:88-104``);
- the plane resolve on the reference's own planes: the port keeps the
  reference's ladders and chain op for op, so it is byte-equal except
  where XLA:CPU contracts the chain's ``C * ca + c * (1 - ca)`` into an
  FMA: measured at 16 layers over 16 chunks, 1 level on about 1e-5 of
  the bytes, pinned below at 1 level and a share of 2e-5;
- end to end (placement order differs as above): at most 1
  premultiplied level, straight envelopes pinned per scene;
- the one-block fused kernel against render_fused_blocksn on the same
  blocks, and the pipelined resolve against the grid resolve: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from swf_renderer_tpu.ops import flatblock as jfb
from swf_renderer_tpu_torch import entry as tentry
from swf_renderer_tpu_torch.native import bindings as tbindings
from swf_renderer_tpu_torch.ops import flatblock as tfb

# (frames, layers, height, width): two chunks; three; one chunk with the
# col-width updates dropped (stride == width); sixteen chunks.
SCENES = [(2, 3, 40, 300), (1, 2, 24, 200), (1, 2, 128, 128),
          (1, 2, 16, 2047)]


def random_update_lists(frames, layers, height, width, seed, n_pts=8):
    """Random closed polygons -> coalesced delta updates, through the
    port's and the reference's splitter twins (held equal here)."""
    rng = np.random.default_rng(seed)
    update_lists = []
    colors = rng.uniform(0.1, 1.0, (frames, layers, 4)).astype(np.float32)
    for _ in range(frames):
        per = []
        for _ in range(layers):
            pts = rng.uniform(0, (width, height), size=(n_pts, 2)).astype(
                np.float32)
            closed = np.concatenate([pts, pts[:1]])
            edges = np.concatenate([closed[:-1], closed[1:]], axis=1)
            got = tentry._coalesce_updates(edges, height, width)
            want = graft._coalesce_updates(edges, height, width)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            per.append(got)
        update_lists.append(per)
    return update_lists, colors


def _t(*arrays):
    return tuple(torch.as_tensor(np.ascontiguousarray(a)) for a in arrays)


def _bytes(u32):
    return np.asarray(u32).view(np.uint32).view(np.uint8).reshape(
        -1, 4).astype(np.int32)


def _diff(ref_u32, got):
    """(straight max, straight share, premultiplied max) level
    differences of two packed RGBA arrays."""
    a = _bytes(ref_u32)
    b = _bytes(got.numpy() if torch.is_tensor(got) else got)
    d = np.abs(a - b)

    def pm(x):
        return np.concatenate([(x[:, :3] * x[:, 3:] + 127) // 255, x[:, 3:]],
                              1)

    return int(d.max()), float((d != 0).mean()), int(np.abs(pm(a) -
                                                             pm(b)).max())


def _packed(scene, seed, pad=8):
    frames, layers, height, width = scene
    ul, colors = random_update_lists(frames, layers, height, width, seed)
    return ul, colors, jfb.pack_flat_blocks(ul, height, width,
                                            block_pad_multiple=pad)


# -- host half: equal ---------------------------------------------------------


@pytest.mark.parametrize("scene", SCENES)
def test_host_packers_equal_reference(scene):
    frames, layers, height, width = scene
    ul, _, want = _packed(scene, seed=sum(scene))
    got = tfb.pack_flat_blocks(ul, height, width, block_pad_multiple=8)
    native = tbindings.pack_blocks_native(ul, height, width,
                                          block_pad_multiple=8)
    for x, y, z in zip(want, got, native):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype == z.dtype
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
        else:
            assert x == y == z
    sidx, keep, urc, ucm, uval, ns, nc = got
    ref_sorted = jfb.sort_blocks_fused(sidx, keep, urc, ucm, uval, layers, ns,
                                       block_pad_multiple=8)
    got_sorted = tfb.sort_blocks_fused(sidx, keep, urc, ucm, uval, layers, ns,
                                       block_pad_multiple=8)
    for x, y in zip(ref_sorted, got_sorted):
        np.testing.assert_array_equal(x, y)
    for group in (2, 6):
        for x, y in zip(
                jfb.group_blocks_fused(*ref_sorted, layers, ns, group=group,
                                       group_pad_multiple=4),
                tfb.group_blocks_fused(*got_sorted, layers, ns, group=group,
                                       group_pad_multiple=4)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [1, 8])
def test_pack_grouped_native_matches_python_chain(seed):
    """The reference's tests/test_flatblock.py:348 on the port: the
    one-pass native packer against pack + sort + group in Python."""
    frames, layers, height, width = 2, 3, 40, 300
    ul, colors = random_update_lists(frames, layers, height, width, seed)
    sidx, keep, urc, ucm, uval, ns, nc = tfb.pack_flat_blocks(
        ul, height, width, block_pad_multiple=1)
    blocks = tfb.sort_blocks_fused(sidx, keep, urc, ucm, uval, layers, ns,
                                   block_pad_multiple=1)
    ns1 = ns + 1
    for group in (2, 8):
        a = tfb.group_blocks_fused(*blocks, layers, ns, group=group,
                                   group_pad_multiple=4)
        gsi, gfl, gla, grc, gcm, gvv, nsb, ncb = tbindings.pack_grouped_native(
            ul, height, width, group=group, group_pad_multiple=4)
        assert (nsb, ncb) == (ns, nc)
        np.testing.assert_array_equal(a[0] // (layers * ns1),
                                      gsi // (layers * ns1))
        np.testing.assert_array_equal(a[0] % ns1, gsi % ns1)
        for x, y in zip(a[1:], (gfl, gla, grc, gcm, gvv)):
            np.testing.assert_array_equal(x, y.reshape(x.shape))
        want = tfb.render_fused_blocksn(*_t(*a, colors), frames, layers, ns,
                                        nc, group=group)
        got = tfb.render_fused_blocksn(*_t(gsi, gfl, gla, grc, gcm, gvv,
                                           colors), frames, layers, ns, nc,
                                       group=group)
        assert torch.equal(got, want)


def test_native_packer_on_reference_scene():
    """The reference's tests/test_flatblock.py:160 scene (3 x 4 x 64x500,
    padding to 16 blocks): the port's native packer against the
    reference's Python packer."""
    ul, _, want = _packed((3, 4, 64, 500), seed=9, pad=16)
    got = tbindings.pack_blocks_native(ul, 64, 500, block_pad_multiple=16)
    for x, y in zip(want, got):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


# -- placement (B14) ----------------------------------------------------------


@pytest.mark.parametrize("scene", SCENES[:2] + SCENES[3:])
def test_place_plain_matches_jax_kernel(scene):
    frames, layers, height, width = scene
    _, _, (sidx, keep, urc, ucm, uval, ns, nc) = _packed(scene, seed=3)
    for step in (False, True):
        want = np.asarray(jfb.place_blocks(sidx, keep, urc, ucm, uval,
                                           frames, layers, ns, step=step))
        got = tfb.place_plain(*_t(sidx, keep, urc, ucm, uval), frames,
                              layers, ns, step=step).numpy()
        assert got.shape == want.shape
        # Strip NS: the padding bucket (the port writes zeros).
        assert not got[:, :, ns].any()
        if step:
            np.testing.assert_allclose(got[:, :, :ns], want[:, :, :ns],
                                       atol=1e-5, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got[:, :, :ns], want[:, :, :ns])
    assert np.abs(want[:, :, :ns]).max() > 0.5


def test_place_blocks_on_cpu_runs_plain_and_counts_nothing():
    scene = SCENES[0]
    frames, layers = scene[:2]
    _, _, (sidx, keep, urc, ucm, uval, ns, nc) = _packed(scene, seed=4)
    before = tfb.place_blocks.launches
    got = tfb.place_blocks(sidx, keep, urc, ucm, uval, frames, layers, ns,
                           device="cpu")
    want = tfb.place_plain(*_t(sidx, keep, urc, ucm, uval), frames, layers,
                           ns)
    assert torch.equal(got, want) and tfb.place_blocks.launches == before


# -- plane resolves (B15, B16) ------------------------------------------------


@pytest.mark.parametrize("layers,n_chunks", [(1, 2), (4, 3), (16, 16)])
def test_resolve_plain_on_reference_planes(layers, n_chunks):
    """Random raw planes and their row prefixes through the JAX resolve
    and the port's, every rule: byte-equal at 1 and 4 layers; at 16
    layers XLA:CPU's FMA in the chain moves 1 level on ~1e-5 of the
    bytes (pinned)."""
    rng = np.random.default_rng(layers * 7 + n_chunks)
    frames, ns = 2, 3
    raw = rng.normal(0, 0.4, (frames, layers, ns + 1, 128, 128)).astype(
        np.float32)
    raw[rng.uniform(size=raw.shape) < 0.6] = 0.0
    raw[..., n_chunks * 8:, :] = 0.0
    colors = rng.uniform(0, 1, (frames, layers, 4)).astype(np.float32)
    mixed = tuple(int(x) for x in rng.integers(0, 2, layers))
    for rule in (0, 1, mixed):
        for prefixed in (False, True):
            planes = (np.cumsum(raw, -1, dtype=np.float32) if prefixed
                      else raw)
            want = np.asarray(jfb.resolve_planes_u32(
                jnp.asarray(planes), jnp.asarray(colors), n_chunks,
                fill_rule=rule, prefixed=prefixed))
            got = tfb.resolve_u32_plain(*_t(planes, colors), n_chunks, rule,
                                        prefixed)
            assert got.shape == want.shape
            dmax, share, pmax = _diff(want, got)
            if layers < 16:
                assert dmax == 0, (rule, prefixed)
            else:
                assert dmax <= 1 and pmax <= 1 and share <= 2e-5, (
                    rule, prefixed, dmax, share)


def test_dma_resolve_equals_grid_resolve():
    """The reference's tests/test_flatblock.py:254 on the port, every
    n_buf (the plain version serves both wrappers on the CPU)."""
    frames, layers, height, width = 2, 3, 40, 300
    _, colors, (sidx, keep, urc, ucm, uval, ns, nc) = _packed(
        (frames, layers, height, width), seed=5, pad=1024)
    planes = tfb.place_blocks(sidx, keep, urc, ucm, uval, frames, layers, ns,
                              step=True, device="cpu")
    want = tfb.resolve_planes_u32(planes, colors, nc)
    for n_buf in (1, 2, 3):
        got = tfb.resolve_planes_u32_dma(planes, colors, nc, n_buf=n_buf)
        assert torch.equal(got, want)
    ref = np.asarray(jfb.resolve_planes_u32_dma(
        jfb.place_blocks(sidx, keep, urc, ucm, uval, frames, layers, ns,
                         step=True), jnp.asarray(colors), nc))
    assert _diff(ref, want)[2] <= 1
    with pytest.raises(ValueError, match="n_buf"):
        tfb.resolve_planes_u32_dma(planes, colors, nc, n_buf=0)


# -- end to end ---------------------------------------------------------------


# Straight-byte envelopes measured on these scenes: the placement's prefix
# order moves a winding by an ulp, which moves a premultiplied byte of an
# AA pixel by a level, and un-premultiplying scales the step by 255 /
# alpha (3 levels on 4.1e-5 of the bytes of scene 0, 9 on 1.5e-5 of
# scene 3; scene 1 byte-equal).  Shares pinned at 1e-4.
FLAT_ENVELOPE = {SCENES[0]: 3, SCENES[1]: 0, SCENES[3]: 9}


@pytest.mark.parametrize("scene", [SCENES[0], SCENES[1], SCENES[3]])
def test_render_flat_blocks_matches_reference(scene):
    frames, layers, height, width = scene
    _, colors, (sidx, keep, urc, ucm, uval, ns, nc) = _packed(scene, seed=2,
                                                              pad=1024)
    rule = tuple(i % 2 for i in range(layers))
    want = np.asarray(jfb.render_flat_blocks(
        sidx, keep, urc, ucm, uval, colors, height, width, frames, layers,
        ns, nc, fill_rule=rule))
    got = tfb.render_flat_blocks(sidx, keep, urc, ucm, uval, colors, height,
                                 width, frames, layers, ns, nc,
                                 fill_rule=rule, device="cpu")
    assert got.shape == want.shape and got.dtype == torch.int32
    dmax, share, pmax = _diff(want, got)
    assert pmax <= 1 and dmax <= FLAT_ENVELOPE[scene], (dmax, share)
    assert share <= 1e-4
    u8 = tfb.frames_u32_to_u8(got.numpy().view(np.uint32), height, width)
    assert u8.shape == (frames, height, width, 4) and u8[..., 3].any()


def test_empty_groups_zeroed():
    """The reference's tests/test_flatblock.py:184: no updates anywhere ->
    fully transparent frames (every empty group places a zero block)."""
    frames, layers, height, width = 1, 2, 16, 100
    empty = [[(np.zeros(0, np.int32), np.zeros(0, np.int32),
               np.zeros(0, np.float32)) for _ in range(layers)]]
    colors = np.full((frames, layers, 4), 0.7, np.float32)
    sidx, keep, urc, ucm, uval, ns, nc = tfb.pack_flat_blocks(
        empty, height, width, block_pad_multiple=4)
    out = tfb.render_flat_blocks(sidx, keep, urc, ucm, uval, colors, height,
                                 width, frames, layers, ns, nc, device="cpu")
    assert out.shape == (frames, ns * 8, nc * 128) and not out.any()
    blocks = tfb.sort_blocks_fused(sidx, keep, urc, ucm, uval, layers, ns)
    out = tfb.render_fused_blocks(*blocks, colors, frames, layers, ns, nc,
                                  device="cpu")
    assert out.shape == (frames, ns + 1, 8, nc * 128) and not out.any()


# Straight-byte envelopes of the one-block fused kernel against the JAX
# kernel (fixed-point carry against the stride-8 ladder, and the prefix
# order).
FUSED_ENVELOPE = {3: 0, 2: 0}


@pytest.mark.parametrize("passes", [3, 2])
def test_render_fused_blocks_matches_reference(passes):
    frames, layers, height, width = 2, 3, 40, 300
    _, colors, (sidx, keep, urc, ucm, uval, ns, nc) = _packed(
        (frames, layers, height, width), seed=6)
    blocks = tfb.sort_blocks_fused(sidx, keep, urc, ucm, uval, layers, ns,
                                   block_pad_multiple=8)
    rule = (0, 1, 0)
    want = np.asarray(jfb.render_fused_blocks(
        *blocks, colors, frames, layers, ns, nc, fill_rule=rule,
        passes=passes))
    got = tfb.render_fused_blocks(*blocks, colors, frames, layers, ns, nc,
                                  fill_rule=rule, passes=passes,
                                  device="cpu")
    assert got.shape == want.shape
    assert not got[:, ns].any()
    dmax, share, pmax = _diff(want[:, :ns], got[:, :ns])
    assert pmax <= 1 and dmax <= FUSED_ENVELOPE[passes], (dmax, share)
    # Two passes carry ~16 bits of each value: another picture than three
    # passes only on alpha-epsilon pixels.
    exact = tfb.render_fused_blocks(*blocks, colors, frames, layers, ns, nc,
                                    fill_rule=rule, device="cpu")
    assert _diff(exact.numpy(), got)[2] <= 1


@pytest.mark.parametrize("group", [2, 4])
def test_fused1_equals_grouped_kernel_on_same_blocks(group):
    """The reference's tests/test_flatblock.py:304 on the port: the
    one-block fused kernel equals render_fused_blocksn on
    group_blocks_fused of the same sorted blocks, word for word."""
    frames, layers, height, width = 2, 3, 40, 300
    _, colors, (sidx, keep, urc, ucm, uval, ns, nc) = _packed(
        (frames, layers, height, width), seed=8)
    blocks = tfb.sort_blocks_fused(sidx, keep, urc, ucm, uval, layers, ns,
                                   block_pad_multiple=8)
    want = tfb.render_fused_blocks(*blocks, colors, frames, layers, ns, nc,
                                   fill_rule=1, device="cpu")[:, :ns]
    grouped = tfb.group_blocks_fused(*blocks, layers, ns, group=group,
                                     group_pad_multiple=4)
    got = tfb.render_fused_blocksn(*_t(*grouped, colors), frames, layers, ns,
                                   nc, group=group, fill_rule=1)[:, :ns]
    assert torch.equal(got, want)


def test_entry_forward_matches_reference():
    """entry()'s forward on the CPU against __graft_entry__.entry()'s."""
    fn, args = graft.entry()
    want = np.asarray(fn(*args))
    forward, targs = tentry.entry(device="cpu")
    for a, b in zip(args, targs):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    before = (tfb.place_blocks.launches, tfb.resolve_planes_u32.launches)
    got = forward(*targs)
    assert (tfb.place_blocks.launches,
            tfb.resolve_planes_u32.launches) == before
    assert got.shape == want.shape == (2, 64, 256)
    dmax, share, pmax = _diff(want, got)
    assert dmax == 0, (dmax, share)


# -- refusals -----------------------------------------------------------------


def test_wide_frames_raise():
    """Width >= 2048 (17 chunks) raises with the reference's messages."""
    frames, layers, ns, nc = 1, 1, 1, 17
    sidx = np.zeros(1, np.int32)
    blk = np.zeros((1, 1, 128), np.float32)
    colors = np.ones((1, 1, 4), np.float32)
    with pytest.raises(ValueError, match="two-kernel path supports width "
                                         "< 2048"):
        tfb.render_flat_blocks(sidx, sidx, blk, blk.reshape(1, 128, 1), blk,
                               colors, 8, 2100, frames, layers, ns, nc,
                               device="cpu")
    with pytest.raises(ValueError, match="render_fused_blocks supports "
                                         "width < 2048"):
        tfb.render_fused_blocks(sidx, sidx, sidx, blk, blk.reshape(1, 128, 1),
                                blk, colors, frames, layers, ns, nc,
                                device="cpu")
    planes = torch.zeros((1, 1, 2, 128, 128))
    for fn in (tfb.resolve_planes_u32, tfb.resolve_planes_u32_dma):
        with pytest.raises(ValueError, match="width < 2048"):
            fn(planes, torch.as_tensor(colors), nc)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    _, colors, (sidx, keep, urc, ucm, uval, ns, nc) = _packed(SCENES[1], 7)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfb.place_blocks(sidx, keep, urc, ucm, uval, 1, 2, ns)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfb.render_flat_blocks(sidx, keep, urc, ucm, uval, colors, 24, 200,
                               1, 2, ns, nc)


def test_wrappers_refuse_devices_they_cannot_launch():
    planes = torch.zeros((1, 1, 2, 128, 128), device="meta")
    colors = torch.zeros((1, 1, 4), device="meta")
    for fn in (tfb.resolve_planes_u32, tfb.resolve_planes_u32_dma):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(planes, colors, 2)
    assert tfb.resolve_planes_u32.launches == 0
    assert tfb.resolve_planes_u32_dma.launches == 0


def test_cuda_lib_refuses_unknown_libraries():
    """Every library has its own ctypes signatures: a name outside
    LIBRARIES raises before anything is built or loaded."""
    from swf_renderer_tpu_torch.ops import cuda_lib

    assert cuda_lib.LIBRARIES["swfplanes"][0] == "planes.cu"
    with pytest.raises(ValueError, match="unknown CUDA library"):
        cuda_lib.load("swfnothing")
