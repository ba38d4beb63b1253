"""The product forms' device code (``csrc/place_mma_device.cuh``: the
placement of the reference's tools/exp_k3.py, exp_lmask.py and
exp_int8.py as one body of warpgroup ``wgmma`` products with the layers
in N) and exp_dmamerge's merged read at any rule and spp, run on the CPU
under the g++ emulation of ``tests/test_torch_kernel_emulated.py``
(whose emulator carries ``wgmma`` m64nNk16 bf16 with B MN-major and
m64nNk32 s8 with B K-major and s32 accumulation, A from registers after
the PTX ISA's fragment layouts and B through its matrix descriptor, an
ideal tensor core that sums a tile exactly (bf16: rounded once), each
``wgmma`` group performed only at the wait that retires it, and the warp
ballot), against the plain versions.

A file of its own so that the test runner's workers take it apart from
the other emulated kernels.  Tolerance: int8 and the merged read
byte-equal (exact integer sums; the merged read is B1's arithmetic); the
bf16 forms within B1's envelope (the card's tensor core sums a tile in
its own order and precision).
"""

import ctypes

import numpy as np
import pytest
import torch

from swf_renderer_tpu_torch.ops import cuda_lib
from swf_renderer_tpu_torch.ops import flatblock as fb
from swf_renderer_tpu_torch.tools import exp_split
from swf_renderer_tpu_torch.utils.scenes import build_scene_edges
from tests.test_torch_kernel_emulated import (  # noqa: F401 (fixture)
    _build_emulator, _c, _emulate_variant, _variant_scene, one_torch_thread,
)


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    return _build_emulator(tmp_path_factory.mktemp("cuda_emu_products"),
                           cuda_lib.CSRC_DIR)


# -- the product forms (csrc/place_mma_device.cuh): exp_k3, exp_lmask,
#    exp_int8; exp_dmamerge's merged read at any rule and spp ---------------

# (height, width, layers): 2 frames, one strip a plane, group 6; layer
# classes 4 (1, 3, 4 layers) and 16 (7: the second pass of the three-
# accumulator forms left out; 11: a short second pass; 16: two full).
PRODUCT_SCENES = [(24, 200, 3), (40, 300, 1), (16, 1100, 16), (32, 260, 4),
                  (24, 300, 7), (24, 200, 11)]
PRODUCT_FORMS = ["k3_three", "k3_concat", "lmask", "int8"]
INT8_VARIANT = 10   # csrc/place_mma_device.cuh kVarInt8 (swf_fused_int8)


def _b1_envelope(got, want, straight=5):
    """B1's pinned envelope (ROADMAP.md queue C, order of the winding
    sums): premultiplied bytes 1 level apart, straight bytes ``straight``
    levels on a share of at most 1e-4."""
    a = got.numpy().view(np.uint8).astype(np.int32)
    b = want.numpy().view(np.uint8).astype(np.int32)
    d = np.abs(a - b)
    assert d.max() <= straight and (d != 0).mean() <= 1e-4, (
        int(d.max()), float((d != 0).mean()))
    pa, pb = (np.concatenate([(x.reshape(-1, 4)[:, :3] * x.reshape(
        -1, 4)[:, 3:] + 127) // 255, x.reshape(-1, 4)[:, 3:]], 1)
        for x in (a, b))
    assert np.abs(pa - pb).max() <= 1


def test_emulated_fragment_layouts_cover_their_tiles(emulator):
    """The emulation's PTX fragment layouts that the warpgroup products
    use (a warp's A of the bf16 and s8 forms, its D) give every element
    of each tile to exactly one (lane, element)."""
    assert emulator.emulate_fragment_cover() == 0


@pytest.mark.parametrize("form", PRODUCT_FORMS)
@pytest.mark.parametrize("scene", PRODUCT_SCENES)
def test_emulated_product_forms_equal_plain_versions(emulator, scene, form):
    """The product forms' one body (warp-ballot gather, wgmma over
    shared-memory part tiles with the layers in N, two passes of eight
    layers for the three-accumulator forms at 16, the emulation's ideal
    tensor core) against the plain versions: int8 byte-equal to
    ``int8_plain`` (exact integer sums), the bf16 forms within B1's
    envelope of ``fusedn_plain`` (k3) and ``lmask_plain``; out pre-filled
    with -7, so every visited word must be written."""
    from swf_renderer_tpu_torch.tools import exp_int8, exp_lmask

    height, width, layers = scene
    d, colors = _variant_scene(height, width, layers)
    ns, nc = d["ns"], d["nc"]
    a = {k: _c(d[k].numpy()) for k in ("sidx", "flags", "lays", "urc", "ucm",
                                        "uval")}
    limbs = [_c(x) for x in exp_int8.limbs_of(a["uval"])[:3]]
    out = np.full((2, ns + 1, 8, nc * 128), -7, np.int32)
    cols = _c(colors)
    rules = np.zeros(layers, np.int32)
    variant = INT8_VARIANT if form == "int8" else exp_split._VARIANTS[form]
    rc = emulator.emulate_product(
        variant, *(a[k].ctypes.data for k in ("sidx", "flags", "lays", "urc",
                                              "ucm", "uval")),
        *(x.ctypes.data for x in limbs), cols.ctypes.data, rules.ctypes.data,
        out.ctypes.data, len(a["sidx"]), 6, 2, layers, ns + 1, nc)
    assert rc == 0
    got = torch.from_numpy(out)[:, :ns]
    arrays = tuple(d[k] for k in ("sidx", "flags", "lays", "urc", "ucm"))
    geo = (torch.as_tensor(colors), 2, layers, ns, nc)
    if form == "int8":
        want = exp_int8.int8_plain(*arrays, *map(torch.from_numpy, limbs),
                                   *geo, 6)[:, :ns]
        assert torch.equal(got, want)
    else:
        plain = exp_lmask.lmask_plain if form == "lmask" else fb.fusedn_plain
        want = plain(*arrays, d["uval"], *geo, group=6)[:, :ns]
        # 16 layers: one pixel at alpha 27 whose premultiplied blue is 7
        # here and 8 in the left-to-right prefix, 10 straight levels
        # (ROADMAP.md queue C, the product forms' rounding).
        _b1_envelope(got, want, straight=10 if layers == 16 else 5)
    assert want.any() and (got != -7).all()


@pytest.mark.parametrize("height,width,layers,spp,rule", [
    (40, 300, 3, 2, 1), (64, 100, 4, 4, "mixed"), (40, 100, 9, 5, 0)])
def test_emulated_merged_at_any_rule_and_spp(emulator, height, width, layers,
                                             spp, rule):
    """kVarMerged (exp_dmamerge's ``render_rv``) at several strips a plane,
    split over blocks at 9 layers, under even-odd and mixed rules:
    byte-equal to its plain version and to B1's."""
    from swf_renderer_tpu_torch.tools import exp_dmamerge

    if rule == "mixed":
        rule = tuple(i % 2 for i in range(layers))
    tables, colors = build_scene_edges(2, layers, height, width,
                                       shapes_per_layer=3, seed=layers + 90)
    d = exp_split.pack(tables, height, width, "cpu", spp=spp)
    ns, nc = d["ns"], d["nc"]
    got = _emulate_variant(emulator, d, colors, layers, "merged", spp=spp,
                           rule=rule)[:, :ns]
    urv = torch.cat([d["urc"], d["uval"]], dim=1)
    geo = (torch.as_tensor(colors), 2, layers, ns, nc)
    want = exp_dmamerge.rv_plain(d["sidx"], d["flags"], d["lays"], urv,
                                 d["ucm"], *geo, 6, rule, spp)[:, :ns]
    b1 = fb.fusedn_plain(*(d[k] for k in ("sidx", "flags", "lays", "urc",
                                          "ucm", "uval")), *geo,
                         fill_rule=rule, spp=spp)[:, :ns]
    assert torch.equal(got, want) and torch.equal(want, b1)
    assert want.any() and (got != -7).all()


# -- mutation checks: broken copies of the layer-masked form are caught ----

LMASK_MUTANTS = {
    # Two groups of products left in flight: a tile buffer is written
    # again while the products that read it may still run.
    "wait_one_more": ("        wgmma_wait<1>();\n",
                      "        wgmma_wait<2>();\n"),
    # A group's later batch written without the barrier that follows
    # both warpgroups' waits.
    "batch_barrier_dropped": (
        "        if (b0 > 0) __syncthreads();   // the buffer's products are "
        "done\n", ""),
}


@pytest.mark.parametrize("mutant", sorted(LMASK_MUTANTS))
def test_emulated_lmask_mutants_are_caught(tmp_path, mutant):
    """Each mutant of the layer-masked form's pipeline leaves the
    envelope under the emulation, whose products read their B tiles only
    when a wait retires them."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    before, after = LMASK_MUTANTS[mutant]
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC_DIR, csrc)
    header = csrc / "place_mma_device.cuh"
    text = header.read_text()
    assert text.count(before) == 1
    header.write_text(text.replace(before, after))
    emu = _build_emulator(tmp_path, csrc)
    with pytest.raises(AssertionError):
        test_emulated_product_forms_equal_plain_versions(
            emu, PRODUCT_SCENES[0], "lmask")


# Mutants of the k3 and int8 forms: (flag, anchor, replacement, form),
# each behind swf_mutant in one scratch build.
FORM_MUTANTS = {
    # int8's second limb combined without its shift.
    "int8_limb_shift_dropped": (
        31, "               (static_cast<uint32_t>(acc[1][j]) << 8) +\n",
        "               (static_cast<uint32_t>(acc[1][j]) <<\n"
        "                (swf_mutant == 31 ? 0 : 8)) +\n", "int8"),
    # The s8 tiles written MN-major (16-byte rows of 16 n for one k),
    # read by the K-major descriptor.
    "int8_tile_mn_major": (
        32, "  return (k >> 5) * (32 * kN) + (n >> 3) * 256 + ((k >> 4) & 1) "
        "* 128 +\n",
        "  if (swf_mutant == 32) {\n"
        "    return (k >> 5) * (32 * kN) + (n >> 4) * 512 + ((k >> 3) & 3) "
        "* 128 +\n           (k & 7) * 16 + (n & 15);\n  }\n"
        "  return (k >> 5) * (32 * kN) + (n >> 3) * 256 + ((k >> 4) & 1) "
        "* 128 +\n", "int8"),
    # The three limbs' products summed into one accumulator.
    "int8_one_accumulator": (
        33, "                wgmma_s8<kN>(acc[q], af[t],\n",
        "                wgmma_s8<kN>(acc[swf_mutant == 33 ? 0 : q], af[t],\n",
        "int8"),
    # k3 three's mid accumulator left out of the winding.
    "k3_three_mid_dropped": (
        34, "    return (acc[0][j] + acc[1][j]) + acc[2][j] + cy;\n",
        "    return (acc[0][j] + (swf_mutant == 34 ? 0.0f : acc[1][j])) +\n"
        "           acc[2][j] + cy;\n", "k3_three"),
}


@pytest.fixture(scope="module")
def form_mutant_emulator(tmp_path_factory):
    """The emulator over a copy of csrc holding every FORM_MUTANTS edit
    behind swf_mutant (0: the committed body)."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("cuda_emu_form_mutants")
    csrc = d / "csrc"
    shutil.copytree(cuda_lib.CSRC_DIR, csrc)
    header = csrc / "place_mma_device.cuh"
    text = header.read_text()
    for name, (_, before, after, _) in FORM_MUTANTS.items():
        assert text.count(before) == 1, name
        text = text.replace(before, after)
    header.write_text(text.replace("#pragma once\n",
                                   "#pragma once\nextern int swf_mutant;\n",
                                   1))
    emu = _build_emulator(d, csrc, """
int swf_mutant = 0;
extern "C" void set_mutant(int m) { swf_mutant = m; }
""")
    emu.set_mutant.restype = None
    emu.set_mutant.argtypes = [ctypes.c_int]
    return emu


@pytest.mark.parametrize("mutant", sorted(FORM_MUTANTS))
def test_emulated_form_mutants_are_caught(form_mutant_emulator, mutant):
    """Each mutant of the k3 or int8 form fails that form's check on the
    first scene (int8 no longer byte-equal, k3 three outside the
    envelope), which the unmutated build of the same copy passes."""
    flag, _, _, form = FORM_MUTANTS[mutant]
    form_mutant_emulator.set_mutant(0)
    test_emulated_product_forms_equal_plain_versions(
        form_mutant_emulator, PRODUCT_SCENES[0], form)
    form_mutant_emulator.set_mutant(flag)
    try:
        with pytest.raises(AssertionError):
            test_emulated_product_forms_equal_plain_versions(
                form_mutant_emulator, PRODUCT_SCENES[0], form)
    finally:
        form_mutant_emulator.set_mutant(0)
