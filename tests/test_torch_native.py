"""The port's native lowering and packing are byte-equal to the JAX
package's (same C++ sources, separate builds and bindings)."""

import numpy as np
import pytest

from swf_renderer_tpu.native import bindings as jax_bindings
from swf_renderer_tpu.ops import pipeline as jax_pipeline
from swf_renderer_tpu_torch.native import bindings as port_bindings
from swf_renderer_tpu_torch.ops import flatblock as port_flatblock
from swf_renderer_tpu_torch.ops import pipeline as port_pipeline
from swf_renderer_tpu_torch.utils.scenes import build_scene_edges


def test_port_builds_its_own_library():
    lib = port_bindings.load_library()
    assert port_bindings.BUILD_DIR.name == "_build"
    assert str(port_bindings._LIB_PATH).startswith(
        str(port_bindings.BUILD_DIR))
    assert "swf_renderer_tpu_torch" in str(port_bindings._LIB_PATH)
    assert lib is port_bindings.load_library()
    assert jax_bindings.native_available()


# (height, width, spp): widths that are (256, 384) and are not (200, 300)
# multiples of 128; spp 1, 2 and the geometry's own packing.
CASES = [(48, 200, 1), (48, 256, 1), (64, 300, 2), (64, 384, 2),
         (40, 256, None), (72, 200, None)]


@pytest.mark.parametrize("height,width,spp", CASES)
def test_lowering_and_packing_byte_equal(height, width, spp):
    tables, _ = build_scene_edges(2, 3, height, width, shapes_per_layer=5,
                                  seed=height + width)
    ul_jax = jax_pipeline.lower_update_lists(tables, height, width)
    ul_port = port_pipeline.lower_update_lists(tables, height, width)
    for per_j, per_p in zip(ul_jax, ul_port):
        for uj, up in zip(per_j, per_p):
            for a, b in zip(uj, up):
                assert a.dtype == b.dtype
                assert a.tobytes() == b.tobytes()
    if spp is None:
        _, nc, ns = port_flatblock.plane_geometry(height, width)
        spp = port_flatblock.strips_per_plane(nc, ns)
        assert spp > 2
    pj = jax_bindings.pack_grouped_native(ul_jax, height, width, group=6,
                                          spp=spp)
    pp = port_bindings.pack_grouped_native(ul_port, height, width, group=6,
                                           spp=spp)
    assert pj[6:] == pp[6:]
    for a, b in zip(pj[:6], pp[:6]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_cells_split_and_block_packer_byte_equal():
    tables, _ = build_scene_edges(1, 2, 40, 180, shapes_per_layer=4, seed=3)
    for t in tables[0]:
        for a, b in zip(jax_bindings.cells_split_native(t, 40, 180),
                        port_bindings.cells_split_native(t, 40, 180)):
            assert a.tobytes() == b.tobytes()
    ul = port_pipeline.lower_update_lists(tables, 40, 180)
    for a, b in zip(jax_bindings.pack_blocks_native(ul, 40, 180),
                    port_bindings.pack_blocks_native(ul, 40, 180)):
        assert np.array_equal(a, b)
