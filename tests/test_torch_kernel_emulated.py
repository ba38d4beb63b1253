"""The CUDA kernels' device code, run on the CPU, against the plain
versions.

``csrc/flatblock_device.cuh`` holds all of the fused kernels' device
logic.  Here g++ compiles it under a small emulation of the CUDA
execution model (one std::thread per CUDA thread, a std::barrier for
``__syncthreads``, std::atomic_ref for the shared-memory atomics), and
the emulated blocks run at small sizes.  This checks the kernel's
indexing, strip slicing and arithmetic without a card; the card itself
runs ``chip_smoke.py``.  Tolerance: byte-equal — the plain versions
perform the kernel's arithmetic (left-to-right prefix, fixed-point
carry, op-by-op f32), and g++ is told not to contract FMAs.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from swf_renderer_tpu_torch.convert import packed_to_device
from swf_renderer_tpu_torch.native import bindings
from swf_renderer_tpu_torch.ops import cuda_lib
from swf_renderer_tpu_torch.ops import flatblock as fb
from swf_renderer_tpu_torch.ops.pipeline import lower_update_lists
from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

EMULATOR = r"""
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>
using std::fmaxf;
using std::fminf;
#define __host__
#define __device__
#define __forceinline__ inline
struct Dim3 { unsigned x = 1, y = 1, z = 1; };
thread_local Dim3 threadIdx, blockIdx;
Dim3 blockDim;
thread_local std::barrier<>* block_barrier;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
inline float atomicAdd(float* p, float v) {
  return std::atomic_ref<float>(*p).fetch_add(v);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
inline long long __double2ll_rn(double x) {
  return static_cast<long long>(std::nearbyint(x));
}
#include "flatblock_device.cuh"

extern "C" int emulate(int styled, const int* sidx, const int* flags,
                       const int* lays, const float* urc, const float* ucm,
                       const float* uval, const float* colors,
                       const int* rules, const int* pint, const float* pflt,
                       const float* f0, int* out, int ng, int group,
                       int frames, int layers, int ns1, int n_chunks,
                       int spp, int plane_rows) {
  swf::FusedArgs a{};
  a.sidx = sidx; a.flags = flags; a.lays = lays; a.urc = urc; a.ucm = ucm;
  a.uval = uval; a.colors = colors; a.rules = rules; a.pint = pint;
  a.pflt = pflt; a.fields[0] = f0; a.out = out; a.ng = ng; a.group = group;
  a.layers = layers; a.ns1 = ns1; a.n_chunks = n_chunks; a.spp = spp;
  a.plane_rows = plane_rows;
  std::vector<int> first(frames * ns1, -1), last(frames * ns1, -1);
  for (int i = 0; i < ng; ++i) {  // supergroup_index_kernel
    const int fl = flags[i];
    if ((fl & 3) == 0) continue;
    const int sg = (sidx[i] / (layers * ns1)) * ns1 + sidx[i] % ns1;
    if (fl & 1) first[sg] = i;
    if (fl & 2) last[sg] = i;
  }
  a.sg_first = first.data();
  a.sg_last = last.data();
  a.spb = swf::strips_per_block(layers, spp, styled != 0);
  a.n_spg = (spp + a.spb - 1) / a.spb;
  std::vector<unsigned char> smem(
      swf::smem_bytes(layers, a.spb * swf::kStripH, styled != 0));
  blockDim.x = swf::kThreads;
  for (int z = 0; z < frames; ++z)
    for (int y = 0; y < ns1 - 1; ++y)
      for (int x = 0; x < n_chunks * a.n_spg; ++x) {
        std::memset(smem.data(), 0xab, smem.size());  // stale contents
        std::barrier<> bar(swf::kThreads);
        std::vector<std::thread> threads;
        for (int t = 0; t < swf::kThreads; ++t) {
          threads.emplace_back([&, t] {
            threadIdx.x = t;
            blockIdx.x = x; blockIdx.y = y; blockIdx.z = z;
            block_barrier = &bar;
            if (styled) swf::fused_block<true>(a, smem.data());
            else swf::fused_block<false>(a, smem.data());
          });
        }
        for (auto& th : threads) th.join();
      }
  return a.spb;
}
"""


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("cuda_emu")
    (d / "emu.cc").write_text(EMULATOR)
    lib = d / "libemu.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         f"-I{cuda_lib.CSRC_DIR}", "-o", str(lib), str(d / "emu.cc"),
         "-lpthread"], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    emu = ctypes.CDLL(str(lib))
    emu.emulate.restype = ctypes.c_int
    emu.emulate.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 12 + [
        ctypes.c_int] * 8
    return emu


def _run(emu, dev, colors, rule, frames, layers, spp, paints=None,
         field=None):
    ns1, nc = dev["ns"] + 1, dev["nc"]
    arr = {k: np.ascontiguousarray(v.numpy()) for k, v in dev.items()
           if torch.is_tensor(v)}
    out = np.full((frames, ns1, spp * 8, nc * 128), -7, np.int32)
    pint = pflt = None
    if paints is not None:
        pint, pflt = fb.paint_tables(tuple(paints))
    rules = np.asarray(fb.layer_rules(rule, layers), np.int32)
    colors = np.ascontiguousarray(colors, np.float32)

    def ptr(x):
        return None if x is None else x.ctypes.data

    spb = emu.emulate(
        int(paints is not None), ptr(arr["sidx"]), ptr(arr["flags"]),
        ptr(arr["lays"]), ptr(arr["urc"]), ptr(arr["ucm"]),
        ptr(arr["uval"]), ptr(colors), ptr(rules), ptr(pint), ptr(pflt),
        ptr(field), out.ctypes.data, arr["urc"].shape[0], 6, frames,
        layers, ns1, nc, spp, fb.plane_rows_for(nc, spp))
    return torch.from_numpy(out), spb


# (height, width, layers, spp, strips per block expected)
CASES = [(24, 200, 3, 1, 1), (40, 300, 4, 2, 2), (16, 2560, 16, 1, 1),
         (64, 100, 16, 4, 2), (40, 100, 9, 5, 3)]


@pytest.mark.parametrize("height,width,layers,spp,spb", CASES)
def test_emulated_kernels_equal_plain_versions(emulator, height, width,
                                               layers, spp, spb):
    tables, colors = build_scene_edges(2, layers, height, width,
                                       shapes_per_layer=3, seed=layers)
    packed = bindings.pack_grouped_native(
        lower_update_lists(tables, height, width), height, width, group=6,
        spp=spp)
    dev = packed_to_device(*packed, device="cpu")
    ns, nc = dev["ns"], dev["nc"]
    args = (dev["sidx"], dev["flags"], dev["lays"], dev["urc"], dev["ucm"],
            dev["uval"], torch.as_tensor(colors), 2, layers, ns, nc)
    rule = tuple(int(i % 2) for i in range(layers))
    want = fb.fusedn_plain(*args, fill_rule=rule, spp=spp)
    got, got_spb = _run(emulator, dev, colors, rule, 2, layers, spp)
    assert got_spb == spb
    assert torch.equal(got[:, :ns], want[:, :ns])

    rng = np.random.default_rng(layers)
    ratios = np.array([0.0, 0.3, 1.0], np.float32)
    stops = rng.uniform(0, 1, (3, 4)).astype(np.float32)
    kinds = [fb.KernelPaint.color(),
             fb.KernelPaint.gradient(fb.KPAINT_LINEAR, (150.0, 10.0, -20.0,
                                                        140.0, -16000.0,
                                                        -9000.0),
                                     ratios, stops, spread=0),
             fb.KernelPaint.gradient(fb.KPAINT_FOCAL, (300.0, 0.0, 0.0,
                                                       300.0, -15000.0,
                                                       -8000.0),
                                     ratios, stops, focal=0.5, spread=2),
             fb.KernelPaint.gradient(fb.KPAINT_FOCAL, (200.0, 30.0, 5.0,
                                                       210.0, -12000.0,
                                                       -7000.0),
                                     ratios, stops, focal=-0.3, spread=1),
             fb.KernelPaint.field(0)]
    paints = tuple(kinds[i % len(kinds)] for i in range(layers))
    field = fb.field_to_chunkmajor(
        torch.as_tensor(rng.uniform(0, 1, (height, width, 4))
                        .astype(np.float32)), ns, nc, spp=spp)
    fields = (field,) if any(p.kind == fb.KPAINT_FIELD for p in paints) \
        else ()
    want = fb.fused_styled_plain(*args[:7], fields, *args[7:], paints,
                                 fill_rule=0, spp=spp)
    got, _ = _run(emulator, dev, colors, 0, 2, layers, spp, paints,
                  np.ascontiguousarray(field.numpy()))
    assert torch.equal(got[:, :ns], want[:, :ns])
