"""The CUDA kernels' device code, run on the CPU, against the plain
versions.

``csrc/flatblock_device.cuh`` holds all of the fused kernels' device
logic, ``csrc/sweep_device.cuh`` all of the sweep kernels',
``csrc/texfield_device.cuh`` all of the texfield kernel's,
``csrc/coverage_device.cuh`` the two direct coverage kernels',
``csrc/resolve_device.cuh`` the resolve kernel's and
``csrc/planes_device.cuh`` the placement and plane-resolve kernels'.
Here g++ compiles them under a small emulation of the CUDA
execution model (one fiber per CUDA thread, all of a block's on one OS
thread, switching at ``__syncthreads`` and at the per-warp barrier of
the shuffles and ``__syncwarp``, std::atomic_ref for the shared-memory
atomics, ``cp.async`` as a plain copy, mbarriers and ``cp.async.bulk``
global-to-shared copies for the pipelined plane resolve (a copy lands at
once and completes its bytes on its barrier, a wait yields the fiber
until the phase completed), so its ring logic runs unchanged; the warp
ballot and the ``wgmma`` forms m64nNk16 bf16 (B MN-major) and m64nNk32
s8 (B K-major, s32 accumulation) with A from registers and B through its
matrix descriptor, each group deferred to the wait that retires it, for
``csrc/place_mma_device.cuh``, whose tests are in
``test_torch_kernel_emulated_products.py``), and
the emulated blocks run at small sizes (a launch aborts if it leaves
the calling thread's MXCSR control bits or x87 control word other than
it found them: the fibers switch both).  This checks the kernel's
indexing, strip slicing and arithmetic without a card; the card itself
runs ``chip_smoke.py``.  Tolerance: byte-equal — the plain versions
perform the kernel's arithmetic (left-to-right prefix, fixed-point
carry, op-by-op f32), and g++ is told not to contract FMAs.
"""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from swf_renderer_tpu_torch.convert import packed_to_device
from swf_renderer_tpu_torch.native import bindings
from swf_renderer_tpu_torch.ops import coverage as cov
from swf_renderer_tpu_torch.ops import cuda_lib
from swf_renderer_tpu_torch.ops import resolve as res
from swf_renderer_tpu_torch.ops import flatblock as fb
from swf_renderer_tpu_torch.ops import texfield
from swf_renderer_tpu_torch.ops import transform as sweep
from swf_renderer_tpu_torch.ops.pipeline import lower_update_lists
from swf_renderer_tpu_torch.tools import exp_bw, exp_split
from swf_renderer_tpu_torch.utils.scenes import (
    build_scene_edges, random_blobs, random_tracks,
)

EMULATOR = r"""
#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <algorithm>
#include <type_traits>
#include <vector>
#include <sys/mman.h>
using std::fmaxf;
using std::fminf;
using std::min;
#define __host__
#define __device__
#define __forceinline__ inline
// Every CUDA thread of an emulated block is a fiber on the calling OS
// thread (run_block): a fiber runs until it waits at a barrier that the
// others have not all reached, then the next fiber that can go on runs.
// A block costs no thread creation and a barrier one switch a fiber, so
// a launch runs on one core however many threads its blocks have.  The
// state below is that of the running fiber: one launch at a time.
struct Dim3 { unsigned x = 1, y = 1, z = 1; };
Dim3 threadIdx, blockIdx;
Dim3 blockDim;
struct EmuBarrier { int n = 0, count = 0; unsigned gen = 0; };
// x86-64: save the callee-saved registers, MXCSR and the x87 control
// word on this stack, store its pointer at *save, switch to load.
extern "C" void emu_switch(void** save, void* load);
asm(R"(
  .text
  .p2align 4
  .globl emu_switch
  .hidden emu_switch
  .type emu_switch, @function
emu_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  subq $8, %rsp
  stmxcsr (%rsp)
  fnstcw 4(%rsp)
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  ldmxcsr (%rsp)
  fldcw 4(%rsp)
  addq $8, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size emu_switch, .-emu_switch
)");
namespace emu {
constexpr size_t kStack = 256 * 1024;   // a fiber's, below a guard page
struct Fiber { void* sp = nullptr; bool done = false; };
std::vector<Fiber> fibers;
std::vector<char*> stacks;
void* sched_sp = nullptr;
int current = 0;
long long progress = 0;   // barrier arrivals and finished fibers
void (*entry_fn)(void*) = nullptr;
void* entry_obj = nullptr;
inline void yield() { emu_switch(&fibers[current].sp, sched_sp); }
extern "C" void emu_fiber_main() {
  entry_fn(entry_obj);
  fibers[current].done = true;
  ++progress;
  yield();   // never resumed
  std::abort();
}
inline void wait(EmuBarrier& b) {
  ++progress;
  if (++b.count == b.n) {
    b.count = 0;
    ++b.gen;
    return;
  }
  const unsigned gen = b.gen;
  do yield(); while (b.gen == gen);
}
// Runs fn(obj) as n fibers to their ends; enter(t) sets fiber t's
// thread state before each of its turns.  Aborts on a deadlock (a round
// in which no fiber arrived at a barrier or finished).
template <class Enter>
void run(int n, void (*fn)(void*), void* obj, Enter enter) {
  while (static_cast<int>(stacks.size()) < n) {
    char* m = static_cast<char*>(mmap(nullptr, kStack + 4096,
                                      PROT_READ | PROT_WRITE,
                                      MAP_PRIVATE | MAP_ANONYMOUS, -1, 0));
    if (m == MAP_FAILED || mprotect(m, 4096, PROT_NONE) != 0) std::abort();
    stacks.push_back(m + 4096);
  }
  unsigned mxcsr = 0;
  unsigned short fcw = 0;
  asm volatile("stmxcsr %0" : "=m"(mxcsr));
  asm volatile("fnstcw %0" : "=m"(fcw));
  const uintptr_t csr = mxcsr | (static_cast<uintptr_t>(fcw) << 32);
  fibers.assign(n, Fiber{});
  for (int t = 0; t < n; ++t) {
    void** sp = reinterpret_cast<void**>(
        reinterpret_cast<uintptr_t>(stacks[t] + kStack) & ~uintptr_t{15});
    *--sp = nullptr;   // emu_fiber_main's return address: it never returns
    *--sp = reinterpret_cast<void*>(&emu_fiber_main);
    for (int r = 0; r < 6; ++r) *--sp = nullptr;
    *--sp = reinterpret_cast<void*>(csr);
    fibers[t].sp = sp;
  }
  entry_fn = fn;
  entry_obj = obj;
  for (int alive = n; alive > 0;) {
    const long long before = progress;
    alive = 0;
    for (int t = 0; t < n; ++t) {
      if (fibers[t].done) continue;
      enter(t);
      current = t;
      emu_switch(&sched_sp, fibers[t].sp);
      alive += !fibers[t].done;
    }
    if (alive > 0 && progress == before) {
      std::fprintf(stderr, "emulated block deadlocked at a barrier\n");
      std::abort();
    }
  }
  // The calling thread leaves with the rounding, flush and mask bits of
  // MXCSR and the x87 control word it came with (the sticky exception
  // flags aside): a fiber's environment never leaks out of a launch.
  unsigned mxcsr_out = 0;
  unsigned short fcw_out = 0;
  asm volatile("stmxcsr %0" : "=m"(mxcsr_out));
  asm volatile("fnstcw %0" : "=m"(fcw_out));
  if (((mxcsr_out ^ mxcsr) & ~0x3Fu) != 0 || fcw_out != fcw) {
    std::fprintf(stderr, "emulated launch changed the calling thread's "
                 "MXCSR %#x -> %#x or x87 control word %#x -> %#x\n",
                 mxcsr, mxcsr_out, static_cast<unsigned>(fcw),
                 static_cast<unsigned>(fcw_out));
    std::abort();
  }
}
}  // namespace emu
EmuBarrier* block_barrier;
inline void __syncthreads() { emu::wait(*block_barrier); }
inline float atomicAdd(float* p, float v) {
  return std::atomic_ref<float>(*p).fetch_add(v);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}
inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> r(*p);
  int old = r.load();
  while (old < v && !r.compare_exchange_weak(old, v)) {}
  return old;
}
inline unsigned __float_as_uint(float x) {
  unsigned u;
  std::memcpy(&u, &x, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float x;
  std::memcpy(&x, &u, 4);
  return x;
}
inline long long __double2ll_rn(double x) {
  return static_cast<long long>(std::nearbyint(x));
}
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct int4 { int x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __fdiv_rn(float a, float b) { return a / b; }
Dim3 gridDim;
// Warp collectives: each warp has a barrier, an exchange slot a lane and
// (run_block) kWarpWords exchange words a lane for the ballot, the
// wgmma fragments and the 64-bit shuffles.
constexpr int kWarpWords = 8;
struct Warp { EmuBarrier* bar; float* slots; unsigned* words; };
Warp this_warp;
inline void __syncwarp() { emu::wait(*this_warp.bar); }
inline unsigned __ballot_sync(unsigned, int pred) {
  const int lane = threadIdx.x & 31;
  this_warp.words[lane * kWarpWords] = pred ? 1u : 0u;
  __syncwarp();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= this_warp.words[l * kWarpWords] << l;
  __syncwarp();
  return m;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
// Fragment layouts of the PTX ISA, (lane, element i) -> (row, col) of a
// warp's tile: a wgmma A operand from registers is the mma.sync A layout
// of each warp's 16 rows, its D the mma.sync C/D layout of each 8
// columns; groupID = lane >> 2, threadID_in_group = lane & 3.
inline void frag_a_bf16(int lane, int i, int& r, int& c) {   // 16 x 16
  r = (lane >> 2) + ((i & 2) ? 8 : 0);
  c = (lane & 3) * 2 + (i & 1) + (i >= 4 ? 8 : 0);
}
inline void frag_a_s8(int lane, int i, int& r, int& c) {     // 16 x 32
  r = (lane >> 2) + ((i & 4) ? 8 : 0);
  c = (lane & 3) * 4 + (i & 3) + (i >= 8 ? 16 : 0);
}
inline void frag_c(int lane, int i, int& r, int& c) {        // 16 x 8
  r = (lane >> 2) + (i >= 2 ? 8 : 0);
  c = (lane & 3) * 2 + (i & 1);
}
// wgmma m64nNk16 bf16 -> f32 and m64nNk32 s8 -> s32, A from registers, B
// from shared memory by its matrix descriptor, no swizzle: bf16 MN-major
// (element (k, n) at the address + (k / 8) * leading + (n / 8) * stride
// + (k % 8) * 16 + (n % 8) * 2 bytes), s8 K-major (8-bit types take no
// transpose: element (k, n) at the address + (k / 16) * leading + (n / 8)
// * stride + (n % 8) * 16 + k % 16).  An ideal tensor core: the bf16
// products and their sum with C exact, rounded once to f32 (the card's
// own sum order and precision differ: the bf16 forms are held to an
// envelope); the s8 products summed exactly and added to C wrapping in
// 32 bits.  A warp of the warpgroup computes its 16 rows of D from its
// own A rows, so each lane posts its fragment to its warp and keeps its
// rows gid and gid + 8.  The products are deferred: each thread keeps
// its committed groups and performs the oldest, reading B from shared
// memory then, only when a wait leaves fewer in flight.  So a kernel that
// writes a B tile before the products reading it have been waited for
// shows in the words.  Descriptors carry offsets from emu_smem_base, the
// emulated block's shared memory.
unsigned char* emu_smem_base = nullptr;
inline unsigned emu_smem_offset(const void* p) {
  return static_cast<unsigned>(static_cast<const unsigned char*>(p) -
                               emu_smem_base);
}
struct EmuWgmma { void* d; int n; bool s8; uint64_t desc; float a[2][32]; };
struct EmuWgmmaState {
  std::vector<EmuWgmma> open;
  std::vector<std::vector<EmuWgmma>> groups;
};
EmuWgmmaState emu_wgmma_state[1024];   // by threadIdx.x
inline void emu_fence_proxy_async() {}
inline void emu_wgmma_issue(void* d, int n, bool s8, const uint32_t* a,
                            uint64_t desc) {
  const int lane = threadIdx.x & 31;
  unsigned* w = this_warp.words + lane * kWarpWords;
  for (int i = 0; i < 4; ++i) w[i] = a[i];
  __syncwarp();
  EmuWgmma op{d, n, s8, desc, {}};
  for (int l = 0; l < 32; ++l) {
    const unsigned* lw = this_warp.words + l * kWarpWords;
    for (int i = 0; i < (s8 ? 16 : 8); ++i) {
      int r, c;
      if (s8) {
        frag_a_s8(l, i, r, c);
      } else {
        frag_a_bf16(l, i, r, c);
      }
      if (r % 8 != lane >> 2) continue;
      op.a[r / 8][c] = s8 ? static_cast<float>(static_cast<int8_t>(
                                (lw[i / 4] >> (8 * (i & 3))) & 0xffu))
                          : __uint_as_float(((lw[i / 2] >> (16 * (i & 1)))
                                             & 0xffffu) << 16);
    }
  }
  __syncwarp();
  if ((desc >> 49) != 0) std::abort();   // base offset, swizzle: none used
  emu_wgmma_state[threadIdx.x].open.push_back(op);
}
inline void emu_wgmma_bf16(float* d, int n, const uint32_t* a,
                           uint64_t desc) {
  emu_wgmma_issue(d, n, false, a, desc);
}
inline void emu_wgmma_s8(int* d, int n, const uint32_t* a, uint64_t desc) {
  emu_wgmma_issue(d, n, true, a, desc);
}
inline void emu_wgmma_commit() {
  EmuWgmmaState& s = emu_wgmma_state[threadIdx.x];
  s.groups.push_back(std::move(s.open));
  s.open.clear();
}
inline void emu_wgmma_wait(int n) {
  EmuWgmmaState& s = emu_wgmma_state[threadIdx.x];
  const int lane = threadIdx.x & 31;
  while (static_cast<int>(s.groups.size()) > n) {
    for (const EmuWgmma& op : s.groups.front()) {
      const unsigned char* b = emu_smem_base + ((op.desc & 0x3fffu) << 4);
      const size_t lead = ((op.desc >> 16) & 0x3fffu) << 4;
      const size_t stride = ((op.desc >> 32) & 0x3fffu) << 4;
      for (int j = 0; j < op.n / 8; ++j) {
        for (int i = 0; i < 4; ++i) {
          int r, c;
          frag_c(lane, i, r, c);
          const int col = 8 * j + c;
          if (op.s8) {
            long long sum = 0;
            for (int k = 0; k < 32; ++k) {
              const int8_t v = static_cast<int8_t>(
                  b[(k / 16) * lead + (col / 8) * stride + (col % 8) * 16 +
                    k % 16]);
              sum += static_cast<long long>(op.a[r / 8][k]) * v;
            }
            int* d = static_cast<int*>(op.d) + 4 * j + i;
            *d = static_cast<int>(static_cast<uint32_t>(*d) +
                                  static_cast<uint32_t>(sum));
            continue;
          }
          float* d = static_cast<float*>(op.d) + 4 * j + i;
          double sum = *d;
          for (int k = 0; k < 16; ++k) {
            uint16_t bits;
            std::memcpy(&bits, b + (k / 8) * lead + (col / 8) * stride +
                                   (k % 8) * 16 + (col % 8) * 2, 2);
            sum += static_cast<double>(op.a[r / 8][k]) *
                   __uint_as_float(static_cast<unsigned>(bits) << 16);
          }
          *d = static_cast<float>(sum);
        }
      }
    }
    s.groups.erase(s.groups.begin());
  }
}
// Products issued or committed and never waited for, over every thread.
inline int emu_wgmma_pending() {
  int n = 0;
  for (const EmuWgmmaState& s : emu_wgmma_state) {
    n += static_cast<int>(s.groups.size() + s.open.size());
  }
  return n;
}
inline float warp_read(float v, int src) {
  const int lane = threadIdx.x & 31;
  this_warp.slots[lane] = v;
  __syncwarp();
  const float u = this_warp.slots[src];
  __syncwarp();
  return u;
}
inline float __shfl_sync(unsigned, float v, int src) {
  return warp_read(v, src);
}
inline float __shfl_up_sync(unsigned, float v, int d) {
  const int lane = threadIdx.x & 31;
  return warp_read(v, lane >= d ? lane - d : lane);
}
// 64-bit shuffles through the lanes' exchange words.
inline long long warp_read64(long long v, int src) {
  const int lane = threadIdx.x & 31;
  std::memcpy(this_warp.words + lane * kWarpWords, &v, 8);
  __syncwarp();
  long long u;
  std::memcpy(&u, this_warp.words + src * kWarpWords, 8);
  __syncwarp();
  return u;
}
inline long long __shfl_sync(unsigned, long long v, int src) {
  return warp_read64(v, src);
}
inline long long __shfl_up_sync(unsigned, long long v, int d) {
  const int lane = threadIdx.x & 31;
  return warp_read64(v, lane >= d ? lane - d : lane);
}
inline int __shfl_sync(unsigned, int v, int src) {
  return static_cast<int>(warp_read64(v, src));
}
inline int __shfl_up_sync(unsigned, int v, int d) {
  const int lane = threadIdx.x & 31;
  return static_cast<int>(warp_read64(v, lane >= d ? lane - d : lane));
}
struct longlong2 { long long x, y; };
// mbarriers and cp.async.bulk global -> shared (the pipelined plane
// resolve).  A barrier's state lives beside it, keyed by its address; a
// copy lands at once and completes its bytes on the barrier; a wait
// yields its fiber until the phase of the parity asked for has
// completed.  Arrivals and completed bytes count as progress.
struct EmuMbar { unsigned count = 0, pending = 0, phase = 0; long long tx = 0; };
std::map<const void*, EmuMbar> emu_mbars;
long long emu_bulk_copies = 0, emu_bulk_misaligned = 0;
inline void emu_mbar_done(EmuMbar& m) {
  ++emu::progress;
  if (m.pending == 0 && m.tx == 0) {
    ++m.phase;
    m.pending = m.count;
  }
}
inline void emu_mbar_init(unsigned long long* bar, unsigned count) {
  emu_mbars[bar] = EmuMbar{count, count, 0, 0};
}
inline void emu_mbar_arrive(unsigned long long* bar) {
  EmuMbar& m = emu_mbars.at(bar);
  if (m.pending == 0) std::abort();   // more arrivals than the count
  --m.pending;
  emu_mbar_done(m);
}
inline void emu_mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  emu_mbars.at(bar).tx += bytes;
  emu_mbar_arrive(bar);
}
inline void emu_mbar_wait(unsigned long long* bar, unsigned parity) {
  while ((emu_mbars.at(bar).phase & 1u) == parity) emu::yield();
}
inline void emu_bulk_copy_g2s(float* dst, const float* src, unsigned bytes,
                              unsigned long long* bar) {
  if (bytes % 16 || reinterpret_cast<uintptr_t>(dst) % 16 ||
      reinterpret_cast<uintptr_t>(src) % 16) {
    ++emu_bulk_misaligned;
  }
  ++emu_bulk_copies;
  std::memcpy(dst, src, bytes);
  EmuMbar& m = emu_mbars.at(bar);
  m.tx -= bytes;
  emu_mbar_done(m);
}
#include "sweep_device.cuh"  // includes flatblock_device.cuh
#include "texfield_device.cuh"
#include "coverage_device.cuh"
#include "resolve_device.cuh"
#include "planes_device.cuh"
#include "probes_device.cuh"
#include "place_mma_device.cuh"

// Each fragment layout covers its tile exactly once over the 32 lanes:
// 0, or the number of elements covered zero or several times.
extern "C" int emulate_fragment_cover() {
  int bad = 0;
  auto cover = [&](int rows, int cols, int per_lane,
                   void (*layout)(int, int, int&, int&)) {
    std::vector<int> seen(rows * cols, 0);
    for (int lane = 0; lane < 32; ++lane)
      for (int i = 0; i < per_lane; ++i) {
        int r, c;
        layout(lane, i, r, c);
        if (r < 0 || r >= rows || c < 0 || c >= cols) { ++bad; continue; }
        ++seen[r * cols + c];
      }
    for (int x : seen) bad += x != 1;
  };
  cover(16, 16, 8, frag_a_bf16);
  cover(16, 32, 16, frag_a_s8);
  cover(16, 8, 4, frag_c);
  return bad;
}

// One emulated block of n threads (warps of 32: a barrier and exchange
// slots each) running body() with blockIdx (x, y, z).
template <class Body>
void run_block(int n, unsigned x, unsigned y, unsigned z, Body body) {
  blockDim.x = n;
  blockIdx.x = x; blockIdx.y = y; blockIdx.z = z;
  EmuBarrier bar{n};
  const int n_warps = (n + 31) / 32;
  std::vector<EmuBarrier> bars(n_warps);
  for (int w = 0; w < n_warps; ++w) bars[w].n = std::min(32, n - 32 * w);
  std::vector<float> slots(n_warps * 32);
  std::vector<unsigned> words(n_warps * 32 * kWarpWords);
  block_barrier = &bar;
  emu::run(n, [](void* b) { (*static_cast<Body*>(b))(); }, &body,
           [&](int t) {
             threadIdx.x = t;
             this_warp = Warp{&bars[t / 32], slots.data() + (t / 32) * 32,
                              words.data() + (t / 32) * 32 * kWarpWords};
           });
}

extern "C" int emulate(int styled, const int* sidx, const int* flags,
                       const int* lays, const float* urc, const float* ucm,
                       const float* uval, const float* colors,
                       const int* rules, const int* pint, const float* pflt,
                       const float* f0, int* out, int ng, int group,
                       int frames, int layers, int ns1, int n_chunks,
                       int spp, int plane_rows, int mode, const float* bg,
                       float* out_pm, int mask_from) {
  swf::FusedArgs a{};
  a.sidx = sidx; a.flags = flags; a.lays = lays; a.urc = urc; a.ucm = ucm;
  a.uval = uval; a.colors = colors; a.rules = rules; a.pint = pint;
  a.pflt = pflt; a.fields[0] = f0; a.out = out; a.ng = ng; a.group = group;
  a.layers = layers; a.ns1 = ns1; a.n_chunks = n_chunks; a.spp = spp;
  a.plane_rows = plane_rows; a.bg = bg; a.out_pm = out_pm;
  a.mask_from = mask_from;
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
  for (int z = 0; z < frames; ++z)
    for (int y = 0; y < ns1 - 1; ++y)
      for (int x = 0; x < n_chunks * a.n_spg; ++x) {
        std::memset(smem.data(), 0xab, smem.size());  // stale contents
        run_block(swf::kThreads, x, y, z, [&] {
          if (!styled) swf::fused_block<false>(a, smem.data());
          else if (mode == 0) swf::fused_block<true>(a, smem.data());
          else if (mode == 1)
            swf::fused_block<true, true, false>(a, smem.data());
          else swf::fused_block<true, true, true>(a, smem.data());
        });
      }
  return a.spb;
}

// One emulated kThreads block per (x, y, z) of the grid running body().
template <class Body>
void run_grid(int gx, int gy, int gz, size_t smem_bytes, Body body) {
  std::vector<unsigned char> smem(smem_bytes);
  for (int z = 0; z < gz; ++z)
    for (int y = 0; y < gy; ++y)
      for (int x = 0; x < gx; ++x) {
        std::memset(smem.data(), 0xab, smem.size());  // stale contents
        run_block(swf::kThreads, x, y, z, [&] { body(smem.data()); });
      }
}

// The pre-pass of B3 and B4: blocks of kThreads pieces a (layer, frame).
template <bool kMorph, bool kAffine>
void run_fine_bounds(const swf::SweepArgs& a) {
  for (int z = 0; z < a.frames; ++z)
    for (int y = 0; y < a.layers; ++y)
      for (int x = 0; x < (a.ep + swf::kThreads - 1) / swf::kThreads; ++x) {
        std::vector<float> red(2 * swf::kThreads, -7.0f);
        run_block(swf::kThreads, x, y, z, [&] {
          swf::fine_bounds_block<kMorph, kAffine>(a, red.data());
        });
      }
}

// The column sweeps (kTileW = kLane: B3, B6, B7) and B4 (kTileW =
// kRowChunk) as csrc/sweep.cu launch_tiles shapes them -> tile rows;
// emu_tile_run > 0 sets a column block's tiles in place of tile_run's
// choice.
int emu_tile_run = 0;
extern "C" void set_tile_run(int n) { emu_tile_run = n; }
template <bool kMorph, bool kAffine, bool kStyled, int kLc, int kTileW>
int run_tiles(swf::SweepArgs a) {
  a.rows = swf::tile_rows(a.layers, kTileW);
  a.n_chunks = (a.ep + swf::kFineChunk - 1) / swf::kFineChunk;
  run_fine_bounds<kMorph, kAffine>(a);
  std::vector<unsigned char> smem(
      swf::tile_smem_bytes(a.layers, a.rows, kTileW, kStyled));
  const int bands = (a.height + a.rows - 1) / a.rows;
  const int tiles = (a.width + swf::kLane - 1) / swf::kLane;
  a.bins_per_block = kTileW == swf::kLane
      ? (emu_tile_run > 0 ? emu_tile_run
                          : swf::tile_run(a.frames, bands, tiles)) : 1;
  const int gx = kTileW == swf::kLane
      ? (tiles + a.bins_per_block - 1) / a.bins_per_block : 1;
  for (int z = 0; z < a.frames; ++z)
    for (int y = 0; y < (a.height + a.rows - 1) / a.rows; ++y)
      for (int x = 0; x < gx; ++x) {
        std::memset(smem.data(), 0xab, smem.size());  // stale contents
        run_block(swf::kThreads, x, y, z, [&] {
          swf::tile_sweep_block<kMorph, kAffine, kStyled, kLc, kTileW>(
              a, smem.data());
        });
      }
  return a.rows;
}

// The layer class as launch_tiles_lc picks it.
template <bool kMorph, bool kAffine, bool kStyled, int kTileW>
int run_tiles_lc(const swf::SweepArgs& a) {
  if constexpr (kStyled) {
    return run_tiles<kMorph, kAffine, true, swf::kMaxLayers, kTileW>(a);
  } else {
    if (swf::solid_layer_class(a.layers) != swf::kSolidSmallLayers)
      return run_tiles<kMorph, kAffine, false, swf::kMaxLayers, kTileW>(a);
    return run_tiles<kMorph, kAffine, false, swf::kSolidSmallLayers,
                     kTileW>(a);
  }
}

// B5 as csrc/sweep.cu launch_bins shapes it, in the layer class
// launch_bins_lc picks.
template <bool kStyled, int kLc>
void run_bins(swf::SweepArgs a) {
  run_grid((a.n_bins + a.bins_per_block - 1) / a.bins_per_block,
           (a.height + a.rows - 1) / a.rows, a.frames,
           swf::tile_smem_bytes(a.layers, a.rows, swf::kLane, kStyled),
           [&](unsigned char* smem) {
             swf::bin_sweep_block<kStyled, kLc>(a, smem);
           });
}

extern "C" int emulate_sweep(int mode, const float* mats, const float* tab_s,
                             const float* tab_e, const float* ratios,
                             const float* colors, const float* colors_e,
                             const int* counts, const int* rules,
                             const int* pint, const float* pflt,
                             const float* grad_mats, const float* stop_colors,
                             const float* fields, float* bounds, int* out,
                             int frames, int layers, int ep, int height,
                             int width,
                             int mats_per_layer, int colors_per_frame,
                             int n_stop_slots) {
  swf::SweepArgs a{};
  a.mats = mats; a.tab_s = tab_s; a.tab_e = tab_e; a.ratios = ratios;
  a.colors = colors; a.colors_e = colors_e; a.counts = counts;
  a.rules = rules; a.pint = pint; a.pflt = pflt; a.grad_mats = grad_mats;
  a.stop_colors = stop_colors; a.fields = fields; a.out = out;
  a.bounds = bounds;
  a.frames = frames; a.layers = layers; a.ep = ep; a.height = height;
  a.width = width; a.mats_per_layer = mats_per_layer;
  a.colors_per_frame = colors_per_frame; a.n_stop_slots = n_stop_slots;
  if (mode == 0 && pint) return run_tiles_lc<false, true, true, swf::kLane>(a);
  if (mode == 0) return run_tiles_lc<false, true, false, swf::kLane>(a);
  if (mode == 1) return run_tiles_lc<true, true, false, swf::kLane>(a);
  return run_tiles_lc<true, false, false, swf::kLane>(a);
}

extern "C" int emulate_sweep_rows(int mode, const float* mats,
                                  const float* tab_s, const float* tab_e,
                                  const float* ratios, const float* colors,
                                  const float* colors_e, const int* counts,
                                  const int* rules, const int* pint,
                                  const float* pflt, const float* grad_mats,
                                  const float* stop_colors,
                                  const float* fields, float* bounds,
                                  int* out, int frames, int layers, int ep,
                                  int height, int width, int mats_per_layer,
                                  int colors_per_frame, int n_stop_slots) {
  swf::SweepArgs a{};
  a.mats = mats; a.tab_s = tab_s; a.tab_e = tab_e; a.ratios = ratios;
  a.colors = colors; a.colors_e = colors_e; a.counts = counts;
  a.rules = rules; a.pint = pint; a.pflt = pflt; a.grad_mats = grad_mats;
  a.stop_colors = stop_colors; a.fields = fields; a.out = out;
  a.bounds = bounds;
  a.frames = frames; a.layers = layers; a.ep = ep; a.height = height;
  a.width = width; a.mats_per_layer = mats_per_layer;
  a.colors_per_frame = colors_per_frame; a.n_stop_slots = n_stop_slots;
  if (mode == 1) return run_tiles_lc<true, true, false, swf::kRowChunk>(a);
  if (pint) return run_tiles_lc<false, true, true, swf::kRowChunk>(a);
  return run_tiles_lc<false, true, false, swf::kRowChunk>(a);
}

extern "C" int emulate_sweep_compact(const float* colors, const int* rules,
                                     const int* pint, const float* pflt,
                                     const float* grad_mats,
                                     const float* stop_colors,
                                     const float* fields, const float* ctab,
                                     const int* ccount, const float* cbounds,
                                     const long long* prefix, int* out,
                                     int frames, int layers, int height,
                                     int width, int cap, int n_bins,
                                     int bin_w, int bins_per_block,
                                     int colors_per_frame,
                                     int n_stop_slots) {
  swf::SweepArgs a{};
  a.colors = colors; a.rules = rules; a.pint = pint; a.pflt = pflt;
  a.grad_mats = grad_mats; a.stop_colors = stop_colors; a.fields = fields;
  a.ctab = ctab; a.ccount = ccount; a.cbounds = cbounds; a.prefix = prefix;
  a.out = out; a.frames = frames; a.layers = layers; a.height = height;
  a.width = width; a.cap = cap; a.n_bins = n_bins; a.bin_w = bin_w;
  a.bins_per_block = bins_per_block; a.colors_per_frame = colors_per_frame;
  a.n_stop_slots = n_stop_slots;
  a.rows = swf::tile_rows(layers, swf::kLane);
  a.n_chunks = cap / swf::kFineChunk;
  if (pint) run_bins<true, swf::kMaxLayers>(a);
  else if (swf::solid_layer_class(layers) != swf::kSolidSmallLayers)
    run_bins<false, swf::kMaxLayers>(a);
  else run_bins<false, swf::kSolidSmallLayers>(a);
  return a.rows;
}

// The texfield grid: (32-column, 32-row tile) blocks, `gz` z-blocks
// walking the frames, through the instantiation the launcher picks.
template <int N, bool kSmooth, int kEdge>
void run_texfield(const swf::TexArgs& a, int gz) {
  gridDim.x = (a.width + swf::kTexTileW - 1) / swf::kTexTileW;
  gridDim.y = (a.height + swf::kTexTileRows - 1) / swf::kTexTileRows;
  gridDim.z = gz;
  for (int z = 0; z < gz; ++z)
    for (unsigned y = 0; y < gridDim.y; ++y)
      for (unsigned x = 0; x < gridDim.x; ++x)
        run_block(swf::kTexThreads, x, y, z, [&] {
          swf::texfield_block<N, kSmooth, kEdge>(a);
        });
}

template <int N, bool kSmooth>
void run_texfield_edge(const swf::TexArgs& a, int gz) {
  switch (swf::tex_edge(a.repeating, a.canvas)) {
    case swf::kTexRepeat: run_texfield<N, kSmooth, swf::kTexRepeat>(a, gz); break;
    case swf::kTexFlash: run_texfield<N, kSmooth, swf::kTexFlash>(a, gz); break;
    default: run_texfield<N, kSmooth, swf::kTexCanvas>(a, gz); break;
  }
}

template <int N>
void run_texfield_n(const swf::TexArgs& a, int gz) {
  if (a.smoothed) run_texfield_edge<N, true>(a, gz);
  else run_texfield_edge<N, false>(a, gz);
}

// generic != 0 runs the run-time-n body (N = 0) whatever n is.
extern "C" void emulate_texfield(const unsigned char* img, float* tex,
                                 const float* invs, float* out, int th,
                                 int tw, int frames, int height, int width,
                                 int n, int repeating, int smoothed,
                                 int canvas, int gz, int generic) {
  swf::TexArgs a{};
  a.img = img; a.tex = reinterpret_cast<float4*>(tex); a.invs = invs;
  a.out = reinterpret_cast<float4*>(out); a.th = th; a.tw = tw;
  a.frames = frames; a.height = height; a.width = width; a.n = n;
  a.repeating = repeating; a.smoothed = smoothed; a.canvas = canvas;
  swf::tex_offsets(a);
  for (int i = 0; i < th * tw; ++i) swf::texprep_texel(a, i);
  switch (generic ? 0 : n) {
    case 1: run_texfield_n<1>(a, gz); break;
    case 2: run_texfield_n<2>(a, gz); break;
    case 4: run_texfield_n<4>(a, gz); break;
    default: run_texfield_n<0>(a, gz); break;
  }
}

// Blocks a band of the banded kernel (gridDim.x; each walks the column
// tiles it is given); 0: one a column tile.
int emu_band_grid_x = 0;
extern "C" void set_band_grid_x(int n) { emu_band_grid_x = n; }

extern "C" void emulate_coverage(int tiled, const float* edges,
                                 const int* ranges, const float* bounds,
                                 float* out, int planes, int n_edges,
                                 int height, int width, int rule) {
  swf::CoverageArgs a{};
  a.edges = edges; a.ranges = ranges; a.bounds = bounds; a.out = out;
  a.planes = planes; a.n_edges = n_edges; a.height = height;
  a.width = width; a.tiles_y = (height + swf::kCovTileH - 1) / swf::kCovTileH;
  a.rule = rule;
  std::vector<float> smem(
      std::max(sizeof(swf::BandedTerms), sizeof(swf::TiledTerms)) /
      sizeof(float));
  const int tiles_x = (width + swf::kCovTileW - 1) / swf::kCovTileW;
  gridDim.x = tiled || emu_band_grid_x < 1
                  ? tiles_x : std::min(emu_band_grid_x, tiles_x);
  for (int z = 0; z < planes; ++z)
    for (int y = 0; y < a.tiles_y; ++y)
      for (int x = 0; x < static_cast<int>(gridDim.x); ++x) {
        std::fill(smem.begin(), smem.end(), -7.0f);   // stale contents
        run_block(swf::kCovThreads, x, y, z, [&] {
          if (tiled) {
            swf::tiled_block(a, *reinterpret_cast<swf::TiledTerms*>(
                                    smem.data()));
          } else {
            swf::banded_block(a, *reinterpret_cast<swf::BandedTerms*>(
                                     smem.data()));
          }
        });
      }
}

extern "C" void emulate_grouped(const float* edges, const float* bounds,
                                float* out, int planes, int n_edges,
                                int height, int width, int rule) {
  swf::CoverageArgs a{};
  a.edges = edges; a.bounds = bounds; a.out = out; a.planes = planes;
  a.n_edges = n_edges; a.height = height; a.width = width; a.rule = rule;
  auto terms = std::make_unique<swf::GroupedTerms>();
  for (int z = 0; z < planes; ++z)
    for (int y = 0; y < (height + swf::kCovTileH - 1) / swf::kCovTileH; ++y)
      for (int x = 0; x < (width + swf::kCovTileW - 1) / swf::kCovTileW;
           ++x) {
        std::memset(terms.get(), 0xab, sizeof(*terms));   // stale contents
        run_block(swf::kCovThreads, x, y, z,
                  [&] { swf::grouped_block(a, *terms); });
      }
}

extern "C" void emulate_fused1(const int* sidx, const int* keep,
                               const int* last, const float* urc,
                               const float* ucm, const float* uval,
                               const float* colors, const int* rules,
                               int* out, int nb, int frames, int layers,
                               int ns1, int n_chunks, int passes) {
  swf::FusedArgs a{};
  a.sidx = sidx; a.urc = urc; a.ucm = ucm; a.uval = uval;
  a.colors = colors; a.rules = rules; a.out = out; a.ng = nb; a.group = 1;
  a.layers = layers; a.ns1 = ns1; a.n_chunks = n_chunks; a.spp = 1;
  a.plane_rows = swf::kLane; a.spb = 1; a.n_spg = 1; a.passes = passes;
  const int n_sg = frames * ns1;
  std::vector<int> first(n_sg, -1), last_idx(n_sg, -1);
  for (int i = 0; i < nb; ++i)   // block_index_kernel
    swf::block_index(sidx, keep, last, i, layers, ns1, n_sg, first.data(),
                     last_idx.data());
  a.sg_first = first.data();
  a.sg_last = last_idx.data();
  std::vector<unsigned char> smem(swf::smem_bytes(layers, swf::kStripH,
                                                  false));
  // launch_one: B1's solid body at kVarOne, kLc the layer class.
  auto run = [&](auto lc) {
    for (int z = 0; z < frames; ++z)
      for (int y = 0; y < ns1 - 1; ++y)
        for (int x = 0; x < n_chunks; ++x) {
          std::memset(smem.data(), 0xab, smem.size());  // stale contents
          run_block(swf::kThreads, x, y, z, [&] {
            swf::fused_block<false, false, false, swf::kVarOne,
                             decltype(lc)::value>(a, smem.data());
          });
        }
  };
  if (swf::solid_layer_class(layers) == swf::kSolidSmallLayers)
    run(std::integral_constant<int, swf::kSolidSmallLayers>{});
  else
    run(std::integral_constant<int, swf::kMaxLayers>{});
  const size_t row = static_cast<size_t>(swf::kStripH) * n_chunks * swf::kLane;
  for (int f = 0; f < frames; ++f)   // the sentinel strip's memset
    std::memset(out + (static_cast<size_t>(f) * ns1 + ns1 - 1) * row, 0,
                row * sizeof(int));
}

extern "C" void emulate_place(const int* sidx, const int* keep,
                              const float* urc, const float* ucm,
                              const float* uval, float* out, int nb,
                              int n_groups, int ns1, int step) {
  std::vector<int> index(2 * n_groups, -1);
  swf::PlaceArgs a{};
  a.sidx = sidx; a.keep = keep; a.urc = urc; a.ucm = ucm; a.uval = uval;
  a.first = index.data(); a.last = index.data() + n_groups; a.out = out;
  a.nb = nb; a.n_groups = n_groups; a.ns1 = ns1; a.step = step;
  for (int i = 0; i < nb; ++i) swf::place_index(a, i);
  std::vector<float> plane(swf::kPlaneRows * swf::kRowStride);
  for (int g = 0; g < n_groups; ++g) {
    std::fill(plane.begin(), plane.end(), -7.0f);   // stale contents
    run_block(swf::kThreads, g, 0, 0, [&] {
      swf::place_block(a, plane.data());
    });
  }
}

// dma == 0: the grid resolve; else the pipelined one at n_buf with
// `blocks` persistent blocks.  Returns the ring depth used; stats (dma)
// = (bulk copies issued, misaligned copies).
extern "C" int emulate_resolve_u32(const float* planes, const float* colors,
                                   const int* rules, int* out, int frames,
                                   int layers, int ns1, int n_chunks,
                                   int prefixed, int dma, int n_buf,
                                   int blocks, long long* stats) {
  swf::PlanesArgs a{};
  a.planes = planes; a.colors = colors; a.rules = rules; a.out = out;
  a.frames = frames; a.layers = layers; a.ns1 = ns1; a.n_chunks = n_chunks;
  a.prefixed = dma ? 1 : prefixed;
  a.depth = dma ? swf::dma_depth(layers, n_buf) : 1;
  std::vector<unsigned char> smem(
      dma ? a.depth * swf::dma_stage_bytes(layers) +
                swf::dma_rest_bytes(layers, a.depth)
          : swf::resolve_smem_bytes(layers));
  emu_bulk_copies = emu_bulk_misaligned = 0;
  if (dma) {
    gridDim.x = blocks;
    for (int x = 0; x < blocks; ++x) {
      std::memset(smem.data(), 0xab, smem.size());  // stale contents
      run_block(swf::kDmaThreads, x, 0, 0,
                [&] { swf::resolve_dma_block(a, smem.data()); });
    }
    stats[0] = emu_bulk_copies;
    stats[1] = emu_bulk_misaligned;
    return a.depth;
  }
  gridDim.x = ns1 - 1;
  for (int y = 0; y < frames; ++y)
    for (int x = 0; x < ns1 - 1; ++x) {
      std::memset(smem.data(), 0xab, smem.size());  // stale contents
      run_block(swf::kThreads, x, y, 0,
                [&] { swf::resolve_u32_block(a, smem.data()); });
    }
  return a.depth;
}

// The variants of the solid kernel (swf_fused_variant).
template <int kVar>
void run_variant(const swf::FusedArgs& a, int frames,
                 std::vector<unsigned char>& smem) {
  for (int z = 0; z < frames; ++z)
    for (int y = 0; y < a.ns1 - 1; ++y)
      for (int x = 0; x < a.n_chunks * a.n_spg; ++x) {
        std::memset(smem.data(), 0xab, smem.size());  // stale contents
        run_block(swf::kThreads, x, y, z, [&] {
          swf::fused_block<false, false, false, kVar>(a, smem.data());
        });
      }
}

extern "C" int emulate_variant(int variant, int kk, int observe,
                               const int* sidx, const int* flags,
                               const int* lays, const float* urc,
                               const float* ucm, const float* uval,
                               const float* colors, const int* rules,
                               int* out, int ng, int group, int frames,
                               int layers, int ns1, int n_chunks, int spp) {
  swf::FusedArgs a{};
  a.sidx = sidx; a.flags = flags; a.lays = lays; a.urc = urc; a.ucm = ucm;
  a.uval = variant == swf::kVarMerged ? urc + group * swf::kBlk : uval;
  a.colors = colors; a.rules = rules; a.out = out; a.mask_from = -1;
  a.ng = ng; a.group = group; a.layers = layers; a.ns1 = ns1;
  a.n_chunks = n_chunks; a.spp = spp; a.plane_rows = 128; a.passes = 3;
  a.spb = swf::strips_per_block(layers, spp, false);
  a.n_spg = (spp + a.spb - 1) / a.spb; a.kk = kk; a.observe = observe;
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
  size_t bytes = swf::smem_bytes(layers, a.spb * swf::kStripH, false);
  if (variant == swf::kVarBatched) {
    bytes += swf::batched_stage_bytes(group, kk);
    if (bytes > swf::kSmemMax || ng % kk != 0) return -1;
  }
  std::vector<unsigned char> smem(bytes);
  switch (variant) {
    case swf::kVarFull: run_variant<swf::kVarFull>(a, frames, smem); break;
    case swf::kVarPlace: run_variant<swf::kVarPlace>(a, frames, smem); break;
    case swf::kVarResolve:
      run_variant<swf::kVarResolve>(a, frames, smem); break;
    case swf::kVarNone: run_variant<swf::kVarNone>(a, frames, smem); break;
    case swf::kVarNone0: run_variant<swf::kVarNone0>(a, frames, smem); break;
    case swf::kVarMerged:
      run_variant<swf::kVarMerged>(a, frames, smem); break;
    default: run_variant<swf::kVarBatched>(a, frames, smem); break;
  }
  return 0;
}

// The product forms (swf_fused_variant 7-9, swf_fused_int8), spp 1,
// through their one body (product_block) at the layer class.
extern "C" int emulate_product(int variant, const int* sidx, const int* flags,
                               const int* lays, const float* urc,
                               const float* ucm, const float* uval,
                               const int8_t* l0, const int8_t* l1,
                               const int8_t* l2, const float* colors,
                               const int* rules, int* out, int ng, int group,
                               int frames, int layers, int ns1,
                               int n_chunks) {
  if (group > swf::kMaxProductGroup) return -1;
  swf::FusedArgs a{};
  a.sidx = sidx; a.flags = flags; a.lays = lays; a.urc = urc; a.ucm = ucm;
  a.uval = uval; a.colors = colors; a.rules = rules; a.out = out;
  a.mask_from = -1; a.ng = ng; a.group = group; a.layers = layers;
  a.ns1 = ns1; a.n_chunks = n_chunks; a.spp = 1; a.plane_rows = 128;
  a.spb = 1; a.n_spg = 1; a.passes = 3; a.kk = 1;
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
  // Each form at its layer class, as launch_product chooses; 16-B
  // aligned, as the card's dynamic shared memory.
  const int lc = swf::solid_layer_class(layers);
  const bool small = lc == swf::kSolidSmallLayers;
  size_t bytes = 0;
  void (*body)(const swf::FusedArgs&, const int8_t*, const int8_t*,
               const int8_t*, unsigned char*) = nullptr;
  switch (variant) {
    case swf::kVarK3Three:
      bytes = small ? swf::product_smem_bytes<swf::kVarK3Three, 4>(layers)
                    : swf::product_smem_bytes<swf::kVarK3Three, 16>(layers);
      body = small ? swf::product_block<swf::kVarK3Three, 4>
                   : swf::product_block<swf::kVarK3Three, 16>;
      break;
    case swf::kVarK3Concat:
      bytes = small ? swf::product_smem_bytes<swf::kVarK3Concat, 4>(layers)
                    : swf::product_smem_bytes<swf::kVarK3Concat, 16>(layers);
      body = small ? swf::product_block<swf::kVarK3Concat, 4>
                   : swf::product_block<swf::kVarK3Concat, 16>;
      break;
    case swf::kVarLmask:
      bytes = small ? swf::product_smem_bytes<swf::kVarLmask, 4>(layers)
                    : swf::product_smem_bytes<swf::kVarLmask, 16>(layers);
      body = small ? swf::product_block<swf::kVarLmask, 4>
                   : swf::product_block<swf::kVarLmask, 16>;
      break;
    default:
      bytes = small ? swf::product_smem_bytes<swf::kVarInt8, 4>(layers)
                    : swf::product_smem_bytes<swf::kVarInt8, 16>(layers);
      body = small ? swf::product_block<swf::kVarInt8, 4>
                   : swf::product_block<swf::kVarInt8, 16>;
      break;
  }
  std::vector<float4> mem((bytes + 15) / 16);
  auto* smem = reinterpret_cast<unsigned char*>(mem.data());
  emu_smem_base = smem;
  for (int z = 0; z < frames; ++z)
    for (int y = 0; y < ns1 - 1; ++y)
      for (int x = 0; x < n_chunks; ++x) {
        std::memset(smem, 0xab, mem.size() * 16);  // stale contents
        run_block(swf::kThreads, x, y, z,
                  [&] { body(a, l0, l1, l2, smem); });
        if (emu_wgmma_pending() != 0) return -2;   // products not waited for
      }
  return 0;
}

// The batched kernel's shared memory a block, as its launcher counts it,
// and the most a block can address.
extern "C" long long emulate_batched_smem(int layers, int group, int kk) {
  return static_cast<long long>(swf::smem_bytes(layers, swf::kStripH, false)
                                + swf::batched_stage_bytes(group, kk));
}
extern "C" long long emulate_smem_max() {
  return static_cast<long long>(swf::kSmemMax);
}

// The probes: read_sum 0 the passthrough, 1 the read+sum, on a grid of
// `grid` blocks (at most one a task), each walking its chunks as on the
// card.  -1 where the launcher refuses the geometry, else 0.
extern "C" int emulate_probe(int read_sum, const float* x, float* out,
                             int n_f, int n_s, int n_l, int tile,
                             long long sf, long long ss, long long sl,
                             long long of, long long os, int grid) {
  swf::ProbeArgs a;
  const bool ok = read_sum
      ? swf::read_sum_args(a, x, out, n_f, n_s, n_l, tile, sf, ss, sl, of,
                           os)
      : swf::passthrough_args(a, x, out, n_f, n_s, n_l, tile, sf, ss, sl);
  if (!ok) return -1;
  gridDim = Dim3{};
  gridDim.x = static_cast<unsigned>(std::min<long long>(grid, a.tasks));
  for (unsigned b = 0; b < gridDim.x; ++b)
    run_block(swf::kProbeThreads, b, 0, 0, [&] {
      if (read_sum) swf::read_sum_span(a);
      else swf::passthrough_span(a);
    });
  return 0;
}

// The probes' chunks in vectors: the passthrough's, the read+sum's.
extern "C" long long emulate_probe_chunk(int read_sum) {
  return read_sum ? swf::kProbeThreads * swf::kSumVectors
                  : swf::kProbeThreads * swf::kPassUnroll;
}

extern "C" void emulate_resolve(const float* delta, const float* colors,
                                const int* rules, float* out, int frames,
                                int layers, int height, int stride) {
  swf::ResolveArgs a{};
  a.delta = delta; a.colors = colors; a.rules = rules; a.out = out;
  a.frames = frames; a.layers = layers; a.height = height;
  a.stride = stride;
  std::vector<float> carries(swf::kResWarps * layers);
  for (int y = 0; y < frames; ++y)
    for (int x = 0; x < height / swf::kStripH; ++x) {
      std::fill(carries.begin(), carries.end(), -7.0f);
      run_block(swf::kResThreads, x, y, 0, [&] {
        swf::resolve_row(a, carries.data() + (threadIdx.x / 32) * layers);
      });
    }
}
"""


def _build_emulator(d, csrc, extra=""):
    """g++ the emulator over the device headers in ``csrc`` into ``d``;
    ``extra`` is C++ appended to it (more headers and entry points, whose
    ctypes signatures the caller sets)."""
    (d / "emu.cc").write_text(EMULATOR + extra)
    lib = d / "libemu.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-ffp-contract=off",
         "-fno-strict-aliasing", "-fPIC", "-shared",
         f"-I{csrc}", "-o", str(lib), str(d / "emu.cc"),
         "-lpthread"], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    emu = ctypes.CDLL(str(lib))
    emu.emulate.restype = ctypes.c_int
    emu.emulate.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 12 + [
        ctypes.c_int] * 9 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
    emu.emulate_sweep.restype = ctypes.c_int
    emu.emulate_sweep.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 15 + [
        ctypes.c_int] * 8
    emu.emulate_sweep_rows.restype = ctypes.c_int
    emu.emulate_sweep_rows.argtypes = [ctypes.c_int] + [
        ctypes.c_void_p] * 15 + [ctypes.c_int] * 8
    emu.emulate_sweep_compact.restype = ctypes.c_int
    emu.emulate_sweep_compact.argtypes = [ctypes.c_void_p] * 12 + [
        ctypes.c_int] * 10
    emu.emulate_grouped.restype = None
    emu.emulate_grouped.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    emu.emulate_texfield.restype = None
    emu.emulate_texfield.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 11
    emu.emulate_coverage.restype = None
    emu.emulate_coverage.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 5
    emu.set_band_grid_x.restype = None
    emu.set_band_grid_x.argtypes = [ctypes.c_int]
    emu.set_tile_run.restype = None
    emu.set_tile_run.argtypes = [ctypes.c_int]
    emu.emulate_resolve.restype = None
    emu.emulate_resolve.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    emu.emulate_fused1.restype = None
    emu.emulate_fused1.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    emu.emulate_place.restype = None
    emu.emulate_place.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    emu.emulate_resolve_u32.restype = ctypes.c_int
    emu.emulate_resolve_u32.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 8 + [ctypes.c_void_p]
    emu.emulate_variant.restype = ctypes.c_int
    emu.emulate_variant.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
    emu.emulate_product.restype = ctypes.c_int
    emu.emulate_product.argtypes = [ctypes.c_int] + [
        ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
    emu.emulate_fragment_cover.restype = ctypes.c_int
    emu.emulate_fragment_cover.argtypes = []
    emu.emulate_batched_smem.restype = ctypes.c_longlong
    emu.emulate_batched_smem.argtypes = [ctypes.c_int] * 3
    emu.emulate_smem_max.restype = ctypes.c_longlong
    emu.emulate_smem_max.argtypes = []
    emu.emulate_probe_chunk.restype = ctypes.c_longlong
    emu.emulate_probe_chunk.argtypes = [ctypes.c_int]
    emu.emulate_probe.restype = ctypes.c_int
    emu.emulate_probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 4 + [ctypes.c_longlong] * 5 + [ctypes.c_int]
    return emu


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run on one intra-op thread in these modules:
    their tensors are small, and the test run's workers share the
    machine's cores, where more threads an op only wait on each other.
    Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    return _build_emulator(tmp_path_factory.mktemp("cuda_emu"),
                           cuda_lib.CSRC_DIR)


def _run(emu, dev, colors, rule, frames, layers, spp, paints=None,
         field=None, chain=False, bg=None, emit="u32", mask_from=None):
    ns1, nc = dev["ns"] + 1, dev["nc"]
    arr = {k: np.ascontiguousarray(v.numpy()) for k, v in dev.items()
           if torch.is_tensor(v)}
    out = np.full((frames, ns1, spp * 8, nc * 128), -7, np.int32)
    plane_rows = fb.plane_rows_for(nc, spp)
    # The launcher zeroes the premultiplied output's padding rows and
    # sentinel strip block; every other value the kernel must write.
    out_pm = np.full((frames, ns1, 4, plane_rows, 128), np.nan, np.float32)
    out_pm[:, ns1 - 1] = 0.0
    out_pm[:, :, :, spp * nc * 8:] = 0.0
    bg = None if bg is None else np.ascontiguousarray(bg.numpy())
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
        layers, ns1, nc, spp, plane_rows,
        int(chain) | (2 if emit == "premul" else 0), ptr(bg),
        out_pm.ctypes.data, -1 if mask_from is None else mask_from)
    if emit == "premul":
        return torch.from_numpy(out_pm), spb
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


def _chain_paints(rng, layers):
    """Colour, linear, focal and field paints in turn (one field plane)."""
    ratios = np.array([0.0, 0.45, 1.0], np.float32)
    stops = rng.uniform(0, 1, (3, 4)).astype(np.float32)
    kinds = [fb.KernelPaint.gradient(fb.KPAINT_LINEAR, (150.0, 10.0, -20.0,
                                                        140.0, -16000.0,
                                                        -9000.0),
                                     ratios, stops, spread=1),
             fb.KernelPaint.color(),
             fb.KernelPaint.field(0),
             fb.KernelPaint.gradient(fb.KPAINT_FOCAL, (300.0, 0.0, 0.0,
                                                       300.0, -15000.0,
                                                       -8000.0),
                                     ratios, stops, focal=0.4, spread=0)]
    return tuple(kinds[i % len(kinds)] for i in range(layers))


def _bg_planes(rng, frames, ns, nc, spp):
    """Random premultiplied background planes (rgb <= a), zero in the
    padding rows and the sentinel strip block, as a pass emits them."""
    rows = fb.plane_rows_for(nc, spp)
    a = rng.uniform(0, 1, (frames, ns + 1, 1, rows, 128)).astype(np.float32)
    rgb = (rng.uniform(0, 1, (frames, ns + 1, 3, rows, 128)) * a).astype(
        np.float32)
    bg = np.concatenate([rgb, a], axis=2)
    bg[:, ns] = 0.0
    bg[:, :, :, spp * nc * 8:] = 0.0
    return torch.from_numpy(bg)


# (height, width, layers, spp, chain-mode keywords of render_fused_styled)
CHAIN_CASES = [
    (24, 200, 4, 1, dict()),
    (24, 200, 4, 1, dict(bg=True)),
    (40, 300, 5, 2, dict(bg=True, emit="premul")),
    (40, 300, 5, 2, dict(emit="premul")),
    (40, 100, 9, 5, dict(bg=True, mask_from=1)),
    (40, 100, 9, 5, dict(bg=True, emit="premul", mask_from=8)),
    (64, 100, 16, 4, dict(emit="premul", mask_from=15)),
    (40, 100, 9, 5, dict(emit="premul", mask_from=3)),
]


@pytest.mark.parametrize("height,width,layers,spp,mode", CHAIN_CASES)
def test_emulated_chain_modes_equal_plain_versions(emulator, height, width,
                                                   layers, spp, mode):
    """The chain instantiations (chain=True, a bg seed, emit="premul",
    mask_from) against fused_styled_plain: words equal, planes equal
    (NaN where the kernel wrote nothing fails the comparison)."""
    tables, colors = build_scene_edges(2, layers, height, width,
                                       shapes_per_layer=3, seed=layers + 50)
    packed = bindings.pack_grouped_native(
        lower_update_lists(tables, height, width), height, width, group=6,
        spp=spp)
    dev = packed_to_device(*packed, device="cpu")
    ns, nc = dev["ns"], dev["nc"]
    rng = np.random.default_rng(layers + spp)
    paints = _chain_paints(rng, layers)
    field = fb.field_to_chunkmajor(
        torch.as_tensor(rng.uniform(0, 1, (height, width, 4))
                        .astype(np.float32)), ns, nc, spp=spp)
    rule = tuple(int(i % 3 == 1) for i in range(layers))
    kw = dict(chain=True, emit=mode.get("emit", "u32"),
              mask_from=mode.get("mask_from"),
              bg=(_bg_planes(rng, 2, ns, nc, spp) if mode.get("bg")
                  else None))
    want = fb.fused_styled_plain(
        dev["sidx"], dev["flags"], dev["lays"], dev["urc"], dev["ucm"],
        dev["uval"], torch.as_tensor(colors), (field,), 2, layers, ns, nc,
        paints, fill_rule=rule, spp=spp, **kw)
    got, _ = _run(emulator, dev, colors, rule, 2, layers, spp, paints,
                  np.ascontiguousarray(field.numpy()), **kw)
    if kw["emit"] == "premul":
        assert got.shape == want.shape
        assert torch.equal(got, want)
    else:
        assert torch.equal(got[:, :ns], want[:, :ns])


# Mutants of chain_pixel, each with a case it must fail: the dropped bg
# seed, the dropped bg term under a clip group, and the mask union folded
# the other way round (equal in exact arithmetic, not in f32).
CHAIN_MUTANTS = {
    "bg_seed": ("acc[ch] = bg_px[ch * bg_step];", "acc[ch] = 0.0f;", 1),
    "bg_under_mask": ("acc[ch] = acc[ch] + bg_px[ch * bg_step] * kp;",
                      "acc[ch] = acc[ch];", 4),
    "mask_fold": ("m = (l == mf) ? ca : ca + m * (1.0f - ca);",
                  "m = (l == mf) ? ca : m + ca * (1.0f - m);", 7),
}


@pytest.mark.parametrize("mutant", sorted(CHAIN_MUTANTS))
def test_emulated_chain_mutants_are_caught(tmp_path, mutant):
    """The chain-mode comparison sees a broken copy of the device code:
    each mutant of flatblock_device.cuh differs from the plain version
    on its case of CHAIN_CASES."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    before, after, case = CHAIN_MUTANTS[mutant]
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC_DIR, csrc)
    header = csrc / "flatblock_device.cuh"
    text = header.read_text()
    assert text.count(before) == 1
    header.write_text(text.replace(before, after))
    emu = _build_emulator(tmp_path, csrc)
    with pytest.raises(AssertionError):
        test_emulated_chain_modes_equal_plain_versions(emu,
                                                       *CHAIN_CASES[case])


def _run_sweep(emu, mats, tab_s, tab_e, ratios, colors, colors_e, height,
               width, rules, counts, paints=None, grad_mats=None,
               stop_colors=None, fields=None, rows=False):
    """The emulated sweep kernel on ``sweep_plain``'s arguments (with
    ``rows`` the row-band tiling)."""
    keep = [None if t is None else np.ascontiguousarray(t.numpy())
            for t in (mats, tab_s, tab_e, ratios, colors, colors_e,
                      grad_mats, stop_colors, fields)]
    mats_a, ts, te, rat, col, cole, gm, sc, fld = keep
    frames = (mats if mats is not None else ratios).shape[0]
    layers, ep = tab_s.shape[0], tab_s.shape[-1]
    pint = pflt = None
    if paints is not None:
        pint, pflt = fb.paint_tables(tuple(paints))
    rules_a = np.asarray(rules, np.int32)
    counts_a = np.asarray(counts, np.int32)
    out = np.full((frames, height, width), -7, np.int32)
    mode = 0 if tab_e is None else (1 if mats is not None else 2)
    # The pre-pass's scratch as ops.transform sizes it: row bounds of
    # 16-piece chunks (csrc kFineChunk).
    scratch = np.full((frames, layers, -(-ep // sweep.FINE_CHUNK), 2),
                      np.nan, np.float32)

    def ptr(x):
        return None if x is None else x.ctypes.data

    args = (
        mode, ptr(mats_a), ptr(ts), ptr(te), ptr(rat), ptr(col), ptr(cole),
        ptr(counts_a), ptr(rules_a), ptr(pint), ptr(pflt), ptr(gm), ptr(sc),
        ptr(fld), scratch.ctypes.data, out.ctypes.data, frames, layers, ep,
        height, width,
        int(mats is not None and mats.ndim == 3), int(colors.ndim == 3),
        0 if sc is None else sc.shape[2])
    n_rows = (emu.emulate_sweep_rows if rows else emu.emulate_sweep)(*args)
    assert not np.isnan(scratch).any()   # every chunk written
    return torch.from_numpy(out), n_rows


def test_emulated_morph_affine_sweep_equals_plain_version(emulator):
    """Solid morph + affine sweep, 5 layers (tile rows 16), 50x150 (two
    column tiles, ragged on both axes), mixed rules, ratios 0 and 1."""
    rng = np.random.default_rng(21)
    height, width, layers, frames = 50, 150, 5, 3
    start = random_blobs(rng, layers, height, width, blobs=3)
    pairs = [(s, s + rng.uniform(-9, 9, s.shape).astype(np.float32),
              rng.uniform(0.1, 1, 4), rng.uniform(0.1, 1, 4)) for s in start]
    mats = random_tracks(rng, frames, layers, height, width)
    tab_s, tab_e, cs, ce = sweep.morph_affine_pieces(pairs, mats)
    counts = tuple(min(max(a, b), tab_s.shape[-1]) for a, b in zip(
        sweep.layer_piece_counts(tab_s), sweep.layer_piece_counts(tab_e)))
    args = (torch.as_tensor(mats), torch.as_tensor(tab_s),
            torch.as_tensor(tab_e),
            torch.as_tensor(np.array([0.0, 0.37, 1.0], np.float32)),
            torch.as_tensor(cs), torch.as_tensor(ce), height, width,
            (0, 1, 0, 1, 1), counts)
    want = sweep.sweep_plain(*args)
    got, rows = _run_sweep(emulator, *args)
    assert rows == 16
    assert torch.equal(got, want)
    # The ratio sweep: same pieces, no matrices.
    args = (None,) + args[1:]
    got, _ = _run_sweep(emulator, *args)
    assert torch.equal(got, sweep.sweep_plain(*args))


def test_emulated_styled_affine_sweep_equals_plain_version(emulator):
    """Styled affine sweep, 4 layers (colour, linear with fading stops,
    focal, field), 37x200, global matrices, per-frame colours."""
    rng = np.random.default_rng(22)
    height, width, layers, frames = 37, 200, 4, 2
    tables = random_blobs(rng, layers, height, width, blobs=3)
    mats = random_tracks(rng, frames, 1, height, width)[:, 0]
    tab, _ = sweep.affine_pieces(tables, [(0,) * 4] * layers, mats)
    ratios = np.array([0.0, 0.4, 1.0], np.float32)
    stops = rng.uniform(0, 1, (3, 4)).astype(np.float32)
    paints = (fb.KernelPaint.color(),
              fb.KernelPaint.gradient(fb.KPAINT_LINEAR, (), ratios, stops,
                                      spread=1),
              fb.KernelPaint.gradient(fb.KPAINT_FOCAL, (), ratios[:2],
                                      stops[:2], focal=0.4, spread=2),
              fb.KernelPaint.field(0))
    gm = np.zeros((frames, layers, 6), np.float32)
    gm[:, 1] = (150.0, 10.0, -20.0, 140.0, -16000.0, -9000.0)
    gm[:, 2] = (300.0, 0.0, 0.0, 300.0, -15000.0, -8000.0)
    gm[1] *= 1.1
    sc = rng.uniform(0, 1, (frames, layers, 3, 4)).astype(np.float32)
    fields = rng.uniform(0, 1, (1, frames, height, width, 4)).astype(
        np.float32)
    colors = rng.uniform(0.1, 1, (frames, layers, 4)).astype(np.float32)
    args = (torch.as_tensor(mats), torch.as_tensor(tab), None, None,
            torch.as_tensor(colors), None, height, width, (0, 0, 1, 0),
            sweep.layer_piece_counts(tab))
    kw = dict(paints=paints, grad_mats=torch.as_tensor(gm),
              stop_colors=torch.as_tensor(sc),
              fields=torch.as_tensor(fields))
    want = sweep.sweep_plain(*args, **kw)
    got, rows = _run_sweep(emulator, *args, **kw)
    assert rows == 16
    assert torch.equal(got, want)
    kw["stop_colors"] = None   # static stops from the paint records
    got, _ = _run_sweep(emulator, *args, **kw)
    assert torch.equal(got, sweep.sweep_plain(*args, **kw))


def test_emulated_sweep_writes_untouched_tiles_as_zeros(emulator):
    """One small blob in a 70x300 frame (most tiles see no piece and take
    the kernel's zero-fill path; frame 0 lies wholly outside)."""
    rng = np.random.default_rng(23)
    height, width = 70, 300
    tables = random_blobs(rng, 1, 40, 40, blobs=1)
    mats = np.asarray([(1.0, 0.0, 0.0, 1.0, -400.0, -300.0),
                       (1.0, 0.1, -0.1, 1.0, 150.0, 20.0),
                       (0.8, 0.0, 0.0, 0.8, 250.0, 35.0)], np.float32)
    tab, colors = sweep.affine_pieces(tables, [(0.9, 0.5, 0.2, 0.7)], mats)
    args = (torch.as_tensor(mats), torch.as_tensor(tab), None, None,
            torch.as_tensor(colors), None, height, width, (1,),
            sweep.layer_piece_counts(tab))
    want = sweep.sweep_plain(*args)
    got, rows = _run_sweep(emulator, *args)
    assert rows == 32
    assert torch.equal(got, want)
    assert not want[0].any() and want[1].any()
    assert float((want != 0).float().mean()) < 0.1


def _styled_sweep_case(rng, frames, layers, height, width):
    """Colour, linear (fading stops), focal and field layers with their
    gradient matrices, stops and field planes."""
    ratios = np.array([0.0, 0.4, 1.0], np.float32)
    stops = rng.uniform(0, 1, (3, 4)).astype(np.float32)
    paints = (fb.KernelPaint.color(),
              fb.KernelPaint.gradient(fb.KPAINT_LINEAR, (), ratios, stops,
                                      spread=1),
              fb.KernelPaint.gradient(fb.KPAINT_FOCAL, (), ratios[:2],
                                      stops[:2], focal=0.4, spread=2),
              fb.KernelPaint.field(0))[:layers]
    gm = np.zeros((frames, layers, 6), np.float32)
    gm[:, 1] = (150.0, 10.0, -20.0, 140.0, -16000.0, -9000.0)
    gm[:, 2] = (300.0, 0.0, 0.0, 300.0, -15000.0, -8000.0)
    gm[1] *= 1.1
    sc = rng.uniform(0, 1, (frames, layers, 3, 4)).astype(np.float32)
    fields = rng.uniform(0, 1, (1, frames, height, width, 4)).astype(
        np.float32)
    return dict(paints=paints, grad_mats=torch.as_tensor(gm),
                stop_colors=torch.as_tensor(sc),
                fields=torch.as_tensor(fields) if layers > 3 else None)


@pytest.mark.parametrize("form,width", [
    ("affine", 300), ("styled", 520), ("morph-affine", 300)])
def test_emulated_row_band_sweep_equals_plain_version(emulator, form,
                                                      width):
    """The row-band tiling (B4) on 3 frames 50 rows high (bands of 8 rows
    at 5 layers, 16 at 3; 256-column chunks, two or three of them, the
    last one ragged, and a ragged last band), blobs overhanging every
    side, mixed rules: byte-equal to sweep_plain, the function of every
    tiling."""
    rng = np.random.default_rng(31 + width)
    height, frames = 50, 3
    layers = 3 if form == "styled" else 5
    tables = random_blobs(rng, layers, height, width, blobs=3)
    mats = random_tracks(rng, frames, layers, height, width)
    rules = tuple(int(x) for x in rng.integers(0, 2, layers))
    kw = {}
    if form == "morph-affine":
        pairs = [(t_, t_ + rng.uniform(-9, 9, t_.shape).astype(np.float32),
                  rng.uniform(0.1, 1, 4), rng.uniform(0.1, 1, 4))
                 for t_ in tables]
        tab_s, tab_e, cs, ce = sweep.morph_affine_pieces(pairs, mats)
        args = (torch.as_tensor(mats), torch.as_tensor(tab_s),
                torch.as_tensor(tab_e),
                torch.as_tensor(np.array([0.0, 0.37, 1.0], np.float32)),
                torch.as_tensor(cs), torch.as_tensor(ce))
    else:
        tab_s, _ = sweep.affine_pieces(tables, [(0,) * 4] * layers, mats)
        colors = rng.uniform(0.1, 1, (frames, layers, 4)).astype(np.float32)
        args = (torch.as_tensor(mats[:, 0] if form == "affine" else mats),
                torch.as_tensor(tab_s), None, None, torch.as_tensor(colors),
                None)
        if form == "styled":
            kw = _styled_sweep_case(rng, frames, layers, height, width)
    args += (height, width, rules, sweep.layer_piece_counts(tab_s))
    want = sweep.sweep_plain(*args, **kw)
    got, rows = _run_sweep(emulator, *args, rows=True, **kw)
    assert rows == swf_rows(layers, 256)
    assert torch.equal(got, want)
    assert float((want != 0).float().mean()) > 0.01   # the scene is there


def swf_rows(layers, tile_w):
    """csrc tile_rows: the most rows (a power of two <= 32) whose planes
    of tile_w long longs fit 100 KB."""
    rows = 32
    while rows > 1 and layers * rows * tile_w * 8 > 100 * 1024:
        rows //= 2
    return rows


def _gentle_tracks(rng, frames, layers, height, width):
    """(F, L, 6) turns of at most 0.15 rad and scales 0.8-1.2 about the
    frame centre, shifted a few pixels: a wide, short frame keeps its
    blobs."""
    th = rng.uniform(-0.15, 0.15, (frames, layers))
    sc = rng.uniform(0.8, 1.2, (frames, layers))
    a, b = sc * np.cos(th), sc * np.sin(th)
    cx, cy = width / 2.0, height / 2.0
    e = cx - a * cx + b * cy + rng.uniform(-6, 6, (frames, layers))
    f = cy - b * cx - a * cy + rng.uniform(-6, 6, (frames, layers))
    return np.stack([a, b, -b, a, e, f], -1).astype(np.float32)


def _run_compact(emu, tables, colors, height, width, rules, bps, paints=None,
                 grad_mats=None, stop_colors=None, fields=None):
    """The emulated compacted kernel on ``compact_pre``'s tables."""
    arr = [None if x is None else np.ascontiguousarray(x.numpy())
           for x in (colors, grad_mats, stop_colors, fields, tables.tab,
                     tables.counts, tables.bounds, tables.prefix)]
    col, gm, sc, fld, ctab, cnt, bnd, pre = arr
    pint = pflt = None
    if paints is not None:
        pint, pflt = fb.paint_tables(tuple(paints))
    rules_a = np.asarray(rules, np.int32)
    frames, nb, layers = tables.counts.shape
    out = np.full((frames, height, width), -7, np.int32)

    def ptr(x):
        return None if x is None else x.ctypes.data

    rows = emu.emulate_sweep_compact(
        ptr(col), ptr(rules_a), ptr(pint), ptr(pflt), ptr(gm), ptr(sc),
        ptr(fld), ptr(ctab), ptr(cnt), ptr(bnd), ptr(pre), out.ctypes.data,
        frames, layers, height, width, tables.cap, nb, tables.bin_w, bps,
        int(colors.ndim == 3), 0 if sc is None else sc.shape[2])
    return torch.from_numpy(out), rows


def _rect_pieces(height, width):
    """One layer: a rectangle spanning most of the frame's width (its
    top and bottom flat), so that the bins between its sides hold no
    crossing piece and rows where its left side is carry its dy."""
    x0, x1, y0, y1 = 12.0, width - 10.0, 5.0, height - 5.0
    return [np.asarray([(x0, y0, x1, y0), (x1, y0, x1, y1),
                        (x1, y1, x0, y1), (x0, y1, x0, y0)], np.float32)]


# The compacted tiling's cases: name -> (form, bin width, bins a block).
COMPACT_CASES = {
    "solid-64": ("solid", 64, 1),
    "styled-128": ("styled", 128, 2),
    "per-layer-88": ("per-layer", 88, 3),
    "solid-256": ("solid", 256, 1),
    "styled-256": ("styled", 256, 2),
    "solid-30": ("solid", 30, 4),
    "16-layers-128": ("16-layers", 128, 2),
    "prefix-only-64": ("prefix-only", 64, 2),
    "edge-pieces-128": ("edge-pieces", 128, 2),
}


def _compact_case(name):
    """(mats, tab, compact_pre's tables, colours, height, width, rules,
    bins a block, paint kwargs) of COMPACT_CASES[name] on 2 frames of
    40x420."""
    form, wblock, bps = COMPACT_CASES[name]
    rng = np.random.default_rng(41 + wblock + len(name))
    height, width, frames = 40, 420, 2
    layers = {"styled": 4, "16-layers": 16, "prefix-only": 2,
              "edge-pieces": 2}.get(form, 3)
    if form == "edge-pieces":
        from tests.test_torch_kernel_emulated_sweep import edge_pieces
        tab, _ = edge_pieces(height, width)
        mats = np.asarray([(1, 0, 0, 1, 0, 0), (1, 0, 0, 1, -3.25, 0.5)],
                          np.float32)
    else:
        tables = random_blobs(rng, layers, height, width, blobs=4)
        tracks = _gentle_tracks(rng, frames, layers, height, width)
        if form == "prefix-only":
            tables = _rect_pieces(height, width) + tables[1:]
            tracks[:, :, :4] = (1.0, 0.0, 0.0, 1.0)
            tracks[1, :, 4:] += (3.5, 1.25)
        mats = tracks if form == "per-layer" else tracks[:, 0]
        tab, _ = sweep.affine_pieces(tables, [(0,) * 4] * layers, mats)
    plan = sweep.plan_compact_sweep(mats, tab, height, width, wblock=wblock,
                                    blocks_per_step=bps)
    assert plan is not None and plan["wblock"] == wblock
    colors = torch.as_tensor(rng.uniform(0.1, 1, (frames, layers, 4))
                             .astype(np.float32))
    kw = (_styled_sweep_case(rng, frames, layers, height, width)
          if form == "styled" else {})
    rules = tuple(int(x) for x in rng.integers(0, 2, layers))
    ctabs = sweep.compact_pre(torch.as_tensor(mats), torch.as_tensor(tab),
                              plan["compact_counts"], wblock, height, width)
    assert (ctabs.crossing <= torch.as_tensor(plan["compact_counts"],
                                              dtype=torch.int32)).all()
    return mats, tab, ctabs, colors, height, width, rules, bps, kw


@pytest.mark.parametrize("name", sorted(COMPACT_CASES))
def test_emulated_compact_sweep_equals_plain_versions(emulator, name):
    """The compacted tiling (B5) on bin_sweep_block, B3's tiled steps:
    compact_pre's tables of 2 frames of 40x420 (bins of 30, 64, 88, 128
    and 256 columns, the last one ragged, 256-column bins in two
    128-column tiles, 30-column bins starting off a 16-byte boundary;
    1-4 bins a block; 2, 3, 4 and 16 layers; styled
    colour, linear, focal and field layers; bins with no crossing piece
    under a nonzero prefix; the edge-case table of the column kernel's
    tests): byte-equal to sweep_compact_plain and to sweep_plain (the
    column tiling's function)."""
    mats, tab, ctabs, colors, height, width, rules, bps, kw = \
        _compact_case(name)
    layers = tab.shape[0]
    want = sweep.sweep_compact_plain(ctabs, colors, height, width, rules,
                                     **kw)
    got, rows = _run_compact(emulator, ctabs, colors, height, width, rules,
                             bps, **kw)
    assert rows == swf_rows(layers, 128)   # 128-column tiles
    assert torch.equal(got, want)
    assert torch.equal(want, sweep.sweep_plain(
        torch.as_tensor(mats), torch.as_tensor(tab), None, None, colors,
        None, height, width, rules, (tab.shape[-1],) * layers, **kw))
    assert float((want != 0).float().mean()) > 0.01   # the scene is there
    if name.startswith("prefix-only"):
        empty = ctabs.counts.sum(-1) == 0                        # (F, NB)
        seeded = ctabs.prefix.abs().sum(dim=(1, 3)) != 0         # (F, NB)
        assert bool((empty & seeded).any())


@pytest.mark.parametrize("shape,repeating,smoothed,edge_mode,n", [
    ((11, 13), True, True, "flash", 2),
    ((11, 13), False, True, "canvas", 3),
    ((11, 13), False, False, "flash", 1),
    ((70, 90), True, False, "flash", 2),
    ((70, 90), False, True, "canvas", 1),
])
def test_emulated_texfield_equals_plain_version(emulator, shape, repeating,
                                                smoothed, edge_mode, n):
    """The texfield kernel: rotated, skewed and far-zoomed inverses over a
    37x45 frame (ragged 32x8 tiles), one far beyond 2^24 texels (the
    float remainder of the repeat wrap), 4 frames walked by 3 z-blocks of
    the grid; the pre-pass's premultiplied texels."""
    rng = np.random.default_rng(sum(shape) + n)
    img = rng.integers(0, 256, (*shape, 4)).astype(np.uint8)
    img[0, :3, 3] = 0   # transparent texels: the un-premultiply guard
    invs = np.asarray([(0.31, 0.12, -0.2, 0.27, -3.5, 2.25),
                       (1.7, -0.9, 0.4, 2.2, -40.0, 31.0),
                       (0.013, 0.0, 0.002, 0.011, 5.5, 4.0),
                       (3.0, 0.4, -0.6, 2.5, -3.3e7, 2.9e7)], np.float32)
    height, width = 37, 45
    tex = np.empty((*shape, 4), np.float32)
    out = np.full((4, height, width, 4), np.nan, np.float32)
    emulator.emulate_texfield(
        img.ctypes.data, tex.ctypes.data, invs.ctypes.data, out.ctypes.data,
        shape[0], shape[1], 4, height, width, n, int(repeating),
        int(smoothed), int(edge_mode == "canvas"), 3, 0)
    want = texfield.texfield_plain(torch.as_tensor(img),
                                   torch.as_tensor(invs), height, width, n,
                                   repeating, smoothed, edge_mode)
    assert torch.equal(torch.as_tensor(tex),
                       texfield.premultiplied_texels(torch.as_tensor(img)))
    assert torch.equal(torch.as_tensor(out), want)
    assert float(want[..., 3].std()) > 0.05


def _random_edges(rng, planes, n, e_pad, height, width):
    """(planes, 4, e_pad) edges: random segments, some off the frame, some
    horizontal, some with spans under 1e-9, a few long unsplit ones; the
    rest padding."""
    t = np.zeros((planes, 4, e_pad), np.float32)
    for p in range(planes):
        e = np.stack([rng.uniform(-20, width + 20, n),
                      rng.uniform(-10, height + 10, n),
                      rng.uniform(-20, width + 20, n),
                      np.zeros(n)], 1).astype(np.float32)
        e[:, 3] = e[:, 1] + rng.uniform(-12, 12, n)
        e[::5, 3] = e[::5, 1]                 # horizontal
        e[1::7, 2] = e[1::7, 0]               # vertical: span 0
        e[2::9, 3] = e[2::9, 1] + 2e-10       # |dy| under 1e-9
        e[3::11, 1], e[3::11, 3] = -30.0, height + 30.0   # long
        t[p, :, :n] = e.T
    return t


@pytest.mark.parametrize("tiled,n,e_pad,rule", [
    (False, 3, 128, 0), (False, 150, 256, 1), (True, 3, 128, 1),
    (True, 300, 384, 0)])
def test_emulated_coverage_equals_plain_version(emulator, tiled, n, e_pad,
                                                rule):
    """Both direct coverage kernels on 2 planes of 37x150 (ragged tiles on
    both axes) against banded_plain / tiled_plain."""
    rng = np.random.default_rng(n + e_pad)
    height, width = 37, 150
    t = torch.as_tensor(_random_edges(rng, 2, n, e_pad, height, width))
    edges_sorted, key, pad = cov.sort_edges(t)
    if tiled:
        table = cov.block_bounds(edges_sorted, key, pad)
        want = cov.tiled_plain(edges_sorted, table, height, width, rule)
    else:
        table = cov.band_ranges(t, key, height)
        want = cov.banded_plain(edges_sorted, table, height, width, rule)
    es = np.ascontiguousarray(edges_sorted.numpy())
    tab = np.ascontiguousarray(table.numpy())
    out = np.full((2, height, width), np.nan, np.float32)
    emulator.emulate_coverage(
        int(tiled), es.ctypes.data, None if tiled else tab.ctypes.data,
        tab.ctypes.data if tiled else None, out.ctypes.data, 2, e_pad,
        height, width, rule)
    assert torch.equal(torch.as_tensor(out), want)
    assert float(want.std()) > 0.05   # not a flat plane


@pytest.mark.parametrize("n,e_pad,rule", [(150, 256, 0), (300, 384, 1)])
def test_emulated_grouped_coverage_equals_plain_version(emulator, n, e_pad,
                                                        rule):
    """The grouped coverage kernel (B11) on 2 planes of 37x150 (ragged
    strips and tiles) against grouped_plain."""
    rng = np.random.default_rng(3 * n + e_pad)
    height, width = 37, 150
    t = torch.as_tensor(_random_edges(rng, 2, n, e_pad, height, width))
    edges_sorted, key, pad = cov.sort_edges(t)
    table = cov.block_bounds(edges_sorted, key, pad)
    want = cov.grouped_plain(edges_sorted, table, height, width, rule)
    es = np.ascontiguousarray(edges_sorted.numpy())
    tab = np.ascontiguousarray(table.numpy())
    out = np.full((2, height, width), np.nan, np.float32)
    emulator.emulate_grouped(es.ctypes.data, tab.ctypes.data,
                             out.ctypes.data, 2, e_pad, height, width, rule)
    assert torch.equal(torch.as_tensor(out), want)
    assert float(want.std()) > 0.05


def test_emulated_resolve_equals_plain_version(emulator):
    """The resolve kernel: 2 frames x 3 layers x 16 rows x 384 columns
    (3 chunks: the carry), mixed rules, alpha 0..1."""
    rng = np.random.default_rng(41)
    f, l, h, s = 2, 3, 16, 384
    delta = rng.normal(0, 0.4, (f, l, h, s)).astype(np.float32)
    delta[rng.uniform(size=delta.shape) < 0.6] = 0.0
    colors = rng.uniform(0, 1, (f, l, 4)).astype(np.float32)
    colors[0, 0, 3], colors[1, 2, 3] = 0.0, 1.0
    rules = (0, 1, 0)
    want = res.resolve_plain(torch.as_tensor(delta), torch.as_tensor(colors),
                             rules)
    out = np.full((f, 4, h, s), np.nan, np.float32)
    rule_a = np.asarray(rules, np.int32)
    emulator.emulate_resolve(delta.ctypes.data, colors.ctypes.data,
                             rule_a.ctypes.data, out.ctypes.data, f, l, h, s)
    assert torch.equal(torch.as_tensor(out), want)


def _flat_blocks(frames, layers, height, width, seed, empty_layer=None):
    """pack_blocks_native arrays of a random scene (layer ``empty_layer``
    without updates: its groups are single zero blocks) and colours."""
    tables, colors = build_scene_edges(frames, layers, height, width,
                                       shapes_per_layer=3, seed=seed)
    ul = lower_update_lists(tables, height, width)
    if empty_layer is not None:
        for per in ul:
            per[empty_layer] = tuple(x[:0] for x in per[empty_layer])
    packed = bindings.pack_blocks_native(ul, height, width,
                                         block_pad_multiple=8)
    return packed, colors


def _c(x):
    return np.ascontiguousarray(x.numpy() if torch.is_tensor(x) else x)


@pytest.mark.parametrize("step", [False, True])
def test_emulated_place_equals_plain_version(emulator, step):
    """B14: 2 frames x 3 layers x 24x300 (3 chunks; one layer empty),
    every plane including the sentinel strips."""
    (sidx, keep, urc, ucm, uval, ns, nc), _ = _flat_blocks(
        2, 3, 24, 300, seed=51, empty_layer=1)
    want = fb.place_plain(*map(torch.as_tensor, (sidx, keep, urc, ucm,
                                                 uval)), 2, 3, ns, step=step)
    out = np.full(want.shape, np.nan, np.float32)
    emulator.emulate_place(sidx.ctypes.data, keep.ctypes.data,
                           urc.ctypes.data, ucm.ctypes.data,
                           uval.ctypes.data, out.ctypes.data, len(sidx),
                           2 * 3 * (ns + 1), ns + 1, int(step))
    assert torch.equal(torch.as_tensor(out), want)
    assert float(want.abs().max()) > 0.5


@pytest.mark.parametrize("layers,n_chunks,rule", [
    (3, 3, (0, 1, 1)), (16, 2, 1), (2, 16, 0)])
def test_emulated_plane_resolves_equal_plain_version(emulator, layers,
                                                     n_chunks, rule):
    """B15 (raw and prefixed planes) and B16 (ring depths 1 to 3, and the
    shallower ring of 16 layers at n_buf 4) on random planes of 2 frames
    x 2 strips (deltas in every chunk: every carry step matters)."""
    frames, ns = 2, 2
    rng = np.random.default_rng(layers * 100 + n_chunks)
    raw = rng.normal(0, 0.4, (frames, layers, ns + 1, 128, 128)).astype(
        np.float32)
    raw[rng.uniform(size=raw.shape) < 0.6] = 0.0
    colors = rng.uniform(0, 1, (frames, layers, 4)).astype(np.float32)
    colors[0, 0, 3], colors[1, -1, 3] = 0.0, 1.0
    rules = np.asarray(fb.layer_rules(rule, layers), np.int32)
    cols = torch.as_tensor(colors)

    def emulate(planes, prefixed, dma=0, n_buf=0, blocks=1):
        out = np.full((frames, ns * 8, n_chunks * 128), -7, np.int32)
        stats = np.zeros(2, np.int64)
        depth = emulator.emulate_resolve_u32(
            _c(planes).ctypes.data, colors.ctypes.data, rules.ctypes.data,
            out.ctypes.data, frames, layers, ns + 1, n_chunks, int(prefixed),
            dma, n_buf, blocks, stats.ctypes.data)
        return torch.from_numpy(out), depth

    for prefixed in (False, True):
        planes = torch.as_tensor(raw)
        if prefixed:
            planes = torch.cumsum(planes, -1)
        want = fb.resolve_u32_plain(planes, cols, n_chunks, rule, prefixed)
        got, _ = emulate(planes, prefixed)
        assert torch.equal(got, want)
    assert len(torch.unique(want)) > 100
    for n_buf, blocks in ((1, 1), (2, 3), (3, 1), (4, 3)):
        got, depth = emulate(planes, True, 1, n_buf, blocks)
        assert depth == (3 if (n_buf, layers) == (4, 16) else n_buf)
        assert torch.equal(got, want)


def dma_depth(layers, n_buf):
    """csrc dma_depth: n_buf (at most 8) slots of L x (4 KB + 16 B), or
    as many as fit 227 KB beside the rules, the eight consumer warps'
    carry ladders (L x 16 floats each) and two mbarriers a slot."""
    depth = min(n_buf, 8)
    while depth > 0 and depth * layers * 4112 + -(-layers * 4 // 16) * 16 \
            + 8 * layers * 64 + 16 * depth > 227 * 1024:
        depth -= 1
    return depth


def _dma_case(emu, layers, n_buf, blocks=(4, 5)):
    """The pipelined resolve (B16) on random prefixed planes of 2 frames x
    3 strips (6 items: 4 and 5 blocks deal them unevenly, runs crossing
    frames), chunks of every strip carrying: -> (words of each block
    count, resolve_u32_plain's words, ring depth, bulk copies issued)."""
    frames, ns = 2, 3
    n_chunks = {1: 5, 4: 3, 16: 2}[layers]
    rng = np.random.default_rng(layers * 10 + n_buf)
    raw = rng.normal(0, 0.4, (frames, layers, ns + 1, 128, 128)).astype(
        np.float32)
    raw[rng.uniform(size=raw.shape) < 0.6] = 0.0
    planes = np.cumsum(raw, -1, dtype=np.float32)
    colors = rng.uniform(0, 1, (frames, layers, 4)).astype(np.float32)
    colors[0, 0, 3], colors[1, -1, 3] = 0.0, 1.0
    rule = tuple(int(x) for x in rng.integers(0, 2, layers))
    rules = np.asarray(fb.layer_rules(rule, layers), np.int32)
    want = fb.resolve_u32_plain(torch.as_tensor(planes),
                                torch.as_tensor(colors), n_chunks, rule)
    outs, depth, copies = [], None, []
    for g in blocks:
        out = np.full((frames, ns * 8, n_chunks * 128), -7, np.int32)
        stats = np.zeros(2, np.int64)
        depth = emu.emulate_resolve_u32(
            planes.ctypes.data, colors.ctypes.data, rules.ctypes.data,
            out.ctypes.data, frames, layers, ns + 1, n_chunks, 1, 1, n_buf,
            g, stats.ctypes.data)
        assert stats[1] == 0                       # no misaligned copy
        outs.append(torch.from_numpy(out))
        copies.append(int(stats[0]))
    return outs, want, depth, copies, frames * ns * n_chunks


@pytest.mark.parametrize("n_buf", [1, 2, 3, 8])
@pytest.mark.parametrize("layers", [1, 4, 16])
def test_emulated_pipelined_resolve_equals_plain_version(emulator, layers,
                                                         n_buf):
    """B16 on the bulk-copy ring: each slot filled by L + 1 bulk copies
    that complete on its full mbarrier, consumer warps releasing it on
    its empty one; n_buf 1, 2, 3 and 8 (8 at 16 layers: the ring goes
    shallower to 3); the (frame, strip) items dealt to 4 and 5 blocks:
    word for word resolve_u32_plain."""
    outs, want, depth, copies, stages = _dma_case(emulator, layers, n_buf)
    assert depth == dma_depth(layers, n_buf)
    assert depth == (3 if (layers, n_buf) == (16, 8) else n_buf)
    for got, n in zip(outs, copies):
        assert n == stages * (layers + 1)          # every stage copied once
        assert torch.equal(got, want)
    assert len(torch.unique(want)) > 100


# Mutants of B5 and B16, built together into one scratch copy behind a
# run-time switch (swf_mutant): name -> (flag, header, anchor,
# replacement, the test and case it must fail).
KERNEL_MUTANTS = {
    "b5_prefix_seed_dropped": (
        21, "sweep_device.cuh",
        "        seed = a.prefix[",
        "        seed = swf_mutant == 21 ? 0 : a.prefix[",
        ("compact", "prefix-only-64")),
    "b5_planes_not_rezeroed": (
        22, "sweep_device.cuh",
        "      dirty = *s.touched != 0;\n",
        "      dirty = swf_mutant != 22 && *s.touched != 0;\n",
        ("compact", "solid-64")),
    "b16_ladder_not_reset": (
        11, "planes_device.cuh",
        "      if (j == 0) {\n",
        "      if (j == 0 && swf_mutant != 11) {\n",
        ("dma", (4, 3))),
    "b16_strip_dealt_twice_another_never": (
        12, "planes_device.cuh",
        "  const long long i0 = n_items * blockIdx.x / gridDim.x;\n"
        "  const long long i1 = n_items * (blockIdx.x + 1) / gridDim.x;\n",
        "  const long long shift_ = swf_mutant == 12 && blockIdx.x == 1;\n"
        "  const long long i0 = n_items * blockIdx.x / gridDim.x - shift_;\n"
        "  const long long i1 = n_items * (blockIdx.x + 1) / gridDim.x -"
        " shift_;\n",
        ("dma", (1, 2))),
}


@pytest.fixture(scope="module")
def mutant_emulator(tmp_path_factory):
    """The emulator over a copy of csrc holding every KERNEL_MUTANTS edit
    behind swf_mutant (0: the committed kernels)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("cuda_emu_kernel_mutants")
    csrc = d / "csrc"
    shutil.copytree(cuda_lib.CSRC_DIR, csrc)
    for name, (_, header, before, after, _) in KERNEL_MUTANTS.items():
        path = csrc / header
        text = path.read_text()
        assert text.count(before) == 1, name
        path.write_text(text.replace(before, after))
    for header in {m[1] for m in KERNEL_MUTANTS.values()}:
        path = csrc / header
        path.write_text(path.read_text().replace(
            "#pragma once\n", "#pragma once\nextern int swf_mutant;\n", 1))
    emu = _build_emulator(d, csrc, """
int swf_mutant = 0;
extern "C" void set_mutant(int m) { swf_mutant = m; }
""")
    emu.set_mutant.restype = None
    emu.set_mutant.argtypes = [ctypes.c_int]
    return emu


@pytest.mark.parametrize("mutant", sorted(KERNEL_MUTANTS))
def test_emulated_kernel_mutants_are_caught(mutant_emulator, mutant):
    """Each mutant of B5's bin body or B16's ring fails the case named
    for it, which the unmutated build of the same copy passes."""
    flag, _, _, _, (kind, case) = KERNEL_MUTANTS[mutant]

    def run():
        if kind == "compact":
            test_emulated_compact_sweep_equals_plain_versions(
                mutant_emulator, case)
        else:
            test_emulated_pipelined_resolve_equals_plain_version(
                mutant_emulator, *case)

    mutant_emulator.set_mutant(0)
    run()
    mutant_emulator.set_mutant(flag)
    try:
        with pytest.raises(AssertionError):
            run()
    finally:
        mutant_emulator.set_mutant(0)


def test_emulated_compact_sweep_matches_jax_kernel(emulator):
    """B5 on bin_sweep_block against the reference's compacted
    ``_xform_kernel`` in Pallas interpret mode (``render_affine_sweep``
    with the plan's ``compact_counts``): the three-layer scene of
    tests/test_torch_sweep_tilings.py, first 2 frames, within the
    envelope ROADMAP.md pins for the compacted tiling (premultiplied 1
    level, 21 straight levels on a share of at most 1.7e-5)."""
    import jax.numpy as jnp

    from swf_renderer_tpu.ops import morph as jmorph
    from swf_renderer_tpu.ops import transform as jsweep
    from swf_renderer_tpu_torch.ops import morph as tmorph
    from tests.test_torch_sweep import assert_close
    from tests.test_torch_sweep_tilings import _compact_scene

    height, width, tables, colors, mats, _ = _compact_scene("three-layers")
    mats = mats[:2]
    colarr = np.asarray(colors, np.float32)
    tab, subxy, _ = jsweep.affine_pieces(tables, colors, mats)
    plan = jsweep.plan_compact_sweep(mats, tab, height, width)
    want = jmorph.morph_frames_to_u8(jsweep.render_affine_sweep(
        jnp.asarray(mats), jnp.asarray(tab), jnp.asarray(subxy),
        jnp.asarray(colarr), height, width, **plan), height, width)
    ctabs = sweep.compact_pre(torch.as_tensor(mats),
                              torch.as_tensor(np.asarray(tab)),
                              plan["compact_counts"], plan["wblock"], height,
                              width)
    got, _ = _run_compact(emulator, ctabs, torch.as_tensor(colarr), height,
                          width, (0, 0, 0), plan["blocks_per_step"])
    assert_close(np.asarray(want), tmorph.morph_frames_to_u8(got, height,
                                                             width), 21,
                 1.7e-5)


def test_emulated_pipelined_resolve_matches_jax_kernel(emulator):
    """B16 on the bulk-copy ring against the reference's
    ``_resolve_dma_kernel`` in Pallas interpret mode
    (``resolve_planes_u32_dma``) on random prefixed planes of 2 frames x
    16 layers x 3 strips, 2 chunks, mixed rules: within the plane
    resolve's pinned envelope (1 level, premultiplied 1, on a share of at
    most 2e-5)."""
    import jax.numpy as jnp

    from swf_renderer_tpu.ops import flatblock as jfb
    from tests.test_torch_flat_blocks import _diff

    layers, n_chunks, frames, ns = 16, 2, 2, 3
    rng = np.random.default_rng(161)
    raw = rng.normal(0, 0.4, (frames, layers, ns + 1, 128, 128)).astype(
        np.float32)
    raw[rng.uniform(size=raw.shape) < 0.6] = 0.0
    raw[..., n_chunks * 8:, :] = 0.0
    planes = np.cumsum(raw, -1, dtype=np.float32)
    colors = rng.uniform(0, 1, (frames, layers, 4)).astype(np.float32)
    rule = tuple(int(x) for x in rng.integers(0, 2, layers))
    want = np.asarray(jfb.resolve_planes_u32_dma(
        jnp.asarray(planes), jnp.asarray(colors), n_chunks, fill_rule=rule))
    out = np.full((frames, ns * 8, n_chunks * 128), -7, np.int32)
    stats = np.zeros(2, np.int64)
    rules = np.asarray(fb.layer_rules(rule, layers), np.int32)
    emulator.emulate_resolve_u32(
        planes.ctypes.data, colors.ctypes.data, rules.ctypes.data,
        out.ctypes.data, frames, layers, ns + 1, n_chunks, 1, 1, 3, 4,
        stats.ctypes.data)
    got = torch.from_numpy(out)
    assert torch.equal(got, fb.resolve_u32_plain(
        torch.as_tensor(planes), torch.as_tensor(colors), n_chunks, rule))
    dmax, share, pmax = _diff(want, got)
    assert dmax <= 1 and pmax <= 1 and share <= 2e-5, (dmax, share, pmax)


@pytest.mark.parametrize("passes", [3, 2])
def test_emulated_fused1_equals_plain_version(emulator, passes):
    """B13 on sort_blocks_fused blocks of 2 frames x 4 layers x 40x300
    (one layer empty), mixed rules; strip NS zeroed."""
    frames, layers = 2, 4
    (sidx, keep, urc, ucm, uval, ns, nc), colors = _flat_blocks(
        frames, layers, 40, 300, seed=57, empty_layer=2)
    sorted_blocks = fb.sort_blocks_fused(sidx, keep, urc, ucm, uval, layers,
                                         ns, block_pad_multiple=16)
    si, ke, la, rc, cm, uv = (_c(x) for x in sorted_blocks)
    rule = (0, 1, 1, 0)
    rules = np.asarray(rule, np.int32)
    want = fb.fused_blocks_plain(*map(torch.as_tensor, sorted_blocks),
                                 torch.as_tensor(colors), frames, layers, ns,
                                 nc, fill_rule=rule, passes=passes)
    out = np.full(want.shape, -7, np.int32)
    emulator.emulate_fused1(
        si.ctypes.data, ke.ctypes.data, la.ctypes.data, rc.ctypes.data,
        cm.ctypes.data, uv.ctypes.data, colors.ctypes.data,
        rules.ctypes.data, out.ctypes.data, len(si), frames, layers, ns + 1,
        nc, passes)
    assert torch.equal(torch.from_numpy(out), want)
    assert (want[:, :ns] != 0).any() and not want[:, ns].any()


# -- tools/exp_split.py's variants of the solid kernel; the probes ----------

# (height, width, layers): 2 frames, one strip a plane, group 6.
VARIANT_SCENES = [(24, 200, 3), (40, 300, 1), (16, 2560, 16)]
VARIANT_KINDS = ["full", "place", "resolve", "none", "none0", "merged",
                 "batched1", "batched2", "batched4"]


@functools.lru_cache(maxsize=None)
def _variant_scene(height, width, layers):
    tables, colors = build_scene_edges(2, layers, height, width,
                                       shapes_per_layer=3, seed=layers + 70)
    return exp_split.pack(tables, height, width, "cpu"), colors


def _emulate_variant(emu, d, colors, layers, kind, observe=0, spp=1,
                     rule=0):
    """The variant's words from the emulated kernel, out pre-filled with
    -7 so that words it does not write show."""
    a = {k: _c(d[k].numpy()) for k in ("sidx", "flags", "lays", "urc", "ucm",
                                        "uval")}
    variant = "batched" if kind.startswith("batched") else kind
    kk = int(kind[len("batched"):]) if variant == "batched" else 1
    urc = (_c(np.concatenate([a["urc"], a["uval"]], axis=2))
           if kind == "merged" else a["urc"])
    ns, nc = d["ns"], d["nc"]
    out = np.full((2, ns + 1, spp * 8, nc * 128), -7, np.int32)
    rules = np.asarray(fb.layer_rules(rule, layers), np.int32)
    colors = _c(colors)
    rc = emu.emulate_variant(
        exp_split._VARIANTS[variant], kk, observe, a["sidx"].ctypes.data,
        a["flags"].ctypes.data, a["lays"].ctypes.data, urc.ctypes.data,
        a["ucm"].ctypes.data, a["uval"].ctypes.data, colors.ctypes.data,
        rules.ctypes.data, out.ctypes.data, len(a["sidx"]), 6, 2, layers,
        ns + 1, nc, spp)
    assert rc == 0
    return torch.from_numpy(out)


@pytest.mark.parametrize("kind", VARIANT_KINDS)
@pytest.mark.parametrize("scene", VARIANT_SCENES)
def test_emulated_split_variants_equal_plain_versions(emulator, scene, kind):
    """Every variant of csrc/flatblock.cu's swf_fused_variant against its
    plain version: full, merged and batched (kk 1, 2, 4) B1's words, the
    ablated modes zero words on every visited strip."""
    height, width, layers = scene
    d, colors = _variant_scene(height, width, layers)
    ns = d["ns"]
    v = exp_split.variants(d, torch.as_tensor(colors), 2, layers,
                           kks=(1, 2, 4))[kind]
    want = v.plain()[:, :ns]
    got = _emulate_variant(emulator, d, colors, layers, kind)[:, :ns]
    assert torch.equal(got, want)
    assert bool(want.any()) == v.words


@pytest.mark.parametrize("scene", VARIANT_SCENES)
def test_emulated_ablations_keep_their_work_observable(emulator, scene):
    """The guard that keeps nvcc from dropping the ablated work: with
    ``observe`` set, mode place writes B1's words (its walk really
    scattered) and mode none the xor of the words it loaded, spread over
    each chunk block's words."""
    height, width, layers = scene
    d, colors = _variant_scene(height, width, layers)
    ns, nc = d["ns"], d["nc"]
    arrays = (d["sidx"], d["flags"], d["lays"], d["urc"], d["ucm"],
              d["uval"])
    want = fb.fusedn_plain(*arrays, torch.as_tensor(colors), 2, layers, ns,
                           nc)[:, :ns]
    got = _emulate_variant(emulator, d, colors, layers, "place", observe=1)
    assert torch.equal(got[:, :ns], want)
    got = _emulate_variant(emulator, d, colors, layers, "none", observe=1)
    blocks = got[:, :ns].numpy().reshape(2, ns, 8, nc, 128)
    seen = np.bitwise_xor.reduce(np.bitwise_xor.reduce(blocks, axis=4),
                                 axis=2)
    want_seen = exp_split.none_observed_plain(*arrays, 2, layers, ns,
                                              6).numpy()
    assert want_seen.any()
    assert (seen == want_seen[..., None]).all()


@pytest.mark.parametrize("layers", [1, 4, 16])
def test_batched_smem_bytes_is_the_launchers_count(emulator, layers):
    """exp_split.batched_smem_bytes (the CPU path's refusal) equals the
    C++ carve-up the launcher refuses by (smem_bytes +
    batched_stage_bytes against kSmemMax) at every group and kk used."""
    assert exp_split.SMEM_MAX == emulator.emulate_smem_max()
    for group in (1, 2, 6):
        for kk in (1, 2, 4, 8, 16, 32):
            assert exp_split.batched_smem_bytes(layers, group, kk) == \
                emulator.emulate_batched_smem(layers, group, kk)


# A grid larger than any task count here: a block a task, as the card
# launches it.
CARD_GRID = 1 << 20


def _emulate_probe(emu, kind, shape, grid=CARD_GRID):
    """The probe ``kind`` (lns, nsl, step: the passthrough; read_sum) on a
    seeded (F, A, B, R, C) array through the emulated launch on ``grid``
    blocks, and its plain version, the output pre-filled with NaN."""
    x = _c(np.random.default_rng(sum(shape)).standard_normal(shape)
           .astype(np.float32))
    layout = "lns" if kind == "lns" else "nsl"
    geo = exp_bw.geometry(shape, layout)
    if kind == "read_sum":
        want = exp_bw.read_sum_plain(torch.from_numpy(x))
        out_strides = (shape[1] * shape[3] * shape[4], shape[3] * shape[4])
    else:
        want = exp_bw.passthrough_plain(torch.from_numpy(x))
        out_strides = (0, 0)
    out = np.full(tuple(want.shape), np.nan, np.float32)
    assert emu.emulate_probe(int(kind == "read_sum"), x.ctypes.data,
                             out.ctypes.data, *geo, *out_strides, grid) == 0
    return torch.from_numpy(out), want


@pytest.mark.parametrize("kind,shape", [
    ("lns", (2, 4, 3, 128, 128)), ("nsl", (2, 3, 4, 128, 128)),
    ("read_sum", (2, 3, 4, 128, 128)), ("step", (1, 64, 1, 8, 128))])
def test_emulated_probes_equal_plain_versions(emulator, kind, shape):
    """csrc/probes_device.cuh: the passthrough in both layouts and as the
    step probe, and the read+sum, equal to their plain versions on the
    card's grid."""
    got, want = _emulate_probe(emulator, kind, shape)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind,shape,grid", [
    # spans that are no multiple of a chunk: less than one, and seven
    # whole chunks and a part
    ("lns", (1, 3, 5, 4, 12), CARD_GRID),
    ("nsl", (2, 3, 5, 24, 40), CARD_GRID),
    # one or two blocks walking every chunk (the last one ragged)
    ("lns", (2, 3, 5, 24, 40), 1), ("nsl", (2, 3, 5, 24, 40), 2),
    ("step", (1, 37, 1, 8, 128), 2), ("read_sum", (3, 5, 4, 24, 40), 2),
    # read+sum: L other than 4 (one partial batch, two batches), tiles no
    # multiple of a chunk, one block
    ("read_sum", (2, 3, 1, 8, 20), CARD_GRID),
    ("read_sum", (2, 3, 3, 24, 40), CARD_GRID),
    ("read_sum", (2, 3, 6, 24, 40), 1),
    ("read_sum", (1, 2, 9, 32, 36), 1)])
def test_emulated_probes_ragged_and_small_grids(emulator, kind, shape, grid):
    """The kernels' grid-stride walk: spans and tiles that are no multiple
    of a chunk (the last chunk masked), grids far smaller than the work
    (a block walking many chunks), read+sums over L of 1, 3, 6 and 9
    (batches of loads, added left to right): byte-equal to the plain
    versions."""
    n = shape[3] * shape[4] // 4 if kind == "read_sum" else \
        int(np.prod(shape)) // 4
    chunk = emulator.emulate_probe_chunk(int(kind == "read_sum"))
    tasks = -(-n // chunk) * (shape[0] * shape[1] if kind == "read_sum"
                              else 1)
    assert kind == "step" or n % chunk != 0
    assert grid == CARD_GRID or grid < tasks
    got, want = _emulate_probe(emulator, kind, shape, grid)
    assert torch.equal(got, want)


def test_emulated_probe_refuses_a_geometry_off_the_span(emulator):
    """The passthrough streams the span its tiles cover: a grid whose
    tiles leave gaps or overlap is refused (-1), one that covers the span
    in any order is taken."""
    x = np.zeros(4 * 2 * 3 * 16, np.float32)
    out = np.zeros_like(x)
    ptr = (x.ctypes.data, out.ctypes.data)
    # (n_f, n_s, n_l, tile, sf, ss, sl) over 24 tiles of 16 floats
    assert emulator.emulate_probe(0, *ptr, 4, 2, 3, 16, 96, 48, 16, 0, 0,
                                  4) == 0
    assert emulator.emulate_probe(0, *ptr, 4, 2, 3, 16, 16, 64, 128, 0, 0,
                                  4) == 0
    for bad in ((4, 2, 3, 16, 96, 48, 32),     # overlapping tiles
                (4, 2, 3, 16, 128, 48, 16),    # a gap after each f
                (4, 2, 3, 16, 96, 16, 16)):    # s and l on the same tiles
        assert emulator.emulate_probe(0, *ptr, *bad, 0, 0, 4) == -1

