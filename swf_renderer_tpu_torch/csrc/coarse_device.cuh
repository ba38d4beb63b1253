// Device logic of the coarse-step form of the solid fused kernel (B1)
// with explicit output copies.
//
// Replaces the TPU kernel `_kernel` of the reference's tools/exp_dma.py
// (:39, pallas_call :154): B1 at one strip a plane under the nonzero
// rule, each grid step walking `coarse` consecutive packed groups (zero
// the planes on a supergroup's first group, place, resolve on its last),
// the resolved strips leaving through a 2-slot VMEM ring by explicit
// async copies into an output in device memory, drained on the last
// step.  A supergroup is the run of groups that builds one strip block
// of one frame.
//
// Design on Hopper.  A TPU grid runs in order and keeps its scratch from
// one step to the next, so a supergroup may span steps; CUDA blocks run
// in no order and share nothing.  One block of 256 threads is (chunk,
// step), NG / coarse steps as in the reference, and it owns the
// supergroups whose FIRST group (flags bit 0) lies in [step * coarse,
// (step + 1) * coarse): it walks each of them to its last group (the
// supergroup index of B1's launcher), even past its range.  So no group
// is placed twice, and padding groups (flags 0) belong to no block.  Per
// supergroup, as B1 at one strip a plane: zero the planes and the carry
// and load the frame's colours (solid_setup), scatter this chunk's
// deltas into shared memory with float atomics and earlier chunks' into
// the row's 32.32 carry, prefix each row, resolve the 8 x 128 words.
//
// Output.  The words go into one slot of a 2-slot ring in shared memory
// (the reference's N_BUF).  The writing threads make their writes
// visible to the async proxy (fence.proxy.async.shared::cta), the block
// meets a barrier, and one thread issues 8 bulk copies of 512 B, one a
// row (cp.async.bulk.global.shared::cta.bulk_group; global rows are
// n_chunks * 512 B apart and 16-B aligned) and commits them as one bulk
// group.  Before a slot is written again, that thread waits until at
// most one group still reads the ring (cp.async.bulk.wait_group.read 1,
// the reference's wait on the slot's semaphore), and the barrier after
// the next set-up publishes the wait to the writers.  Before the block
// exits it waits for every copy (cp.async.bulk.wait_group 0, the
// reference's _drain).  The sentinel strip block is never written.
//
// Bound on this card: bytes, as B1 (the packed words written once, the
// grouped inputs read once).  The copies leave the register file free
// of the stores; the set-up of a block (its share of B1's launch and
// zeroing floor) is paid once for every supergroup it owns.
//
// Tolerance against the plain version (tools/exp_dma.py dma_plain, B1's
// plain version at one strip a plane under the nonzero rule): byte-equal
// (B1's arithmetic; the float atomics of a layer never share a target).
//
// Without __CUDA_ARCH__ and without __CUDACC__ (the g++ emulation of the
// tests) the bulk-copy operations call functions that the emulation
// defines before it includes this header; there the copies are deferred
// to the waits (or the block's exit), so a slot written before its wait
// shows in the words.

#pragma once

#include "flatblock_device.cuh"

namespace swf {

constexpr int kNBuf = 2;                          // ring slots (N_BUF)
constexpr int kRingWords = kStripH * kLane;       // one slot: 8 x 128 words

__host__ __device__ inline size_t coarse_smem_bytes(int layers) {
  return smem_bytes(layers, kStripH, false) +
         static_cast<size_t>(kNBuf) * kRingWords * 4;
}

// This thread's generic-proxy writes to shared memory become visible to
// the async proxy (the bulk copies).
__device__ __forceinline__ void bulk_fence_shared() {
#if defined(__CUDA_ARCH__)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#elif !defined(__CUDACC__)
  emu_fence_proxy_async();
#endif
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-B aligned)
// from shared to global memory, into the open bulk group.
__device__ __forceinline__ void bulk_copy_s2g(int* dst, const int* src,
                                              unsigned bytes) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(s), "r"(bytes)
      : "memory");
#elif !defined(__CUDACC__)
  emu_bulk_copy_s2g(dst, src, bytes);
#endif
}

__device__ __forceinline__ void bulk_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
#elif !defined(__CUDACC__)
  emu_bulk_commit();
#endif
}

// Until at most kNBuf - 1 committed groups still read shared memory.
__device__ __forceinline__ void bulk_wait_read_ring() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kNBuf - 1)
               : "memory");
#elif !defined(__CUDACC__)
  emu_bulk_wait(kNBuf - 1);
#endif
}

// Until every committed group has completed, its writes included.
__device__ __forceinline__ void bulk_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
#elif !defined(__CUDACC__)
  emu_bulk_wait(0);
#endif
}

// One block: blockIdx.x = step * n_chunks + chunk; the supergroup index
// in a.sg_last.  Spp 1: a.n_chunks * 8 row ids, 8 plane rows a layer.
__device__ void coarse_block(const FusedArgs& a, int coarse,
                             unsigned char* smem) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int chunk = static_cast<int>(blockIdx.x % a.n_chunks);
  const int step = static_cast<int>(blockIdx.x / a.n_chunks);
  const int L = a.layers;
  const SolidSmem sm = solid_smem(smem, L, kStripH);
  float* plane = sm.plane;
  long long* carry = sm.carry;
  int* ring = reinterpret_cast<int*>(smem + sm.end);
  const int gb = a.group * kBlk;
  const int stride = a.n_chunks * kLane;
  const int g_lo = step * coarse;
  const int g_hi = g_lo + coarse < a.ng ? g_lo + coarse : a.ng;
  int n = 0;   // supergroups this block has resolved
  for (int g0 = g_lo; g0 < g_hi; ++g0) {
    if ((a.flags[g0] & 1) == 0) continue;
    const int packed = a.sidx[g0];
    const int f = packed / (L * a.ns1);
    const int s = packed % a.ns1;
    if (s >= a.ns1 - 1) continue;   // the sentinel strip block
    const int g1 = a.sg_last[f * a.ns1 + s];
    if (g1 < g0) continue;
    int* slot = ring + (n % kNBuf) * kRingWords;
    if (tid == 0 && n >= kNBuf) bulk_wait_read_ring();
    solid_setup(a, sm, L, kStripH, f);
    __syncthreads();

    // Placement of groups g0..g1: this chunk's deltas into the plane,
    // earlier chunks' deltas of the same row into the carry.
    const long long total = static_cast<long long>(g1 - g0 + 1) * gb;
    for (long long j = tid; j < total; j += nthr) {
      const int g = g0 + static_cast<int>(j / gb);
      const int rem = static_cast<int>(j % gb);
      const int k = rem / kBlk;
      const int nblk = static_cast<int>(
          static_cast<unsigned>(a.flags[g]) >> 2);
      if (nblk != 0 && k >= nblk) continue;
      const long long idx = static_cast<long long>(g) * gb + rem;
      const float v = a.uval[idx];
      if (v == 0.0f) continue;
      const int rc = static_cast<int>(a.urc[idx]);
      const int ch = rc >> 3;
      if (ch > chunk) continue;
      const int layer = a.lays[static_cast<long long>(k) * a.ng + g];
      if (layer < 0 || layer >= L) continue;
      const int row = layer * kStripH + (rc & 7);
      if (ch == chunk) {
        atomicAdd(&plane[row * kRowStride + static_cast<int>(a.ucm[idx])],
                  v);
      } else {
        atomicAdd(reinterpret_cast<unsigned long long*>(&carry[row]),
                  static_cast<unsigned long long>(to_fixed(v)));
      }
    }
    __syncthreads();

    // In-chunk inclusive prefix (left to right), plus the carry.
    for (int r = tid; r < L * kStripH; r += nthr) {
      float* p = plane + r * kRowStride;
      const float cy = from_fixed(carry[r]);
      float acc = 0.0f;
      for (int c = 0; c < kLane; ++c) {
        acc = acc + p[c];
        p[c] = acc + cy;
      }
    }
    __syncthreads();

    // Resolve into the ring slot: nonzero rule, suffix-product
    // composite, quantize, pack.
    for (int p = tid; p < kRingWords; p += nthr) {
      const int r8 = p / kLane;
      const int c = p % kLane;
      float cas[kMaxLayers];
#pragma unroll
      for (int l = 0; l < kMaxLayers; ++l) {
        if (l < L) {
          const float w = plane[(l * kStripH + r8) * kRowStride + c];
          cas[l] = sm.col_s[4 * l + 3] * fill_cov(w, sm.rule_s[l]);
        }
      }
      slot[p] = static_cast<int>(composite_pack(
          L, cas, [&](int l, int ch) { return sm.col_s[4 * l + ch]; }));
    }
    bulk_fence_shared();
    __syncthreads();
    if (tid == 0) {
      int* dst = a.out + (static_cast<long long>(f) * a.ns1 + s) * kStripH *
                             stride + chunk * kLane;
      for (int r8 = 0; r8 < kStripH; ++r8) {
        bulk_copy_s2g(dst + static_cast<long long>(r8) * stride,
                      slot + r8 * kLane, kLane * 4);
      }
      bulk_commit();
    }
    ++n;
  }
  if (tid == 0) bulk_wait_all();
}

}  // namespace swf
