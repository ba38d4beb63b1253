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
// supergroup, B1's body at one strip a plane (flatblock_device.cuh): zero
// the planes and the carry and load the frame's colours (solid_setup),
// walk the groups four slots' loads at a time without a 64-bit division
// (solid_walk), place this chunk's deltas into shared memory and earlier
// chunks' into the row's 32.32 carry as two 32-bit atomics (place_slot),
// prefix each row (prefix_rows) and resolve the 8 x 128 words with the
// layer loops unrolled to the class kLc chosen at launch, the colours in
// registers and the rules as a bit mask (solid_pixel).  Its first design
// placed one slot at a time behind a 64-bit division, added the carry
// with a 64-bit compare-and-swap loop and resolved through the generic
// composite_pack (128 B of stack): 3.46-3.70 ms on the headline against
// B1's 1.63-1.70 in the same call (H100, PERF.md).
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
// in a.sg_last.  Spp 1 (a.spb 1): a.n_chunks * 8 row ids, 8 plane rows a
// layer; kLc the layer class of B1's resolve.  kOne: coarse 1, where a
// block owns at most one supergroup.  The loop over a block's
// supergroups costs B1's body 32 registers (80 against 48 at kLc 4: three
// blocks an SM, not five) and 28% at coarse 1 (H100, PERF.md); kOne
// leaves the loop after its supergroup, so nothing is live across it.
template <int kLc, bool kOne>
__device__ void coarse_block(const FusedArgs& a, int coarse,
                             unsigned char* smem) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int chunk = static_cast<int>(blockIdx.x % a.n_chunks);
  const int step = static_cast<int>(blockIdx.x / a.n_chunks);
  const int L = a.layers;
  const SolidSmem sm = solid_smem(smem, L, kStripH);
  int* ring = reinterpret_cast<int*>(smem + sm.end);
  const int stride = a.n_chunks * kLane;
  const int nc8 = a.n_chunks * kStripH;
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

    // Placement (B1's walk): this chunk's deltas into the plane, earlier
    // chunks' deltas of the same row into the carry.
    solid_walk<kVarFull>(a, g0, g1, [&](float v, float rcf, float cmf,
                                        int layer, int win) {
      place_slot<kVarFull>(a, sm.plane, sm.carry, L, kStripH, chunk, 0,
                           nc8, v, rcf, cmf, layer, win);
    });
    __syncthreads();
    prefix_rows(sm.plane, sm.carry, L * kStripH);
    __syncthreads();

    // Resolve into the ring slot (B1's solid_pixel): fill rule,
    // suffix-product composite, quantize, pack.
    const SolidColours<kLc> colour(sm.col_s, sm.rule_s, L);
    for (int p = tid; p < kRingWords; p += nthr) {
      slot[p] = static_cast<int>(solid_pixel<kLc>(
          sm.plane + (p / kLane) * kRowStride + p % kLane,
          kStripH * kRowStride, colour, colour.eo, L));
    }
    fence_proxy_async();
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
    if constexpr (kOne) break;
  }
  if (tid == 0) bulk_wait_all();
}

}  // namespace swf
