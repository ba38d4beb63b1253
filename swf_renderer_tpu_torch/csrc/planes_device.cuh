// Device logic of the unfused flat-block pipeline: placement of the
// packer's blocks into chunk-major winding planes in device memory, and
// the two resolves of those planes into packed RGBA.
//
// Replaces the TPU kernels `_place_kernel` (B14, swf_renderer_tpu/ops/
// flatblock.py:486, pallas_call :547), `_resolve_u32_kernel` (B15, :556,
// pallas_call :600) and `_resolve_dma_kernel` (B16, :1364, pallas_call
// :1437).
//
// What they compute.  A chunk-major plane holds one 8-row strip of one
// (frame, layer): row rc = chunk*8 + y, column c is pixel (y, chunk*128 +
// c).  Placement sums each (frame, layer, strip) group's coalesced
// winding deltas into its plane (step: then the inclusive prefix of each
// row within its chunk).  The resolve turns a strip's planes into pixels:
// the in-chunk prefix when the planes are raw (the reference's lane
// ladder), the cross-chunk carry, the fill rule of each layer, the
// sequential over chain, and the premultiplied-u8 quantize tail.
//
// The carry keeps the reference's order exactly: each chunk's total is
// its row value at lane 127; an inclusive ladder over the chunks of the
// row (shifts of 1, 2, 4 and 8 chunks, adding 0.0 below the shift, as the
// stride-8 sublane roll does) gives incl, and winding = x + (incl -
// total).  The lane ladder is resolve_device.cuh's chunk_ladder (the
// reference's shifts 1..64), the over chain its `over`, the quantize tail
// flatblock_device.cuh's quantize_pack; so the kernels equal the plain
// version (ops/flatblock.py resolve_u32_plain) bit for bit, and it equals
// the JAX kernel wherever XLA:CPU does not contract a multiply-add.
//
// Design.
// - Placement (B14): one 256-thread block per group.  The TPU places a
//   block through a one-hot MXU product into a VMEM accumulator; here the
//   group's blocks (consecutive in the packer's order, the first with keep
//   == 0) scatter their deltas into a 128 x 129 shared plane (rows padded
//   so that the row walks below are free of bank conflicts).  The updates
//   of a group never share a target, so the float atomics are exact and
//   order-free.  With step, one thread per row sums it left to right; the
//   block then writes the 64 KB plane with coalesced stores.  A pre-pass
//   finds each group's first and last block.  Bound: bytes (the planes
//   written once).
// - Resolve (B15): one 256-thread block per (frame, strip), one warp per
//   pixel row.  The warp first computes its row's carries for every layer
//   (lane j holds chunk j; the ladder is four shuffles), then walks the
//   chunks left to right; each lane holds 4 neighbouring columns (one
//   16-byte load per layer, 512 contiguous bytes a warp), composites the
//   layers in registers and writes 4 packed words.  Bound: bytes (each
//   plane value read once, each pixel written once).
// - Pipelined resolve (B16): the Hopper counterpart of the manual DMA,
//   redesigned around the bulk-copy engine.  A stage is a COLUMN SLICE of
//   a strip: one 128-column chunk of its 8 rows, all layers (L x 4 KB;
//   the reference's stage is the whole strip, L x 64 KB, which does not
//   fit n_buf deep at 16 layers), plus the frame's colours.  In the
//   chunk-major layout a layer's stage is 4 contiguous KB, so one
//   producer thread (a ninth warp) fills a ring slot with L + 1
//   cp.async.bulk copies that complete on the slot's "full" mbarrier
//   (expect_tx); the eight consumer warps, one a pixel row, wait on that
//   barrier's phase, resolve through B15's resolve_chunk_row and arrive
//   on the slot's "empty" barrier, which the producer waits on before it
//   refills the slot.  The stage loop has no block barrier.  The
//   persistent grid is the SMs times the blocks an SM holds, and the
//   (frame, strip) items are dealt out in equal contiguous runs (one
//   strip more or less), a run crossing frames where it must.  The carry
//   needs no extra read: the ladder over the chunk totals is causal (chunk
//   j's inclusive sum reads only chunks <= j), so each consumer warp keeps
//   the ladder's four levels (shifts 1, 2, 4, 8) of the chunks seen so far
//   per layer and completes chunk j's carry from the stage's own lane-127
//   values, the same additions in the same order as strip_carries.
//   Where n_buf stages do not fit the shared-memory budget the ring goes
//   shallower (dma_depth).  Bound: bytes (each plane value read once,
//   each pixel written once); the stage split it was redesigned from and
//   its times are in PERF.md §6.

// Rounding: op by op in IEEE f32, -fmad=false, rintf, IEEE division; the
// even-odd rule is the floored modulo.

#pragma once

#include "flatblock_device.cuh"   // kLane, kStripH, kRowStride, quantize_pack
#include "resolve_device.cuh"     // chunk_ladder, from_below, over

namespace swf {

constexpr int kPlaneRows = kLane;                     // rows of a plane
constexpr int kPlaneSize = kPlaneRows * kLane;        // floats of a plane
constexpr int kPlaneChunks = kPlaneRows / kStripH;    // at most 16 chunks
constexpr int kStageRowFloats = kStripH * kLane;      // one layer's stage
constexpr size_t kDmaSmemBudget = 227 * 1024;   // a block's maximum
constexpr int kMaxDmaDepth = 8;

static_assert(kThreads == 32 * kStripH, "one warp per strip row");

struct PlaceArgs {
  const int* sidx;      // (NB,) packed (frame*L + layer)*(NS+1) + strip
  const int* keep;      // (NB,) 0 on the first block of a group
  const float* urc;     // (NB, 128) chunk-major row id
  const float* ucm;     // (NB, 128) column within the chunk
  const float* uval;    // (NB, 128) winding delta
  int* first;           // (G,) last keep == 0 block of each group
  int* last;            // (G,) last block of each group
  float* out;           // (G, 128, 128), G = F * L * (NS+1)
  int nb, n_groups, ns1, step;
};

struct PlanesArgs {
  const float* planes;  // (F, L, NS+1, 128, 128) chunk-major
  const float* colors;  // (F, L, 4) straight RGBA
  const int* rules;     // (L,) fill rule per layer
  int* out;             // (F, NS*8, n_chunks*128) packed u32 RGBA
  int frames, layers, ns1, n_chunks, prefixed, depth;
};

// Placement pre-pass: block i marks its group's last block and, when it
// resets the group, its first (the max over the group's blocks, so a
// group's plane sums its blocks from its last reset on).  Padding blocks
// on the sentinel strip mark nothing.
__device__ __forceinline__ void place_index(const PlaceArgs& a, int i) {
  if (i >= a.nb) return;
  const int g = a.sidx[i];
  if (g < 0 || g >= a.n_groups || g % a.ns1 == a.ns1 - 1) return;
  atomicMax(a.last + g, i);
  if (a.keep[i] == 0) atomicMax(a.first + g, i);
}

// One block: the plane of group blockIdx.x.  plane: 128 x kRowStride
// floats of shared memory.
__device__ void place_block(const PlaceArgs& a, float* plane) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int g = blockIdx.x;
  for (int i = tid; i < kPlaneRows * kRowStride; i += nthr) plane[i] = 0.0f;
  __syncthreads();
  const int b0 = a.first[g];
  const int b1 = a.last[g];
  if (b0 >= 0 && b1 >= b0) {
    const long long total = static_cast<long long>(b1 - b0 + 1) * kBlk;
    for (long long j = tid; j < total; j += nthr) {
      const int b = b0 + static_cast<int>(j / kBlk);
      if (a.sidx[b] != g) continue;
      const long long idx = static_cast<long long>(b) * kBlk + j % kBlk;
      const float v = a.uval[idx];
      if (v == 0.0f) continue;
      const int rc = static_cast<int>(a.urc[idx]);
      const int cm = static_cast<int>(a.ucm[idx]);
      if (rc < 0 || rc >= kPlaneRows || cm < 0 || cm >= kLane) continue;
      atomicAdd(&plane[rc * kRowStride + cm], v);
    }
  }
  __syncthreads();
  if (a.step) {
    for (int r = tid; r < kPlaneRows; r += nthr) {
      float* p = plane + r * kRowStride;
      float acc = 0.0f;
      for (int c = 0; c < kLane; ++c) {
        acc = acc + p[c];
        p[c] = acc;
      }
    }
    __syncthreads();
  }
  float* out = a.out + static_cast<size_t>(g) * kPlaneSize;
  for (int i = tid; i < kPlaneSize; i += nthr) {
    out[i] = plane[(i / kLane) * kRowStride + i % kLane];
  }
}

__device__ __forceinline__ const float* plane_row(const PlanesArgs& a, int f,
                                                  int l, int s, int rc) {
  return a.planes +
         ((((static_cast<size_t>(f) * a.layers + l) * a.ns1 + s) *
           kPlaneRows) + rc) * kLane;
}

// The calling warp's carries for pixel row y of strip s, every layer:
// carry[l * 16 + j] = incl_j - total_j.  Lane j holds chunk j's total
// (the row's lane-127 value; for raw planes, that of the lane ladder).
__device__ void strip_carries(const PlanesArgs& a, int f, int s, int y,
                              float* carry) {
  const int lane = threadIdx.x & 31;
  for (int l = 0; l < a.layers; ++l) {
    float t = 0.0f;
    if (a.prefixed) {
      if (lane < a.n_chunks) {
        t = plane_row(a, f, l, s, lane * kStripH + y)[kLane - 1];
      }
    } else {
      for (int j = 0; j < a.n_chunks; ++j) {
        const float4 d = *reinterpret_cast<const float4*>(
            plane_row(a, f, l, s, j * kStripH + y) + 4 * lane);
        float e[4] = {d.x, d.y, d.z, d.w};
        chunk_ladder(e, lane);
        const float tj = __shfl_sync(0xffffffffu, e[3], 31);
        if (lane == j) t = tj;
      }
    }
    float incl = t;
    for (int d = 1; d * kStripH < kPlaneRows; d <<= 1) {
      incl = incl + from_below(incl, d, lane);
    }
    if (lane < kPlaneChunks) carry[l * kPlaneChunks + lane] = incl - t;
  }
  __syncwarp();
}

// One chunk of one pixel row (the calling warp; lane holds columns
// 4 lane .. 4 lane + 3): winding = x + carry, the rule, the over chain,
// quantize and pack into out_row[0..127].  src(l) points at layer l's 128
// values of the row (device or shared memory).
template <typename RowFn>
__device__ __forceinline__ void resolve_chunk_row(
    const PlanesArgs& a, RowFn src, const float* carry, int j,
    const float* col_s, const int* rule_s, int* out_row) {
  const int lane = threadIdx.x & 31;
  float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float al[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int l = 0; l < a.layers; ++l) {
    const float4 d = *reinterpret_cast<const float4*>(src(l) + 4 * lane);
    float e[4] = {d.x, d.y, d.z, d.w};
    if (!a.prefixed) chunk_ladder(e, lane);
    const float cy = carry[l * kPlaneChunks + j];
    const int rule = rule_s[l];
    const float* c = col_s + 4 * l;
    for (int q = 0; q < 4; ++q) {
      over(c[3] * fill_cov(e[q] + cy, rule), c[0], c[1], c[2], r[q], g[q],
           b[q], al[q]);
    }
  }
  int w[4];
  for (int q = 0; q < 4; ++q) {
    const float pm[3] = {r[q], g[q], b[q]};
    w[q] = static_cast<int>(quantize_pack(al[q], pm));
  }
  *reinterpret_cast<int4*>(out_row + 4 * lane) = make_int4(w[0], w[1], w[2],
                                                           w[3]);
}

// Shared memory of the grid resolve (B15): colours, rules, the warps'
// carries.
__host__ __device__ inline size_t resolve_smem_bytes(int layers) {
  return align16(static_cast<size_t>(layers) * 4 * 4) +
         align16(static_cast<size_t>(layers) * 4) +
         static_cast<size_t>(kStripH) * layers * kPlaneChunks * 4;
}

// The pipelined resolve's threads: eight consumer warps (a pixel row
// each) and the producer warp.
constexpr int kDmaThreads = kThreads + 32;

// A ring slot: the L layers' 8 x 128 stage, then the frame's colours.
__host__ __device__ inline size_t dma_stage_bytes(int layers) {
  return static_cast<size_t>(layers) * (kStageRowFloats + 4) * 4;
}

// After the ring: the rules, each consumer warp's carry ladder (L x 16
// floats) and each slot's full and empty mbarriers.
__host__ __device__ inline size_t dma_rest_bytes(int layers, int depth) {
  return align16(static_cast<size_t>(layers) * 4) +
         static_cast<size_t>(kStripH) * layers * kPlaneChunks * 4 +
         static_cast<size_t>(depth) * 16;
}

// Ring depth of the pipelined resolve: n_buf, or as many stages as fit
// the budget (0: not even one).
__host__ __device__ inline int dma_depth(int layers, int n_buf) {
  int depth = n_buf < kMaxDmaDepth ? n_buf : kMaxDmaDepth;
  while (depth > 0 && depth * dma_stage_bytes(layers) +
                          dma_rest_bytes(layers, depth) > kDmaSmemBudget) {
    --depth;
  }
  return depth;
}

// mbarriers and bulk copies from global to shared memory.  Without
// __CUDA_ARCH__ and without __CUDACC__ (the g++ emulation of the tests)
// they call functions that the emulation defines before it includes this
// header.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
#if defined(__CUDA_ARCH__)
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
#else
  return 0u;
#endif
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
#if defined(__CUDA_ARCH__)
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
#elif !defined(__CUDACC__)
  emu_mbar_init(bar, count);
#endif
}

// The barriers' initialisation made visible to the async proxy.
__device__ __forceinline__ void mbar_fence_init() {
#if defined(__CUDA_ARCH__)
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#endif
}

// The producer's arrival, announcing `bytes` of copies to complete.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
#if defined(__CUDA_ARCH__)
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
#elif !defined(__CUDACC__)
  emu_mbar_expect_tx(bar, bytes);
#endif
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
#if defined(__CUDA_ARCH__)
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
#elif !defined(__CUDACC__)
  emu_mbar_arrive(bar);
#endif
}

// Until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
#elif !defined(__CUDACC__)
  emu_mbar_wait(bar, parity);
#endif
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-B aligned)
// from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(float* dst, const float* src,
                                              unsigned bytes,
                                              unsigned long long* bar) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
#elif !defined(__CUDACC__)
  emu_bulk_copy_g2s(dst, src, bytes, bar);
#endif
}

__device__ __forceinline__ void load_tables(const PlanesArgs& a, int f,
                                            float* col_s, int* rule_s) {
  for (int i = threadIdx.x; i < a.layers * 4; i += blockDim.x) {
    col_s[i] = a.colors[static_cast<size_t>(f) * a.layers * 4 + i];
  }
  for (int i = threadIdx.x; i < a.layers; i += blockDim.x) {
    rule_s[i] = a.rules[i];
  }
}

// B15: one block per (strip blockIdx.x, frame blockIdx.y).
__device__ void resolve_u32_block(const PlanesArgs& a, unsigned char* smem) {
  const int L = a.layers;
  float* col_s = reinterpret_cast<float*>(smem);
  int* rule_s = reinterpret_cast<int*>(smem + align16(L * 4 * 4));
  float* carry = reinterpret_cast<float*>(smem + align16(L * 4 * 4) +
                                          align16(L * 4));
  const int s = blockIdx.x;
  const int f = blockIdx.y;
  const int y = threadIdx.x >> 5;
  load_tables(a, f, col_s, rule_s);
  __syncthreads();
  carry += y * L * kPlaneChunks;
  strip_carries(a, f, s, y, carry);
  const int stride = a.n_chunks * kLane;
  int* out_row = a.out + (static_cast<size_t>(f) * (a.ns1 - 1) * kStripH +
                          static_cast<size_t>(s) * kStripH + y) * stride;
  for (int j = 0; j < a.n_chunks; ++j) {
    resolve_chunk_row(
        a, [&](int l) { return plane_row(a, f, l, s, j * kStripH + y); },
        carry, j, col_s, rule_s, out_row + j * kLane);
  }
}

// Where the pipelined resolve's stage t lies, advanced a stage at a time
// (no division in the stage loops): chunk j of strip s of frame f, in
// ring slot `slot`, that slot's use of parity `phase`.
struct DmaCursor {
  int f, s, j, slot;
  unsigned phase;
  __device__ __forceinline__ void next(int ns, int nc, int depth) {
    if (++j == nc) {
      j = 0;
      if (++s == ns) {
        s = 0;
        ++f;
      }
    }
    if (++slot == depth) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// B16: a persistent block of kDmaThreads owns the (frame, strip) items
// [n b / G, n (b + 1) / G) of n = frames * strips, G = gridDim.x; its
// stage t is chunk t % n_chunks of item t / n_chunks, in ring slot
// t % depth.  smem: the ring (depth slots), then dma_rest_bytes.
__device__ void resolve_dma_block(const PlanesArgs& a, unsigned char* smem) {
  const int L = a.layers;
  const int depth = a.depth;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nc = a.n_chunks;
  const int ns = a.ns1 - 1;
  const size_t stage_floats = dma_stage_bytes(L) / 4;
  float* ring = reinterpret_cast<float*>(smem);
  unsigned char* rest = smem + depth * dma_stage_bytes(L);
  int* rule_s = reinterpret_cast<int*>(rest);
  float* ladders = reinterpret_cast<float*>(rest + align16(L * 4));
  unsigned long long* full = reinterpret_cast<unsigned long long*>(
      rest + align16(L * 4) + static_cast<size_t>(kStripH) * L *
                                  kPlaneChunks * 4);
  unsigned long long* empty = full + depth;
  const long long n_items = static_cast<long long>(a.frames) * ns;
  const long long i0 = n_items * blockIdx.x / gridDim.x;
  const long long i1 = n_items * (blockIdx.x + 1) / gridDim.x;
  const int n_stages = static_cast<int>(i1 - i0) * nc;
  DmaCursor c{static_cast<int>(i0 / ns), static_cast<int>(i0 % ns), 0, 0,
              0u};
  if (tid == 0) {
    for (int i = 0; i < depth; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kThreads);
    }
    mbar_fence_init();
  }
  for (int i = tid; i < L; i += blockDim.x) rule_s[i] = a.rules[i];
  __syncthreads();
  if (warp == kStripH) {
    // The producer: one thread issues every stage's copies.
    if (lane != 0) return;
    for (int t = 0; t < n_stages; ++t, c.next(ns, nc, depth)) {
      if (t >= depth) mbar_wait(empty + c.slot, c.phase ^ 1u);
      float* stage = ring + c.slot * stage_floats;
      mbar_expect_tx(full + c.slot,
                     static_cast<unsigned>(dma_stage_bytes(L)));
      for (int l = 0; l < L; ++l) {
        bulk_copy_g2s(stage + l * kStageRowFloats,
                      plane_row(a, c.f, l, c.s, c.j * kStripH),
                      kStageRowFloats * 4, full + c.slot);
      }
      bulk_copy_g2s(stage + L * kStageRowFloats,
                    a.colors + static_cast<size_t>(c.f) * L * 4,
                    a.layers * 16, full + c.slot);
    }
    return;
  }
  // The consumers: warp y resolves pixel row y of every stage.  Its
  // ladder holds, per layer, 16 floats: [0] the last chunk total (shift
  // 1), [1, 2] the last two sums of shift 1 (shift 2), [3, 7) the last
  // four of shift 2 (shift 4), [7, 15) the last eight of shift 4 (shift
  // 8), [15] this stage's carry; all 0 at a strip's first chunk, so a
  // shift past the first chunk adds 0.0 as the lane ladder does.
  const int y = warp;
  float* ladder = ladders + y * L * kPlaneChunks;
  const int stride = nc * kLane;
  for (int t = 0; t < n_stages; ++t, c.next(ns, nc, depth)) {
    const int j = c.j;
    const float* stage = ring + c.slot * stage_floats;
    mbar_wait(full + c.slot, c.phase);
    for (int l = lane; l < L; l += 32) {
      float* h = ladder + l * kPlaneChunks;
      if (j == 0) {
        for (int k = 0; k < kPlaneChunks - 1; ++k) h[k] = 0.0f;
      }
      const float x = stage[l * kStageRowFloats + y * kLane + kLane - 1];
      const float sum1 = x + h[0];
      const float sum2 = sum1 + h[1 + (j & 1)];
      const float sum4 = sum2 + h[3 + (j & 3)];
      const float sum8 = sum4 + h[7 + (j & 7)];
      h[0] = x;
      h[1 + (j & 1)] = sum1;
      h[3 + (j & 3)] = sum2;
      h[7 + (j & 7)] = sum4;
      h[kPlaneChunks - 1] = sum8 - x;
    }
    __syncwarp();   // every lane's carry is written
    int* out_row = a.out + ((static_cast<size_t>(c.f) * ns + c.s) * kStripH +
                            y) * stride;
    resolve_chunk_row(
        a, [&](int l) { return stage + l * kStageRowFloats + y * kLane; },
        ladder, kPlaneChunks - 1, stage + L * kStageRowFloats, rule_s,
        out_row + j * kLane);
    mbar_arrive(empty + c.slot);
    __syncwarp();
  }
}

}  // namespace swf
