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
// - Pipelined resolve (B16): the Hopper counterpart of the manual DMA.
//   Persistent blocks each own a run of one frame's strips and stream them
//   through a ring of n_buf shared-memory stages filled by cp.async; the
//   block resolves stage t while the copies of stages t+1 .. t+n_buf-1 are
//   in flight, through the same resolve_chunk_row as B15.  A stage is a
//   COLUMN SLICE of a strip: one 128-column chunk of the 8 rows, all
//   layers (L x 4 KB; the reference's stage is the whole strip, L x 64 KB,
//   which does not fit n_buf deep at 16 layers).  Stages run chunk by
//   chunk, so the carry, computed per strip from the chunk totals before
//   its first stage, runs in the reference's order.  Where n_buf stages
//   of L x 4 KB do not fit the shared-memory budget the ring goes
//   shallower (dma_depth).
//
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

// Shared memory of both resolves after the DMA ring: colours, rules, the
// warps' carries.
__host__ __device__ inline size_t resolve_smem_bytes(int layers) {
  return align16(static_cast<size_t>(layers) * 4 * 4) +
         align16(static_cast<size_t>(layers) * 4) +
         static_cast<size_t>(kStripH) * layers * kPlaneChunks * 4;
}

__host__ __device__ inline size_t dma_stage_bytes(int layers) {
  return static_cast<size_t>(layers) * kStageRowFloats * 4;
}

// Ring depth of the pipelined resolve: n_buf, or as many stages as fit
// the budget (0: not even one).
__host__ __device__ inline int dma_depth(int layers, int n_buf) {
  int depth = n_buf < kMaxDmaDepth ? n_buf : kMaxDmaDepth;
  while (depth > 0 && depth * dma_stage_bytes(layers) +
                          resolve_smem_bytes(layers) > kDmaSmemBudget) {
    --depth;
  }
  return depth;
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

// B16: blockIdx.y = frame; the frame's strips split in gridDim.x runs.
// smem: the ring (depth stages), then resolve_smem_bytes.
__device__ void resolve_dma_block(const PlanesArgs& a, unsigned char* smem) {
  const int L = a.layers;
  const int depth = a.depth;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const size_t stage_floats = static_cast<size_t>(L) * kStageRowFloats;
  float* ring = reinterpret_cast<float*>(smem);
  unsigned char* rest = smem + depth * dma_stage_bytes(L);
  float* col_s = reinterpret_cast<float*>(rest);
  int* rule_s = reinterpret_cast<int*>(rest + align16(L * 4 * 4));
  float* carry = reinterpret_cast<float*>(rest + align16(L * 4 * 4) +
                                          align16(L * 4));
  const int f = blockIdx.y;
  const int ns = a.ns1 - 1;
  const int per = (ns + gridDim.x - 1) / gridDim.x;
  const int s0 = blockIdx.x * per;
  const int s1 = s0 + per < ns ? s0 + per : ns;
  if (s0 >= s1) return;                       // uniform across the block
  const int y = tid >> 5;
  carry += y * L * kPlaneChunks;
  load_tables(a, f, col_s, rule_s);
  const int n_stages = (s1 - s0) * a.n_chunks;
  // Stage t: chunk t % n_chunks of strip s0 + t / n_chunks, into slot
  // t % depth; 16 bytes a copy, 256 copies a layer.
  auto fetch = [&](int t) {
    const int s = s0 + t / a.n_chunks;
    const int j = t % a.n_chunks;
    float* stage = ring + static_cast<size_t>(t % depth) * stage_floats;
    for (int i = tid; i < L * (kStageRowFloats / 4); i += nthr) {
      const int l = i / (kStageRowFloats / 4);
      const int q = i % (kStageRowFloats / 4);
      const int row = q / (kLane / 4);
      const int c4 = (q % (kLane / 4)) * 4;
      cp_async16(stage + l * kStageRowFloats + row * kLane + c4,
                 plane_row(a, f, l, s, j * kStripH + row) + c4);
    }
  };
  for (int t = 0; t < depth - 1; ++t) {
    if (t < n_stages) fetch(t);
    cp_async_commit();
  }
  const int stride = a.n_chunks * kLane;
  for (int t = 0; t < n_stages; ++t) {
    if (t + depth - 1 < n_stages) fetch(t + depth - 1);
    cp_async_commit();
    cp_async_wait(depth - 1);                 // stage t has landed
    __syncthreads();
    const int s = s0 + t / a.n_chunks;
    const int j = t % a.n_chunks;
    if (j == 0) strip_carries(a, f, s, y, carry);
    const float* stage = ring + static_cast<size_t>(t % depth) * stage_floats;
    int* out_row = a.out + (static_cast<size_t>(f) * ns * kStripH +
                            static_cast<size_t>(s) * kStripH + y) * stride;
    resolve_chunk_row(
        a, [&](int l) { return stage + l * kStageRowFloats + y * kLane; },
        carry, j, col_s, rule_s, out_row + j * kLane);
    __syncthreads();                          // slot t % depth is free
  }
}

}  // namespace swf
