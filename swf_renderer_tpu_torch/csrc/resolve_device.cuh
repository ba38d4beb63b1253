// Device logic of the scanline resolve kernel: delta-encoded winding planes
// -> premultiplied frames.
//
// Replaces the TPU kernel `_resolve_kernel` (B12, swf_renderer_tpu/ops/
// resolve.py:53, pallas_call :128).
//
// What it computes, per frame f, row y and layer l in order: the winding
// of a pixel is the prefix sum along the row of the layer's delta plane
// (the scanline scatter puts each cell's area at its column and cover -
// area at the next, so the prefix is the exact winding integral); the
// layer's fill rule maps it to coverage; the layer composites over the
// frame (ca = alpha * cov, c = colour * ca + c * (1 - ca), a = ca +
// a * (1 - ca)).  The output is (F, 4, H, S) premultiplied f32, channel
// major, as the reference's.
//
// The prefix sum keeps the reference's f32 order, so the kernel, its plain
// version (ops/resolve.py resolve_plain) and the JAX kernel agree bit for
// bit on the same planes: per 128-column chunk a Hillis-Steele ladder
// (x[i] += x[i - s] for s = 1, 2, ..., 64, adding 0.0 where i < s), then
// the running carry (the previous chunk's last prefix value) added to
// every lane.  Adds only, in one fixed order.
//
// One deliberate change: the reference tests the rule argument against
// nonzero as a whole, so a per-layer rule tuple resolves every layer
// even-odd; this kernel reads one rule per layer, as the fused kernels do
// (ROADMAP.md queue C).
//
// Design.  The TPU kernel holds an 8-row strip of all layers in VMEM and
// shifts whole vector registers.  Here one warp owns one row of one frame
// and walks its 128-column chunks left to right; within a chunk each lane
// holds 4 neighbouring columns (one float4 load of the delta plane per
// layer: 512 contiguous bytes a warp), so the ladder's shifts of 1 and 2
// are register moves plus one shuffle and the shifts of 4..64 are warp
// shuffles.  Per chunk the layers run in order with the four pixels' RGBA
// accumulators in registers; each layer's carry lives in shared memory.
// A block is 8 warps = one 8-row strip.
//
// Bound on this card: bytes — each delta value is read once and each
// output channel written once (8 bytes a pixel-layer plus 16 a pixel)
// against ~40 f32 operations a pixel-layer.
//
// Rounding: op by op in IEEE f32; the even-odd rule is floored modulo
// (fmodf plus the sign fix-up); built with -fmad=false, so the composite's
// multiply-adds do not contract into FMAs.

#pragma once

#include "flatblock_device.cuh"   // fill_cov, kLane, kStripH

namespace swf {

constexpr int kResWarps = kStripH;      // one warp per row of a strip
constexpr int kResThreads = 32 * kResWarps;

struct ResolveArgs {
  const float* delta;   // (F, L, H, S) delta-encoded winding planes
  const float* colors;  // (F, L, 4) straight RGBA
  const int* rules;     // (L,) fill rule per layer
  float* out;           // (F, 4, H, S) premultiplied RGBA
  int frames, layers, height, stride;
};

// One step of the sequential over chain (composite.over_premul, and
// flatblock.composite_quantize_pack with chain=True): layer colour (cr,
// cg, cb) at effective alpha ca over the premultiplied (r, g, b, a).
__device__ __forceinline__ void over(float ca, float cr, float cg, float cb,
                                     float& r, float& g, float& b,
                                     float& a) {
  const float keep = 1.0f - ca;
  r = cr * ca + r * keep;
  g = cg * ca + g * keep;
  b = cb * ca + b * keep;
  a = ca + a * keep;
}

// v of the lane d below, or 0.0 for the lowest d lanes (the ladder's
// masked roll).
__device__ __forceinline__ float from_below(float v, int d, int lane) {
  const float u = __shfl_up_sync(0xffffffffu, v, d);
  return lane >= d ? u : 0.0f;
}

// The Hillis-Steele ladder over one 128-column chunk: lane `lane` holds
// columns 4 lane .. 4 lane + 3 in e[0..3].
__device__ __forceinline__ void chunk_ladder(float* e, int lane) {
  {  // shift 1
    const float p = from_below(e[3], 1, lane);
    e[3] = e[3] + e[2];
    e[2] = e[2] + e[1];
    e[1] = e[1] + e[0];
    e[0] = e[0] + p;
  }
  {  // shift 2
    const float p2 = from_below(e[2], 1, lane);
    const float p3 = from_below(e[3], 1, lane);
    e[3] = e[3] + e[1];
    e[2] = e[2] + e[0];
    e[1] = e[1] + p3;
    e[0] = e[0] + p2;
  }
  for (int d = 1; d <= 16; d <<= 1) {  // shifts 4, 8, 16, 32, 64
    for (int j = 0; j < 4; ++j) e[j] = e[j] + from_below(e[j], d, lane);
  }
}

// One warp: one row of one frame.  `carry` holds this warp's L floats of
// shared memory.
__device__ void resolve_row(const ResolveArgs& a, float* carry) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f = blockIdx.y;
  const int row = blockIdx.x * kResWarps + warp;
  if (row >= a.height) return;   // whole warps only: no shuffle is split
  for (int l = lane; l < a.layers; l += 32) carry[l] = 0.0f;
  __syncwarp();
  const size_t plane = static_cast<size_t>(a.height) * a.stride;
  const size_t row_off = static_cast<size_t>(row) * a.stride + 4 * lane;
  const int n_chunks = a.stride / kLane;
  for (int c = 0; c < n_chunks; ++c) {
    float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float al[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int l = 0; l < a.layers; ++l) {
      const size_t fl = static_cast<size_t>(f) * a.layers + l;
      const float4 d = *reinterpret_cast<const float4*>(
          a.delta + fl * plane + row_off + c * kLane);
      float e[4] = {d.x, d.y, d.z, d.w};
      chunk_ladder(e, lane);
      const float cin = carry[l];
      for (int j = 0; j < 4; ++j) e[j] = e[j] + cin;
      const float cout = __shfl_sync(0xffffffffu, e[3], 31);
      __syncwarp();
      if (lane == 0) carry[l] = cout;
      __syncwarp();
      const int rule = a.rules[l];
      const float* col = a.colors + fl * 4;
      const float cr = col[0], cg = col[1], cb = col[2], ca0 = col[3];
      for (int j = 0; j < 4; ++j) {
        over(ca0 * fill_cov(e[j], rule), cr, cg, cb, r[j], g[j], b[j],
             al[j]);
      }
    }
    float* out = a.out + static_cast<size_t>(f) * 4 * plane + row_off +
                 c * kLane;
    *reinterpret_cast<float4*>(out) = make_float4(r[0], r[1], r[2], r[3]);
    *reinterpret_cast<float4*>(out + plane) =
        make_float4(g[0], g[1], g[2], g[3]);
    *reinterpret_cast<float4*>(out + 2 * plane) =
        make_float4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<float4*>(out + 3 * plane) =
        make_float4(al[0], al[1], al[2], al[3]);
  }
}

}  // namespace swf
