// Device logic of the card's streaming probes: the reference's HBM
// bandwidth tool and its grid-step probe.
//
// Replaces the TPU kernels `passthrough.<locals>.kernel` (tools/
// exp_bw.py:63, pallas_call :67: x + 1 over (1, L, 1, 128, 128) blocks of
// an (F, L, NS, 128, 128) array or (1, 1, L, 128, 128) blocks of its
// (F, NS, L, 128, 128) transpose), `kernel4` (:84, pallas_call :88: the
// sum over L of each (f, s) block of the transpose) and
// `exp_D.<locals>.kernel` (tools/exp_scatter.py:121, pallas_call :128:
// x + 1 on (steps, 8, 128), one grid step an (8, 128) tile).
//
// Design.  A TPU grid step is one CUDA block here: block (blockIdx.x =
// s, blockIdx.y = f) owns the L sub-blocks of `tile` floats that the
// reference's block holds, at the strides of either layout, and its
// threads stream them as 16-byte vectors (neighbouring threads on
// neighbouring addresses).  The read+sum adds the L sub-blocks left to
// right in f32, as its plain version does.  Bound on this card: bytes —
// each input read once, each output written once, no arithmetic to
// speak of; what the probes measure is how close a plain streaming
// kernel comes to the 3.35 TB/s data sheet rate, and the cost of one
// block of the grid.

#pragma once

#include <stddef.h>

namespace swf {

constexpr int kProbeThreads = 256;

struct ProbeArgs {
  const float* x;
  float* out;
  int n_l;                 // sub-blocks of a block (L)
  int tile;                // floats of a sub-block, a multiple of 4
  long long sf, ss, sl;    // strides (floats) of f, s and l in x
  long long of, os;        // read+sum: strides of f and s in out
};

// out = x + 1 over the block's L sub-blocks; out has x's layout.
__device__ __forceinline__ void passthrough_block(const ProbeArgs& a) {
  const long long base = blockIdx.y * a.sf + blockIdx.x * a.ss;
  const int n4 = a.tile / 4;
  for (int l = 0; l < a.n_l; ++l) {
    const float4* src =
        reinterpret_cast<const float4*>(a.x + base + l * a.sl);
    float4* dst = reinterpret_cast<float4*>(a.out + base + l * a.sl);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      float4 v = src[i];
      v.x = v.x + 1.0f;
      v.y = v.y + 1.0f;
      v.z = v.z + 1.0f;
      v.w = v.w + 1.0f;
      dst[i] = v;
    }
  }
}

// out[f, s] = x[f, s, 0] + x[f, s, 1] + ... + x[f, s, L - 1], per float.
__device__ __forceinline__ void read_sum_block(const ProbeArgs& a) {
  const long long base = blockIdx.y * a.sf + blockIdx.x * a.ss;
  float4* dst =
      reinterpret_cast<float4*>(a.out + blockIdx.y * a.of + blockIdx.x * a.os);
  const int n4 = a.tile / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    float4 acc = reinterpret_cast<const float4*>(a.x + base)[i];
    for (int l = 1; l < a.n_l; ++l) {
      const float4 v =
          reinterpret_cast<const float4*>(a.x + base + l * a.sl)[i];
      acc.x = acc.x + v.x;
      acc.y = acc.y + v.y;
      acc.z = acc.z + v.z;
      acc.w = acc.w + v.w;
    }
    dst[i] = acc;
  }
}

}  // namespace swf
