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
// Bound on this card: bytes — each input read once, each output written
// once, no arithmetic to speak of.  The design streams, and does not
// mirror the TPU's grid:
// - x + 1 is elementwise at the same index, and the TPU blocks of every
//   geometry the tools pass tile their contiguous array exactly once, so
//   the passthrough streams that array as one span of 16-byte vectors
//   whatever its layout (`passthrough_args` refuses a geometry that does
//   not tile the span): no block carries a 256 KB TPU block alone;
// - a block of 1024 threads a chunk of kProbeThreads * kPassUnroll
//   vectors, the last one masked: neighbouring threads on neighbouring
//   vectors, plain cached loads and stores.  On the H100 this beat the
//   TPU-shaped grid (256 threads, a block a TPU block) and every other
//   form tried: a persistent grid with eight loads a thread in flight
//   (streaming or not), a ring of bulk copies through shared memory,
//   streaming, read-only and prefetching cache hints, two or four
//   vectors a thread, 128-512 threads a block (PERF.md §6;
//   tools/probe_phases.py).  The grid-stride walk stays, so any grid
//   covers the span;
// - the read+sum runs on the same scheme over (tile, chunk of
//   kProbeThreads * kSumVectors output vectors) tasks: a thread loads the
//   kSumBatch inputs of each of its output vectors up front, then adds
//   them left to right in f32, ((x0 + x1) + x2) + x3, as the plain
//   version does.
// 64-bit offsets throughout: the bandwidth tool's span is 2.15 GB.

#pragma once

#include <stddef.h>

namespace swf {

constexpr int kProbeThreads = 1024;
constexpr int kPassUnroll = 1;   // vectors a thread loads before it stores
constexpr int kSumVectors = 2;   // output vectors a read+sum thread owns
constexpr int kSumBatch = 4;     // inputs of each loaded before the adds

struct ProbeArgs {
  const float* x;
  float* out;
  long long n4;      // vectors: of the span (passthrough), of a tile (sum)
  long long tasks;   // chunks of the grid's walk
  int n_s, n_l;      // read+sum: s of a row, sub-blocks L of a tile
  int chunks;        // read+sum: chunks of a tile
  long long sf, ss, sl;   // read+sum: strides (floats) of f, s, l in x
  long long of, os;       // read+sum: strides of f and s in out
};

// The probe tools' grid over x: n_f x n_s blocks of n_l tiles of `tile`
// floats at strides sf, ss, sl (floats).  True when those tiles cover
// [0, n_f * n_s * n_l * tile) exactly once, the dimensions of one block
// aside: sorted by stride, each stride is the span of the ones below it.
inline bool tiles_span(int n_f, int n_s, int n_l, long long tile,
                       long long sf, long long ss, long long sl) {
  const long long strides[3] = {sf, ss, sl};
  const int counts[3] = {n_f, n_s, n_l};
  long long st[3], n[3];
  int m = 0;
  for (int i = 0; i < 3; ++i) {
    if (counts[i] > 1) {
      st[m] = strides[i];
      n[m++] = counts[i];
    }
  }
  for (int i = 1; i < m; ++i) {   // insertion sort by stride
    for (int j = i; j > 0 && st[j] < st[j - 1]; --j) {
      const long long s = st[j], c = n[j];
      st[j] = st[j - 1];
      n[j] = n[j - 1];
      st[j - 1] = s;
      n[j - 1] = c;
    }
  }
  long long span = tile;
  for (int i = 0; i < m; ++i) {
    if (st[i] != span) return false;
    span *= n[i];
  }
  return true;
}

// The passthrough's arguments over the span of that grid; false when the
// tiles do not cover it exactly once.
inline bool passthrough_args(ProbeArgs& a, const float* x, float* out,
                             int n_f, int n_s, int n_l, int tile,
                             long long sf, long long ss, long long sl) {
  if (!tiles_span(n_f, n_s, n_l, tile, sf, ss, sl)) return false;
  constexpr long long kChunk = kProbeThreads * kPassUnroll;
  a = ProbeArgs{};
  a.x = x;
  a.out = out;
  a.n4 = static_cast<long long>(n_f) * n_s * n_l * (tile / 4);
  a.tasks = (a.n4 + kChunk - 1) / kChunk;
  return true;
}

// The read+sum's arguments: tasks of (tile, chunk); false when the tasks
// outnumber a 32-bit index.
inline bool read_sum_args(ProbeArgs& a, const float* x, float* out,
                          int n_f, int n_s, int n_l, int tile, long long sf,
                          long long ss, long long sl, long long of,
                          long long os) {
  constexpr int kChunk = kProbeThreads * kSumVectors;
  a = ProbeArgs{};
  a.x = x;
  a.out = out;
  a.n4 = tile / 4;
  a.chunks = static_cast<int>((a.n4 + kChunk - 1) / kChunk);
  a.tasks = static_cast<long long>(n_f) * n_s * a.chunks;
  a.n_s = n_s;
  a.n_l = n_l;
  a.sf = sf;
  a.ss = ss;
  a.sl = sl;
  a.of = of;
  a.os = os;
  return a.tasks <= 0x7fffffffLL;
}

// The 16-byte load and store of both kernels: plain, cached.
__device__ __forceinline__ float4 load_vec(const float4* p) { return *p; }

__device__ __forceinline__ void store_vec(float4* p, float4 v) { *p = v; }

__device__ __forceinline__ float4 add_one(float4 v) {
  v.x = v.x + 1.0f;
  v.y = v.y + 1.0f;
  v.z = v.z + 1.0f;
  v.w = v.w + 1.0f;
  return v;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  a.x = a.x + b.x;
  a.y = a.y + b.y;
  a.z = a.z + b.z;
  a.w = a.w + b.w;
  return a;
}

// out = x + 1 over the span; the block walks chunks blockIdx.x,
// blockIdx.x + gridDim.x, ... (one chunk on the launcher's grid).
__device__ __forceinline__ void passthrough_span(const ProbeArgs& a) {
  constexpr long long kChunk = kProbeThreads * kPassUnroll;
  const float4* __restrict__ src = reinterpret_cast<const float4*>(a.x);
  float4* __restrict__ dst = reinterpret_cast<float4*>(a.out);
  for (long long t = blockIdx.x; t < a.tasks; t += gridDim.x) {
    const long long i0 = t * kChunk + threadIdx.x;
    float4 v[kPassUnroll];
#pragma unroll
    for (int k = 0; k < kPassUnroll; ++k)
      if (i0 + k * kProbeThreads < a.n4)   // the last chunk is ragged
        v[k] = load_vec(src + i0 + k * kProbeThreads);
#pragma unroll
    for (int k = 0; k < kPassUnroll; ++k)
      if (i0 + k * kProbeThreads < a.n4)
        store_vec(dst + i0 + k * kProbeThreads, add_one(v[k]));
  }
}

// out[f, s] = x[f, s, 0] + x[f, s, 1] + ... + x[f, s, L - 1], per float,
// over tasks (tile f * n_s + s, chunk c).
__device__ __forceinline__ void read_sum_span(const ProbeArgs& a) {
  constexpr int kChunk = kProbeThreads * kSumVectors;
  const long long sl4 = a.sl / 4;
  for (long long t = blockIdx.x; t < a.tasks; t += gridDim.x) {
    const unsigned task = static_cast<unsigned>(t);
    const unsigned item = task / static_cast<unsigned>(a.chunks);
    const int c = static_cast<int>(task - item * a.chunks);
    const unsigned f = item / static_cast<unsigned>(a.n_s);
    const unsigned s = item - f * a.n_s;
    const float4* __restrict__ src =
        reinterpret_cast<const float4*>(a.x + f * a.sf + s * a.ss);
    float4* __restrict__ dst =
        reinterpret_cast<float4*>(a.out + f * a.of + s * a.os);
    long long idx[kSumVectors];
    bool ok[kSumVectors];
#pragma unroll
    for (int v = 0; v < kSumVectors; ++v) {
      idx[v] = static_cast<long long>(c) * kChunk + v * kProbeThreads +
               threadIdx.x;
      ok[v] = idx[v] < a.n4;
    }
    float4 acc[kSumVectors] = {};
    for (int l0 = 0; l0 < a.n_l; l0 += kSumBatch) {
      float4 in[kSumVectors][kSumBatch] = {};
#pragma unroll
      for (int v = 0; v < kSumVectors; ++v)
#pragma unroll
        for (int k = 0; k < kSumBatch; ++k)
          if (ok[v] && l0 + k < a.n_l)
            in[v][k] = load_vec(src + idx[v] + (l0 + k) * sl4);
#pragma unroll
      for (int v = 0; v < kSumVectors; ++v)
#pragma unroll
        for (int k = 0; k < kSumBatch; ++k)
          if (l0 + k < a.n_l)
            acc[v] = l0 + k == 0 ? in[v][k] : add4(acc[v], in[v][k]);
    }
#pragma unroll
    for (int v = 0; v < kSumVectors; ++v)
      if (ok[v]) store_vec(dst + idx[v], acc[v]);
  }
}

}  // namespace swf
