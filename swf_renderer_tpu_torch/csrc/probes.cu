// Streaming probes for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (tools/exp_bw.py, tools/exp_scatter.py): the
// passthrough (x + 1) and the read+sum over L.  The device logic and its
// design notes live in probes_device.cuh.
//
// Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libswfprobes.so probes.cu
//
// Every entry point launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include "probes_device.cuh"

namespace swf {

__global__ void __launch_bounds__(kProbeThreads)
passthrough_kernel(ProbeArgs a) {
  passthrough_span(a);
}

__global__ void __launch_bounds__(kProbeThreads)
read_sum_kernel(ProbeArgs a) {
  read_sum_span(a);
}

// Strides and the tile in floats, multiples of 4 (16-byte vectors on
// 16-byte aligned pointers).
bool valid(const void* x, const void* out, int n_f, int n_s, int n_l,
           int tile, long long sf, long long ss, long long sl) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<size_t>(p) & 15) == 0;
  };
  return n_f >= 1 && n_s >= 1 && n_l >= 1 && tile >= 4 && tile % 4 == 0 &&
         sf % 4 == 0 && ss % 4 == 0 && sl % 4 == 0 && aligned(x) &&
         aligned(out);
}

// A block a task; the grid-stride walk covers what a grid of 2^31 - 1
// blocks does not.
int grid_for(long long tasks) {
  constexpr long long kMaxGrid = 0x7fffffffLL;
  return static_cast<int>(tasks < kMaxGrid ? tasks : kMaxGrid);
}

}  // namespace swf

extern "C" {

// out (x's layout) = x + 1, x the n_f x n_s blocks of n_l tiles of `tile`
// floats at x[f*sf + s*ss + l*sl + i]; those tiles must cover the
// contiguous span of x exactly once (any order), which is streamed.
int swf_passthrough(const void* x, void* out, int n_f, int n_s, int n_l,
                    int tile, long long sf, long long ss, long long sl,
                    void* stream) {
  swf::ProbeArgs a;
  if (!swf::valid(x, out, n_f, n_s, n_l, tile, sf, ss, sl) ||
      !swf::passthrough_args(a, static_cast<const float*>(x),
                             static_cast<float*>(out), n_f, n_s, n_l, tile,
                             sf, ss, sl)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swf::passthrough_kernel<<<swf::grid_for(a.tasks), swf::kProbeThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out[f*of + s*os + i] = sum over l < n_l, left to right, of
// x[f*sf + s*ss + l*sl + i], i < tile.
int swf_read_sum(const void* x, void* out, int n_f, int n_s, int n_l,
                 int tile, long long sf, long long ss, long long sl,
                 long long of, long long os, void* stream) {
  swf::ProbeArgs a;
  if (!swf::valid(x, out, n_f, n_s, n_l, tile, sf, ss, sl) || of % 4 != 0 ||
      os % 4 != 0 ||
      !swf::read_sum_args(a, static_cast<const float*>(x),
                          static_cast<float*>(out), n_f, n_s, n_l, tile, sf,
                          ss, sl, of, os)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swf::read_sum_kernel<<<swf::grid_for(a.tasks), swf::kProbeThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
