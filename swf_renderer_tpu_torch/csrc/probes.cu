// Streaming probes for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (tools/exp_bw.py, tools/exp_scatter.py): the strided
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
  passthrough_block(a);
}

__global__ void __launch_bounds__(kProbeThreads)
read_sum_kernel(ProbeArgs a) {
  read_sum_block(a);
}

// Grid x = the n_s blocks of a row (up to 2^31 - 1), y = the n_f rows
// (up to 65535); strides and the tile in floats, multiples of 4 (16-byte
// vectors on 16-byte aligned pointers).
bool valid(const void* x, const void* out, int n_f, int n_s, int n_l,
           int tile, long long sf, long long ss, long long sl) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<size_t>(p) & 15) == 0;
  };
  return n_f >= 1 && n_f <= 65535 && n_s >= 1 && n_l >= 1 && tile >= 4 &&
         tile % 4 == 0 && sf % 4 == 0 && ss % 4 == 0 && sl % 4 == 0 &&
         aligned(x) && aligned(out);
}

}  // namespace swf

extern "C" {

// out (x's layout) = x + 1: block (s, f) over x[f*sf + s*ss + l*sl + i],
// l < n_l, i < tile.
int swf_passthrough(const void* x, void* out, int n_f, int n_s, int n_l,
                    int tile, long long sf, long long ss, long long sl,
                    void* stream) {
  if (!swf::valid(x, out, n_f, n_s, n_l, tile, sf, ss, sl)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swf::ProbeArgs a = {};
  a.x = static_cast<const float*>(x);
  a.out = static_cast<float*>(out);
  a.n_l = n_l;
  a.tile = tile;
  a.sf = sf;
  a.ss = ss;
  a.sl = sl;
  swf::passthrough_kernel<<<dim3(n_s, n_f), swf::kProbeThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out[f*of + s*os + i] = sum over l < n_l, left to right, of
// x[f*sf + s*ss + l*sl + i], i < tile.
int swf_read_sum(const void* x, void* out, int n_f, int n_s, int n_l,
                 int tile, long long sf, long long ss, long long sl,
                 long long of, long long os, void* stream) {
  if (!swf::valid(x, out, n_f, n_s, n_l, tile, sf, ss, sl) || of % 4 != 0 ||
      os % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swf::ProbeArgs a = {};
  a.x = static_cast<const float*>(x);
  a.out = static_cast<float*>(out);
  a.n_l = n_l;
  a.tile = tile;
  a.sf = sf;
  a.ss = ss;
  a.sl = sl;
  a.of = of;
  a.os = os;
  swf::read_sum_kernel<<<dim3(n_s, n_f), swf::kProbeThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
