// Scanline resolve kernel for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (ops/resolve.py).  The device logic and its design
// notes live in resolve_device.cuh.
//
// Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libswfresolve.so resolve.cu
//
// The entry point launches on the caller's stream, does not synchronise,
// and returns the first CUDA error (0 on success).

#include <cuda_runtime.h>

#include "resolve_device.cuh"

namespace swf {

__global__ void __launch_bounds__(kResThreads) resolve_kernel(ResolveArgs a) {
  extern __shared__ float carries[];
  resolve_row(a, carries + (threadIdx.x >> 5) * a.layers);
}

}  // namespace swf

extern "C" {

// delta: (F, L, H, S) f32, S a multiple of 128, H of 8, 16-byte aligned;
// colors: (F, L, 4) f32; rules: (L,) i32; out: (F, 4, H, S) f32.
int swf_resolve(const void* delta, const void* colors, const void* rules,
                void* out, int frames, int layers, int height, int stride,
                void* stream) {
  const size_t smem = static_cast<size_t>(swf::kResWarps) * layers * 4;
  if (frames < 1 || frames > 65535 || layers < 1 || height < 1 ||
      height % swf::kStripH != 0 || stride < swf::kLane ||
      stride % swf::kLane != 0 || smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      swf::resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  swf::ResolveArgs a;
  a.delta = static_cast<const float*>(delta);
  a.colors = static_cast<const float*>(colors);
  a.rules = static_cast<const int*>(rules);
  a.out = static_cast<float*>(out);
  a.frames = frames;
  a.layers = layers;
  a.height = height;
  a.stride = stride;
  const dim3 grid(height / swf::kStripH, frames);
  swf::resolve_kernel<<<grid, swf::kResThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
