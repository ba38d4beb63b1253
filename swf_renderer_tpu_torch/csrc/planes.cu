// The unfused flat-block pipeline for Hopper (sm_90a): placement into
// chunk-major planes and the two plane resolves, with a plain C interface
// loaded through ctypes (ops/flatblock.py place_blocks,
// resolve_planes_u32, resolve_planes_u32_dma).  The device logic and its
// design notes live in planes_device.cuh.
//
// Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libswfplanes.so planes.cu
//
// Every entry point launches on the caller's stream, does not synchronise,
// and returns the first CUDA error (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

#include "planes_device.cuh"

namespace swf {

__global__ void place_index_kernel(PlaceArgs a) {
  place_index(a, blockIdx.x * blockDim.x + threadIdx.x);
}

__global__ void __launch_bounds__(kThreads) place_kernel(PlaceArgs a) {
  extern __shared__ __align__(16) float plane_smem[];
  place_block(a, plane_smem);
}

__global__ void __launch_bounds__(kThreads) resolve_u32_kernel(PlanesArgs a) {
  extern __shared__ __align__(16) unsigned char resolve_smem[];
  resolve_u32_block(a, resolve_smem);
}

__global__ void __launch_bounds__(kDmaThreads) resolve_dma_kernel(
    PlanesArgs a) {
  extern __shared__ __align__(16) unsigned char dma_smem[];
  resolve_dma_block(a, dma_smem);
}

bool planes_shape_ok(int frames, int layers, int ns1, int n_chunks) {
  return frames >= 1 && frames <= 65535 && layers >= 1 && ns1 >= 2 &&
         n_chunks >= 1 && n_chunks * kStripH <= kPlaneRows;
}

PlanesArgs planes_args(const void* planes, const void* colors,
                       const void* rules, void* out, int frames, int layers,
                       int ns1, int n_chunks) {
  PlanesArgs a;
  a.planes = static_cast<const float*>(planes);
  a.colors = static_cast<const float*>(colors);
  a.rules = static_cast<const int*>(rules);
  a.out = static_cast<int*>(out);
  a.frames = frames;
  a.layers = layers;
  a.ns1 = ns1;
  a.n_chunks = n_chunks;
  a.prefixed = 1;
  a.depth = 1;
  return a;
}

}  // namespace swf

extern "C" {

// sidx/keep (nb,) int32, urc/ucm/uval (nb, 128) f32 in the packer's order;
// index: scratch of 2 * n_groups ints; out: (n_groups, 128, 128) f32 with
// n_groups = frames * layers * ns1.
int swf_place(const void* sidx, const void* keep, const void* urc,
              const void* ucm, const void* uval, void* index, void* out,
              int nb, int n_groups, int ns1, int step, void* stream) {
  if (nb < 0 || n_groups < 1 || ns1 < 1 || n_groups % ns1 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  swf::PlaceArgs a;
  a.sidx = static_cast<const int*>(sidx);
  a.keep = static_cast<const int*>(keep);
  a.urc = static_cast<const float*>(urc);
  a.ucm = static_cast<const float*>(ucm);
  a.uval = static_cast<const float*>(uval);
  a.first = static_cast<int*>(index);
  a.last = a.first + n_groups;
  a.out = static_cast<float*>(out);
  a.nb = nb;
  a.n_groups = n_groups;
  a.ns1 = ns1;
  a.step = step;
  cudaError_t err = cudaMemsetAsync(index, 0xff,
                                    sizeof(int) * 2 * static_cast<size_t>(
                                        n_groups), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb > 0) {
    swf::place_index_kernel<<<(nb + 255) / 256, 256, 0, s>>>(a);
  }
  const size_t bytes = sizeof(float) * swf::kPlaneRows * swf::kRowStride;
  err = cudaFuncSetAttribute(swf::place_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  swf::place_kernel<<<n_groups, swf::kThreads, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// planes (F, L, ns1, 128, 128) f32, colors (F, L, 4) f32, rules (L,) int32
// -> out (F, (ns1 - 1) * 8, n_chunks * 128) int32 packed u32 RGBA.
int swf_resolve_u32(const void* planes, const void* colors, const void* rules,
                    void* out, int frames, int layers, int ns1, int n_chunks,
                    int prefixed, void* stream) {
  const size_t bytes = swf::resolve_smem_bytes(layers);
  if (!swf::planes_shape_ok(frames, layers, ns1, n_chunks) ||
      bytes > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swf::PlanesArgs a = swf::planes_args(planes, colors, rules, out, frames,
                                       layers, ns1, n_chunks);
  a.prefixed = prefixed;
  cudaError_t err = cudaFuncSetAttribute(
      swf::resolve_u32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ns1 - 1, frames);
  swf::resolve_u32_kernel<<<grid, swf::kThreads, bytes,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The same function as swf_resolve_u32 on prefixed planes, through an
// n_buf-deep ring of bulk copies (planes and colours 16-byte aligned; the
// ring shallower where n_buf stages do not fit shared memory, refused
// where one does not).  Persistent blocks, as many as the SMs hold, each
// a run of (frame, strip) items of equal length give or take one.
int swf_resolve_u32_dma(const void* planes, const void* colors,
                        const void* rules, void* out, int frames, int layers,
                        int ns1, int n_chunks, int n_buf, void* stream) {
  const int depth = layers < 1 || n_buf < 1 ? 0
                                             : swf::dma_depth(layers, n_buf);
  if (!swf::planes_shape_ok(frames, layers, ns1, n_chunks) || depth < 1 ||
      reinterpret_cast<uintptr_t>(planes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(colors) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swf::PlanesArgs a = swf::planes_args(planes, colors, rules, out, frames,
                                       layers, ns1, n_chunks);
  a.depth = depth;
  const size_t bytes = depth * swf::dma_stage_bytes(layers) +
                       swf::dma_rest_bytes(layers, depth);
  cudaError_t err = cudaFuncSetAttribute(
      swf::resolve_dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, swf::resolve_dma_kernel, swf::kDmaThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = static_cast<long long>(frames) * (ns1 - 1);
  long long blocks = static_cast<long long>(sms) * (per_sm > 1 ? per_sm : 1);
  blocks = blocks < items ? blocks : items;
  swf::resolve_dma_kernel<<<static_cast<unsigned>(blocks), swf::kDmaThreads,
                            bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
