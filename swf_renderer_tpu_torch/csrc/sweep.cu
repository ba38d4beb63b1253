// Animation sweep kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (ops/transform.py, ops/morph.py).  The device
// logic and its design notes live in sweep_device.cuh.
//
// Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libswfsweep.so sweep.cu
//
// The entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include "sweep_device.cuh"

namespace swf {

template <bool kMorph, bool kAffine>
__global__ void __launch_bounds__(kSweepChunk) sweep_bounds_kernel(
    SweepArgs a) {
  __shared__ float red[2 * kSweepChunk];
  sweep_bounds_block<kMorph, kAffine>(a, red);
}

template <bool kMorph, bool kAffine, bool kStyled>
__global__ void __launch_bounds__(kThreads) sweep_kernel(SweepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  sweep_block<kMorph, kAffine, kStyled>(a, smem);
}

template <bool kMorph, bool kAffine, bool kStyled>
cudaError_t launch_sweep(SweepArgs a, cudaStream_t stream) {
  a.rows = sweep_tile_rows(a.layers);
  const size_t bytes = sweep_smem_bytes(a.layers, a.rows, kStyled);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<kMorph, kAffine, kStyled>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  sweep_bounds_kernel<kMorph, kAffine>
      <<<dim3(a.n_chunks, a.layers, a.frames), kSweepChunk, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((a.width + kLane - 1) / kLane,
                  (a.height + a.rows - 1) / a.rows, a.frames);
  sweep_kernel<kMorph, kAffine, kStyled><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace swf

extern "C" {

// mode 0: affine sweep (styled when pint is not null); mode 1: morph +
// affine sweep; mode 2: morph ratio sweep (no matrices).  Tables are
// (L, 4, EP) f32; bounds is scratch of F * L * ceil(EP / 64) * 2 floats;
// out is (F, H, W) int32 holding packed u32 RGBA.
int swf_sweep(int mode, const void* mats, const void* tab_s,
              const void* tab_e, const void* ratios, const void* colors,
              const void* colors_e, const void* counts, const void* rules,
              const void* pint, const void* pflt, const void* grad_mats,
              const void* stop_colors, const void* fields, void* bounds,
              void* out,
              int frames, int layers, int ep, int height, int width,
              int mats_per_layer, int colors_per_frame, int n_stop_slots,
              void* stream) {
  // Grid y and z (row bands, frames) are limited to 65535 blocks.
  if (mode < 0 || mode > 2 || layers < 1 || layers > swf::kMaxLayers ||
      frames < 1 || frames > 65535 || ep < 1 || height < 1 ||
      height > 65535 || width < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swf::SweepArgs a;
  a.mats = static_cast<const float*>(mats);
  a.tab_s = static_cast<const float*>(tab_s);
  a.tab_e = static_cast<const float*>(tab_e);
  a.ratios = static_cast<const float*>(ratios);
  a.colors = static_cast<const float*>(colors);
  a.colors_e = static_cast<const float*>(colors_e);
  a.counts = static_cast<const int*>(counts);
  a.rules = static_cast<const int*>(rules);
  a.pint = static_cast<const int*>(pint);
  a.pflt = static_cast<const float*>(pflt);
  a.grad_mats = static_cast<const float*>(grad_mats);
  a.stop_colors = static_cast<const float*>(stop_colors);
  a.fields = static_cast<const float*>(fields);
  a.bounds = static_cast<float*>(bounds);
  a.n_chunks = (ep + swf::kSweepChunk - 1) / swf::kSweepChunk;
  a.out = static_cast<int*>(out);
  a.frames = frames;
  a.layers = layers;
  a.ep = ep;
  a.height = height;
  a.width = width;
  a.rows = 1;
  a.mats_per_layer = mats_per_layer;
  a.colors_per_frame = colors_per_frame;
  a.n_stop_slots = n_stop_slots;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == 0) {
    err = pint != nullptr ? swf::launch_sweep<false, true, true>(a, s)
                          : swf::launch_sweep<false, true, false>(a, s);
  } else if (mode == 1) {
    err = swf::launch_sweep<true, true, false>(a, s);
  } else {
    err = swf::launch_sweep<true, false, false>(a, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
