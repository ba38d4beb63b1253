// Texfield kernel for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (ops/texfield.py).  The device logic and its design
// notes live in texfield_device.cuh.
//
// Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libswftexfield.so texfield.cu
//
// The entry point launches on the caller's stream, does not synchronise,
// and returns the first CUDA error (0 on success).

#include <cuda_runtime.h>

#include "texfield_device.cuh"

namespace swf {

__global__ void __launch_bounds__(kTexThreads) texprep_kernel(TexArgs a) {
  const int i = blockIdx.x * kTexThreads + threadIdx.x;
  if (i < a.th * a.tw) texprep_texel(a, i);
}

__global__ void __launch_bounds__(kTexThreads) texfield_kernel(TexArgs a) {
  texfield_block(a);
}

// Persistent grid: as many blocks as can be resident at once, at most
// one per (frame, tile) item.
cudaError_t launch_texfield(const TexArgs& a, cudaStream_t stream) {
  cudaError_t err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, texfield_kernel, kTexThreads, 0);
  if (err != cudaSuccess) return err;
  const long long tiles =
      static_cast<long long>((a.width + kTexTileW - 1) / kTexTileW) *
      ((a.height + kTexTileH - 1) / kTexTileH) * a.frames;
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > tiles) blocks = tiles;
  texfield_kernel<<<static_cast<unsigned>(blocks), kTexThreads, 0, stream>>>(
      a);
  return cudaGetLastError();
}

}  // namespace swf

extern "C" {

// img: (Th, Tw, 4) u8; tex: scratch of Th * Tw * 4 floats; invs: (F, 6)
// f32; out: (F, H, W, 4) f32.  canvas: 0 clamps edge texels outward
// ("flash"), 1 reads transparent outside the image; ignored when
// repeating.
int swf_texfield(const void* img, void* tex, const void* invs, void* out,
                 int th, int tw, int frames, int height, int width, int n,
                 int repeating, int smoothed, int canvas, void* stream) {
  if (th < 1 || tw < 1 || static_cast<long long>(th) * tw > (1LL << 30) ||
      frames < 1 || height < 1 || width < 1 || n < 1 ||
      n > swf::kTexMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swf::TexArgs a;
  a.img = static_cast<const unsigned char*>(img);
  a.tex = static_cast<float4*>(tex);
  a.invs = static_cast<const float*>(invs);
  a.out = static_cast<float4*>(out);
  a.th = th;
  a.tw = tw;
  a.frames = frames;
  a.height = height;
  a.width = width;
  a.n = n;
  a.repeating = repeating;
  a.smoothed = smoothed;
  a.canvas = canvas;
  swf::tex_offsets(a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int texels = th * tw;
  swf::texprep_kernel<<<(texels + swf::kTexThreads - 1) / swf::kTexThreads,
                        swf::kTexThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(swf::launch_texfield(a, s));
}

}  // extern "C"
