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

template <int N, bool kSmooth, int kEdge>
__global__ void __launch_bounds__(kTexThreads) texfield_kernel(TexArgs a) {
  texfield_block<N, kSmooth, kEdge>(a);
}

// One block per (32 x 32 tile, frame); frames beyond the grid's z limit
// loop inside the blocks.
template <int N, bool kSmooth, int kEdge>
cudaError_t launch_texfield(const TexArgs& a, cudaStream_t stream) {
  const dim3 grid((a.width + kTexTileW - 1) / kTexTileW,
                  (a.height + kTexTileRows - 1) / kTexTileRows,
                  a.frames < kTexMaxGridZ ? a.frames : kTexMaxGridZ);
  texfield_kernel<N, kSmooth, kEdge><<<grid, kTexThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int N, bool kSmooth>
cudaError_t launch_edge(const TexArgs& a, cudaStream_t stream) {
  switch (tex_edge(a.repeating, a.canvas)) {
    case kTexRepeat:
      return launch_texfield<N, kSmooth, kTexRepeat>(a, stream);
    case kTexFlash:
      return launch_texfield<N, kSmooth, kTexFlash>(a, stream);
    default:
      return launch_texfield<N, kSmooth, kTexCanvas>(a, stream);
  }
}

template <int N>
cudaError_t launch_n(const TexArgs& a, cudaStream_t stream) {
  return a.smoothed ? launch_edge<N, true>(a, stream)
                    : launch_edge<N, false>(a, stream);
}

// The instantiation for a.n: unrolled for 1, 2 and 4, run-time loops
// (N = 0) for any other supersample.
cudaError_t launch_any(const TexArgs& a, cudaStream_t stream) {
  switch (a.n) {
    case 1: return launch_n<1>(a, stream);
    case 2: return launch_n<2>(a, stream);
    case 4: return launch_n<4>(a, stream);
    default: return launch_n<0>(a, stream);
  }
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
      n > swf::kTexMaxN ||
      (height + swf::kTexTileRows - 1) / swf::kTexTileRows > 65535) {
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
  return static_cast<int>(swf::launch_any(a, s));
}

}  // extern "C"
