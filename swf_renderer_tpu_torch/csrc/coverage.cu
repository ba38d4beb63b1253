// Direct coverage kernels for Hopper (sm_90a): banded (B9), tiled (B10)
// and grouped (B11), with a plain C interface
// loaded through ctypes (ops/coverage.py).  The device logic and its design
// notes live in coverage_device.cuh.
//
// Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libswfcoverage.so coverage.cu
//
// The entry points launch on the caller's stream, do not synchronise, and
// return the first CUDA error (0 on success).

#include <cuda_runtime.h>

#include "coverage_device.cuh"

namespace swf {

__global__ void __launch_bounds__(kCovThreads) banded_kernel(CoverageArgs a) {
  __shared__ BandedTerms s;
  banded_block(a, s);
}

__global__ void __launch_bounds__(kCovThreads) tiled_kernel(CoverageArgs a) {
  __shared__ TiledTerms s;
  tiled_block(a, s);
}

// Five blocks an SM (48 registers; shared memory holds no sixth): 7-8%
// faster than the four that 52 registers leave (PERF.md).
__global__ void __launch_bounds__(kCovThreads, 5) grouped_kernel(
    CoverageArgs a) {
  __shared__ GroupedTerms s;
  grouped_block(a, s);
}

inline bool coverage_args(CoverageArgs& a, const void* edges, void* out,
                          int planes, int n_edges, int height, int width,
                          int rule) {
  if (planes < 1 || planes > 65535 || n_edges < 1 || height < 1 ||
      width < 1 || (height + kCovTileH - 1) / kCovTileH > 65535 ||
      (rule != 0 && rule != 1)) {
    return false;
  }
  a.edges = static_cast<const float*>(edges);
  a.out = static_cast<float*>(out);
  a.planes = planes;
  a.n_edges = n_edges;
  a.height = height;
  a.width = width;
  a.tiles_y = (height + kCovTileH - 1) / kCovTileH;
  a.rule = rule;
  return true;
}

inline dim3 coverage_grid(const CoverageArgs& a) {
  return dim3((a.width + kCovTileW - 1) / kCovTileW, a.tiles_y, a.planes);
}

// B9's blocks a band (grid x): each walks `per` of the band's column
// tiles, per as large as leaves kBandMinBlocksPerSm blocks an SM.
inline unsigned banded_grid_x(unsigned tiles_x, unsigned bands) {
  int dev = 0, sms = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1) {
    (void)cudaGetLastError();   // not the launch's error
    sms = 1;
  }
  const unsigned long long want =
      static_cast<unsigned long long>(sms) * kBandMinBlocksPerSm;
  const unsigned long long all =
      static_cast<unsigned long long>(tiles_x) * bands;
  unsigned per = static_cast<unsigned>(all / want);
  per = per < 1 ? 1 : (per > tiles_x ? tiles_x : per);
  return (tiles_x + per - 1) / per;
}

}  // namespace swf

extern "C" {

// edges: (B, 4, E) f32 sorted by ymin, E <= 2048; ranges: (B, TY, 2) i32;
// out: (B, H, W) f32.
int swf_coverage_banded(const void* edges, const void* ranges, void* out,
                        int planes, int n_edges, int height, int width,
                        int rule, void* stream) {
  swf::CoverageArgs a{};
  if (n_edges > swf::kCovEdgeCap ||
      !swf::coverage_args(a, edges, out, planes, n_edges, height, width,
                          rule)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.ranges = static_cast<const int*>(ranges);
  dim3 grid = swf::coverage_grid(a);
  grid.x = swf::banded_grid_x(grid.x, grid.y * grid.z);
  swf::banded_kernel<<<grid, swf::kCovThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// edges: (B, 4, E) f32 sorted by ymin, E a multiple of 128; bounds:
// (B, E / 128, 2) f32; out: (B, H, W) f32.
int swf_coverage_tiled(const void* edges, const void* bounds, void* out,
                       int planes, int n_edges, int height, int width,
                       int rule, void* stream) {
  swf::CoverageArgs a{};
  if (n_edges % swf::kCovBlock != 0 ||
      !swf::coverage_args(a, edges, out, planes, n_edges, height, width,
                          rule)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.bounds = static_cast<const float*>(bounds);
  swf::tiled_kernel<<<swf::coverage_grid(a), swf::kCovThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// edges: (B, 4, E) f32 sorted by ymin, E a multiple of 128; bounds:
// (B, E / 128, 2) f32; out: (B, H, W) f32.  Strips of 8 rows, two a
// block.
int swf_coverage_grouped(const void* edges, const void* bounds, void* out,
                         int planes, int n_edges, int height, int width,
                         int rule, void* stream) {
  swf::CoverageArgs a{};
  if (n_edges % swf::kCovBlock != 0 ||
      !swf::coverage_args(a, edges, out, planes, n_edges, height, width,
                          rule)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.bounds = static_cast<const float*>(bounds);
  swf::grouped_kernel<<<swf::coverage_grid(a), swf::kCovThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
