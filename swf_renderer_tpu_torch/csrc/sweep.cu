// Animation sweep kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (ops/transform.py, ops/morph.py): the column
// tiling (swf_sweep_shift: B3 affine, B6 morph + affine, B7 morph ratio,
// all tile_sweep_block, at a tile shard's origin), the row-band tiling
// (swf_sweep_rows, B4,
// tile_sweep_block) and the compacted tiling (swf_sweep_compact, B5,
// bin_sweep_block).
// The device logic and its design notes live in sweep_device.cuh.
//
// Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libswfsweep.so sweep.cu
//
// The entry points launch on the caller's stream, do not synchronise,
// and return cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include "sweep_device.cuh"

namespace swf {

template <bool kMorph, bool kAffine>
__global__ void __launch_bounds__(kThreads) fine_bounds_kernel(SweepArgs a) {
  __shared__ float red[2 * kThreads];
  fine_bounds_block<kMorph, kAffine>(a, red);
}

// The column sweeps: B3 affine (solid: layer class kLc; styled), B6
// morph + affine and B7 morph ratio (solid).
template <bool kMorph, bool kAffine, bool kStyled, int kLc>
__global__ void __launch_bounds__(kThreads, tile_min_blocks(kStyled, kLc))
    sweep_tile_kernel(SweepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  tile_sweep_block<kMorph, kAffine, kStyled, kLc, kLane>(a, smem);
}

// B4: the row bands.
template <bool kMorph, bool kAffine, bool kStyled, int kLc>
__global__ void __launch_bounds__(kThreads, tile_min_blocks(kStyled, kLc))
    sweep_rows_kernel(SweepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  tile_sweep_block<kMorph, kAffine, kStyled, kLc, kRowChunk>(a, smem);
}

// B5: the compacted bins (solid: layer class kLc; styled).
template <bool kStyled, int kLc>
__global__ void __launch_bounds__(kThreads, tile_min_blocks(kStyled, kLc))
    sweep_bin_kernel(SweepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bin_sweep_block<kStyled, kLc>(a, smem);
}

// The column sweeps (kTileW = kLane: a block a run of 128-column tiles,
// tile_run) and B4 (kTileW = kRowChunk: a block a band of rows), after
// the pre-pass of kFineChunk-piece bounds; the solid forms in the layer
// class of B1 (4 up to four layers, else 16).
template <bool kMorph, bool kAffine, bool kStyled, int kLc, int kTileW>
cudaError_t launch_tiles(SweepArgs a, cudaStream_t stream) {
  constexpr bool kBand = kTileW != kLane;
  a.rows = tile_rows(a.layers, kTileW);
  a.n_chunks = (a.ep + kFineChunk - 1) / kFineChunk;
  const size_t bytes = tile_smem_bytes(a.layers, a.rows, kTileW, kStyled);
  void (*kernel)(SweepArgs);
  if constexpr (kBand) {
    kernel = sweep_rows_kernel<kMorph, kAffine, kStyled, kLc>;
  } else {
    kernel = sweep_tile_kernel<kMorph, kAffine, kStyled, kLc>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  fine_bounds_kernel<kMorph, kAffine>
      <<<dim3((a.ep + kThreads - 1) / kThreads, a.layers, a.frames),
         kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int bands = (a.height + a.rows - 1) / a.rows;
  const int tiles = (a.width + kLane - 1) / kLane;
  a.bins_per_block = kBand ? 1 : tile_run(a.frames, bands, tiles);
  const dim3 grid(kBand ? 1 : (tiles + a.bins_per_block - 1)
                                  / a.bins_per_block,
                  bands, a.frames);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <bool kMorph, bool kAffine, bool kStyled, int kTileW>
cudaError_t launch_tiles_lc(SweepArgs a, cudaStream_t stream) {
  if constexpr (kStyled) {   // layer by layer at any count
    return launch_tiles<kMorph, kAffine, true, kMaxLayers, kTileW>(a,
                                                                   stream);
  } else {
    if (solid_layer_class(a.layers) != kSolidSmallLayers) {
      return launch_tiles<kMorph, kAffine, false, kMaxLayers, kTileW>(
          a, stream);
    }
    return launch_tiles<kMorph, kAffine, false, kSolidSmallLayers, kTileW>(
        a, stream);
  }
}

// B5 over compact_pre's tables: 128-column tiles of tile_rows rows, a
// block bins_per_block bins of its band.
template <bool kStyled, int kLc>
cudaError_t launch_bins(SweepArgs a, cudaStream_t stream) {
  a.rows = tile_rows(a.layers, kLane);
  a.n_chunks = a.cap / kFineChunk;
  const size_t bytes = tile_smem_bytes(a.layers, a.rows, kLane, kStyled);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_bin_kernel<kStyled, kLc>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_bins + a.bins_per_block - 1) / a.bins_per_block,
                  (a.height + a.rows - 1) / a.rows, a.frames);
  sweep_bin_kernel<kStyled, kLc><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// The layer class as launch_tiles_lc picks it.
inline cudaError_t launch_bins_lc(SweepArgs a, bool styled,
                                  cudaStream_t stream) {
  if (styled) return launch_bins<true, kMaxLayers>(a, stream);
  if (solid_layer_class(a.layers) != kSolidSmallLayers) {
    return launch_bins<false, kMaxLayers>(a, stream);
  }
  return launch_bins<false, kSolidSmallLayers>(a, stream);
}

// The arguments every entry point shares.
inline SweepArgs sweep_args(const void* colors, const void* rules,
                            const void* pint, const void* pflt,
                            const void* grad_mats, const void* stop_colors,
                            const void* fields, void* out, int frames,
                            int layers, int height, int width,
                            int colors_per_frame, int n_stop_slots) {
  SweepArgs a{};
  a.colors = static_cast<const float*>(colors);
  a.rules = static_cast<const int*>(rules);
  a.pint = static_cast<const int*>(pint);
  a.pflt = static_cast<const float*>(pflt);
  a.grad_mats = static_cast<const float*>(grad_mats);
  a.stop_colors = static_cast<const float*>(stop_colors);
  a.fields = static_cast<const float*>(fields);
  a.out = static_cast<int*>(out);
  a.frames = frames;
  a.layers = layers;
  a.height = height;
  a.width = width;
  a.rows = 1;
  a.colors_per_frame = colors_per_frame;
  a.n_stop_slots = n_stop_slots;
  a.n_bins = 1;
  a.bins_per_block = 1;
  return a;
}

// Grid y and z (row bands, frames) are limited to 65535 blocks.
inline bool sweep_shape_ok(int layers, int frames, int height, int width) {
  return layers >= 1 && layers <= kMaxLayers && frames >= 1 &&
         frames <= 65535 && height >= 1 && height <= 65535 && width >= 1;
}

}  // namespace swf

extern "C" {

// The column sweeps.  mode 0: affine sweep (styled when pint is not
// null); mode 1: morph + affine sweep; mode 2: morph ratio sweep (no
// matrices).  Tables are (L, 4, EP) f32; bounds is scratch of F * L *
// ceil(EP / 16) * 2 floats; out is (F, H, W) int32 holding packed u32
// RGBA.  Frame column c is column c + x_shift of the global pixel grid (0
// for a whole frame, a tile shard's first column of a wider one;
// |x_shift| and x_shift + width below 2^24).
int swf_sweep_shift(int mode, const void* mats, const void* tab_s,
                    const void* tab_e, const void* ratios,
                    const void* colors, const void* colors_e,
                    const void* counts, const void* rules, const void* pint,
                    const void* pflt, const void* grad_mats,
                    const void* stop_colors, const void* fields,
                    void* bounds, void* out, int frames, int layers, int ep,
                    int height, int width, int mats_per_layer,
                    int colors_per_frame, int n_stop_slots, int x_shift,
                    void* stream) {
  if (mode < 0 || mode > 2 || ep < 1 ||
      !swf::sweep_shape_ok(layers, frames, height, width) ||
      x_shift <= -(1 << 24) || x_shift >= (1 << 24) - width) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swf::SweepArgs a = swf::sweep_args(
      colors, rules, pint, pflt, grad_mats, stop_colors, fields, out, frames,
      layers, height, width, colors_per_frame, n_stop_slots);
  a.mats = static_cast<const float*>(mats);
  a.tab_s = static_cast<const float*>(tab_s);
  a.tab_e = static_cast<const float*>(tab_e);
  a.ratios = static_cast<const float*>(ratios);
  a.colors_e = static_cast<const float*>(colors_e);
  a.counts = static_cast<const int*>(counts);
  a.bounds = static_cast<float*>(bounds);
  a.ep = ep;
  a.mats_per_layer = mats_per_layer;
  a.x_shift = x_shift;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == 0) {
    err = pint != nullptr
        ? swf::launch_tiles_lc<false, true, true, swf::kLane>(a, s)
        : swf::launch_tiles_lc<false, true, false, swf::kLane>(a, s);
  } else if (mode == 1) {
    err = swf::launch_tiles_lc<true, true, false, swf::kLane>(a, s);
  } else {
    err = swf::launch_tiles_lc<true, false, false, swf::kLane>(a, s);
  }
  return static_cast<int>(err);
}

// swf_sweep_shift of a whole frame (x_shift 0), under the signature of
// the builds before the origin, so that their libraries and this one
// bind alike (chip_smoke.py --parent times both).
int swf_sweep(int mode, const void* mats, const void* tab_s,
              const void* tab_e, const void* ratios, const void* colors,
              const void* colors_e, const void* counts, const void* rules,
              const void* pint, const void* pflt, const void* grad_mats,
              const void* stop_colors, const void* fields, void* bounds,
              void* out,
              int frames, int layers, int ep, int height, int width,
              int mats_per_layer, int colors_per_frame, int n_stop_slots,
              void* stream) {
  return swf_sweep_shift(mode, mats, tab_s, tab_e, ratios, colors, colors_e,
                         counts, rules, pint, pflt, grad_mats, stop_colors,
                         fields, bounds, out, frames, layers, ep, height,
                         width, mats_per_layer, colors_per_frame,
                         n_stop_slots, 0, stream);
}

// The row-band sweep (B4) over swf_sweep's arguments; mode 0: affine
// (styled when pint is not null), mode 1: morph + affine.  A band sweeps
// the width in kRowChunk-column chunks.
int swf_sweep_rows(int mode, const void* mats, const void* tab_s,
                   const void* tab_e, const void* ratios, const void* colors,
                   const void* colors_e, const void* counts,
                   const void* rules, const void* pint, const void* pflt,
                   const void* grad_mats, const void* stop_colors,
                   const void* fields, void* bounds, void* out, int frames,
                   int layers, int ep, int height, int width,
                   int mats_per_layer, int colors_per_frame,
                   int n_stop_slots, void* stream) {
  if (mode < 0 || mode > 1 || ep < 1 || (mode == 1 && pint != nullptr) ||
      !swf::sweep_shape_ok(layers, frames, height, width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swf::SweepArgs a = swf::sweep_args(
      colors, rules, pint, pflt, grad_mats, stop_colors, fields, out, frames,
      layers, height, width, colors_per_frame, n_stop_slots);
  a.mats = static_cast<const float*>(mats);
  a.tab_s = static_cast<const float*>(tab_s);
  a.tab_e = static_cast<const float*>(tab_e);
  a.ratios = static_cast<const float*>(ratios);
  a.colors_e = static_cast<const float*>(colors_e);
  a.counts = static_cast<const int*>(counts);
  a.bounds = static_cast<float*>(bounds);
  a.ep = ep;
  a.mats_per_layer = mats_per_layer;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == 1) {
    err = swf::launch_tiles_lc<true, true, false, swf::kRowChunk>(a, s);
  } else {
    err = pint != nullptr
        ? swf::launch_tiles_lc<false, true, true, swf::kRowChunk>(a, s)
        : swf::launch_tiles_lc<false, true, false, swf::kRowChunk>(a, s);
  }
  return static_cast<int>(err);
}

// The compacted sweep (B5) over compact_pre's tables: ctab (F, NB, L, 4,
// cap) f32 device-space pieces, ccount (F, NB, L) i32, cbounds (F, NB, L,
// cap / 16, 2) f32 row bounds of 16-slot chunks, prefix (F, L, NB, H)
// i64; bins of bin_w <= 256 columns, bins_per_block of them walked by one
// block in turn.  Styled when pint is not null.
int swf_sweep_compact(const void* colors, const void* rules,
                      const void* pint, const void* pflt,
                      const void* grad_mats, const void* stop_colors,
                      const void* fields, const void* ctab,
                      const void* ccount, const void* cbounds,
                      const void* prefix, void* out, int frames, int layers,
                      int height, int width, int cap, int n_bins, int bin_w,
                      int bins_per_block, int colors_per_frame,
                      int n_stop_slots, void* stream) {
  if (cap < swf::kFineChunk || cap % swf::kFineChunk != 0 || bin_w < 1 ||
      bin_w > 256 || n_bins != (width + bin_w - 1) / bin_w ||
      bins_per_block < 1 ||
      !swf::sweep_shape_ok(layers, frames, height, width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swf::SweepArgs a = swf::sweep_args(
      colors, rules, pint, pflt, grad_mats, stop_colors, fields, out, frames,
      layers, height, width, colors_per_frame, n_stop_slots);
  a.ctab = static_cast<const float*>(ctab);
  a.ccount = static_cast<const int*>(ccount);
  a.cbounds = static_cast<const float*>(cbounds);
  a.prefix = static_cast<const long long*>(prefix);
  a.cap = cap;
  a.n_bins = n_bins;
  a.bin_w = bin_w;
  a.bins_per_block = bins_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(swf::launch_bins_lc(a, pint != nullptr, s));
}

}  // extern "C"
