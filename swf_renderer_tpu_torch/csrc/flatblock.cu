// Fused flat-block kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (ops/flatblock.py): the solid grouped kernel
// (render_fused_blocksn), the styled one (render_fused_styled: single
// pass, and the chain, background-seeded, premultiplied-output and
// mask-group modes of deep and masked draw lists) and the one-block-per-
// step form (render_fused_blocks); the variants of the solid kernel that
// tools/exp_split.py cuts it into and the reference's design tools place
// with a matrix product (swf_fused_variant, swf_fused_int8); the
// window-targeted form of tools/exp_winplace.py (swf_fused_win) and the
// coarse steps with explicit output copies of tools/exp_dma.py
// (swf_fused_coarse).  The device logic and its design notes live in
// flatblock_device.cuh and, for the product forms, place_mma_device.cuh,
// for the coarse steps coarse_device.cuh.
//
// Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libswfkernels.so flatblock.cu
//
// Every entry point launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "coarse_device.cuh"
#include "place_mma_device.cuh"   // includes flatblock_device.cuh

namespace swf {

// First and last group of every (frame, strip block) supergroup, from the
// packer's flags (bit0 first, bit1 last).  Padding groups carry neither.
__global__ void supergroup_index_kernel(const int* sidx, const int* flags,
                                        int ng, int layers, int ns1,
                                        int* first, int* last) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ng) return;
  const int fl = flags[i];
  if ((fl & 3) == 0) return;
  const int packed = sidx[i];
  const int sg = (packed / (layers * ns1)) * ns1 + packed % ns1;
  if (fl & 1) first[sg] = i;
  if (fl & 2) last[sg] = i;
}

// The same index from the sorted blocks of render_fused_blocks.
__global__ void block_index_kernel(const int* sidx, const int* keep,
                                   const int* last, int nb, int layers,
                                   int ns1, int n_sg, int* first,
                                   int* last_idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nb) {
    block_index(sidx, keep, last, i, layers, ns1, n_sg, first, last_idx);
  }
}

// B1 and its variants (the solid grouped kernel), the one-block form
// B13 among them (kVarOne): fused_block with the layer loops of the
// resolve unrolled to kLc >= layers.
template <int kVar, int kLc>
__global__ void __launch_bounds__(kThreads)
solid_flatblock_kernel(FusedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  fused_block<false, false, false, kVar, kLc>(a, smem);
}

// B2, the styled grouped kernel, in its modes (kChain, kPremul).
template <bool kChain, bool kPremul>
__global__ void __launch_bounds__(kThreads, kStyledMinBlocks)
styled_flatblock_kernel(FusedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  fused_block<true, kChain, kPremul>(a, smem);
}

// Zero the premultiplied output's padding rows (plane rows spp*n_chunks*8
// and up of every (frame, strip block, channel) plane) and its sentinel
// strip block NS, which no block of the kernel writes.
cudaError_t zero_premul_padding(const FusedArgs& a, int frames,
                                cudaStream_t stream) {
  const size_t lane_bytes = sizeof(float) * kLane;
  const size_t plane_bytes = lane_bytes * a.plane_rows;
  const size_t used = static_cast<size_t>(a.spp) * a.n_chunks * kStripH;
  cudaError_t err = cudaSuccess;
  if (used < static_cast<size_t>(a.plane_rows)) {
    err = cudaMemset2DAsync(
        reinterpret_cast<char*>(a.out_pm) + used * lane_bytes, plane_bytes,
        0, plane_bytes - used * lane_bytes,
        static_cast<size_t>(frames) * a.ns1 * 4, stream);
    if (err != cudaSuccess) return err;
  }
  const size_t strip_bytes = 4 * plane_bytes;
  return cudaMemset2DAsync(
      reinterpret_cast<char*>(a.out_pm) + (a.ns1 - 1) * strip_bytes,
      strip_bytes * a.ns1, 0, strip_bytes, frames, stream);
}

// Zero the packed-word output's sentinel strip block NS, which no block
// of the kernels writes, as the plain versions do (so no caller reads
// stale words there).
cudaError_t zero_sentinel_words(const FusedArgs& a, int frames,
                                cudaStream_t stream) {
  const size_t strip_bytes = sizeof(int) * static_cast<size_t>(a.spp) *
                             kStripH * a.n_chunks * kLane;
  return cudaMemset2DAsync(
      reinterpret_cast<char*>(a.out) + (a.ns1 - 1) * strip_bytes,
      strip_bytes * a.ns1, 0, strip_bytes, frames, stream);
}

// Fill sg_index (2 * frames * ns1 ints) with the supergroup index of the
// packer's flags and point a.sg_first / a.sg_last at it.
cudaError_t supergroup_index(FusedArgs& a, int frames, int* sg_index,
                             cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      sg_index, 0xff, sizeof(int) * 2 * static_cast<size_t>(frames) * a.ns1,
      stream);
  if (err != cudaSuccess) return err;
  int* first = sg_index;
  int* last = sg_index + static_cast<size_t>(frames) * a.ns1;
  if (a.ng > 0) {
    supergroup_index_kernel<<<(a.ng + 255) / 256, 256, 0, stream>>>(
        a.sidx, a.flags, a.ng, a.layers, a.ns1, first, last);
  }
  a.sg_first = first;
  a.sg_last = last;
  return cudaSuccess;
}

// Allow `bytes` of dynamic shared memory to kernel and launch it on grid.
cudaError_t launch_kernel(void (*kernel)(FusedArgs), const FusedArgs& a,
                          dim3 grid, size_t bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  if (grid.x > 0 && grid.y > 0 && grid.z > 0) {
    kernel<<<grid, kThreads, bytes, stream>>>(a);
  }
  return cudaGetLastError();
}

template <bool kStyled, bool kChain = false, bool kPremul = false,
          int kVar = kVarFull>
cudaError_t launch(FusedArgs a, int frames, int n_strips, int* sg_index,
                   cudaStream_t stream) {
  cudaError_t err = supergroup_index(a, frames, sg_index, stream);
  if (err != cudaSuccess) return err;
  a.spb = strips_per_block(a.layers, a.spp, kStyled);
  a.n_spg = (a.spp + a.spb - 1) / a.spb;
  size_t bytes = smem_bytes(a.layers, a.spb * kStripH, kStyled);
  if constexpr (kVar == kVarBatched) {
    bytes += batched_stage_bytes(a.group, a.kk);
    if (bytes > kSmemMax) return cudaErrorInvalidValue;
  }
  const dim3 grid(a.n_chunks * a.n_spg, n_strips, frames);
  if constexpr (!kStyled) {
    constexpr int kSmall = kSolidSmallLayers;
    return solid_layer_class(a.layers) == kSmall
               ? launch_kernel(solid_flatblock_kernel<kVar, kSmall>, a, grid,
                               bytes, stream)
               : launch_kernel(solid_flatblock_kernel<kVar, kMaxLayers>, a,
                               grid, bytes, stream);
  } else {
    static_assert(kVar == kVarFull, "the variants are of the solid kernel");
    if (kPremul) {
      err = zero_premul_padding(a, frames, stream);
      if (err != cudaSuccess) return err;
    }
    void (*kernel)(FusedArgs) = styled_flatblock_kernel<kChain, kPremul>;
    // Three blocks share an SM at 16 layers (strips_per_block): ask for
    // the largest shared-memory carve-out.
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    return launch_kernel(kernel, a, grid, bytes, stream);
  }
}

// The product forms (product_block: warpgroup products, N = 8 x the
// layers a pass); at four layers three blocks an SM by a register bound
// with one accumulator (80 registers for the layer-masked form, no
// spill; 2.79 against 3.47 ms at the 95 it takes unbounded on the H100,
// PERF.md), two with three.  The bf16 forms read a.uval (l0, l1, l2
// null), int8 its limbs.
template <int kVar, int kLc>
__global__ void __launch_bounds__(kThreads,
                                  ProductForm<kVar, kLc>::kMinBlocks)
product_kernel(FusedArgs a, const int8_t* l0, const int8_t* l1,
               const int8_t* l2) {
  extern __shared__ __align__(16) unsigned char smem[];
  product_block<kVar, kLc>(a, l0, l1, l2, smem);
}

template <int kVar, int kLc>
cudaError_t launch_product_lc(FusedArgs a, const int8_t* l0,
                              const int8_t* l1, const int8_t* l2,
                              int frames, int n_strips,
                              cudaStream_t stream) {
  const size_t bytes = product_smem_bytes<kVar, kLc>(a.layers);
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  const dim3 grid(a.n_chunks, n_strips, frames);
  void (*kernel)(FusedArgs, const int8_t*, const int8_t*, const int8_t*) =
      product_kernel<kVar, kLc>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  if (grid.x > 0 && grid.y > 0 && grid.z > 0) {
    kernel<<<grid, kThreads, bytes, stream>>>(a, l0, l1, l2);
  }
  return cudaGetLastError();
}

// A product form at the layer class of a.layers: one block of two
// warpgroups per (chunk, strip block, frame), one strip a plane; l0, l1,
// l2 the int8 form's limbs (null for the bf16 forms).
template <int kVar>
cudaError_t launch_product(FusedArgs a, const int8_t* l0, const int8_t* l1,
                           const int8_t* l2, int frames, int n_strips,
                           int* sg_index, cudaStream_t stream) {
  cudaError_t err = supergroup_index(a, frames, sg_index, stream);
  if (err != cudaSuccess) return err;
  return solid_layer_class(a.layers) == kSolidSmallLayers
             ? launch_product_lc<kVar, kSolidSmallLayers>(
                   a, l0, l1, l2, frames, n_strips, stream)
             : launch_product_lc<kVar, kMaxLayers>(a, l0, l1, l2, frames,
                                                   n_strips, stream);
}

// B1's body at one strip a plane over coarse steps, the layer loops of
// the resolve unrolled to kLc >= layers; kOne for coarse 1.
template <int kLc, bool kOne>
__global__ void __launch_bounds__(kThreads)
coarse_kernel(FusedArgs a, int coarse) {
  extern __shared__ __align__(16) unsigned char smem[];
  coarse_block<kLc, kOne>(a, coarse, smem);
}

// The coarse steps (coarse_device.cuh): one block per (chunk, step) of
// `coarse` groups, ng % coarse == 0, one strip a plane (a.spb 1).
template <int kLc>
cudaError_t launch_coarse(FusedArgs a, int coarse, int frames, int* sg_index,
                          cudaStream_t stream) {
  cudaError_t err = supergroup_index(a, frames, sg_index, stream);
  if (err != cudaSuccess) return err;
  void (*kernel)(FusedArgs, int) = coarse == 1 ? coarse_kernel<kLc, true>
                                               : coarse_kernel<kLc, false>;
  const size_t bytes = coarse_smem_bytes(a.layers);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(a.ng / coarse) * a.n_chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks > 0) {
    kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
        a, coarse);
  }
  return cudaGetLastError();
}

// The one-block-per-step form (B13): B1's solid body at kVarOne over
// blocks of 128 slots sorted by (frame, strip, layer), one CUDA block a
// (chunk, strip, frame); strip NS of every frame is zeroed.
cudaError_t launch_one(FusedArgs a, const int* keep, const int* last,
                       int frames, int* sg_index, cudaStream_t stream) {
  const size_t n_sg = static_cast<size_t>(frames) * a.ns1;
  cudaError_t err = cudaMemsetAsync(sg_index, 0xff, sizeof(int) * 2 * n_sg,
                                    stream);
  if (err != cudaSuccess) return err;
  a.sg_first = sg_index;
  a.sg_last = sg_index + n_sg;
  if (a.ng > 0) {
    block_index_kernel<<<(a.ng + 255) / 256, 256, 0, stream>>>(
        a.sidx, keep, last, a.ng, a.layers, a.ns1, static_cast<int>(n_sg),
        sg_index, sg_index + n_sg);
  }
  const size_t bytes = smem_bytes(a.layers, kStripH, false);
  const dim3 grid(a.n_chunks, a.ns1 - 1, frames);
  err = solid_layer_class(a.layers) == kSolidSmallLayers
            ? launch_kernel(solid_flatblock_kernel<kVarOne, kSolidSmallLayers>,
                            a, grid, bytes, stream)
            : launch_kernel(solid_flatblock_kernel<kVarOne, kMaxLayers>, a,
                            grid, bytes, stream);
  if (err != cudaSuccess) return err;
  const size_t row_bytes = sizeof(int) * kStripH * a.n_chunks * kLane;
  err = cudaMemset2DAsync(
      a.out + static_cast<size_t>(a.ns1 - 1) * kStripH * a.n_chunks * kLane,
      row_bytes * a.ns1, 0, row_bytes, frames, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace swf

extern "C" {

// styled == 0: the solid kernel (pint, pflt and fields unused);
// styled == 1: per-layer paints from pint/pflt (16-byte aligned, copied
// by cp.async), field planes f0..f3.
// mode (styled only): bit0 the chain composite, seeded from bg (F, ns1,
// 4, plane_rows, 128) premultiplied planes when bg is not null, with
// layers [mask_from:] a clip group's mask when mask_from >= 0; bit1
// (with bit0) premultiplied planes out.  sg_index: scratch of 2 * frames
// * ns1 ints.  out: (F, ns1, spp*8, n_chunks*128) int32 holding packed
// u32 RGBA, the sentinel strip block (index ns1 - 1) zeroed; or, mode
// bit1, (F, ns1, 4, plane_rows, 128) f32, zero in
// the padding rows and the sentinel strip block.
int swf_fused_flatblock(int styled, int mode, const void* sidx,
                        const void* flags, const void* lays, const void* urc,
                        const void* ucm, const void* uval,
                        const void* colors, const void* rules,
                        const void* pint, const void* pflt, const void* f0,
                        const void* f1, const void* f2, const void* f3,
                        const void* bg, void* sg_index, void* out, int ng,
                        int group, int frames, int layers, int ns1,
                        int n_chunks, int spp, int plane_rows, int mask_from,
                        void* stream) {
  const bool chain = (mode & 1) != 0;
  const bool premul = (mode & 2) != 0;
  // Grid y and z (strip blocks, frames) are limited to 65535 blocks.
  if (layers < 1 || layers > swf::kMaxLayers || spp < 1 || group < 1 ||
      n_chunks < 1 || ns1 < 1 || ns1 - 1 > 65535 || frames < 1 ||
      frames > 65535 || mode < 0 || mode > 3 || (premul && !chain) ||
      (mode != 0 && !styled) || (!chain && (bg != nullptr || mask_from >= 0))
      || mask_from >= layers ||
      (styled && ((reinterpret_cast<uintptr_t>(pint) |
                   reinterpret_cast<uintptr_t>(pflt)) & 15) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swf::FusedArgs a;
  a.sidx = static_cast<const int*>(sidx);
  a.flags = static_cast<const int*>(flags);
  a.lays = static_cast<const int*>(lays);
  a.urc = static_cast<const float*>(urc);
  a.ucm = static_cast<const float*>(ucm);
  a.uval = static_cast<const float*>(uval);
  a.colors = static_cast<const float*>(colors);
  a.rules = static_cast<const int*>(rules);
  a.pint = static_cast<const int*>(pint);
  a.pflt = static_cast<const float*>(pflt);
  a.fields[0] = static_cast<const float*>(f0);
  a.fields[1] = static_cast<const float*>(f1);
  a.fields[2] = static_cast<const float*>(f2);
  a.fields[3] = static_cast<const float*>(f3);
  a.sg_first = nullptr;
  a.sg_last = nullptr;
  a.out = premul ? nullptr : static_cast<int*>(out);
  a.out_pm = premul ? static_cast<float*>(out) : nullptr;
  a.bg = static_cast<const float*>(bg);
  a.mask_from = mask_from < 0 ? -1 : mask_from;
  a.ng = ng;
  a.group = group;
  a.layers = layers;
  a.ns1 = ns1;
  a.n_chunks = n_chunks;
  a.spp = spp;
  a.plane_rows = plane_rows;
  a.spb = 1;
  a.n_spg = 1;
  a.passes = 3;
  a.kk = 1;
  a.observe = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* idx = static_cast<int*>(sg_index);
  cudaError_t err;
  if (!premul) {
    err = swf::zero_sentinel_words(a, frames, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!styled) {
    err = swf::launch<false>(a, frames, ns1 - 1, idx, s);
  } else if (!chain) {
    err = swf::launch<true>(a, frames, ns1 - 1, idx, s);
  } else if (!premul) {
    err = swf::launch<true, true, false>(a, frames, ns1 - 1, idx, s);
  } else {
    err = swf::launch<true, true, true>(a, frames, ns1 - 1, idx, s);
  }
  return static_cast<int>(err);
}

// render_fused_blocks: sidx/keep/last (nb,) int32, urc/ucm/uval (nb, 128)
// f32 sorted by (frame, strip, layer), colors (F, L, 4), rules (L,);
// sg_index: scratch of 2 * frames * ns1 ints; out: (F, ns1, 8,
// n_chunks*128) int32 packed u32 RGBA, strip ns1 - 1 zeroed.
int swf_fused_blocks1(const void* sidx, const void* keep, const void* last,
                      const void* urc, const void* ucm, const void* uval,
                      const void* colors, const void* rules, void* sg_index,
                      void* out, int nb, int frames, int layers, int ns1,
                      int n_chunks, int passes, void* stream) {
  if (layers < 1 || layers > swf::kMaxLayers || n_chunks < 1 ||
      n_chunks * swf::kStripH > swf::kLane || ns1 < 1 || ns1 - 1 > 65535 ||
      frames < 1 || frames > 65535 || nb < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swf::FusedArgs a = {};
  a.sidx = static_cast<const int*>(sidx);
  a.urc = static_cast<const float*>(urc);
  a.ucm = static_cast<const float*>(ucm);
  a.uval = static_cast<const float*>(uval);
  a.colors = static_cast<const float*>(colors);
  a.rules = static_cast<const int*>(rules);
  a.out = static_cast<int*>(out);
  a.ng = nb;
  a.group = 1;
  a.layers = layers;
  a.ns1 = ns1;
  a.n_chunks = n_chunks;
  a.spp = 1;
  a.plane_rows = swf::kLane;
  a.spb = 1;
  a.n_spg = 1;
  a.passes = passes;
  return static_cast<int>(swf::launch_one(
      a, static_cast<const int*>(keep), static_cast<const int*>(last),
      frames, static_cast<int*>(sg_index),
      static_cast<cudaStream_t>(stream)));
}

// Variants of the solid kernel, with the caller's per-layer `rules` (and
// `spp` strips a plane for kVarMerged, 1 for the others):
// tools/exp_split.py's swf::kVarFull (0, B1's own
// instantiation) .. swf::kVarBatched (6), flatblock_device.cuh, and the
// bf16 product forms swf::kVarK3Three (7), kVarK3Concat (8) and
// kVarLmask (9), place_mma_device.cuh (spp 1, group <= 8).  kVarMerged:
// urc is the (ng, 1, 2 * group * 128) array of urc and uval halves (the
// reference's (ng, 2, group * 128) block), uval unused; kVarBatched: kk
// groups a stage, ng % kk == 0, refused when the stage and the planes
// exceed 227 KB of shared memory; kVarNone0: lays, urc, ucm and uval
// unused.  observe != 0 keeps the ablated work observable
// (flatblock_device.cuh).  Other arguments as swf_fused_flatblock's.
int swf_fused_variant(int variant, int kk, int observe, const void* sidx,
                      const void* flags, const void* lays, const void* urc,
                      const void* ucm, const void* uval, const void* colors,
                      const void* rules, void* sg_index, void* out, int ng,
                      int group, int frames, int layers, int ns1,
                      int n_chunks, int spp, int plane_rows, void* stream) {
  const bool product = variant >= swf::kVarK3Three;
  if (layers < 1 || layers > swf::kMaxLayers || group < 1 || n_chunks < 1 ||
      ns1 < 1 || ns1 - 1 > 65535 || frames < 1 || frames > 65535 ||
      spp < 1 || variant < swf::kVarFull || variant > swf::kVarLmask ||
      (variant == swf::kVarBatched && (kk < 1 || ng % kk != 0)) ||
      (variant != swf::kVarMerged && spp != 1) ||
      (product && (group > swf::kMaxProductGroup ||
                   n_chunks * swf::kStripH > swf::kLane))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swf::FusedArgs a = {};
  a.sidx = static_cast<const int*>(sidx);
  a.flags = static_cast<const int*>(flags);
  a.lays = static_cast<const int*>(lays);
  a.urc = static_cast<const float*>(urc);
  a.ucm = static_cast<const float*>(ucm);
  a.uval = variant == swf::kVarMerged
               ? static_cast<const float*>(urc) + group * swf::kBlk
               : static_cast<const float*>(uval);
  a.colors = static_cast<const float*>(colors);
  a.rules = static_cast<const int*>(rules);
  a.out = static_cast<int*>(out);
  a.mask_from = -1;
  a.ng = ng;
  a.group = group;
  a.layers = layers;
  a.ns1 = ns1;
  a.n_chunks = n_chunks;
  a.spp = spp;
  a.plane_rows = plane_rows;
  a.passes = 3;
  a.kk = kk;
  a.observe = observe;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* idx = static_cast<int*>(sg_index);
  const int n = ns1 - 1;
  cudaError_t err;
  switch (variant) {
    case swf::kVarFull:
      err = swf::launch<false>(a, frames, n, idx, s);
      break;
    case swf::kVarPlace:
      err = swf::launch<false, false, false, swf::kVarPlace>(a, frames, n,
                                                               idx, s);
      break;
    case swf::kVarResolve:
      err = swf::launch<false, false, false, swf::kVarResolve>(a, frames, n,
                                                                 idx, s);
      break;
    case swf::kVarNone:
      err = swf::launch<false, false, false, swf::kVarNone>(a, frames, n,
                                                              idx, s);
      break;
    case swf::kVarNone0:
      err = swf::launch<false, false, false, swf::kVarNone0>(a, frames, n,
                                                               idx, s);
      break;
    case swf::kVarMerged:
      err = swf::launch<false, false, false, swf::kVarMerged>(a, frames, n,
                                                                idx, s);
      break;
    case swf::kVarBatched:
      err = swf::launch<false, false, false, swf::kVarBatched>(a, frames, n,
                                                                 idx, s);
      break;
    case swf::kVarK3Three:
      err = swf::launch_product<swf::kVarK3Three>(a, nullptr, nullptr,
                                                   nullptr, frames, n, idx, s);
      break;
    case swf::kVarK3Concat:
      err = swf::launch_product<swf::kVarK3Concat>(a, nullptr, nullptr,
                                                    nullptr, frames, n, idx,
                                                    s);
      break;
    default:
      err = swf::launch_product<swf::kVarLmask>(a, nullptr, nullptr, nullptr,
                                                frames, n, idx, s);
      break;
  }
  return static_cast<int>(err);
}

// tools/exp_int8.py's form (swf::kVarInt8, place_mma_device.cuh): the
// limbs l0, l1, l2 (ng, group * 128) int8 of q = round(v * 2^20) in place
// of uval; spp 1 (n_chunks <= 16), group <= 8.  Other arguments as
// swf_fused_variant's.
int swf_fused_int8(const void* sidx, const void* flags, const void* lays,
                   const void* urc, const void* ucm, const void* l0,
                   const void* l1, const void* l2, const void* colors,
                   const void* rules, void* sg_index, void* out, int ng,
                   int group, int frames, int layers, int ns1, int n_chunks,
                   void* stream) {
  if (layers < 1 || layers > swf::kMaxLayers || group < 1 ||
      group > swf::kMaxProductGroup || n_chunks < 1 ||
      n_chunks * swf::kStripH > swf::kLane || ns1 < 1 || ns1 - 1 > 65535 ||
      frames < 1 || frames > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swf::FusedArgs a = {};
  a.sidx = static_cast<const int*>(sidx);
  a.flags = static_cast<const int*>(flags);
  a.lays = static_cast<const int*>(lays);
  a.urc = static_cast<const float*>(urc);
  a.ucm = static_cast<const float*>(ucm);
  a.colors = static_cast<const float*>(colors);
  a.rules = static_cast<const int*>(rules);
  a.out = static_cast<int*>(out);
  a.mask_from = -1;
  a.ng = ng;
  a.group = group;
  a.layers = layers;
  a.ns1 = ns1;
  a.n_chunks = n_chunks;
  a.spp = 1;
  return static_cast<int>(swf::launch_product<swf::kVarInt8>(
      a, static_cast<const int8_t*>(l0), static_cast<const int8_t*>(l1),
      static_cast<const int8_t*>(l2), frames, ns1 - 1,
      static_cast<int*>(sg_index), static_cast<cudaStream_t>(stream)));
}

// tools/exp_winplace.py's form (swf::kVarWin): the per-strip placement
// blocks of its packer, urc holding row ids LOCAL to each slot's strip
// window and wins (group, ng) int32 the window of each slot (0 .. spp -
// 1), at any rule and spp.  Other arguments as swf_fused_variant's.
int swf_fused_win(const void* sidx, const void* flags, const void* lays,
                  const void* wins, const void* urc, const void* ucm,
                  const void* uval, const void* colors, const void* rules,
                  void* sg_index, void* out, int ng, int group, int frames,
                  int layers, int ns1, int n_chunks, int spp, int plane_rows,
                  void* stream) {
  if (layers < 1 || layers > swf::kMaxLayers || group < 1 || n_chunks < 1 ||
      ns1 < 1 || ns1 - 1 > 65535 || frames < 1 || frames > 65535 ||
      spp < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swf::FusedArgs a = {};
  a.sidx = static_cast<const int*>(sidx);
  a.flags = static_cast<const int*>(flags);
  a.lays = static_cast<const int*>(lays);
  a.wins = static_cast<const int*>(wins);
  a.urc = static_cast<const float*>(urc);
  a.ucm = static_cast<const float*>(ucm);
  a.uval = static_cast<const float*>(uval);
  a.colors = static_cast<const float*>(colors);
  a.rules = static_cast<const int*>(rules);
  a.out = static_cast<int*>(out);
  a.mask_from = -1;
  a.ng = ng;
  a.group = group;
  a.layers = layers;
  a.ns1 = ns1;
  a.n_chunks = n_chunks;
  a.spp = spp;
  a.plane_rows = plane_rows;
  a.passes = 3;
  a.kk = 1;
  return static_cast<int>(
      swf::launch<false, false, false, swf::kVarWin>(
          a, frames, ns1 - 1, static_cast<int*>(sg_index),
          static_cast<cudaStream_t>(stream)));
}

// tools/exp_dma.py's form (coarse_device.cuh): B1's inputs at one strip a
// plane, `coarse` groups a step (ng % coarse == 0); out (F, ns1, 8,
// n_chunks*128) int32 written by bulk copies, the sentinel strip block
// left unwritten.  rules: the caller's per-layer rules (the tool passes
// the nonzero rule).  Other arguments as swf_fused_variant's.
int swf_fused_coarse(int coarse, const void* sidx, const void* flags,
                     const void* lays, const void* urc, const void* ucm,
                     const void* uval, const void* colors, const void* rules,
                     void* sg_index, void* out, int ng, int group,
                     int frames, int layers, int ns1, int n_chunks,
                     void* stream) {
  if (layers < 1 || layers > swf::kMaxLayers || group < 1 || n_chunks < 1 ||
      ns1 < 1 || frames < 1 || frames > 65535 || coarse < 1 ||
      ng % coarse != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swf::FusedArgs a = {};
  a.sidx = static_cast<const int*>(sidx);
  a.flags = static_cast<const int*>(flags);
  a.lays = static_cast<const int*>(lays);
  a.urc = static_cast<const float*>(urc);
  a.ucm = static_cast<const float*>(ucm);
  a.uval = static_cast<const float*>(uval);
  a.colors = static_cast<const float*>(colors);
  a.rules = static_cast<const int*>(rules);
  a.out = static_cast<int*>(out);
  a.mask_from = -1;
  a.ng = ng;
  a.group = group;
  a.layers = layers;
  a.ns1 = ns1;
  a.n_chunks = n_chunks;
  a.spp = 1;
  a.plane_rows = swf::kLane;
  a.spb = 1;
  a.n_spg = 1;
  int* idx = static_cast<int*>(sg_index);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      swf::solid_layer_class(layers) == swf::kSolidSmallLayers
          ? swf::launch_coarse<swf::kSolidSmallLayers>(a, coarse, frames,
                                                       idx, s)
          : swf::launch_coarse<swf::kMaxLayers>(a, coarse, frames, idx, s));
}

// Packed strips each block of swf_fused_flatblock resolves (spb); a plane's
// spp strips are split over ceil(spp / spb) blocks when spb < spp.
int swf_strips_per_block(int layers, int spp, int styled) {
  return swf::strips_per_block(layers, spp, styled != 0);
}

}  // extern "C"
