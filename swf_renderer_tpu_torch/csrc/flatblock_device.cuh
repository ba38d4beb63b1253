// Device logic of the fused flat-block kernels (place + resolve in one
// pass), shared by the solid and the styled instantiation.
//
// Replaces the TPU kernels `_fusedn_kernel` (swf_renderer_tpu/ops/
// flatblock.py:784, pallas_call :920) and `_fused_styled_kernel` (:1083,
// pallas_call :1276) — in its single-pass form (chain=False, bg=None,
// emit="u32", mask_from=None) and in the modes of deep and masked draw
// lists (fused_block<true, false, true, kPremul>: chain=True, a `bg`
// seed, emit="premul", mask_from) — and `_fused_kernel` (:618,
// pallas_call :709), the one-block-per-step form over blocks sorted by
// (frame, strip, layer) (fused_block<false, true>).
//
// What it computes, per (frame, strip block): the grouped placement
// blocks of the native packer hold coalesced winding deltas (rc, cm, v)
// for every layer; the winding of a pixel is the sum of the deltas left
// of it in its row; the fill rule turns winding into coverage; layers
// composite front-to-back in the suffix-product form; premultiplied
// bytes quantize and un-premultiply into packed little-endian RGBA.
//
// Design.  The TPU keeps all L layer planes of a strip block (L x
// plane_rows x 128 f32, up to 2 MB) in VMEM and places deltas with a
// one-hot MXU product.  A Hopper block has at most 227 KB of shared
// memory, so one CUDA block owns one 128-column CHUNK of one strip block
// (and, when the planes are still too large, a slice of its packed
// strips): L x (8 x strips) x 128 floats.  It walks the supergroup's
// grouped update arrays (every block of the strip block reads the same
// few KB, which stay in L2), scatters the deltas of its own chunk into
// shared memory, and sums the deltas of EARLIER chunks of the same row
// into a per-row carry — the cross-chunk carry needs no second pass.
// The carry accumulates in 32.32 fixed point with 64-bit shared atomics,
// so its sum does not depend on the order the atomics land in; within a
// layer the native packer's coalesced updates never share a target, so
// the float atomics of the scatter are order-free too.  One thread per
// plane row then runs the in-chunk prefix sum left to right (rows are
// padded to 129 floats so those column walks are free of bank
// conflicts), and every thread resolves pixels of its chunk.
//
// B1 and its variants (the solid grouped kernel, solid_flatblock_kernel
// in flatblock.cu) were redesigned for this card from clock64 readings
// of each phase (PERF.md): the per-pixel composite took 53% of a block's
// cycles and the walk 34%, the prefix 6%.  So for them (kSolid):
//   - solid_walk issues the loads of four slots before it places any,
//     and steps through the groups without a 64-bit division;
//   - place_loaded adds the 64-bit fixed-point carry as two native
//     32-bit atomics (a 64-bit shared atomicAdd is a CAS loop here);
//   - solid_pixel composites with the layer loops unrolled to a layer
//     class kLc chosen at launch (4 up to four layers, else 16), the
//     frame's colours in registers (kLc 4) and the rules as a bit mask:
//     the generic composite_pack, sized for 16 layers under a run-time
//     count, indexes its arrays and so keeps them in local memory.
// The arithmetic is composite_pack's, operation for operation.  The
// styled, chain and one-block instantiations keep the generic body (their
// per-layer paints do not fit a register class), and the prefix and the
// set-up stay as they were.
//
// The chain modes (kChain) resolve each pixel with the sequential over
// chain, a left fold over the layers, in place of the suffix-product
// form, so that passes of <= 16 layers chained through their
// premultiplied planes equal one long chain.  The fold starts from the
// pixel's 4 premultiplied floats of an earlier pass (`bg`, plane row
// `frow`, read along the 128 lanes like the field planes) or from
// transparent.  `mask_from` >= 0 (a runtime index) makes layers
// [mask_from:] a clip group's mask: the content layers fold from
// transparent, the mask layers' union alpha folds beside them, the
// content scales by it and goes over `bg` — the unfused program's plane
// algebra, operation for operation.  kPremul stores the 4 premultiplied
// floats at `frow` of the (F, NS+1, 4, plane_rows, 128) output in place
// of the packed word; the launcher zeroes its padding rows and sentinel
// strip block.
//
// Bound on this card: the packed u32 output (one write of every pixel)
// dominates the bytes; the per-pixel arithmetic is ~15 f32 operations a
// layer.  The kernel writes each output row of a chunk as 128 coalesced
// words and never round-trips winding planes through device memory.
//
// Tolerance against the plain PyTorch versions (ops/flatblock.py
// fusedn_plain, fused_styled_plain, fused_blocks_plain) on the card: at
// most 1 u8 level per channel for the grouped forms, equal words for the
// one-block form (chip_smoke.py); measured byte-equal on every case,
// since the plain versions perform this exact arithmetic (sequential
// prefix, fixed-point carry).
//
// Rounding: the arithmetic is the reference's, operation for operation,
// in IEEE f32: rintf (half to even, as jnp.round), IEEE division (no
// fast math), floored modulo for even-odd and the gradient spreads, and
// the library is built with -fmad=false so that no a*b+c contracts into
// an FMA the reference does not perform.

#pragma once

#include <stddef.h>
#include <stdint.h>

namespace swf {

constexpr int kStripH = 8;
constexpr int kLane = 128;
constexpr int kBlk = 128;
constexpr int kMaxLayers = 16;
constexpr int kMaxStops = 15;
constexpr int kMaxFields = 4;
constexpr int kThreads = 256;
constexpr int kRowStride = kLane + 1;   // padded shared plane row (floats)

// Paint kinds (ops/flatblock.py KPAINT_*).
constexpr int kPaintColor = 0;
constexpr int kPaintLinear = 1;
constexpr int kPaintFocal = 2;
constexpr int kPaintField = 3;

// Per-layer paint records (ops/flatblock.py paint_tables).
constexpr int kPintStride = 8;    // kind, spread, n_stops, slot, a_small
constexpr int kPfltStride = 128;
constexpr int kPInv = 0;          // 6: device -> gradient-space affine
constexpr int kPFx = 6;           // focal x (f32 of focal * R)
constexpr int kPCdx = 7;          // -fx
constexpr int kPQa = 8;           // quadratic a
constexpr int kPSafeA = 9;        // a, or 1e-6 when |a| < 1e-6
constexpr int kPRatio = 10;       // kMaxStops stop ratios
constexpr int kPDr = kPRatio + kMaxStops;          // segment widths
constexpr int kPC0 = kPDr + kMaxStops - 1;         // first stop RGBA
constexpr int kPDc = kPC0 + 4;                     // per-segment RGBA step

struct FusedArgs {
  const int* sidx;      // (NG,) packed (frame*L)*(NS+1) + strip
  const int* flags;     // (NG,) bit0 first, bit1 last, bits 2+ used slots
  const int* lays;      // (group, NG) layer of each slot
  const float* urc;     // (NG, group*128) chunk-major row id
  const float* ucm;     // (NG, group*128) column within chunk
  const float* uval;    // (NG, group*128) winding delta
  const float* colors;  // (F, L, 4) straight RGBA
  const int* rules;     // (L,) fill rule per layer
  const int* pint;      // (L, kPintStride) styled only
  const float* pflt;    // (L, kPfltStride) styled only
  const float* fields[kMaxFields];  // (NS+1, 4, plane_rows, 128)
  const int* sg_first;  // (F*(NS+1),) first group of each supergroup
  const int* sg_last;   // (F*(NS+1),) last group of each supergroup
  int* out;             // (F, NS+1, spp*8, n_chunks*128) u32 bits
  const float* bg;      // chain: (F, NS+1, 4, plane_rows, 128) or null
  float* out_pm;        // kPremul: (F, NS+1, 4, plane_rows, 128)
  int mask_from;        // chain: first mask layer, -1 for none
  int ng, group, layers, ns1, n_chunks, spp, plane_rows;
  int spb;              // packed strips owned by one block
  int n_spg;            // strip slices per chunk (ceil(spp / spb))
  int passes;           // one-block form: < 3 splits values in two bf16
  int kk;               // kVarBatched: groups staged in shared memory
  int observe;          // kVarPlace / kVarNone: keep the work observable
  const int* wins;      // kVarWin: (group, NG) strip window of each slot
};

// Variants of the solid grouped kernel that cut it apart
// (tools/exp_split.py: `_kernel` :36 with mode full / place / resolve /
// none, `_kernel0` :159, `_kernel_b` :245, `_kernel_m` :379), spp 1.
// kVarFull is B1 itself.  The ablations skip phases of fused_block:
//   kVarPlace   the walk, scatter and carry; zero words;
//   kVarResolve no walk; prefix and resolve of the zeroed planes (zero
//               words: coverage 0 everywhere);
//   kVarNone    the walk loads every update of its supergroup and
//               scatters nothing; zero words;
//   kVarNone0   reads no update array; zeroes shared memory, zero words.
// Nothing reads the planes of kVarPlace or the loads of kVarNone, so
// nvcc could drop both: a run-time `observe` that the tools never set
// keeps them (kVarPlace then prefixes and resolves, writing B1's words;
// kVarNone stores each thread's xor of its loaded words, so the xor of
// a block's words is that of its supergroup's updates).  The two layout
// variants write B1's words: kVarMerged reads urc and uval as the halves
// of one (NG, 1, 2 * group * 128) row per group (a.urc = the array,
// a.uval = a.urc + group * 128), kVarBatched stages the inputs of `kk`
// consecutive groups (aligned to kk, as the reference's index map i //
// kk) into shared memory with one cp.async group, then scatters from
// there.
//
// kVarWin (tools/exp_winplace.py `_win_kernel` :75, pallas_call :161) is
// B1 over per-strip placement blocks: each slot's row id is LOCAL to its
// strip window (rc < n_chunks * 8) and the window index comes from the
// `wins` table, read like `lays` (a.wins[k * ng + g]).  The TPU shrank
// its one-hot product to the window; here the window only replaces the
// division rc / nc8 that finds a slot's packed strip, and the strip
// slice test skips windows outside the block's slice.  Any rule and spp.
constexpr int kVarFull = 0;
constexpr int kVarPlace = 1;
constexpr int kVarResolve = 2;
constexpr int kVarNone = 3;
constexpr int kVarNone0 = 4;
constexpr int kVarMerged = 5;
constexpr int kVarBatched = 6;
constexpr int kVarWin = 11;   // 7-10: place_mma_device.cuh

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Shared-memory carve-up, in bytes: plane, carry (fixed point), colors,
// rules, then (styled) the paint records.
__host__ __device__ inline size_t smem_plane_bytes(int layers, int rows) {
  return align16(static_cast<size_t>(layers) * rows * kRowStride * 4);
}
__host__ __device__ inline size_t smem_bytes(int layers, int rows,
                                             bool styled) {
  size_t n = smem_plane_bytes(layers, rows);
  n += align16(static_cast<size_t>(layers) * rows * 8);   // carry
  n += align16(static_cast<size_t>(layers) * 4 * 4);      // colors
  n += align16(static_cast<size_t>(layers) * 4);          // rules
  if (styled) {
    n += align16(static_cast<size_t>(layers) * kPintStride * 4);
    n += align16(static_cast<size_t>(layers) * kPfltStride * 4);
  }
  return n;
}

// Largest dynamic shared-memory carve-up a block may take (of the 227 KB
// an H100 block can address).
constexpr size_t kSmemBudget = 160 * 1024;
constexpr size_t kSmemMax = 232448;   // 227 KB: what a block can address

// kVarBatched's stage after the solid carve-up: rc, cm and v of kk
// groups of group * 128 slots.
__host__ __device__ inline size_t batched_stage_bytes(int group, int kk) {
  return static_cast<size_t>(3) * kk * group * kBlk * 4;
}

// Strips per block: as many of the plane's packed strips as fit the
// shared-memory budget and one scan row per thread.
inline int strips_per_block(int layers, int spp, bool styled) {
  int spb = spp;
  while (spb > 1 && (smem_bytes(layers, spb * kStripH, styled) > kSmemBudget
                     || layers * spb * kStripH > kThreads)) {
    --spb;
  }
  return spb;
}

__device__ __forceinline__ long long to_fixed(float v) {
  return __double2ll_rn(static_cast<double>(v) * 4294967296.0);
}

__device__ __forceinline__ float from_fixed(long long q) {
  return static_cast<float>(static_cast<double>(q) *
                            (1.0 / 4294967296.0));
}

// f32 -> bf16 -> f32, round to nearest even (finite x), as XLA and
// PyTorch convert.
__device__ __forceinline__ float bf16_rn(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// The value the reference's two-pass placement carries (flatblock.
// _place_delta, passes=2): bf16(v) + bf16(v - bf16(v)), exact in f32.
__device__ __forceinline__ float split_bf16x2(float v) {
  const float hi = bf16_rn(v);
  return hi + bf16_rn(v - hi);
}

// jnp.mod / torch.remainder for floats: C remainder, then the sign of y.
__device__ __forceinline__ float floor_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r = r + y;
  return r;
}

__device__ __forceinline__ float fill_cov(float w, int rule) {
  if (rule == 0) return fminf(fabsf(w), 1.0f);
  const float m = floor_mod(w, 2.0f);
  return 1.0f - fabsf(m - 1.0f);
}

// Gradient parameter t at pixel center (px, py): flatblock._grad_rgba and
// style._focal_gradient_t, then the spread.
__device__ __forceinline__ float grad_t(const float* P, const int* I,
                                        float px, float py) {
  const float sx = P[kPInv + 0] * px + P[kPInv + 2] * py + P[kPInv + 4];
  const float sy = P[kPInv + 1] * px + P[kPInv + 3] * py + P[kPInv + 5];
  float t;
  if (I[0] == kPaintLinear) {
    t = (sx + 16384.0f) / 32768.0f;
  } else {
    const float pdx = sx - P[kPFx];
    const float pdy = sy;
    const float b = pdx * P[kPCdx];
    const float cc = pdx * pdx + pdy * pdy;
    if (I[4]) {  // |a| < 1e-6: -2 b t + cc = 0
      const bool tiny = fabsf(b) < 1e-9f;
      const float safe_b = tiny ? 1e-9f : b;
      t = tiny ? 0.0f : cc / (2.0f * safe_b);
    } else {
      const float disc = fmaxf(b * b - P[kPQa] * cc, 0.0f);
      const float sq = sqrtf(disc);
      const float t1 = (b + sq) / P[kPSafeA];
      const float t2 = (b - sq) / P[kPSafeA];
      t = fmaxf(t1, t2);
    }
  }
  const int spread = I[1];
  if (spread == 0) {
    t = fminf(fmaxf(t, 0.0f), 1.0f);
  } else if (spread == 2) {
    t = floor_mod(t, 1.0f);
  } else {
    const float m = floor_mod(t, 2.0f);
    t = 1.0f - fabsf(m - 1.0f);
  }
  return t;
}

// Clamped-segment ramp (flatblock._grad_eval): one straight channel.
__device__ __forceinline__ float grad_ramp(const float* P, int n_stops,
                                           float t, int ch) {
  float acc = P[kPC0 + ch];
  for (int k = 0; k < n_stops - 1; ++k) {
    float w = (t - P[kPRatio + k]) / P[kPDr + k];
    w = fminf(fmaxf(w, 0.0f), 1.0f);
    acc = acc + P[kPDc + 4 * k + ch] * w;
  }
  return acc;
}

// Quantize tail shared by every kernel (flatblock._quantize_pack_tail):
// premultiplied-u8 quantization of the composited alpha and colours,
// un-premultiply, little-endian RGBA.
__device__ __forceinline__ uint32_t quantize_pack(float alpha_out,
                                                  const float* pm) {
  const float a8f = rintf(fminf(fmaxf(alpha_out, 0.0f), 1.0f) * 255.0f);
  const float inv = 255.0f / fmaxf(a8f, 1.0f);
  uint32_t packed = static_cast<uint32_t>(static_cast<int>(a8f)) << 24;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float pm8 = fminf(rintf(pm[ch] * 255.0f), a8f);
    packed += static_cast<uint32_t>(static_cast<int>(rintf(pm8 * inv)))
        << (8 * ch);
  }
  return packed;
}

// Resolve tail of the fused kernels (flatblock.composite_quantize_pack
// with chain=False): suffix-product alpha-over composite of cas[l] =
// alpha_l * coverage_l, then quantize_pack.  color(l, ch) gives the
// straight colour of layer l, channel ch in 0..2.
template <typename ColorFn>
__device__ __forceinline__ uint32_t composite_pack(int L, const float* cas,
                                                   ColorFn color) {
  float wgt[kMaxLayers];
  float suffix = 1.0f;
#pragma unroll
  for (int l = kMaxLayers - 1; l >= 0; --l) {
    if (l < L) {
      if (l == L - 1) {
        wgt[l] = cas[l];
        suffix = 1.0f - cas[l];
      } else {
        wgt[l] = cas[l] * suffix;
        suffix = suffix * (1.0f - cas[l]);
      }
    }
  }
  float alpha_out = wgt[0];
  float pm[3];
#pragma unroll
  for (int l = 1; l < kMaxLayers; ++l) {
    if (l < L) alpha_out = alpha_out + wgt[l];
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = 0.0f;
#pragma unroll
    for (int l = 0; l < kMaxLayers; ++l) {
      if (l < L) {
        const float term = color(l, ch) * wgt[l];
        acc = (l == 0) ? term : acc + term;
      }
    }
    pm[ch] = acc;
  }
  return quantize_pack(alpha_out, pm);
}

// Supergroup index of the one-block form from its sorted blocks: keep ==
// 0 starts a supergroup, last == 1 ends it; the sentinel tail (keep 1,
// last 0) marks neither.
__device__ __forceinline__ void block_index(const int* sidx, const int* keep,
                                            const int* last, int i,
                                            int layers, int ns1, int n_sg,
                                            int* first, int* last_idx) {
  const int packed = sidx[i];
  const int sg = (packed / (layers * ns1)) * ns1 + packed % ns1;
  if (packed < 0 || sg >= n_sg) return;
  if (keep[i] == 0) first[sg] = i;
  if (last[i] == 1) last_idx[sg] = i;
}

// Straight colour (c[0..2]) and alpha of layer l at a pixel: the
// constant colour, the gradient ramp at (px, py) or the field planes at
// plane row frow, lane c of strip block s.
template <bool kStyled>
__device__ __forceinline__ void layer_rgba(const FusedArgs& a,
                                           const float* col_s,
                                           const int* pint_s,
                                           const float* pflt_s, int l,
                                           float px, float py, int s,
                                           long long frow, int c,
                                           float* rgba) {
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) rgba[ch] = col_s[4 * l + ch];
  if (kStyled) {
    const int* I = pint_s + l * kPintStride;
    const float* P = pflt_s + l * kPfltStride;
    if (I[0] == kPaintLinear || I[0] == kPaintFocal) {
      const float t = grad_t(P, I, px, py);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) rgba[ch] = grad_ramp(P, I[2], t, ch);
    } else if (I[0] == kPaintField) {
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        rgba[ch] = a.fields[I[3]][((static_cast<long long>(s) * 4 + ch)
                                   * a.plane_rows + frow) * kLane + c];
      }
    }
  }
}

// The chain modes' resolve of one pixel (composite_quantize_pack with
// chain=True, a bg seed and mask_from): premultiplied (r, g, b, a) into
// out[0..3].  w(l) is the winding of layer l at the pixel; bg_px points
// at the pixel's red background value (channels a plane apart) or is
// null.
template <bool kStyled, typename WindingFn>
__device__ __forceinline__ void chain_pixel(
    const FusedArgs& a, const float* col_s, const int* rule_s,
    const int* pint_s, const float* pflt_s, WindingFn w, float px,
    float py, int s, long long frow, int c, const float* bg_px,
    long long bg_step, float* out) {
  const int L = a.layers;
  const int mf = a.mask_from;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (bg_px != nullptr && mf < 0) {
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) acc[ch] = bg_px[ch * bg_step];
  }
  float m = 0.0f;
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l) {
    if (l < L) {
      const float cov = fill_cov(w(l), rule_s[l]);
      float rgba[4];
      layer_rgba<kStyled>(a, col_s, pint_s, pflt_s, l, px, py, s, frow, c,
                          rgba);
      const float ca = rgba[3] * cov;
      if (mf >= 0 && l >= mf) {
        m = (l == mf) ? ca : ca + m * (1.0f - ca);
      } else {
        const float kp = 1.0f - ca;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          acc[ch] = rgba[ch] * ca + acc[ch] * kp;
        }
        acc[3] = ca + acc[3] * kp;
      }
    }
  }
  if (mf >= 0) {
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) acc[ch] = acc[ch] * m;
    if (bg_px != nullptr) {
      const float kp = 1.0f - acc[3];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        acc[ch] = acc[ch] + bg_px[ch * bg_step] * kp;
      }
    }
  }
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) out[ch] = acc[ch];
}

// cp.async of 16 bytes from device to shared memory, its commit and its
// wait.  Without __CUDA_ARCH__ (the host pass, and the CPU emulation of
// the tests) the copy is a plain one and the rest are empty.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
#else
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Waits until at most n committed groups are still in flight.
__device__ __forceinline__ void cp_async_wait(int n) {
#ifdef __CUDA_ARCH__
  switch (n) {
    case 7: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
  }
#endif
}

// B1's solid carve-up of shared memory (smem_bytes, not styled): the
// layers' planes, each row's 32.32 carry, the frame's colours and the
// rules.  A form's own regions start at `end`.
struct SolidSmem {
  float* plane;
  long long* carry;
  float* col_s;
  int* rule_s;
  size_t end;
};

__device__ __forceinline__ SolidSmem solid_smem(unsigned char* smem, int L,
                                                int rows) {
  SolidSmem m;
  size_t off = smem_plane_bytes(L, rows);
  m.plane = reinterpret_cast<float*>(smem);
  m.carry = reinterpret_cast<long long*>(smem + off);
  off += align16(static_cast<size_t>(L) * rows * 8);
  m.col_s = reinterpret_cast<float*>(smem + off);
  off += align16(static_cast<size_t>(L) * 4 * 4);
  m.rule_s = reinterpret_cast<int*>(smem + off);
  m.end = off + align16(static_cast<size_t>(L) * 4);
  return m;
}

// Zeroes the planes and the carry and loads frame f's colours and the
// rules; the caller's barrier follows.
__device__ __forceinline__ void solid_setup(const FusedArgs& a,
                                            const SolidSmem& m, int L,
                                            int rows, int f) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  for (int i = tid; i < L * rows * kRowStride; i += nthr) m.plane[i] = 0.0f;
  for (int i = tid; i < L * rows; i += nthr) m.carry[i] = 0;
  for (int i = tid; i < L * 4; i += nthr) {
    m.col_s[i] = a.colors[static_cast<long long>(f) * L * 4 + i];
  }
  for (int i = tid; i < L; i += nthr) m.rule_s[i] = a.rules[i];
}

// The layer class of the solid kernel (kLc of fused_block, chosen at
// launch): 4 up to four layers, else kMaxLayers.
constexpr int kSolidSmallLayers = 4;
__host__ __device__ constexpr int solid_layer_class(int layers) {
  return layers <= kSolidSmallLayers ? kSolidSmallLayers : kMaxLayers;
}

// B1's walk (the solid grouped forms but kVarBatched): thread tid takes
// slots tid, tid + nthr, ... of the supergroup's groups g0..g1, four at
// a time, and issues every load of the four (flags, value, row id,
// column, layer, window) before it uses any, so that their round trips
// to L2 overlap; slot (g, rem) advances by nthr without a division.
// Skips what fused_block's own walk skips (slots past a group's used
// count, zero values) and calls place(v, rc, cm, layer, win) on the
// rest, or (kVarNone) returns the xor of their loaded words.
template <int kVar, typename Place>
__device__ __forceinline__ uint32_t solid_walk(const FusedArgs& a, int g0,
                                               int g1, Place place) {
  constexpr int kU = 4;
  const int nthr = blockDim.x;
  const int gb = a.group * kBlk;
  uint32_t seen = 0;
  int g = g0;
  int rem = threadIdx.x;
  while (rem >= gb) {
    rem -= gb;
    ++g;
  }
  while (g <= g1) {
    int gs[kU], rs[kU], fl[kU], ly[kU], wn[kU];
    float vs[kU], rcs[kU], cms[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      gs[u] = g;
      rs[u] = rem;
      rem += nthr;
      while (rem >= gb) {
        rem -= gb;
        ++g;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (gs[u] <= g1) {
        const long long idx = static_cast<long long>(gs[u]) * gb + rs[u];
        // kVarMerged: urc and uval are the halves of a row of 2 * gb.
        const long long iv = kVar == kVarMerged
                                 ? idx + static_cast<long long>(gs[u]) * gb
                                 : idx;
        const long long kg = static_cast<long long>(rs[u] / kBlk) * a.ng
                             + gs[u];
        fl[u] = a.flags[gs[u]];
        vs[u] = a.uval[iv];
        rcs[u] = a.urc[iv];
        cms[u] = a.ucm[idx];
        ly[u] = a.lays[kg];
        wn[u] = kVar == kVarWin ? a.wins[kg] : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (gs[u] > g1) continue;
      const int k = rs[u] / kBlk;
      const int nblk = static_cast<int>(static_cast<unsigned>(fl[u]) >> 2);
      if ((nblk != 0 && k >= nblk) || vs[u] == 0.0f) continue;
      if constexpr (kVar == kVarNone) {
        seen ^= __float_as_uint(vs[u]) ^ __float_as_uint(rcs[u]) ^
                __float_as_uint(cms[u]) ^ static_cast<uint32_t>(ly[u]);
      } else {
        place(vs[u], rcs[u], cms[u], ly[u], wn[u]);
      }
    }
  }
  return seen;
}

// B1's resolve of one pixel (composite_pack's arithmetic, operation for
// operation): w points at the winding of layer 0, layers lstride floats
// apart; colour(l) the straight RGBA of layer l; bit l of eo set for an
// even-odd layer.  The layer loops unroll to kLc >= L, so the per-layer
// values live in registers (the generic composite_pack, sized for 16
// layers under a run-time count, indexes them and keeps them in local
// memory); a block whose L == kLc takes a copy without the guards.
template <bool kExact, int kLc, typename ColourFn>
__device__ __forceinline__ uint32_t solid_composite(const float* w,
                                                    int lstride,
                                                    ColourFn colour,
                                                    unsigned eo, int L) {
  float cas[kLc];
  float4 cl[kLc];
#pragma unroll
  for (int l = 0; l < kLc; ++l) {
    if (kExact || l < L) {
      cl[l] = colour(l);
      cas[l] = cl[l].w * fill_cov(w[l * lstride],
                                  static_cast<int>((eo >> l) & 1u));
    }
  }
  float wgt[kLc];
  float suffix = 1.0f;
  bool top = true;   // the front-most layer: its weight is its cas
#pragma unroll
  for (int l = kLc - 1; l >= 0; --l) {
    if (kExact || l < L) {
      if (kExact ? l == kLc - 1 : top) {
        wgt[l] = cas[l];
        suffix = 1.0f - cas[l];
      } else {
        wgt[l] = cas[l] * suffix;
        suffix = suffix * (1.0f - cas[l]);
      }
      top = false;
    }
  }
  float alpha_out = wgt[0];
#pragma unroll
  for (int l = 1; l < kLc; ++l) {
    if (kExact || l < L) alpha_out = alpha_out + wgt[l];
  }
  float pm[3];
  pm[0] = cl[0].x * wgt[0];
  pm[1] = cl[0].y * wgt[0];
  pm[2] = cl[0].z * wgt[0];
#pragma unroll
  for (int l = 1; l < kLc; ++l) {
    if (kExact || l < L) {
      pm[0] = pm[0] + cl[l].x * wgt[l];
      pm[1] = pm[1] + cl[l].y * wgt[l];
      pm[2] = pm[2] + cl[l].z * wgt[l];
    }
  }
  return quantize_pack(alpha_out, pm);
}

template <int kLc, typename ColourFn>
__device__ __forceinline__ uint32_t solid_pixel(const float* w, int lstride,
                                                ColourFn colour, unsigned eo,
                                                int L) {
  return L == kLc ? solid_composite<true, kLc>(w, lstride, colour, eo, L)
                  : solid_composite<false, kLc>(w, lstride, colour, eo, L);
}

// One block: (chunk, strip slice) x strip block x frame.  kOne: the
// one-block-per-step form (render_fused_blocks): group 1, no flags or
// layer table (the layer is read from each block's sidx), values split
// in two bf16 parts when passes < 3.  kChain / kPremul: the chain modes
// (chain_pixel) and the premultiplied-plane output.  kVar: a variant of
// the solid grouped kernel (kVarFull ... kVarBatched, kVarWin above).
template <bool kStyled, bool kOne = false, bool kChain = false,
          bool kPremul = false, int kVar = kVarFull, int kLc = kMaxLayers>
__device__ void fused_block(const FusedArgs& a, unsigned char* smem) {
  static_assert(kVar == kVarFull || (!kStyled && !kOne && !kChain),
                "the variants are of the solid grouped kernel");
  // B1 and its variants: solid_walk, place_loaded and solid_pixel.
  constexpr bool kSolid = !kStyled && !kOne && !kChain;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int chunk = blockIdx.x / a.n_spg;
  const int spg = blockIdx.x % a.n_spg;
  const int s = blockIdx.y;
  const int f = blockIdx.z;
  const int L = a.layers;
  const int rows = a.spb * kStripH;
  const int sp0 = spg * a.spb;
  const int nc8 = a.n_chunks * kStripH;

  const SolidSmem sm = solid_smem(smem, L, rows);
  float* plane = sm.plane;
  long long* carry = sm.carry;
  const float* col_s = sm.col_s;
  const int* rule_s = sm.rule_s;
  int* pint_s = nullptr;
  float* pflt_s = nullptr;
  if (kStyled) {
    pint_s = reinterpret_cast<int*>(smem + sm.end);
    pflt_s = reinterpret_cast<float*>(
        smem + sm.end + align16(static_cast<size_t>(L) * kPintStride * 4));
  }

  solid_setup(a, sm, L, rows, f);
  if (kStyled) {
    for (int i = tid; i < L * kPintStride; i += nthr) pint_s[i] = a.pint[i];
    for (int i = tid; i < L * kPfltStride; i += nthr) pflt_s[i] = a.pflt[i];
  }
  __syncthreads();

  // Placement: this chunk's deltas into the plane, earlier chunks' deltas
  // of the same row into the carry.  place(g, k, v, rc, cm) scatters the
  // update of value v in slot k of group g, its row id at rc and its
  // column at cm (the generic walk of the styled, chain and one-block
  // forms: the layer is read only for an update that lands in this
  // block).
  auto place = [&](int g, int k, float v, const float* rc_p,
                   const float* cm_p) {
    const int rc = static_cast<int>(*rc_p);
    const int sp = rc / nc8;
    const int local = rc - sp * nc8;
    const int ch = local >> 3;
    const int lsp = sp - sp0;
    if (ch > chunk || lsp < 0 || lsp >= a.spb) return;
    const int layer = kOne ? (a.sidx[g] / a.ns1) % L
                           : a.lays[static_cast<long long>(k) * a.ng + g];
    if (layer < 0 || layer >= L) return;
    const int row = layer * rows + lsp * kStripH + (local & 7);
    if (ch == chunk) {
      atomicAdd(&plane[row * kRowStride + static_cast<int>(*cm_p)], v);
    } else {
      atomicAdd(reinterpret_cast<unsigned long long*>(&carry[row]),
                static_cast<unsigned long long>(to_fixed(v)));
    }
  };
  // The same placement from loaded values (solid_walk, kVarBatched).
  auto place_loaded = [&](float v, float rcf, float cmf, int layer,
                          int win) {
    const int rc = static_cast<int>(rcf);
    const int sp = kVar == kVarWin ? win : rc / nc8;
    const int local = kVar == kVarWin ? rc : rc - sp * nc8;
    const int ch = local >> 3;
    const int lsp = sp - sp0;
    if (ch > chunk || lsp < 0 || lsp >= a.spb) return;
    if (layer < 0 || layer >= L) return;
    const int row = layer * rows + lsp * kStripH + (local & 7);
    if (ch == chunk) {
      atomicAdd(&plane[row * kRowStride + static_cast<int>(cmf)], v);
    } else {
      // The 64-bit carry as two native 32-bit adds (a 64-bit shared
      // atomicAdd is a compare-and-swap loop on this card): the adder
      // that wraps the low word carries one into the high word, so the
      // pair ends as the same sum modulo 2^64, whatever the order.
      const unsigned long long q =
          static_cast<unsigned long long>(to_fixed(v));
      unsigned* word = reinterpret_cast<unsigned*>(&carry[row]);
      const unsigned lo = static_cast<unsigned>(q);
      const unsigned old = atomicAdd(&word[0], lo);
      atomicAdd(&word[1], static_cast<unsigned>(q >> 32) +
                              (old + lo < old ? 1u : 0u));
    }
  };
  const int sg = f * a.ns1 + s;
  const int g0 = a.sg_first[sg];
  const int g1 = a.sg_last[sg];
  const int gb = a.group * kBlk;
  uint32_t seen = 0;   // kVarNone: xor of the words this thread loaded
  if constexpr (kVar == kVarBatched) {
    const int n = a.kk * gb;   // floats of one staged array
    float* stage = reinterpret_cast<float*>(
        smem + smem_bytes(L, rows, false));           // rc, cm, v
    for (int b0 = g0 - g0 % a.kk; g0 >= 0 && b0 <= g1; b0 += a.kk) {
      const long long base = static_cast<long long>(b0) * gb;
      for (int i = tid; i < 3 * (n / 4); i += nthr) {
        const int arr = i / (n / 4);
        const int off = 4 * (i - arr * (n / 4));
        const float* src = arr == 0 ? a.urc : (arr == 1 ? a.ucm : a.uval);
        cp_async16(stage + arr * n + off, src + base + off);
      }
      cp_async_commit();
      cp_async_wait(0);
      __syncthreads();
      const int lo = g0 > b0 ? g0 : b0;
      const int hi = g1 < b0 + a.kk - 1 ? g1 : b0 + a.kk - 1;
      for (int j = tid; j < (hi - lo + 1) * gb; j += nthr) {
        const int g = lo + j / gb;
        const int rem = j % gb;
        const int k = rem / kBlk;
        const int nblk = static_cast<int>(
            static_cast<unsigned>(a.flags[g]) >> 2);
        if (nblk != 0 && k >= nblk) continue;
        const int si = (g - b0) * gb + rem;
        const float v = stage[2 * n + si];
        if (v == 0.0f) continue;
        place_loaded(v, stage[si], stage[n + si],
                     a.lays[static_cast<long long>(k) * a.ng + g], 0);
      }
      __syncthreads();   // the stage is free again
    }
  } else if constexpr (kSolid && kVar != kVarResolve && kVar != kVarNone0) {
    if (g0 >= 0 && g1 >= g0) {
      seen = solid_walk<kVar>(a, g0, g1, place_loaded);
    }
  } else if constexpr (!kSolid) {
    if (g0 >= 0 && g1 >= g0) {
      const long long total = static_cast<long long>(g1 - g0 + 1) * gb;
      for (long long j = tid; j < total; j += nthr) {
        const int g = g0 + static_cast<int>(j / gb);
        const int rem = static_cast<int>(j % gb);
        const int k = rem / kBlk;
        const int nblk = kOne ? 0 : static_cast<int>(
            static_cast<unsigned>(a.flags[g]) >> 2);
        if (nblk != 0 && k >= nblk) continue;
        const long long idx = static_cast<long long>(g) * gb + rem;
        float v = a.uval[idx];
        if (kOne && a.passes < 3) v = split_bf16x2(v);
        if (v == 0.0f) continue;
        place(g, k, v, a.urc + idx, a.ucm + idx);
      }
    }
  }
  __syncthreads();

  if constexpr (kVar == kVarPlace || kVar == kVarNone ||
                kVar == kVarNone0) {
    if (kVar != kVarPlace || a.observe == 0) {
      const int stride = a.n_chunks * kLane;
      for (int p = tid; p < rows * kLane; p += nthr) {
        const int row = p / kLane;
        const int sp = sp0 + row / kStripH;
        if (sp >= a.spp) continue;
        const int word = (kVar == kVarNone && a.observe != 0 && p == tid)
                             ? static_cast<int>(seen) : 0;
        a.out[((static_cast<long long>(f) * a.ns1 + s) * (a.spp * kStripH)
               + sp * kStripH + row % kStripH) * stride + chunk * kLane
              + p % kLane] = word;
      }
      return;
    }
  }

  // In-chunk inclusive prefix (left to right), plus the carry: winding.
  for (int r = tid; r < L * rows; r += nthr) {
    float* p = plane + r * kRowStride;
    const float cy = from_fixed(carry[r]);
    float acc = 0.0f;
    for (int c = 0; c < kLane; ++c) {
      acc = acc + p[c];
      p[c] = acc + cy;
    }
  }
  __syncthreads();

  // Resolve: fill rule, suffix-product composite, quantize, pack.
  const int stride = a.n_chunks * kLane;
  // kSolid: the even-odd layers as bits, and the frame's colours in
  // registers when kLc <= 4 (read from shared memory otherwise).
  unsigned eo = 0;
  float4 creg[kLc <= 4 ? kLc : 1];
  if constexpr (kSolid) {
#pragma unroll
    for (int l = 0; l < kLc; ++l) {
      if (l < L) {
        eo |= (rule_s[l] != 0 ? 1u : 0u) << l;
        if constexpr (kLc <= 4) {
          creg[l] = reinterpret_cast<const float4*>(col_s)[l];
        }
      }
    }
  }
  auto colour = [&](int l) -> float4 {
    if constexpr (kLc <= 4) {
      return creg[l];
    } else {
      return reinterpret_cast<const float4*>(col_s)[l];
    }
  };
  for (int p = tid; p < rows * kLane; p += nthr) {
    const int row = p / kLane;
    const int c = p % kLane;
    const int sp = sp0 + row / kStripH;
    if (sp >= a.spp) continue;
    const int r8 = row % kStripH;
    const float px = static_cast<float>(chunk * kLane + c) + 0.5f;
    const float py = static_cast<float>((s * a.spp + sp) * kStripH + r8)
        + 0.5f;
    const long long frow =
        static_cast<long long>(sp) * nc8 + chunk * kStripH + r8;

    if constexpr (kChain) {
      // Plane (f, s, channel 0) of the bg and premul arrays; channels are
      // plane_rows * 128 floats apart.
      const long long step = static_cast<long long>(a.plane_rows) * kLane;
      const long long px0 =
          (static_cast<long long>(f) * a.ns1 + s) * 4 * step + frow * kLane
          + c;
      float pm4[4];
      chain_pixel<kStyled>(
          a, col_s, rule_s, pint_s, pflt_s,
          [&](int l) { return plane[(l * rows + row) * kRowStride + c]; },
          px, py, s, frow, c, a.bg == nullptr ? nullptr : a.bg + px0, step,
          pm4);
      if constexpr (kPremul) {
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) a.out_pm[px0 + ch * step] = pm4[ch];
      } else {
        a.out[((static_cast<long long>(f) * a.ns1 + s) * (a.spp * kStripH)
               + sp * kStripH + r8) * stride + chunk * kLane + c] =
            static_cast<int>(quantize_pack(pm4[3], pm4));
      }
    } else if constexpr (kSolid) {
      a.out[((static_cast<long long>(f) * a.ns1 + s) * (a.spp * kStripH)
             + sp * kStripH + r8) * stride + chunk * kLane + c] =
          static_cast<int>(solid_pixel<kLc>(
              plane + row * kRowStride + c, rows * kRowStride, colour, eo,
              L));
    } else {
      float cas[kMaxLayers];
      float tpar[kMaxLayers];
#pragma unroll
      for (int l = 0; l < kMaxLayers; ++l) {
        if (l < L) {
          const float w = plane[(l * rows + row) * kRowStride + c];
          const float cov = fill_cov(w, rule_s[l]);
          float alpha = col_s[4 * l + 3];
          tpar[l] = 0.0f;
          if (kStyled) {
            const int* I = pint_s + l * kPintStride;
            const float* P = pflt_s + l * kPfltStride;
            if (I[0] == kPaintLinear || I[0] == kPaintFocal) {
              tpar[l] = grad_t(P, I, px, py);
              alpha = grad_ramp(P, I[2], tpar[l], 3);
            } else if (I[0] == kPaintField) {
              alpha = a.fields[I[3]][((static_cast<long long>(s) * 4 + 3)
                                       * a.plane_rows + frow) * kLane + c];
            }
          }
          cas[l] = alpha * cov;
        }
      }
      const uint32_t packed = composite_pack(L, cas, [&](int l, int ch) {
        float color = col_s[4 * l + ch];
        if (kStyled) {
          const int* I = pint_s + l * kPintStride;
          const float* P = pflt_s + l * kPfltStride;
          if (I[0] == kPaintLinear || I[0] == kPaintFocal) {
            color = grad_ramp(P, I[2], tpar[l], ch);
          } else if (I[0] == kPaintField) {
            color = a.fields[I[3]][((static_cast<long long>(s) * 4 + ch)
                                     * a.plane_rows + frow) * kLane + c];
          }
        }
        return color;
      });
      a.out[((static_cast<long long>(f) * a.ns1 + s) * (a.spp * kStripH)
             + sp * kStripH + r8) * stride + chunk * kLane + c] =
          static_cast<int>(packed);
    }
  }
}

}  // namespace swf
