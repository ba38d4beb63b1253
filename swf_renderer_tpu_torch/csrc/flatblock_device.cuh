// Device logic of the fused flat-block kernels (place + resolve in one
// pass): the solid grouped kernel, the styled one and the one-block form.
//
// Replaces the TPU kernels `_fusedn_kernel` (swf_renderer_tpu/ops/
// flatblock.py:784, pallas_call :920), `_fused_styled_kernel` (:1083,
// pallas_call :1276) — in its single-pass form (chain=False, bg=None,
// emit="u32", mask_from=None) and in the modes of deep and masked draw
// lists (fused_block<true, true, kPremul>: chain=True, a `bg` seed,
// emit="premul", mask_from) — and `_fused_kernel` (:618, pallas_call
// :709), the one-block-per-step form over blocks sorted by (frame,
// strip, layer) (B1's solid body at kVarOne, below).
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
//   - place_loaded adds the 64-bit fixed-point carry as two native 32-bit
//     atomics (a 64-bit shared atomicAdd is a CAS loop here);
//   - solid_pixel composites with the layer loops unrolled to a layer
//     class kLc chosen at launch (4 up to four layers, else 16), the
//     frame's colours in registers (kLc 4) and the rules as a bit mask:
//     the generic composite_pack, sized for 16 layers under a run-time
//     count, indexes its arrays and so keeps them in local memory.
// The arithmetic is composite_pack's, operation for operation.  The
// one-block form (B13) runs on this body too (kVarOne).  The styled
// kernel (B2) was redesigned the same way (styled_resolve, below): B1's
// walk, a strip budget of three blocks an SM, and a layer-by-layer
// resolve.
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
// kVarOne is the one-block-per-step form (B13, `_fused_kernel`,
// render_fused_blocks) on B1's body: group 1, blocks sorted by (frame,
// strip, layer) with the supergroup index of block_index, no flags or
// layer table (a slot's layer is read from its block's sidx, every slot
// of a block may hold an update), and values split in two bf16 parts
// when passes < 3.  Its first design ran the generic walk (one slot at a
// time behind a 64-bit division, the carry as a 64-bit compare-and-swap
// loop) and the generic composite (stack-indexed arrays: 128 B of stack,
// 48 local stores): 3.46 ms on the headline against B1's 1.41 (PERF.md).
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
constexpr int kVarOne = 12;

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

// The styled kernel's budget: three blocks on an SM (228 KB less 1 KB a
// block for the system) at 16 layers and one strip a block.
constexpr size_t kStyledSmemBudget = (228 * 1024) / 3 - 1024;

// Strips per block: as many of the plane's packed strips as fit the
// shared-memory budget and one scan row per thread.
inline int strips_per_block(int layers, int spp, bool styled) {
  const size_t budget = styled ? kStyledSmemBudget : kSmemBudget;
  int spb = spp;
  while (spb > 1 && (smem_bytes(layers, spb * kStripH, styled) > budget
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

// Adds v to a 32.32 fixed-point carry in shared memory as two native
// 32-bit atomics (a 64-bit shared atomicAdd is a compare-and-swap loop on
// this card): the adder that wraps the low word carries one into the high
// word, so the pair ends as the same sum modulo 2^64, whatever the order.
__device__ __forceinline__ void carry_add(long long* carry, float v) {
  const unsigned long long q = static_cast<unsigned long long>(to_fixed(v));
  unsigned* word = reinterpret_cast<unsigned*>(carry);
  const unsigned lo = static_cast<unsigned>(q);
  const unsigned old = atomicAdd(&word[0], lo);
  const unsigned wrap = old + lo < old ? 1u : 0u;
  atomicAdd(&word[1], static_cast<unsigned>(q >> 32) + wrap);
}

// This thread's generic-proxy writes to shared memory become visible to
// the async proxy (bulk copies, wgmma operands).  Without __CUDA_ARCH__
// and without __CUDACC__ (the g++ emulation of the tests) it calls a
// function that the emulation defines before it includes this header.
__device__ __forceinline__ void fence_proxy_async() {
#if defined(__CUDA_ARCH__)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#elif !defined(__CUDACC__)
  emu_fence_proxy_async();
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
// Skips slots past a group's used count and zero values, and calls
// place(v, rc, cm, layer, win) on the rest, or (kVarNone) returns the
// xor of their loaded words.  kVarOne reads no flags or layer table: a
// slot's layer comes from its block's sidx, its value is split in two
// bf16 parts when passes < 3 (before the zero test).
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
        fl[u] = kVar == kVarOne ? 0 : a.flags[gs[u]];
        vs[u] = a.uval[iv];
        rcs[u] = a.urc[iv];
        cms[u] = a.ucm[idx];
        ly[u] = kVar == kVarOne ? (a.sidx[gs[u]] / a.ns1) % a.layers
                                : a.lays[kg];
        wn[u] = kVar == kVarWin ? a.wins[kg] : 0;
        if (kVar == kVarOne && a.passes < 3) vs[u] = split_bf16x2(vs[u]);
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

// B1's placement of one slot that solid_walk loaded (its `place`): this
// chunk's delta into the plane (a float atomic: a layer's coalesced
// updates never share a target), an earlier chunk's delta of the same row
// into the row's 32.32 carry.  rows plane rows a layer, the block's strip
// slice from sp0 (a.spb strips), nc8 = n_chunks * 8.  fused_block writes
// the same operations out in its own lambda, and B1's resolve its own
// SolidColours: called from there, these helpers changed nvcc's code for
// B1 and B2 (tools/design_phases.py variants, PERF.md).
template <int kVar>
__device__ __forceinline__ void place_slot(const FusedArgs& a, float* plane,
                                           long long* carry, int L,
                                           int rows, int chunk, int sp0,
                                           int nc8, float v, float rcf,
                                           float cmf, int layer, int win) {
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
    carry_add(&carry[row], v);
  }
}

// B1's resolve inputs: bit l of eo set for an even-odd layer l, and the
// straight colour of layer l (operator()), the frame's colours in
// registers when kLc <= 4 (read from shared memory otherwise).
template <int kLc>
struct SolidColours {
  unsigned eo = 0;
  float4 creg[kLc <= 4 ? kLc : 1];
  const float* col_s;

  __device__ __forceinline__ SolidColours(const float* col, const int* rule_s,
                                          int L)
      : col_s(col) {
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

  __device__ __forceinline__ float4 operator()(int l) const {
    if constexpr (kLc <= 4) {
      return creg[l];
    } else {
      return reinterpret_cast<const float4*>(col_s)[l];
    }
  }
};

// In-chunk inclusive prefix of each of the n_rows plane rows (left to
// right, one thread a row), plus the row's carry: winding.
__device__ __forceinline__ void prefix_rows(float* plane,
                                            const long long* carry,
                                            int n_rows) {
  for (int r = threadIdx.x; r < n_rows; r += blockDim.x) {
    float* p = plane + r * kRowStride;
    const float cy = from_fixed(carry[r]);
    float acc = 0.0f;
    for (int c = 0; c < kLane; ++c) {
      acc = acc + p[c];
      p[c] = acc + cy;
    }
  }
}

// --- B2: the styled grouped kernel -------------------------------------
//
// fused_block<true, kChain, kPremul> (styled_flatblock_kernel)
// replaces `_fused_styled_kernel`
// (swf_renderer_tpu/ops/flatblock.py:1083) in every mode: the single pass
// (suffix-product composite, packed words out) and the chain modes (a
// `bg` seed, premultiplied planes out, `mask_from`).  Redesigned for this
// card from clock64 readings of the generic body it replaces (PERF.md):
// the resolve took 48-95% of a block's cycles and the walk 23-45%; the
// generic body unrolled 16 layers of colour, gradient and field code
// around a per-pixel paint lookup (17,584-19,152 instructions, a 128 B
// stack in the single pass) and walked the slots one at a time behind a
// 64-bit division.  So the styled kernel
//   - walks with B1's solid_walk and place_loaded (four slots' loads in
//     flight, the carry as two 32-bit adds) and zeroes its planes 16 B a
//     store while its paint records arrive by cp.async (styled_setup);
//   - resolves (styled_resolve) layer by layer over a batch of kPx
//     pixels a thread (rows of its lane kRowStep apart): the layer's
//     paint kind, rule and colour are read once a batch, not once a
//     pixel, the batch's pixels are independent, the background of the
//     chain is loaded before the fold, and the layer loop is a run-time
//     loop, so the code of each paint kind appears once;
//   - keeps its registers within four blocks an SM (kStyledMinBlocks);
//   - holds the single pass's suffix weights in the plane slots the
//     winding leaves free, so its two sweeps over the layers (top-down
//     for the weights, bottom-up for the sums) keep no per-layer arrays;
//   - takes its strips per block from a budget of three blocks on an
//     SM (strips_per_block, styled).
// The arithmetic of every pixel is composite_pack's (single pass) and the
// chain fold's (chain_seed, chain_step, chain_finish), operation for
// operation; gradient parameters are evaluated again in the second sweep
// (the same operations, the same value).  Measured and left out
// (PERF.md): the layer loop unrolled to a class of 4 layers, 1 or 4
// pixels a batch, field values fetched a layer ahead, 160 KB of strips
// a block.

// Pixels a thread resolves at once (a batch): rows r, r + kRowStep, ...
// of the thread's lane, kPx of them; a packed strip of the block (8 rows
// x 128 lanes over kThreads threads) takes kBatches batches.
constexpr int kRowStep = kThreads / kLane;
constexpr int kPx = 2;
constexpr int kBatches = kStripH / (kRowStep * kPx);
static_assert(kBatches * kRowStep * kPx == kStripH, "batches tile a strip");

// Blocks of the styled kernel an SM must hold by registers (its launch
// bound): 64 registers a thread.
constexpr int kStyledMinBlocks = 4;

// The chain fold of one pixel (composite_quantize_pack with chain=True,
// a bg seed and mask_from): acc the premultiplied (r, g, b, a), m the
// mask layers' union alpha; with has_bg, bg_px points at the pixel's red
// background value (channels bg_step floats apart).
__device__ __forceinline__ void chain_seed(float* acc, const float* bg_px,
                                           long long bg_step, bool has_bg,
                                           int mf) {
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) acc[ch] = 0.0f;
  if (has_bg && mf < 0) {
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) acc[ch] = bg_px[ch * bg_step];
  }
}

// Layer l of straight colour rgba and coverage-scaled alpha ca.
__device__ __forceinline__ void chain_step(float* acc, float& m,
                                           const float* rgba, float ca,
                                           int l, int mf) {
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

__device__ __forceinline__ void chain_finish(float* acc, float m,
                                             const float* bg_px,
                                             long long bg_step, bool has_bg,
                                             int mf) {
  if (mf >= 0) {
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) acc[ch] = acc[ch] * m;
    if (has_bg) {
      const float kp = 1.0f - acc[3];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        acc[ch] = acc[ch] + bg_px[ch * bg_step] * kp;
      }
    }
  }
}

// The styled set-up: planes and carry (one 16-byte aligned run) zeroed
// 16 B a store while the paint records (pint, pflt: 16-byte aligned, the
// launcher checks) arrive by cp.async and the frame's colours and the
// rules by loads issued before the zeroing; the caller's barrier
// follows.
__device__ __forceinline__ void styled_setup(const FusedArgs& a,
                                             unsigned char* smem,
                                             const SolidSmem& m, int* pint_s,
                                             float* pflt_s, int L, int rows,
                                             int f) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  for (int i = tid; i < L * (kPintStride / 4); i += nthr) {
    cp_async16(reinterpret_cast<float*>(pint_s) + 4 * i,
               reinterpret_cast<const float*>(a.pint) + 4 * i);
  }
  for (int i = tid; i < L * (kPfltStride / 4); i += nthr) {
    cp_async16(pflt_s + 4 * i, a.pflt + 4 * i);
  }
  cp_async_commit();
  const float cv = tid < L * 4
      ? a.colors[static_cast<long long>(f) * L * 4 + tid] : 0.0f;
  const int rv = tid < L ? a.rules[tid] : 0;
  const int n16 = static_cast<int>(
      (smem_plane_bytes(L, rows) + align16(static_cast<size_t>(L) * rows * 8))
      / 16);
  int4* z = reinterpret_cast<int4*>(smem);
  for (int i = tid; i < n16; i += nthr) z[i] = make_int4(0, 0, 0, 0);
  if (tid < L * 4) m.col_s[tid] = cv;
  if (tid < L) m.rule_s[tid] = rv;
  cp_async_wait(0);
}

// The styled resolve of the block (chunk, strip slice from sp0) x strip
// block s x frame f, after the prefix: its planes hold the winding.
template <bool kChain, bool kPremul>
__device__ __forceinline__ void styled_resolve(
    const FusedArgs& a, const SolidSmem& sm, const int* pint_s,
    const float* pflt_s, int chunk, int s, int f, int sp0, int rows,
    int nc8) {
  const int tid = threadIdx.x;
  const int L = a.layers;
  // The block's paint kinds (2 bits a layer) and even-odd rules (a bit).
  unsigned kinds = 0;
  unsigned eo = 0;
  for (int l = 0; l < L; ++l) {
    kinds |= static_cast<unsigned>(pint_s[l * kPintStride]) << (2 * l);
    eo |= (sm.rule_s[l] != 0 ? 1u : 0u) << l;
  }
  const int mf = a.mask_from;
  const int c = tid % kLane;
  const float px = static_cast<float>(chunk * kLane + c) + 0.5f;
  const long long chan = static_cast<long long>(a.plane_rows) * kLane;
  const int layer_step = rows * kRowStride;
  const int stride = a.n_chunks * kLane;
  // Pixel k of a batch is kRowStep rows below pixel k - 1: dk floats in
  // the planes, dkp in the field, bg and premultiplied planes, dko in
  // the words.
  constexpr int dk = kRowStep * kRowStride;
  constexpr int dkp = kRowStep * kLane;
  const int dko = kRowStep * stride;

  for (int q = 0; q < a.spb * kBatches; ++q) {
    const int sp = sp0 + q / kBatches;
    if (sp >= a.spp) break;
    const int r8 = (q % kBatches) * kRowStep * kPx + tid / kLane;
    // Pixel 0 of the batch: its plane slot (layer 0), its plane row, its
    // row of the frame.
    const int slot = ((sp - sp0) * kStripH + r8) * kRowStride + c;
    const long long frow =
        static_cast<long long>(sp) * nc8 + chunk * kStripH + r8;
    const int y = (s * a.spp + sp) * kStripH + r8;
    const long long pix = frow * kLane + c;   // in a (4, plane_rows, 128)
    // Straight colour rgba[ch], lo <= ch < hi, of layer l at pixel k.
    auto paint = [&](int l, int kind, const float4& col, int k, int lo,
                     int hi, float* rgba) {
      if (kind == kPaintColor) {
        rgba[0] = col.x;
        rgba[1] = col.y;
        rgba[2] = col.z;
        rgba[3] = col.w;
      } else if (kind == kPaintField) {
        const float* fp = a.fields[pint_s[l * kPintStride + 3]]
                          + static_cast<long long>(s) * 4 * chan + pix
                          + k * dkp;
        for (int ch = lo; ch < hi; ++ch) rgba[ch] = fp[ch * chan];
      } else {
        const int* I = pint_s + l * kPintStride;
        const float* P = pflt_s + l * kPfltStride;
        const float py = static_cast<float>(y + k * kRowStep) + 0.5f;
        const float t = grad_t(P, I, px, py);
        for (int ch = lo; ch < hi; ++ch) {
          rgba[ch] = grad_ramp(P, I[2], t, ch);
        }
      }
    };
    // (F, NS+1, 4, plane_rows, 128) planes: this batch's pixel 0, red.
    const long long at = (static_cast<long long>(f) * a.ns1 + s) * 4 * chan
                         + pix;
    int* word = a.out == nullptr ? nullptr
        : a.out + ((static_cast<long long>(f) * a.ns1 + s)
                   * (a.spp * kStripH) + sp * kStripH + r8) * stride
          + chunk * kLane + c;

    if constexpr (kChain) {
      // The background of the batch's pixels, loaded before the fold.
      const bool has_bg = a.bg != nullptr;
      float bgv[kPx][4];
      if (has_bg) {
#pragma unroll
        for (int k = 0; k < kPx; ++k) {
#pragma unroll
          for (int ch = 0; ch < 4; ++ch) {
            bgv[k][ch] = a.bg[at + ch * chan + k * dkp];
          }
        }
      }
      float acc[kPx][4];
      float m[kPx];
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        chain_seed(acc[k], bgv[k], 1, has_bg, mf);
        m[k] = 0.0f;
      }
      for (int l = 0; l < L; ++l) {
        const int kind = static_cast<int>((kinds >> (2 * l)) & 3u);
        const int rule = static_cast<int>((eo >> l) & 1u);
        const float4 col = reinterpret_cast<const float4*>(sm.col_s)[l];
        const float* w = sm.plane + l * layer_step + slot;
#pragma unroll
        for (int k = 0; k < kPx; ++k) {
          float rgba[4];
          paint(l, kind, col, k, 0, 4, rgba);
          const float ca = rgba[3] * fill_cov(w[k * dk], rule);
          chain_step(acc[k], m[k], rgba, ca, l, mf);
        }
      }
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        chain_finish(acc[k], m[k], bgv[k], 1, has_bg, mf);
        if constexpr (kPremul) {
          float* o = a.out_pm + at + k * dkp;
#pragma unroll
          for (int ch = 0; ch < 4; ++ch) o[ch * chan] = acc[k][ch];
        } else {
          word[k * dko] = static_cast<int>(quantize_pack(acc[k][3], acc[k]));
        }
      }
    } else {
      // Top-down: each layer's weight cas * (the suffix product of the
      // layers above it), into the layer's plane slot.
      float suffix[kPx];
      for (int l = L - 1; l >= 0; --l) {
        const int kind = static_cast<int>((kinds >> (2 * l)) & 3u);
        const int rule = static_cast<int>((eo >> l) & 1u);
        const float4 col = reinterpret_cast<const float4*>(sm.col_s)[l];
        float* w = sm.plane + l * layer_step + slot;
#pragma unroll
        for (int k = 0; k < kPx; ++k) {
          float rgba[4];
          paint(l, kind, col, k, 3, 4, rgba);
          const float cas = rgba[3] * fill_cov(w[k * dk], rule);
          if (l == L - 1) {
            w[k * dk] = cas;
            suffix[k] = 1.0f - cas;
          } else {
            w[k * dk] = cas * suffix[k];
            suffix[k] = suffix[k] * (1.0f - cas);
          }
        }
      }
      // Bottom-up: alpha and the premultiplied channels, summed left to
      // right.
      float alpha_out[kPx];
      float pm[kPx][3];
      for (int l = 0; l < L; ++l) {
        const int kind = static_cast<int>((kinds >> (2 * l)) & 3u);
        const float4 col = reinterpret_cast<const float4*>(sm.col_s)[l];
        const float* w = sm.plane + l * layer_step + slot;
#pragma unroll
        for (int k = 0; k < kPx; ++k) {
          float rgba[4];
          paint(l, kind, col, k, 0, 3, rgba);
          const float wgt = w[k * dk];
          if (l == 0) {
            alpha_out[k] = wgt;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) pm[k][ch] = rgba[ch] * wgt;
          } else {
            alpha_out[k] = alpha_out[k] + wgt;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
              pm[k][ch] = pm[k][ch] + rgba[ch] * wgt;
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        word[k * dko] = static_cast<int>(quantize_pack(alpha_out[k], pm[k]));
      }
    }
  }
}

// One block: (chunk, strip slice) x strip block x frame.  kStyled: the
// styled kernel (per-layer paints; kChain / kPremul its chain modes and
// premultiplied-plane output; its own set-up and resolve above).  kVar:
// a variant of the solid grouped kernel (kVarFull ... kVarBatched,
// kVarWin, kVarOne above).  kLc: the layer class of B1's resolve.
template <bool kStyled, bool kChain = false, bool kPremul = false,
          int kVar = kVarFull, int kLc = kMaxLayers>
__device__ void fused_block(const FusedArgs& a, unsigned char* smem) {
  static_assert(kVar == kVarFull || (!kStyled && !kChain),
                "the variants are of the solid grouped kernel");
  static_assert(kStyled || !kChain, "the chain modes are styled");
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
  if constexpr (kStyled) {
    pint_s = reinterpret_cast<int*>(smem + sm.end);
    pflt_s = reinterpret_cast<float*>(
        smem + sm.end + align16(static_cast<size_t>(L) * kPintStride * 4));
    styled_setup(a, smem, sm, pint_s, pflt_s, L, rows, f);
  } else {
    solid_setup(a, sm, L, rows, f);
  }
  __syncthreads();

  // Placement: this chunk's deltas into the plane, earlier chunks' deltas
  // of the same row into the carry (solid_walk, kVarBatched).
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
  } else if constexpr (kVar != kVarResolve && kVar != kVarNone0) {
    if (g0 >= 0 && g1 >= g0) {
      seen = solid_walk<kVar>(a, g0, g1, place_loaded);
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

  prefix_rows(plane, carry, L * rows);
  __syncthreads();

  if constexpr (kStyled) {
    styled_resolve<kChain, kPremul>(a, sm, pint_s, pflt_s, chunk, s, f,
                                    sp0, rows, nc8);
  } else {
    // B1's resolve (solid_pixel): fill rule, suffix-product composite,
    // quantize, pack; the even-odd layers as bits, and the frame's
    // colours in registers when kLc <= 4 (read from shared memory
    // otherwise).
    const int stride = a.n_chunks * kLane;
    unsigned eo = 0;
    float4 creg[kLc <= 4 ? kLc : 1];
#pragma unroll
    for (int l = 0; l < kLc; ++l) {
      if (l < L) {
        eo |= (rule_s[l] != 0 ? 1u : 0u) << l;
        if constexpr (kLc <= 4) {
          creg[l] = reinterpret_cast<const float4*>(col_s)[l];
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
      a.out[((static_cast<long long>(f) * a.ns1 + s) * (a.spp * kStripH)
             + sp * kStripH + r8) * stride + chunk * kLane + c] =
          static_cast<int>(solid_pixel<kLc>(
              plane + row * kRowStride + c, rows * kRowStride, colour, eo,
              L));
    }
  }
}

}  // namespace swf
