// Device logic of the product-placement variants of the solid fused
// kernel (B1): placement as a matrix product on the tensor cores.
//
// Replaces the TPU kernels of the reference's design tools:
//   kVarK3Three   tools/exp_k3.py:53 `_kernel` (k3=False, pallas_call
//                 :122): three bf16 products (hi, mid, lo), each into its
//                 own accumulator, delta = (hi + mid) + lo;
//   kVarK3Concat  the same kernel with k3=True: one accumulator fed hi,
//                 mid and lo along K;
//   kVarLmask     tools/exp_lmask.py:36 `_lmask_kernel` (pallas_call
//                 :117): one accumulator per layer, kept in registers over
//                 the whole walk, every layer taking every slot of a group
//                 with the values of the other layers masked to zero;
//   kVarInt8      tools/exp_int8.py:53 `_kernel` (pallas_call :146):
//                 values quantized to q = round(v * 2^20) on the host and
//                 split in three s8 limbs; three s8 products combined as
//                 m0 + (m1 << 8) + (m2 << 16) in wrapping int32; the
//                 resolve reads the exact integer winding times 2^-20.
//
// What the TPU kernels compute: each 128-slot placement block of a group
// becomes a (plane_rows x 128) delta = onehot(rc) x Step, with the step
// matrix Step[k, c] = [cm_k <= c], so one product both places a block's
// deltas and prefix-sums them within their 128-column chunk.
//
// Design on Hopper.  B1's grid, walk and carry stay (flatblock_device.cuh
// fused_block): one CUDA block of 256 threads per (128-column chunk,
// strip block, frame) walks the groups of its supergroup, and the deltas
// of earlier chunks of a row go into the row's carry (32.32 fixed point
// in 64-bit shared atomics; for int8 the exact integer sum of q).  Only
// the in-chunk placement changes:
//   1. Gather.  Per group, each thread takes up to four slots (256 apart);
//      a warp's 32 slots lie in one placement block, and a warp ballot
//      compacts the slots whose row falls in this chunk, in slot order,
//      into the block's region of a shared list (key = cm | row << 8, and
//      the parts: hi | mid << 16 and lo as bf16 bits, or the three limbs).
//      Two list buffers alternate, so a group costs two barriers.
//   2. Product.  Warp w owns columns 16w .. 16w + 15 of the chunk and
//      computes D (16 columns x 8 rows) = Step (16 x K) . P (K x 8), with
//      Step[m][k] = [cm_k <= m] and P[k][n] = part_k when row_k == n, else
//      0, built in registers from the list (no ldmatrix): mma.sync
//      m16n8k16 bf16 -> f32, or m16n8k32 s8 -> s32.  N = 8 is one strip.
//      D is the chunk's winding already prefixed, so the one-thread-a-row
//      prefix of B1 and its shared float atomics are gone; each warp adds
//      D into its own tile of the layer's shared plane with plain stores.
//   3. Resolve as B1: winding = plane + carry, the fill rule, the
//      suffix-product composite, quantize and pack.
// One strip a plane (spp 1) only, as the reference tools; group <= 8.
//
// Bound on this card: bytes, as B1 (the packed words, written once, and
// the grouped inputs read once; int8 reads 3 B of limbs a slot in place
// of a 4 B value).  The tensor-core work (2 x M x N x K over the gathered
// K) is small beside it.
//
// Tolerance against the plain versions (tools/exp_int8.py int8_plain:
// byte-equal, the integer sums are exact; tools/exp_k3.py,
// tools/exp_lmask.py: B1's plain version, within B1's envelope — the
// tensor core sums a tile's products in its own order and precision).
//
// Without __CUDA_ARCH__ and without __CUDACC__ (the g++ emulation of the
// tests) the two mma shapes, the ballot and popc call functions that the
// emulation defines before it includes this header.

#pragma once

#include <stdint.h>

#include "flatblock_device.cuh"

namespace swf {

constexpr int kVarK3Three = 7;
constexpr int kVarK3Concat = 8;
constexpr int kVarLmask = 9;
constexpr int kVarInt8 = 10;

constexpr int kMaxProductGroup = 8;              // four slots a thread
constexpr int kProductRounds = kMaxProductGroup * kBlk / kThreads;
constexpr float kInvQ = 1.0f / 1048576.0f;       // 2^-20 (exp_int8 S = 20)

// Shared memory of a product block: B1's solid carve-up at one strip a
// plane, then two list buffers (key, parts a, parts b of group * 128
// slots), two count tables (4 warps a placement block) and two tables of
// the placement blocks' layers.
__host__ __device__ inline size_t product_list_bytes(int group) {
  return static_cast<size_t>(3) * group * kBlk * 4;
}
__host__ __device__ inline size_t product_smem_bytes(int layers, int group) {
  return smem_bytes(layers, kStripH, false) + 2 * product_list_bytes(group)
         + align16(static_cast<size_t>(2) * group * 5 * 4);
}

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#elif !defined(__CUDACC__)
  emu_mma_m16n8k16_bf16(d, a, b);
#endif
}

__device__ __forceinline__ void mma_s8_16832(int* d, const uint32_t* a,
                                             const uint32_t* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#elif !defined(__CUDACC__)
  emu_mma_m16n8k32_s8(d, a, b);
#endif
}

// One placement block's product for one warp's 16 columns, bf16 forms:
// the n entries of key / pab / pc; D accumulates the hi / mid / lo parts
// (into d[0], d[1], d[2] when kThree, all into d[0] otherwise).  `keep` false
// masks every part to zero (the layer-masked form's other layers).
template <bool kThree>
__device__ __forceinline__ void product_bf16(
    const uint32_t* key, const uint32_t* pab, const uint32_t* pc, int n,
    int m0, int gid, int tig, bool keep, float (*d)[4]) {
  const int m1 = m0 + 8;
  for (int t0 = 0; t0 < n; t0 += 16) {
    uint32_t cm[4], row[4], ph[4], pm[4], pl[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = t0 + tig * 2 + (j & 1) + (j >> 1) * 8;
      if (e < n) {
        const uint32_t k = key[e];
        cm[j] = k & 0xffu;
        row[j] = k >> 8;
        ph[j] = pab[e] & 0xffffu;
        pm[j] = pab[e] >> 16;
        pl[j] = pc[e];
      } else {
        cm[j] = 0xffu;   // above every column: Step 0
        row[j] = 0xffu;
        ph[j] = pm[j] = pl[j] = 0u;
      }
    }
    auto step = [&](int j, int m) -> uint32_t {
      return cm[j] <= static_cast<uint32_t>(m) ? 0x3f80u : 0u;   // bf16 1
    };
    const uint32_t a[4] = {step(0, m0) | step(1, m0) << 16,
                           step(0, m1) | step(1, m1) << 16,
                           step(2, m0) | step(3, m0) << 16,
                           step(2, m1) | step(3, m1) << 16};
    auto sel = [&](int j, const uint32_t* p) -> uint32_t {
      return (keep && row[j] == static_cast<uint32_t>(gid)) ? p[j] : 0u;
    };
    const uint32_t bh[2] = {sel(0, ph) | sel(1, ph) << 16,
                            sel(2, ph) | sel(3, ph) << 16};
    const uint32_t bm[2] = {sel(0, pm) | sel(1, pm) << 16,
                            sel(2, pm) | sel(3, pm) << 16};
    const uint32_t bl[2] = {sel(0, pl) | sel(1, pl) << 16,
                            sel(2, pl) | sel(3, pl) << 16};
    mma_bf16_16816(d[0], a, bh);
    mma_bf16_16816(d[kThree ? 1 : 0], a, bm);
    mma_bf16_16816(d[kThree ? 2 : 0], a, bl);
  }
}

// The int8 form's product for one warp's 16 columns: three s8 products
// (limbs 0, 1, 2 into d[0], d[1], d[2]) over n list entries.
__device__ __forceinline__ void product_s8(const uint32_t* key,
                                           const uint32_t* limbs, int n,
                                           int m0, int gid, int tig,
                                           int (*d)[4]) {
  const int m1 = m0 + 8;
  for (int t0 = 0; t0 < n; t0 += 32) {
    uint32_t cm[8], row[8], lb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = t0 + tig * 4 + (j & 3) + (j >> 2) * 16;
      if (e < n) {
        const uint32_t k = key[e];
        cm[j] = k & 0xffu;
        row[j] = k >> 8;
        lb[j] = limbs[e];
      } else {
        cm[j] = 0xffu;
        row[j] = 0xffu;
        lb[j] = 0u;
      }
    }
    uint32_t a[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int hi = j >> 2;   // k + 16: registers 2 and 3
      a[2 * hi] |= (cm[j] <= static_cast<uint32_t>(m0) ? 1u : 0u)
                   << (8 * (j & 3));
      a[2 * hi + 1] |= (cm[j] <= static_cast<uint32_t>(m1) ? 1u : 0u)
                       << (8 * (j & 3));
    }
#pragma unroll
    for (int limb = 0; limb < 3; ++limb) {
      uint32_t b[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t v = row[j] == static_cast<uint32_t>(gid)
                               ? (lb[j] >> (8 * limb)) & 0xffu : 0u;
        b[j >> 2] |= v << (8 * (j & 3));
      }
      mma_s8_16832(d[limb], a, b);
    }
  }
}

// One block: chunk x strip block x frame, the product forms above.
template <int kVar>
__device__ void product_block(const FusedArgs& a, const int8_t* l0,
                              const int8_t* l1, const int8_t* l2,
                              unsigned char* smem) {
  static_assert(kVar >= kVarK3Three && kVar <= kVarInt8,
                "a product form");
  constexpr bool kInt8 = kVar == kVarInt8;
  constexpr bool kLmask = kVar == kVarLmask;
  constexpr int kRows = kStripH;   // one strip a plane
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int chunk = blockIdx.x;
  const int s = blockIdx.y;
  const int f = blockIdx.z;
  const int L = a.layers;
  const int nc8 = a.n_chunks * kStripH;
  const int gb = a.group * kBlk;

  const SolidSmem sm = solid_smem(smem, L, kRows);
  float* plane = sm.plane;
  int* plane_i = reinterpret_cast<int*>(plane);   // the int8 form's
  long long* carry = sm.carry;
  const float* col_s = sm.col_s;
  const int* rule_s = sm.rule_s;
  uint32_t* lists = reinterpret_cast<uint32_t*>(smem + sm.end);
  int* counts = reinterpret_cast<int*>(                // [2][group][4]
      smem + sm.end + 2 * product_list_bytes(a.group));
  int* lay_tab = counts + 2 * a.group * 4;             // [2][group]
  solid_setup(a, sm, L, kRows, f);
  __syncthreads();

  // The layer-masked form's accumulators: 16 columns x 8 rows a layer.
  float acc[kLmask ? kMaxLayers : 1][4];
#pragma unroll
  for (int l = 0; l < (kLmask ? kMaxLayers : 1); ++l) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[l][i] = 0.0f;
  }
  const int m0 = warp * 16 + gid;   // the warp's column of D rows gid

  const int sg = f * a.ns1 + s;
  const int g0 = a.sg_first[sg];
  const int g1 = a.sg_last[sg];
  int buf = 0;
  for (int g = g0; g0 >= 0 && g <= g1; ++g, buf ^= 1) {
    const int nblk = static_cast<int>(static_cast<unsigned>(a.flags[g]) >> 2);
    uint32_t* key = lists + static_cast<size_t>(buf) * 3 * gb;
    uint32_t* pab = key + gb;
    uint32_t* pc = pab + gb;
    int* cnt = counts + buf * a.group * 4;
    int* lay_g = lay_tab + buf * a.group;
    if (tid < a.group) {
      lay_g[tid] = a.lays[static_cast<long long>(tid) * a.ng + g];
    }

    // 1. Gather: this chunk's slots into the list, earlier chunks' into
    //    the carry; the placement blocks' layers into lay_g.
    uint32_t hkey[kProductRounds], hab[kProductRounds], hc[kProductRounds];
    int hpos[kProductRounds];
    bool hin[kProductRounds];
#pragma unroll
    for (int r = 0; r < kProductRounds; ++r) {
      const int slot = r * kThreads + tid;
      const int b = slot / kBlk;   // warp-uniform
      bool in = false;
      if (b < a.group && (kLmask || nblk == 0 || b < nblk)) {
        const long long idx = static_cast<long long>(g) * gb + slot;
        float v = 0.0f;
        int q = 0;
        uint32_t limbs = 0u;
        if constexpr (kInt8) {
          const int x0 = l0[idx], x1 = l1[idx], x2 = l2[idx];
          q = x0 + 256 * x1 + 65536 * x2;
          limbs = (static_cast<uint32_t>(x0) & 0xffu) |
                  (static_cast<uint32_t>(x1) & 0xffu) << 8 |
                  (static_cast<uint32_t>(x2) & 0xffu) << 16;
        } else {
          v = a.uval[idx];
        }
        if (kInt8 ? q != 0 : v != 0.0f) {
          const int rc = static_cast<int>(a.urc[idx]);
          const int sp = rc / nc8;
          const int local = rc - sp * nc8;
          const int ch = local >> 3;
          const int layer = a.lays[static_cast<long long>(b) * a.ng + g];
          if (sp == 0 && ch <= chunk && layer >= 0 && layer < L) {
            if (ch == chunk) {
              in = true;
              hkey[r] = static_cast<uint32_t>(a.ucm[idx]) |
                        static_cast<uint32_t>(local & 7) << 8;
              if constexpr (kInt8) {
                hab[r] = limbs;
                hc[r] = 0u;
              } else {
                const float hi = bf16_rn(v);
                const float mid = bf16_rn(v - hi);
                const float lo = bf16_rn(v - hi - mid);
                hab[r] = __float_as_uint(hi) >> 16 |
                         (__float_as_uint(mid) & 0xffff0000u);
                hc[r] = __float_as_uint(lo) >> 16;
              }
            } else {
              const long long add = kInt8 ? static_cast<long long>(q)
                                          : to_fixed(v);
              atomicAdd(reinterpret_cast<unsigned long long*>(
                            &carry[layer * kRows + (local & 7)]),
                        static_cast<unsigned long long>(add));
            }
          }
        }
      }
      const unsigned m = __ballot_sync(0xffffffffu, in);
      if (lane == 0 && b < a.group) cnt[b * 4 + (warp & 3)] = __popc(m);
      hpos[r] = __popc(m & ((1u << lane) - 1u));
      hin[r] = in;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kProductRounds; ++r) {
      if (hin[r]) {
        const int b = (r * kThreads + tid) / kBlk;
        int e = b * kBlk + hpos[r];
        for (int q = 0; q < (warp & 3); ++q) e += cnt[b * 4 + q];
        key[e] = hkey[r];
        pab[e] = hab[r];
        pc[e] = hc[r];
      }
    }
    __syncthreads();

    // 2. Product: warp w's 16 columns of every placement block.
    if constexpr (kLmask) {
#pragma unroll
      for (int l = 0; l < kMaxLayers; ++l) {
        if (l < L) {
          for (int b = 0; b < a.group; ++b) {
            const int n = cnt[b * 4] + cnt[b * 4 + 1] + cnt[b * 4 + 2] +
                          cnt[b * 4 + 3];
            const bool keep = lay_g[b] == l;
            product_bf16<false>(key + b * kBlk, pab + b * kBlk,
                                pc + b * kBlk, n, m0, gid, tig, keep,
                                &acc[l]);
          }
        }
      }
    } else {
      for (int b = 0; b < a.group; ++b) {
        const int n = cnt[b * 4] + cnt[b * 4 + 1] + cnt[b * 4 + 2] +
                      cnt[b * 4 + 3];
        if (n == 0) continue;   // block-uniform
        const int layer = lay_g[b];
        const int r0 = (layer * kRows + tig * 2) * kRowStride;
        const int cols[4] = {m0, m0 + kRowStride, m0 + 8,
                             m0 + 8 + kRowStride};
        if constexpr (kInt8) {
          int d[3][4] = {};
          product_s8(key + b * kBlk, pab + b * kBlk, n, m0, gid, tig, d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t sum = static_cast<uint32_t>(d[0][i]) +
                                 (static_cast<uint32_t>(d[1][i]) << 8) +
                                 (static_cast<uint32_t>(d[2][i]) << 16);
            plane_i[r0 + cols[i]] = static_cast<int>(
                static_cast<uint32_t>(plane_i[r0 + cols[i]]) + sum);
          }
        } else {
          float d[3][4] = {};
          product_bf16<kVar == kVarK3Three>(key + b * kBlk, pab + b * kBlk,
                                            pc + b * kBlk, n, m0, gid, tig,
                                            true, d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float delta = kVar == kVarK3Three
                                    ? (d[0][i] + d[1][i]) + d[2][i]
                                    : d[0][i];
            plane[r0 + cols[i]] = plane[r0 + cols[i]] + delta;
          }
        }
      }
    }
  }
  if constexpr (kLmask) {
#pragma unroll
    for (int l = 0; l < kMaxLayers; ++l) {
      if (l < L) {
        const int r0 = (l * kRows + tig * 2) * kRowStride;
        plane[r0 + m0] = acc[l][0];
        plane[r0 + kRowStride + m0] = acc[l][1];
        plane[r0 + m0 + 8] = acc[l][2];
        plane[r0 + kRowStride + m0 + 8] = acc[l][3];
      }
    }
  }
  __syncthreads();

  // Each row's carry, converted once into the free list buffer: to f32
  // (B1's prefix pass does the same), or for int8 to the int32 of the
  // TPU's accumulator (exact while |winding| < 2048).
  float* carry_f = reinterpret_cast<float*>(lists);
  int* carry_i = reinterpret_cast<int*>(lists);
  for (int r = tid; r < L * kRows; r += nthr) {
    if constexpr (kInt8) {
      carry_i[r] = static_cast<int>(carry[r]);
    } else {
      carry_f[r] = from_fixed(carry[r]);
    }
  }
  __syncthreads();

  // 3. Resolve: winding = plane + carry, fill rule, composite, pack.  The
  //    loop is B1's, written out here: moved into a shared helper it
  //    changed nvcc's code for both kernels (int8 62 -> 97 registers and
  //    4.8 -> 7.3 ms, B1 47 -> 32 registers; H100, chip_smoke.py phases 1
  //    and 12), where the shared carve-up and set-up leave it unchanged.
  const int stride = a.n_chunks * kLane;
  for (int p = tid; p < kRows * kLane; p += nthr) {
    const int row = p / kLane;
    const int c = p % kLane;
    float cas[kMaxLayers];
#pragma unroll
    for (int l = 0; l < kMaxLayers; ++l) {
      if (l < L) {
        const int r = l * kRows + row;
        float w;
        if constexpr (kInt8) {
          w = static_cast<float>(static_cast<int>(
                  static_cast<uint32_t>(plane_i[r * kRowStride + c]) +
                  static_cast<uint32_t>(carry_i[r]))) * kInvQ;
        } else {
          w = plane[r * kRowStride + c] + carry_f[r];
        }
        cas[l] = col_s[4 * l + 3] * fill_cov(w, rule_s[l]);
      }
    }
    const uint32_t packed = composite_pack(
        L, cas, [&](int l, int ch) { return col_s[4 * l + ch]; });
    a.out[((static_cast<long long>(f) * a.ns1 + s) * kStripH + row) * stride
          + chunk * kLane + c] = static_cast<int>(packed);
  }
}

}  // namespace swf
