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
// Design on Hopper of the k3 and int8 forms (product_block).  B1's grid,
// walk and carry stay (flatblock_device.cuh fused_block): one CUDA block
// of 256 threads per (128-column chunk, strip block, frame) walks the
// groups of its supergroup, and the deltas of earlier chunks of a row go
// into the row's carry (32.32 fixed point in 64-bit shared atomics; for
// int8 the exact integer sum of q).  Only the in-chunk placement changes:
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
// The layer-masked form runs on warpgroup products (lmask_block, below).
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
// tests) the mma and wgmma operations, the ballot and popc call functions
// that the emulation defines before it includes this header.

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
// (into d[0], d[1], d[2] when kThree, all into d[0] otherwise).
template <bool kThree>
__device__ __forceinline__ void product_bf16(
    const uint32_t* key, const uint32_t* pab, const uint32_t* pc, int n,
    int m0, int gid, int tig, float (*d)[4]) {
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
      return row[j] == static_cast<uint32_t>(gid) ? p[j] : 0u;
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

// One block: chunk x strip block x frame, the k3 and int8 forms.
template <int kVar>
__device__ void product_block(const FusedArgs& a, const int8_t* l0,
                              const int8_t* l1, const int8_t* l2,
                              unsigned char* smem) {
  static_assert(kVar == kVarK3Three || kVar == kVarK3Concat ||
                    kVar == kVarInt8,
                "a k3 or int8 form");
  constexpr bool kInt8 = kVar == kVarInt8;
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
      if (b < a.group && (nblk == 0 || b < nblk)) {
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
                                          d);
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

// --- The layer-masked form (kVarLmask): warpgroup products -------------
//
// Design on Hopper.  The TPU kernel keeps an accumulator a layer over the
// walk and multiplies every slot into each, the other layers' values
// masked to zero.  Its first port ran that as one mma.sync product a
// layer, placement block and warp, all but one of each slot's products
// multiplying zeros, behind two barriers and a generic resolve a group:
// 9.05-9.13 ms on the headline against B1's 1.63-1.70 in the same call
// (H100, PERF.md).  Here the layer folds into the N dimension of one
// product:
//   D (128 columns x 8 kLc) = Step (128 x K) . P (K x 8 kLc),
//   Step[m][k] = [cm_k <= m],  P[k][8 layer_k + row_k] = part_k, else 0:
// the zeros of P are the reference's masking, so it is the same product.
// Per group of the supergroup:
//   1. Gather.  Each thread issues the loads of its slots (256 apart, up
//      to four) before it uses any; earlier chunks' deltas go into the
//      row's 32.32 carry as two 32-bit atomics (carry_add), and the slots
//      of this chunk, whatever their block or layer, form one K run in
//      slot order: a warp ballot a round, the counts of every (round,
//      warp) in shared memory, one barrier.
//   2. Batches of at most kLmaskCap entries.  The threads holding them
//      write their rows of the three part tiles (hi, mid and lo bf16,
//      along K into one accumulator) in the core-matrix layout of a wgmma
//      B operand (MN-major, no swizzle: lmask_desc) and their columns;
//      fence.proxy.async and a barrier; then each warpgroup (64 columns)
//      builds Step in registers from the columns (a warp's fragment is the
//      mma.sync A layout), issues wgmma m64nNk16 (N = 8 kLc) over the
//      tiles, commits and waits until one group is left in flight, so the
//      next group's gather overlaps the product.  Two tile buffers
//      alternate; each warpgroup's wait precedes the gather's barrier, so
//      a buffer is written again only once both products that read it
//      are done.
//   3. Resolve from registers.  A thread's accumulator holds every layer
//      of its four pixels (columns gid and gid + 8 of its warp's 16, rows
//      2 tig and 2 tig + 1): winding = D + the row's carry, then B1's fill
//      rule and suffix-product composite at the layer class kLc
//      (solid_pixel), quantize and pack; the words leave as 32-byte row
//      segments.  No shared plane, no row prefix, no float atomics.
// Columns of P past the frame's layers are left unwritten: they reach
// only accumulator columns that the resolve never reads.

constexpr int kLmaskCap = 64;                 // K entries a batch
constexpr int kLmaskSteps = kLmaskCap / 16;   // wgmma k16 steps a batch
constexpr int kLmaskLoads = kProductRounds;   // slots' loads in flight

// One part tile: kLmaskCap x 8 kLc bf16 in 8 x 8 core matrices of 128 B
// (a core matrix: 8 k rows of 8 n, 16 B a row), the n blocks of a k block
// 128 B apart (the descriptor's stride byte offset), k blocks 128 kLc B
// apart (its leading byte offset).
__host__ __device__ constexpr int lmask_tile_bytes(int kLc) {
  return kLmaskCap * 16 * kLc;
}

// Shared memory of the layer-masked form: two buffers of three part
// tiles, two buffers of the entries' columns, two of the (round, warp)
// counts, then the rows' carries, the frame's colours and the rules.
constexpr int kLmaskCounts = kProductRounds * (kThreads / 32);
__host__ __device__ inline size_t lmask_smem_bytes(int layers, int kLc) {
  return static_cast<size_t>(6) * lmask_tile_bytes(kLc) + 2 * kLmaskCap +
         2 * kLmaskCounts * 4 +
         align16(static_cast<size_t>(layers) * kStripH * 8) +
         align16(static_cast<size_t>(layers) * 4 * 4) +
         align16(static_cast<size_t>(layers) * 4);
}

struct LmaskSmem {
  unsigned char* tiles;   // [2][3] part tiles
  unsigned char* cols;    // [2][kLmaskCap] column of each entry
  int* counts;            // [2][kProductRounds][8 warps] in-chunk slots
  long long* carry;       // [L][8] 32.32 carries
  float* col_s;           // [L][4] straight colours
  int* rule_s;            // [L] fill rules
};

template <int kLc>
__device__ __forceinline__ LmaskSmem lmask_smem(unsigned char* smem, int L) {
  LmaskSmem m;
  size_t off = static_cast<size_t>(6) * lmask_tile_bytes(kLc);
  m.tiles = smem;
  m.cols = smem + off;
  off += 2 * kLmaskCap;
  m.counts = reinterpret_cast<int*>(smem + off);
  off += 2 * kLmaskCounts * 4;
  m.carry = reinterpret_cast<long long*>(smem + off);
  off += align16(static_cast<size_t>(L) * kStripH * 8);
  m.col_s = reinterpret_cast<float*>(smem + off);
  off += align16(static_cast<size_t>(L) * 4 * 4);
  m.rule_s = reinterpret_cast<int*>(smem + off);
  return m;
}

// Zeroes the carries and loads frame f's colours and the rules; the
// caller's barrier follows.
__device__ __forceinline__ void lmask_setup(const FusedArgs& a,
                                            const LmaskSmem& m, int L,
                                            int f) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  for (int i = tid; i < L * kStripH; i += nthr) m.carry[i] = 0;
  for (int i = tid; i < L * 4; i += nthr) {
    m.col_s[i] = a.colors[static_cast<long long>(f) * L * 4 + i];
  }
  for (int i = tid; i < L; i += nthr) m.rule_s[i] = a.rules[i];
}

// The matrix descriptor of a part tile's k16 step at `tile` (16-B
// aligned): its shared-memory address, the leading (k blocks) and stride
// (n blocks) byte offsets, no swizzle.
template <int kLc>
__device__ __forceinline__ uint64_t lmask_desc(const unsigned char* tile) {
#if defined(__CUDA_ARCH__)
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(tile));
#elif !defined(__CUDACC__)
  const unsigned addr = emu_smem_offset(tile);
#else
  const unsigned addr = 0u;
#endif
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) |
         static_cast<uint64_t>((128u * kLc) >> 4) << 16 |
         static_cast<uint64_t>(128u >> 4) << 32;
}

// wgmma.fence, commit_group and wait_group: warpgroup-wide, every thread
// of the four warps in step.
__device__ __forceinline__ void wgmma_fence() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void wgmma_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#elif !defined(__CUDACC__)
  emu_wgmma_commit();
#endif
}

// Until at most kN committed groups of this warpgroup are in flight.
template <int kN>
__device__ __forceinline__ void wgmma_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kN) : "memory");
#elif !defined(__CUDACC__)
  emu_wgmma_wait(kN);
#endif
}

// Keeps the compiler from touching the accumulator registers across the
// asynchronous products (CUTLASS's warpgroup_fence_operand).
template <int kN>
__device__ __forceinline__ void wgmma_fence_operand(float (&d)[kN]) {
#if defined(__CUDA_ARCH__)
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
#endif
}

// D (64 x kN, f32, this thread's kN / 2 of it in d) += A (64 x 16 bf16,
// this thread's fragment in a) . B (16 x kN bf16 at desc, MN-major).
template <int kN>
__device__ __forceinline__ void wgmma_bf16(float* d, const uint32_t* a,
                                           uint64_t desc) {
  static_assert(kN == 32 || kN == 128, "N = 8 kLc");
#if defined(__CUDA_ARCH__)
  if constexpr (kN == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
        "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
        "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
#elif !defined(__CUDACC__)
  emu_wgmma_bf16(d, kN, a, desc);
#endif
}

// Row k of the three part tiles of a batch for an entry of plane row
// `row` (layer row >> 3, strip row row & 7) with bf16 parts hi, mid, lo:
// kLc n blocks of 16 B a tile, zero but for the entry's layer.  Blocks of
// layers >= L are not written.
template <int kLc>
__device__ __forceinline__ void lmask_tile_row(unsigned char* tiles, int k,
                                               int row, uint32_t hi,
                                               uint32_t mid, uint32_t lo,
                                               int L) {
  const int layer = row >> 3;
  const int word = (row & 7) >> 1;
  const int shift = 16 * (row & 1);
  const uint32_t parts[3] = {hi, mid, lo};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    unsigned char* at = tiles + q * lmask_tile_bytes(kLc) +
                        (k >> 3) * (128 * kLc) + (k & 7) * 16;
    const uint32_t v = parts[q] << shift;
#pragma unroll
    for (int j = 0; j < kLc; ++j) {
      if (j < L) {
        const bool mine = j == layer;
        *reinterpret_cast<uint4*>(at + 128 * j) =
            make_uint4(mine && word == 0 ? v : 0u, mine && word == 1 ? v : 0u,
                       mine && word == 2 ? v : 0u, mine && word == 3 ? v : 0u);
      }
    }
  }
}

// The packed words of this thread's four pixels into the frame: pixel i
// at row 2 tig + (i & 1), column 16 warp + gid + 8 (i >> 1) of the chunk.
__device__ __forceinline__ void lmask_store_words(const FusedArgs& a,
                                                  const uint32_t* words,
                                                  int chunk, int s, int f) {
  const int lane = threadIdx.x & 31;
  const int stride = a.n_chunks * kLane;
  int* out = a.out +
             ((static_cast<long long>(f) * a.ns1 + s) * kStripH +
              2 * (lane & 3)) * stride +
             chunk * kLane + (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[(i & 1) * stride + 8 * (i >> 1)] = static_cast<int>(words[i]);
  }
}

// One block: chunk x strip block x frame, two warpgroups; kLc the layer
// class (4 up to four layers, else 16): N = 8 kLc.
template <int kLc>
__device__ void lmask_block(const FusedArgs& a, unsigned char* smem) {
  constexpr int kN = 8 * kLc;
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tig = lane & 3;
  const int chunk = blockIdx.x;
  const int s = blockIdx.y;
  const int f = blockIdx.z;
  const int L = a.layers;
  const int nc8 = a.n_chunks * kStripH;
  const int gb = a.group * kBlk;
  const LmaskSmem ls = lmask_smem<kLc>(smem, L);
  lmask_setup(a, ls, L, f);
  __syncthreads();

  float acc[kN / 2];   // D of this thread's 4 pixels, kLc layers
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.0f;
  const uint32_t m0 = warp * 16 + (lane >> 2);   // the thread's D rows
  const uint32_t m1 = m0 + 8;                    // (columns of the chunk)
  const int sg = f * a.ns1 + s;
  const int g0 = a.sg_first[sg];
  const int g1 = a.sg_last[sg];
  int buf = 0;   // the tile buffer of the next batch
  for (int g = g0; g0 >= 0 && g <= g1; ++g) {
    // A group's counts are read after its barrier, the next group's
    // written before the next: two buffers.
    int* counts = ls.counts + (g & 1) * kLmaskCounts;
    // 1. Gather: every slot's loads first, then this chunk's slots into
    //    the K run (positions from the (round, warp) counts), earlier
    //    chunks' into the carry.  A held entry: its column | plane row <<
    //    8, its hi | mid << 16 and lo parts (bf16 bits), its place.
    uint32_t hkey[kProductRounds], hab[kProductRounds], hc[kProductRounds];
    int hpos[kProductRounds];
#pragma unroll
    for (int r0 = 0; r0 < kProductRounds; r0 += kLmaskLoads) {
      float vs[kLmaskLoads], rcs[kLmaskLoads], cms[kLmaskLoads];
      int lys[kLmaskLoads];
#pragma unroll
      for (int u = 0; u < kLmaskLoads; ++u) {
        const int slot = (r0 + u) * kThreads + tid;
        vs[u] = 0.0f;
        if (slot < gb) {
          const long long idx = static_cast<long long>(g) * gb + slot;
          vs[u] = a.uval[idx];
          rcs[u] = a.urc[idx];
          cms[u] = a.ucm[idx];
          lys[u] = a.lays[static_cast<long long>(slot / kBlk) * a.ng + g];
        }
      }
#pragma unroll
      for (int u = 0; u < kLmaskLoads; ++u) {
        const int r = r0 + u;
        bool in = false;
        if (vs[u] != 0.0f) {
          const int rc = static_cast<int>(rcs[u]);
          const int sp = rc / nc8;
          const int local = rc - sp * nc8;
          const int ch = local >> 3;
          const int layer = lys[u];
          if (sp == 0 && ch <= chunk && layer >= 0 && layer < L) {
            const int row = layer * kStripH + (local & 7);
            if (ch == chunk) {
              in = true;
              const float v = vs[u];
              const float hi = bf16_rn(v);
              const float mid = bf16_rn(v - hi);
              const float lo = bf16_rn(v - hi - mid);
              hkey[r] = static_cast<uint32_t>(cms[u]) |
                        static_cast<uint32_t>(row) << 8;
              hab[r] = __float_as_uint(hi) >> 16 |
                       (__float_as_uint(mid) & 0xffff0000u);
              hc[r] = __float_as_uint(lo) >> 16;
            } else {
              carry_add(&ls.carry[row], vs[u]);
            }
          }
        }
        const unsigned m = __ballot_sync(0xffffffffu, in);
        if (lane == 0) counts[r * kWarps + warp] = __popc(m);
        hpos[r] = in ? __popc(m & ((1u << lane) - 1u)) : -1;
      }
    }
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int r = 0; r < kProductRounds; ++r) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w == warp && hpos[r] >= 0) hpos[r] += total;
        total += counts[r * kWarps + w];
      }
    }

    // 2. The batches of the K run (block-uniform).
    for (int b0 = 0; b0 < total; b0 += kLmaskCap) {
      if (b0 > 0) __syncthreads();   // the buffer's products are done
      const int nb = total - b0 < kLmaskCap ? total - b0 : kLmaskCap;
      const int kpad = (nb + 15) & ~15;
      unsigned char* tiles = ls.tiles + buf * 3 * lmask_tile_bytes(kLc);
      unsigned char* cols = ls.cols + buf * kLmaskCap;
#pragma unroll
      for (int r = 0; r < kProductRounds; ++r) {
        const int k = hpos[r] - b0;
        if (hpos[r] >= 0 && k >= 0 && k < nb) {
          cols[k] = static_cast<unsigned char>(hkey[r] & 0xffu);
          lmask_tile_row<kLc>(tiles, k, static_cast<int>(hkey[r] >> 8),
                              hab[r] & 0xffffu, hab[r] >> 16, hc[r], L);
        }
      }
      // Rows nb .. kpad - 1: zero parts, a column above every pixel.
      for (int i = tid; i < (kpad - nb) * 3 * L; i += kThreads) {
        const int k = nb + i / (3 * L);
        const int q = i / L % 3;
        *reinterpret_cast<uint4*>(tiles + q * lmask_tile_bytes(kLc) +
                                  (k >> 3) * (128 * kLc) + (k & 7) * 16 +
                                  128 * (i % L)) = make_uint4(0, 0, 0, 0);
      }
      for (int k = nb + tid; k < kpad; k += kThreads) cols[k] = 0xffu;
      fence_proxy_async();
      __syncthreads();
      // Issue: Step in registers (bf16 1 where the entry's column is at
      // or left of the pixel's), then the three parts' products.
      const int steps = kpad / 16;
      uint32_t af[kLmaskSteps][4];
#pragma unroll
      for (int t = 0; t < kLmaskSteps; ++t) {
        if (t < steps) {
          const unsigned char* c = cols + 16 * t + 2 * tig;
          const uint32_t c0 = c[0], c1 = c[1], c2 = c[8], c3 = c[9];
          auto one = [](uint32_t cm, uint32_t m) -> uint32_t {
            return cm <= m ? 0x3f80u : 0u;   // bf16 1
          };
          af[t][0] = one(c0, m0) | one(c1, m0) << 16;
          af[t][1] = one(c0, m1) | one(c1, m1) << 16;
          af[t][2] = one(c2, m0) | one(c3, m0) << 16;
          af[t][3] = one(c2, m1) | one(c3, m1) << 16;
        }
      }
      wgmma_fence_operand(acc);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < kLmaskSteps; ++t) {
        if (t < steps) {
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            wgmma_bf16<kN>(acc, af[t],
                           lmask_desc<kLc>(tiles + q * lmask_tile_bytes(kLc) +
                                           t * 2 * (128 * kLc)));
          }
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
      wgmma_fence_operand(acc);
      buf ^= 1;
    }
  }
  wgmma_wait<0>();
  wgmma_fence_operand(acc);

  // 3. Resolve: winding = D + the row's carry (B1's from_fixed), B1's
  //    composite at kLc; pixel i is column m0 + 8 (i >> 1), row 2 tig +
  //    (i & 1): its layer l in acc[4 l + i].
  const SolidColours<kLc> colour(ls.col_s, ls.rule_s, L);
  uint32_t words[4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float cy[kLc];
#pragma unroll
    for (int l = 0; l < kLc; ++l) {
      cy[l] = l < L ? from_fixed(ls.carry[l * kStripH + 2 * tig + r]) : 0.0f;
    }
#pragma unroll
    for (int i = r; i < 4; i += 2) {
      float w[kLc];
#pragma unroll
      for (int l = 0; l < kLc; ++l) w[l] = acc[4 * l + i] + cy[l];
      words[i] = solid_pixel<kLc>(w, 1, colour, colour.eo, L);
    }
  }
  lmask_store_words(a, words, chunk, s, f);
}

}  // namespace swf
