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
//                 :117): one accumulator per layer, kept over the whole
//                 walk, every layer taking every slot of a group with the
//                 values of the other layers masked to zero;
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
// Design on Hopper: one body for the four forms (product_block).  B1's
// grid and carry stay: one CUDA block of two warpgroups per (128-column
// chunk, strip block, frame) walks the groups of its supergroup, and the
// deltas of earlier chunks of a row go into the row's carry (32.32 fixed
// point as two 32-bit atomics, carry_add; for int8 the exact integer sum
// of q, one 32-bit atomic).  The layer folds into the N dimension of one
// product:
//   D (128 columns x 8 kLc) = Step (128 x K) . P (K x 8 kLc),
//   Step[m][k] = [cm_k <= m],  P[k][8 layer_k + row_k] = part_k, else 0:
// the zeros of P are the layer-masked reference's masking, and for the
// k3 and int8 tools (one layer a placement block) the per-layer sums of
// their `acc_ref[layer]`.  Per group of the supergroup:
//   1. Gather.  Each thread issues the loads of its slots (256 apart, up
//      to four) before it uses any; earlier chunks' deltas go into the
//      row's carry, and the slots of this chunk, whatever their block or
//      layer, form one K run in slot order: a warp ballot a round, the
//      counts of every (round, warp) in shared memory, one barrier, then
//      each thread's place from a warp scan of the counts.  The k3 and
//      int8 forms place only the flags' used blocks, as their references;
//      the layer-masked form places every slot, as its own.
//   2. Batches of at most kProductCap entries.  The part tiles of a batch
//      are the B operand of a wgmma in shared memory without swizzle:
//      bf16 MN-major (product_desc: the leading byte offset is the
//      k-block stride, the stride byte offset the n-block stride), s8
//      K-major, as 8-bit wgmma takes B (no transpose flag for 8-bit
//      types; int8_desc: leading byte offset the 16-k block stride,
//      stride byte offset the n-block stride).  A batch's tiles are zeroed
//      one batch ahead (three buffers, so the zeroing needs no barrier of
//      its own) and each entry writes only its parts (bf16 halves or limb
//      bytes); the zeros are the other layers' columns and the padding
//      rows.  fence.proxy.async and a barrier; then each warpgroup (64
//      columns) builds Step in registers from the entries' columns (a warp's
//      fragment is the mma.sync A layout: bf16 ones, or s8 ones), issues
//      wgmma m64nNk16 bf16 -> f32 or m64nNk32 s8 -> s32 over the tiles,
//      commits and waits until one group is left in flight, so the next
//      group's gather overlaps the product.  Each warpgroup's wait
//      precedes the next barrier, so a buffer is written again only once
//      both products that read it are done.
//   3. Resolve from registers.  A thread's accumulators hold every layer
//      of its four pixels (columns gid and gid + 8 of its warp's 16, rows
//      2 tig and 2 tig + 1): winding = D + the row's carry, then B1's fill
//      rule and suffix-product composite at the layer class kLc
//      (solid_pixel), quantize and pack; the words leave as 32-byte row
//      segments.
// The accumulators: the layer-masked and concat forms sum hi, mid and lo
// along K into one f32 accumulator (on this card the concat form is the
// layer-masked form's product over the flags' used blocks, so the k3
// forms converge on it); the three form keeps one a part and combines
// them as (hi + mid) + lo at the resolve, where its reference combines
// each block's (a change of summation order only); int8 keeps one s32
// accumulator a limb (no s8 Step holds x256, so the limbs cannot share
// one along K) and combines m0 + (m1 << 8) + (m2 << 16) in wrapping
// uint32_t.  A limb's sum is at most 128 times a column's entries, far
// from 2^31.  Three accumulators of N = 8 kLc are 192 registers a thread
// at 16 layers, so there those two forms walk the groups twice, eight
// layers a pass (N = 64, 96 registers), each pass writing its windings
// to shared memory for the resolve.  Columns of P past the frame's
// layers stay zero: they reach only accumulator columns that the resolve
// never reads.
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
// tests) the wgmma operations call functions that the emulation defines
// before it includes this header.

#pragma once

#include <stdint.h>

#include <type_traits>

#include "flatblock_device.cuh"

namespace swf {

constexpr int kVarK3Three = 7;
constexpr int kVarK3Concat = 8;
constexpr int kVarLmask = 9;
constexpr int kVarInt8 = 10;

constexpr int kMaxProductGroup = 8;              // four slots a thread
constexpr int kProductRounds = kMaxProductGroup * kBlk / kThreads;
constexpr float kInvQ = 1.0f / 1048576.0f;       // 2^-20 (exp_int8 S = 20)

constexpr int kProductCap = 64;                  // K entries a batch
constexpr int kProductLoads = kProductRounds;    // slots' loads in flight
constexpr int kProductCounts = kProductRounds * (kThreads / 32);
// Tile buffers: a batch's tiles are zeroed one batch ahead of their
// writes, so the zeroing needs no barrier of its own.
constexpr int kProductBufs = 3;

// A form of the product body at layer class kLc (4 up to four layers,
// else 16): its parts and accumulators, the layers a pass (kLp, N = 8
// kLp), its tile buffers and the wgmma depth of a step (kStepK).
template <int kVar, int kLc>
struct ProductForm {
  static_assert(kVar == kVarK3Three || kVar == kVarK3Concat ||
                    kVar == kVarLmask || kVar == kVarInt8,
                "a product form");
  static constexpr bool kInt8 = kVar == kVarInt8;
  static constexpr int kAccs =
      kVar == kVarK3Three || kVar == kVarInt8 ? 3 : 1;
  static constexpr bool kUsed = kVar != kVarLmask;   // the flags' blocks
  static constexpr int kLp = kAccs == 3 && kLc > 8 ? 8 : kLc;
  static constexpr int kPasses = kLc / kLp;
  static constexpr int kN = 8 * kLp;
  static constexpr int kStepK = kInt8 ? 32 : 16;
  static constexpr int kSteps = kProductCap / kStepK;
  // One part tile: kProductCap x kN bf16 (16 B a core-matrix row of 8 n)
  // or s8 (16 B a row of 16 k).
  static constexpr int kTileBytes = kProductCap * kN * (kInt8 ? 1 : 2);
  static_assert(kProductCounts == 32, "a warp scans the counts");
  // Blocks an SM the register bound asks for (flatblock.cu): three at
  // four layers with one accumulator, two with three.
  static constexpr int kMinBlocks =
      kLc != kSolidSmallLayers ? 1 : kAccs == 1 ? 3 : 2;
  using Acc = std::conditional_t<kInt8, int, float>;
};

// Shared memory of a product block: kProductBufs buffers of three part
// tiles, kProductBufs of the entries' columns, two of the (round, warp)
// counts, then the rows' carries, the frame's colours and the rules;
// with two passes, the windings of every layer.
template <int kVar, int kLc>
__host__ __device__ inline size_t product_smem_bytes(int layers) {
  using P = ProductForm<kVar, kLc>;
  return static_cast<size_t>(kProductBufs) * 3 * P::kTileBytes +
         kProductBufs * kProductCap + 2 * kProductCounts * 4 +
         align16(static_cast<size_t>(layers) * kStripH * 8) +
         align16(static_cast<size_t>(layers) * 4 * 4) +
         align16(static_cast<size_t>(layers) * 4) +
         (P::kPasses > 1
              ? static_cast<size_t>(layers) * kStripH * kLane * 4
              : 0);
}

struct ProductSmem {
  unsigned char* tiles;   // [kProductBufs][3] part tiles
  unsigned char* cols;    // [kProductBufs][kProductCap] column of each entry
  int* counts;            // [2][kProductRounds][8 warps] in-chunk slots
  long long* carry;       // [L][8] 32.32 carries (int8: int sums of q)
  float* col_s;           // [L][4] straight colours
  int* rule_s;            // [L] fill rules
  float* wsave;           // [L][8][128] windings (two passes)
};

template <int kVar, int kLc>
__device__ __forceinline__ ProductSmem product_smem(unsigned char* smem,
                                                   int L) {
  using P = ProductForm<kVar, kLc>;
  ProductSmem m;
  size_t off = static_cast<size_t>(kProductBufs) * 3 * P::kTileBytes;
  m.tiles = smem;
  m.cols = smem + off;
  off += kProductBufs * kProductCap;
  m.counts = reinterpret_cast<int*>(smem + off);
  off += 2 * kProductCounts * 4;
  m.carry = reinterpret_cast<long long*>(smem + off);
  off += align16(static_cast<size_t>(L) * kStripH * 8);
  m.col_s = reinterpret_cast<float*>(smem + off);
  off += align16(static_cast<size_t>(L) * 4 * 4);
  m.rule_s = reinterpret_cast<int*>(smem + off);
  off += align16(static_cast<size_t>(L) * 4);
  m.wsave = reinterpret_cast<float*>(smem + off);
  return m;
}

// Zeroes the carries and the first tile buffer and loads frame f's
// colours and the rules; the caller's barrier follows.
template <int kVar, int kLc>
__device__ __forceinline__ void product_setup(const FusedArgs& a,
                                              const ProductSmem& m, int L,
                                              int f) {
  using P = ProductForm<kVar, kLc>;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  for (int i = tid; i < L * kStripH; i += nthr) m.carry[i] = 0;
  for (int i = tid; i < L * 4; i += nthr) {
    m.col_s[i] = a.colors[static_cast<long long>(f) * L * 4 + i];
  }
  for (int i = tid; i < L; i += nthr) m.rule_s[i] = a.rules[i];
  for (int i = tid; i < 3 * P::kTileBytes / 16; i += nthr) {
    reinterpret_cast<uint4*>(m.tiles)[i] = make_uint4(0, 0, 0, 0);
  }
}

// The matrix descriptor of a part tile's step at `tile` (16-B aligned):
// its shared-memory address, the leading and stride byte offsets, no
// swizzle.
__device__ __forceinline__ uint64_t smem_desc(const unsigned char* tile,
                                              unsigned lead,
                                              unsigned stride) {
#if defined(__CUDA_ARCH__)
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(tile));
#elif !defined(__CUDACC__)
  const unsigned addr = emu_smem_offset(tile);
#else
  const unsigned addr = 0u;
#endif
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) |
         static_cast<uint64_t>(lead >> 4) << 16 |
         static_cast<uint64_t>(stride >> 4) << 32;
}

// bf16 tiles, MN-major: 8 x 8 core matrices of 128 B (8 k rows of 8 n,
// 16 B a row), the n blocks of a k block 128 B apart (the stride byte
// offset), k blocks 128 kLp B apart (the leading byte offset).
template <int kLp>
__device__ __forceinline__ uint64_t product_desc(const unsigned char* tile) {
  return smem_desc(tile, 128u * kLp, 128u);
}

// s8 tiles, K-major: a k32 step is kLp n blocks 256 B apart (the stride
// byte offset) of two 8 x 16 B core matrices (8 n rows of 16 k), the
// second 16 k 128 B on (the leading byte offset).
__device__ __forceinline__ uint64_t int8_desc(const unsigned char* tile) {
  return smem_desc(tile, 128u, 256u);
}

// Byte of entry k for tile column n in a bf16 tile of kLp n blocks.
template <int kLp>
__device__ __forceinline__ int bf16_tile_off(int k, int n) {
  return (k >> 3) * (128 * kLp) + (n >> 3) * 128 + (k & 7) * 16 +
         (n & 7) * 2;
}

// Byte of entry k for tile column n in an s8 tile of kN columns.
template <int kN>
__device__ __forceinline__ int int8_tile_off(int k, int n) {
  return (k >> 5) * (32 * kN) + (n >> 3) * 256 + ((k >> 4) & 1) * 128 +
         (n & 7) * 16 + (k & 15);
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

template <int kN>
__device__ __forceinline__ void wgmma_fence_operand(int (&d)[kN]) {
#if defined(__CUDA_ARCH__)
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(d[i])::"memory");
#endif
}

// D (64 x kN, f32, this thread's kN / 2 of it in d) += A (64 x 16 bf16,
// this thread's fragment in a) . B (16 x kN bf16 at desc, MN-major).
template <int kN>
__device__ __forceinline__ void wgmma_bf16(float* d, const uint32_t* a,
                                           uint64_t desc) {
  static_assert(kN == 32 || kN == 64 || kN == 128, "N = 8 layers");
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
  } else if constexpr (kN == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
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

// D (64 x kN, s32, wrapping) += A (64 x 32 s8, this thread's fragment in
// a) . B (32 x kN s8 at desc, K-major: 8-bit types take no transpose).
template <int kN>
__device__ __forceinline__ void wgmma_s8(int* d, const uint32_t* a,
                                         uint64_t desc) {
  static_assert(kN == 32 || kN == 64, "N = 8 layers");
#if defined(__CUDA_ARCH__)
  if constexpr (kN == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
#elif !defined(__CUDACC__)
  emu_wgmma_s8(d, kN, a, desc);
#endif
}

// s8 ones of Step for the four columns of the byte lanes of cw (bytes of
// entries' columns) at or left of pixel column m.
__device__ __forceinline__ uint32_t step_s8(uint32_t cw, uint32_t m) {
  uint32_t r = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r |= ((cw >> (8 * j)) & 0xffu) <= m ? 1u << (8 * j) : 0u;
  }
  return r;
}

// The packed words of this thread's four pixels into the frame: pixel i
// at row 2 tig + (i & 1), column 16 warp + gid + 8 (i >> 1) of the chunk.
__device__ __forceinline__ void product_store_words(const FusedArgs& a,
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

// Winding of accumulator element j plus the row's carry cy: the one f32
// accumulator, (hi + mid) + lo of three, or int8's limbs combined in
// wrapping uint32_t with the integer carry, times 2^-20.
template <int kVar, int kLc, class Acc, class Carry>
__device__ __forceinline__ float product_winding(
    const Acc (&acc)[ProductForm<kVar, kLc>::kAccs]
                    [ProductForm<kVar, kLc>::kN / 2],
    int j, Carry cy) {
  using P = ProductForm<kVar, kLc>;
  if constexpr (P::kInt8) {
    return static_cast<float>(static_cast<int>(
               static_cast<uint32_t>(acc[0][j]) +
               (static_cast<uint32_t>(acc[1][j]) << 8) +
               (static_cast<uint32_t>(acc[2][j]) << 16) +
               static_cast<uint32_t>(cy))) * kInvQ;
  } else if constexpr (P::kAccs == 3) {
    return (acc[0][j] + acc[1][j]) + acc[2][j] + cy;
  } else {
    return acc[0][j] + cy;
  }
}

// One block: chunk x strip block x frame, two warpgroups; kLc the layer
// class (4 up to four layers, else 16).  l0, l1, l2: int8's limbs (null
// for the bf16 forms, which read a.uval).
template <int kVar, int kLc>
__device__ void product_block(const FusedArgs& a, const int8_t* l0,
                              const int8_t* l1, const int8_t* l2,
                              unsigned char* smem) {
  using P = ProductForm<kVar, kLc>;
  using Acc = typename P::Acc;
  using Carry = Acc;   // f32 of the 32.32 carry, or int8's int sum of q
  constexpr int kN = P::kN;
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
  const ProductSmem ps = product_smem<kVar, kLc>(smem, L);
  int* carry_i = reinterpret_cast<int*>(ps.carry);   // int8's
  product_setup<kVar, kLc>(a, ps, L, f);
  __syncthreads();

  const uint32_t m0 = warp * 16 + (lane >> 2);   // the thread's D rows
  const uint32_t m1 = m0 + 8;                    // (columns of the chunk)
  const int sg = f * a.ns1 + s;
  const int g0 = a.sg_first[sg];
  const int g1 = a.sg_last[sg];
  uint32_t words[4];
  int buf = 0;   // the tile buffer of the next batch
#pragma unroll
  for (int pass = 0; pass < P::kPasses; ++pass) {
    // This pass's layers: lp0 .. lp0 + kLp - 1.
    const int lp0 = pass * P::kLp;
    if (pass > 0) {
      if (lp0 >= L) break;
      __syncthreads();   // every warp has read the last group's counts
    }
    Acc acc[P::kAccs][kN / 2];   // D of this thread's 4 pixels, kLp layers
#pragma unroll
    for (int q = 0; q < P::kAccs; ++q) {
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[q][i] = 0;
    }
    for (int g = g0; g0 >= 0 && g <= g1; ++g) {
      // A group's counts are read after its barrier, the next group's
      // written before the next: two buffers.
      int* counts = ps.counts + (g & 1) * kProductCounts;
      int lim = gb;   // slots placed: the flags' used blocks, or all
      if constexpr (P::kUsed) {
        const int nblk =
            static_cast<int>(static_cast<unsigned>(a.flags[g]) >> 2);
        if (nblk != 0 && nblk < a.group) lim = nblk * kBlk;
      }
      // 1. Gather: every slot's loads first, then this chunk's slots into
      //    the K run (positions from the (round, warp) counts), earlier
      //    chunks' into the carry.  A held entry: its column | tile column
      //    << 8, its hi | mid << 16 and lo parts (bf16 bits) or its three
      //    limbs, its place.
      uint32_t hkey[kProductRounds], hab[kProductRounds], hc[kProductRounds];
      int hpos[kProductRounds];
#pragma unroll
      for (int r0 = 0; r0 < kProductRounds; r0 += kProductLoads) {
        float vs[kProductLoads], rcs[kProductLoads], cms[kProductLoads];
        int lys[kProductLoads], x0[kProductLoads], x1[kProductLoads],
            x2[kProductLoads];
#pragma unroll
        for (int u = 0; u < kProductLoads; ++u) {
          const int slot = (r0 + u) * kThreads + tid;
          vs[u] = 0.0f;
          x0[u] = x1[u] = x2[u] = 0;
          if (slot < lim) {
            const long long idx = static_cast<long long>(g) * gb + slot;
            if constexpr (P::kInt8) {
              x0[u] = l0[idx];
              x1[u] = l1[idx];
              x2[u] = l2[idx];
            } else {
              vs[u] = a.uval[idx];
            }
            rcs[u] = a.urc[idx];
            cms[u] = a.ucm[idx];
            lys[u] = a.lays[static_cast<long long>(slot / kBlk) * a.ng + g];
          }
        }
#pragma unroll
        for (int u = 0; u < kProductLoads; ++u) {
          const int r = r0 + u;
          bool in = false;
          const int q = x0[u] + 256 * x1[u] + 65536 * x2[u];
          if (P::kInt8 ? q != 0 : vs[u] != 0.0f) {
            const int rc = static_cast<int>(rcs[u]);
            const int sp = rc / nc8;
            const int local = rc - sp * nc8;
            const int ch = local >> 3;
            const int layer = lys[u];
            if (sp == 0 && ch <= chunk && layer >= 0 && layer < L &&
                (P::kPasses == 1 ||
                 (layer >= lp0 && layer < lp0 + P::kLp))) {
              const int row = layer * kStripH + (local & 7);
              if (ch == chunk) {
                in = true;
                hkey[r] = static_cast<uint32_t>(cms[u]) |
                          static_cast<uint32_t>(row - kStripH * lp0) << 8;
                if constexpr (P::kInt8) {
                  hab[r] = (static_cast<uint32_t>(x0[u]) & 0xffu) |
                           (static_cast<uint32_t>(x1[u]) & 0xffu) << 8 |
                           (static_cast<uint32_t>(x2[u]) & 0xffu) << 16;
                } else {
                  const float v = vs[u];
                  const float hi = bf16_rn(v);
                  const float mid = bf16_rn(v - hi);
                  const float lo = bf16_rn(v - hi - mid);
                  hab[r] = __float_as_uint(hi) >> 16 |
                           (__float_as_uint(mid) & 0xffff0000u);
                  hc[r] = __float_as_uint(lo) >> 16;
                }
              } else if constexpr (P::kInt8) {
                atomicAdd(&carry_i[row], q);
              } else {
                carry_add(&ps.carry[row], vs[u]);
              }
            }
          }
          const unsigned m = __ballot_sync(0xffffffffu, in);
          if (lane == 0) counts[r * kWarps + warp] = __popc(m);
          hpos[r] = in ? __popc(m & ((1u << lane) - 1u)) : -1;
        }
      }
      __syncthreads();
      // Lane i holds count i of the 32 (round, warp) counts: an inclusive
      // scan, then each round's offset from its lane.
      const int c = counts[lane];
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      const int excl = incl - c;
#pragma unroll
      for (int r = 0; r < kProductRounds; ++r) {
        const int off = __shfl_sync(0xffffffffu, excl, r * kWarps + warp);
        if (hpos[r] >= 0) hpos[r] += off;
      }

      // 2. The batches of the K run (block-uniform).
      for (int b0 = 0; b0 < total; b0 += kProductCap) {
        if (b0 > 0) __syncthreads();   // the buffer's products are done
        const int nb = total - b0 < kProductCap ? total - b0 : kProductCap;
        const int kpad = (nb + P::kStepK - 1) & ~(P::kStepK - 1);
        unsigned char* tiles = ps.tiles + buf * 3 * P::kTileBytes;
        unsigned char* cols = ps.cols + buf * kProductCap;
#pragma unroll
        for (int r = 0; r < kProductRounds; ++r) {
          const int k = hpos[r] - b0;
          if (hpos[r] >= 0 && k >= 0 && k < nb) {
            cols[k] = static_cast<unsigned char>(hkey[r] & 0xffu);
            const int n = static_cast<int>(hkey[r] >> 8);
            if constexpr (P::kInt8) {
              const int off = int8_tile_off<kN>(k, n);
#pragma unroll
              for (int q = 0; q < 3; ++q) {
                tiles[q * P::kTileBytes + off] =
                    static_cast<unsigned char>(hab[r] >> (8 * q));
              }
            } else {
              const int off = bf16_tile_off<P::kLp>(k, n);
              const uint32_t parts[3] = {hab[r], hab[r] >> 16, hc[r]};
#pragma unroll
              for (int q = 0; q < 3; ++q) {
                *reinterpret_cast<uint16_t*>(tiles + q * P::kTileBytes +
                                             off) =
                    static_cast<uint16_t>(parts[q]);
              }
            }
          }
        }
        // The next buffer, whose products two batches back are done.
        const int next = buf + 1 == kProductBufs ? 0 : buf + 1;
        uint4* zero =
            reinterpret_cast<uint4*>(ps.tiles + next * 3 * P::kTileBytes);
        for (int i = tid; i < 3 * P::kTileBytes / 16; i += kThreads) {
          zero[i] = make_uint4(0, 0, 0, 0);
        }
        for (int k = nb + tid; k < kpad; k += kThreads) cols[k] = 0xffu;
        fence_proxy_async();
        __syncthreads();
        // Issue: Step in registers (one where the entry's column is at or
        // left of the pixel's), then the three parts' products.
        const int steps = kpad / P::kStepK;
        uint32_t af[P::kSteps][4];
#pragma unroll
        for (int t = 0; t < P::kSteps; ++t) {
          if (t < steps) {
            if constexpr (P::kInt8) {
              const unsigned char* c = cols + 32 * t + 4 * tig;
              const uint32_t w0 = *reinterpret_cast<const uint32_t*>(c);
              const uint32_t w1 = *reinterpret_cast<const uint32_t*>(c + 16);
              af[t][0] = step_s8(w0, m0);
              af[t][1] = step_s8(w0, m1);
              af[t][2] = step_s8(w1, m0);
              af[t][3] = step_s8(w1, m1);
            } else {
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
        }
#pragma unroll
        for (int q = 0; q < P::kAccs; ++q) wgmma_fence_operand(acc[q]);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < P::kSteps; ++t) {
          if (t < steps) {
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              if constexpr (P::kInt8) {
                wgmma_s8<kN>(acc[q], af[t],
                             int8_desc(tiles + q * P::kTileBytes +
                                       t * 32 * kN));
              } else {
                wgmma_bf16<kN>(acc[P::kAccs == 1 ? 0 : q], af[t],
                               product_desc<P::kLp>(
                                   tiles + q * P::kTileBytes +
                                   t * 2 * (128 * P::kLp)));
              }
            }
          }
        }
        wgmma_commit();
        wgmma_wait<1>();
#pragma unroll
        for (int q = 0; q < P::kAccs; ++q) wgmma_fence_operand(acc[q]);
        buf = next;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < P::kAccs; ++q) wgmma_fence_operand(acc[q]);

    // 3. Resolve: winding = D + the row's carry (B1's from_fixed, or
    //    int8's integer sum), B1's composite at kLc; pixel i is column m0
    //    + 8 (i >> 1), row 2 tig + (i & 1): its layer l in element 4 l +
    //    i.  With two passes each pass's windings go to shared memory
    //    (each thread reads back only its own) and the resolve follows
    //    the last.
    auto carries = [&](int r, Carry* cy) {
#pragma unroll
      for (int l = 0; l < P::kLp; ++l) {
        const int row = (lp0 + l) * kStripH + 2 * tig + r;
        if constexpr (P::kInt8) {
          cy[l] = lp0 + l < L ? carry_i[row] : 0;
        } else {
          cy[l] = lp0 + l < L ? from_fixed(ps.carry[row]) : 0.0f;
        }
      }
    };
    if constexpr (P::kPasses == 1) {
      const SolidColours<kLc> colour(ps.col_s, ps.rule_s, L);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        Carry cy[kLc];
        carries(r, cy);
#pragma unroll
        for (int i = r; i < 4; i += 2) {
          float w[kLc];
#pragma unroll
          for (int l = 0; l < kLc; ++l) {
            w[l] = product_winding<kVar, kLc>(acc, 4 * l + i, cy[l]);
          }
          words[i] = solid_pixel<kLc>(w, 1, colour, colour.eo, L);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        Carry cy[P::kLp];
        carries(r, cy);
#pragma unroll
        for (int i = r; i < 4; i += 2) {
          const int px = (2 * tig + r) * kLane + m0 + 8 * (i >> 1);
#pragma unroll
          for (int l = 0; l < P::kLp; ++l) {
            if (lp0 + l < L) {
              ps.wsave[(lp0 + l) * kStripH * kLane + px] =
                  product_winding<kVar, kLc>(acc, 4 * l + i, cy[l]);
            }
          }
        }
      }
    }
  }
  if constexpr (P::kPasses > 1) {
    const SolidColours<kLc> colour(ps.col_s, ps.rule_s, L);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int px = (2 * tig + (i & 1)) * kLane + m0 + 8 * (i >> 1);
      float w[kLc];
#pragma unroll
      for (int l = 0; l < kLc; ++l) {
        w[l] = l < L ? ps.wsave[l * kStripH * kLane + px] : 0.0f;
      }
      words[i] = solid_pixel<kLc>(w, 1, colour, colour.eo, L);
    }
  }
  product_store_words(a, words, chunk, s, f);
}

}  // namespace swf
