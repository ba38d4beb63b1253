// Device logic of the animation sweep kernels: per frame, lerp and/or
// transform LOCAL-space edge pieces, rasterize them analytically, resolve
// and pack — the frame count costs the host nothing.
//
// Replaces five TPU kernels:
//   * `_xform_kernel` (swf_renderer_tpu/ops/transform.py:586, pallas_call
//     :1710) — the affine sweep, solid and styled (B3: tile_sweep_block,
//     kTileW = kLane; redesigned, see the section at the end);
//   * `_xform_kernel(morph=True)` (same file, pallas_call :1875) — the
//     morph + affine sweep (B6: tile_sweep_block, kMorph, kAffine,
//     kTileW = kLane; redesigned, see the section at the end);
//   * `_morph_kernel` (swf_renderer_tpu/ops/morph.py:98, pallas_call :213)
//     — the morph ratio sweep (B7: tile_sweep_block, kMorph, no kAffine,
//     kTileW = kLane; redesigned);
//   * `_xform_kernel_rows` (transform.py:1012, pallas_call :1710 and
//     :1875) — the row-grid sweep (B4: tile_sweep_block, kTileW =
//     kRowChunk): one block owns a band of rows of one frame across the
//     full width;
//   * `_xform_kernel(compact=True)` (transform.py:586, pallas_call :1514)
//     — the compacted sweep (B5: bin_sweep_block, tile_sweep_block's
//     steps): one block walks only the pieces a host-planned pre-pass
//     gathered for its column bin.
//
// What it computes.  A piece is a segment whose transformed |dy| <= 1, so
// it touches at most the two pixel rows floor(min(y0, y1)) + {0, 1}.  In
// such a row the piece covers, of pixel x, the area to its right:
//   ramp(x) = dy * (1 - mean(x))
// with dy the piece's signed y-extent clipped to the row and mean(x) the
// mean over that extent of clamp(edge_x - x, 0, 1) (coverage.py
// edge_contribution, the trapezoid math op for op).  Pixels whose right
// border lies left of the piece get exactly 0, pixels right of it exactly
// dy; only the columns floor(xmn) .. ceil(xmx) - 1 need the formula.  A
// layer's winding is the sum of its pieces' ramps; then the fill rule,
// the paints and the shared composite / quantize / pack tail.
//
// Design.  The TPU evaluates every ramp over a whole column block and
// places rows with a one-hot MXU product (3-pass bf16 split), carries a
// per-frame prefix plane for pieces left of the block, and walks chunk
// lists: formulations for its matrix unit and its sequential grid.  Here
// one CUDA block owns a tile of kLane columns x `rows` rows of one frame
// with every layer's accumulator in shared memory.  Its threads walk the
// layers' pieces (a few thousand, L2-resident, read coalesced), in device
// space, and for a piece that reaches the tile scatter the DIFFERENCES
// ramp(x) - ramp(x - 1) over the columns the piece crosses, ending with
// the step to dy (a pre-pass kernel has written each chunk's row bounds,
// so the walk skips chunks that miss the tile's rows).  A row scan then
// rebuilds every pixel's winding.  Differences and scan are 32.32 fixed
// point: integer sums telescope exactly and do not depend on the order
// the atomics land in, so the result is the same on every run, for every
// tile shape, and equal to the plain PyTorch version (ops/transform.py
// sweep_plain), which sums the same integers with index_add_.  The
// winding rounds to f32 once.
//
// Every sweep (B3, B4, B5, B6, B7) runs the tiled body at the end of this
// file.  The three tilings of the same function, all byte-equal to the
// column kernel because every pixel still sums the same integers:
//   * rows (B4): a block owns a band of rows and sweeps the width in
//     kRowChunk-column chunks, carrying each row's exact winding from chunk
//     to chunk (the TPU's "cheap plane" of left pieces becomes that
//     carry): in a later chunk a piece scatters ramp(x) - ramp(x - 1)
//     from the chunk's first column on, and a piece whose ramp completed
//     left of the chunk adds nothing.  The band's rows come from the same
//     shared-memory budget as the column tile, so the band is short (16
//     rows at 3 layers and 256-column chunks, 2 at 16 layers).
//   * compacted (B5): ops/transform.py compact_pre gathers, per (frame,
//     column bin of `bin_w` columns, layer), the pieces crossing the bin
//     in table order, already in device pixels, with the row bounds of
//     their kFineChunk-slot chunks, and the 32.32 sum of dy of the pieces
//     wholly left of the bin per row (the prefix plane).  A block owns
//     `bins_per_block` bins of one row band in turn (bin_sweep_block), in
//     128-column tiles: the prefix seeds each row's carry and the walk
//     reads only the bin's gathered pieces.

// Bound on this card: bytes for the output (one u32 a pixel) at the main
// path's shapes.  The kernel's own cost is the piece walk (without the
// chunk bounds it was two thirds of the kernel: every tile read every
// piece from L2), the resolve and the setup; a tile whose windings are
// all 0 skips the scan and the resolve and writes zeros.
//
// Tolerance against the plain version on the card: equal words
// (chip_smoke.py); by construction all byte-equal.  Rounding as in
// flatblock_device.cuh: op-by-op IEEE f32, -fmad=false, rintf, floored
// modulo.

#pragma once

#include "flatblock_device.cuh"

namespace swf {

constexpr int kSweepMaxRows = 32;
constexpr int kSweepMaxHits = 1024;          // chunk list of one walk round
constexpr int kRowChunk = 256;               // row-band kernel's column chunk

struct SweepArgs {
  const float* mats;         // (F, 6) or (F, L, 6) device affines
  const float* tab_s;        // (L, 4, EP) local pieces x0, y0, x1, y1
  const float* tab_e;        // (L, 4, EP) morph end pieces
  const float* ratios;       // (F,) morph ratios
  const float* colors;       // (L, 4) or (F, L, 4) straight RGBA
  const float* colors_e;     // (L, 4) morph end colours
  const int* counts;         // (L,) pieces to walk in each layer
  const int* rules;          // (L,) fill rule per layer
  const int* pint;           // (L, kPintStride) styled only
  const float* pflt;         // (L, kPfltStride) styled only
  const float* grad_mats;    // (F, L, 6) device -> gradient space
  const float* stop_colors;  // (F, L, K, 4) per-frame stops, or null
  const float* fields;       // (NF, F, H, W, 4) baked paint planes
  float* bounds;             // (F, L, n_chunks, 2) scratch: lowest and
                             // highest row base of each piece chunk
  int* out;                  // (F, H, W) packed RGBA u32 bits
  int frames, layers, ep, height, width;
  int n_chunks;              // ceil(ep / kFineChunk), B5: cap / kFineChunk
  int rows;                  // tile rows
  int mats_per_layer, colors_per_frame, n_stop_slots;
  // The compacted sweep's tables (compact_pre):
  const float* ctab;         // (F, NB, L, 4, cap) gathered device pieces
  const int* ccount;         // (F, NB, L) gathered pieces of each bin
  const float* cbounds;      // (F, NB, L, cap / kFineChunk, 2) row bounds
  const long long* prefix;   // (F, L, NB, H) 32.32 dy of left pieces
  int cap;                   // gathered slots per (frame, bin, layer)
  int n_bins, bin_w, bins_per_block;
  int x_shift;               // the column sweeps: the frame's first column
                             // on the global pixel grid (a tile shard's)
};

struct SweepShared {
  long long* plane;   // (L, rows, tile_w + 1) accumulators
  float* col;         // (L, 4) this frame's colours
  float* mat;         // (L, 6) this frame's matrices
  int* rule;          // (L,)
  int* touched;       // set when a piece or a seed lands in the tile
  int* n_hits;
  int* hits;          // (kSweepMaxHits,) hit (layer, chunk) pairs
  int* pint;          // styled: (L, kPintStride)
  float* pflt;        // styled: (L, kPfltStride)
  long long* carry;   // (L, rows) each row's winding left of the tile
};

// Antiderivative of clamp(x, 0, 1) (coverage.py _h01).
__device__ __forceinline__ float h01(float x) {
  if (x <= 0.0f) return 0.0f;
  if (x >= 1.0f) return x - 0.5f;
  return 0.5f * x * x;
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// Piece p of a layer in device space: the ratio lerp, then the frame's
// affine (transform.py:695-708).  ``M`` holds a, b, c, d, e, f.
template <bool kMorph, bool kAffine>
__device__ __forceinline__ void device_piece(
    const float* ts, const float* te, int ep, int p, float t, float omt,
    const float* M, float& x0, float& y0, float& x1, float& y1) {
  x0 = ts[p];
  y0 = ts[ep + p];
  x1 = ts[2 * ep + p];
  y1 = ts[3 * ep + p];
  if (kMorph) {  // ratio lerp BEFORE the frame transform
    x0 = omt * x0 + t * te[p];
    y0 = omt * y0 + t * te[ep + p];
    x1 = omt * x1 + t * te[2 * ep + p];
    y1 = omt * y1 + t * te[3 * ep + p];
  }
  if (kAffine) {
    const float tx0 = M[0] * x0 + M[2] * y0 + M[4];
    const float ty0 = M[1] * x0 + M[3] * y0 + M[5];
    const float tx1 = M[0] * x1 + M[2] * y1 + M[4];
    const float ty1 = M[1] * x1 + M[3] * y1 + M[5];
    x0 = tx0; y0 = ty0; x1 = tx1; y1 = ty1;
  }
}

// --- The tiled body: the sweeps redesigned for this card -----------------
//
// tile_sweep_block runs the column sweeps (kTileW = kLane: B3 the affine
// sweep, solid and styled; B6 morph + affine; B7 morph ratio) and the row
// bands (B4: solid, styled, morph + affine, kTileW = kRowChunk, a band's
// chunks in turn); bin_sweep_block runs the compacted bins (B5) through
// the same steps.  Redesigned from clock64 readings of the first form
// (PERF.md §6): at anim1080 a tile read ~1300 pieces (64-piece chunks
// span many rows), ~180 of them wholly left of the tile added dy at its
// first column through 64-bit shared atomics (compare-and-swap loops),
// which also marked the tile as reached, so the serial row prefix and the
// two-pass resolve ran on two thirds of the tiles, where three quarters
// have all windings 0.  So
//   - a pre-pass (fine_bounds_block) writes row bounds of kFineChunk-piece
//     chunks: a tile walks ~2.5x fewer pieces;
//   - differences go in as two native 32-bit atomics (add_fixed), and a
//     piece wholly left of the tile adds its step to dy to its row's
//     carry, not to a column, without marking the tile; a tile that no
//     piece crosses and whose rows' carries are all 0 has every winding
//     0 and writes zeros;
//   - a warp scans a row (4 columns a lane, a shuffle scan of the lane
//     totals, the carry added at the front): integer sums, so the same
//     integers as the serial prefix; the solid composite of kLc <= 4
//     layers runs on those windings in registers (tile_composite, B1's
//     solid_composite op for op); the styled resolve and more layers read
//     them from the plane slots, layer by layer (tile_layered, B2's
//     order); a pixel whose windings are all 0 writes 0 at once;
//   - the frame's tables load while the planes are zeroed (tile_setup),
//     and on large grids a column block walks five column tiles of its
//     band (one hit list, one set-up); the words go out 16 bytes a store.
// Every pixel sums the same integers as sweep_plain's index_add_ and
// composites in composite_quantize_pack's order: byte-equal (the zero
// shortcuts take the colours and paints as finite, as the first form's
// untouched tiles do).

constexpr int kFineChunk = 16;                 // pieces a row-bounds chunk
constexpr size_t kTileSmemBudget = 100 * 1024;   // a block's planes
// Blocks an SM the kernels' register bound asks for.  Up to 4 layers
// the planes fill the budget and leave room for two blocks, so the
// styled and small-class forms may take 128 registers a thread (without
// a bound ptxas kept the styled ones at 80, with spills); the 16-layer
// class's shorter planes leave room for three, as its 80 registers did.
__host__ __device__ constexpr int tile_min_blocks(bool styled, int lc) {
  return styled || lc <= kSolidSmallLayers ? 2 : 3;
}
// Column blocks (B3, B6, B7) walk a run of up to kTileRun column tiles
// of their band in turn (its hit list built once, the frame's tables
// loaded once): the longest run that keeps at least kTileRunBlocks
// blocks, one tile a block where none does (a 16-frame 1080p morph keeps
// 2,176 blocks at four tiles a run, anim1080's 60 frames 6,120 at five).
constexpr int kTileRun = 5;
constexpr long long kTileRunBlocks = 2048;

__host__ __device__ inline int tile_run(int frames, int bands, int tiles) {
  for (int run = kTileRun; run > 1; --run) {
    if (static_cast<long long>(frames) * bands * ((tiles + run - 1) / run)
        >= kTileRunBlocks) {
      return run;
    }
  }
  return 1;
}

// Rows of a tile (B3) or band (B4): the most (a power of two, at most
// kSweepMaxRows) whose layer planes of tile_w long longs fit the budget.
__host__ __device__ inline int tile_rows(int layers, int tile_w) {
  int rows = kSweepMaxRows;
  while (rows > 1 && static_cast<size_t>(layers) * rows * tile_w * 8
                         > kTileSmemBudget) {
    rows /= 2;
  }
  return rows;
}

__host__ __device__ inline size_t tile_zeroed_bytes(int layers, int rows,
                                                    int tile_w) {
  return align16(static_cast<size_t>(layers) * rows * tile_w * 8) +
         align16(static_cast<size_t>(layers) * rows * 8);
}

// Shared-memory carve-up: planes (rows of tile_w long longs, 16-byte
// aligned for the scan's vector loads), each row's carry, then the
// colours, matrices, rules and flags (the tile's touched flag, the hit
// count), the hit list and (styled) the paint records.
__host__ __device__ inline size_t tile_smem_bytes(int layers, int rows,
                                                  int tile_w, bool styled) {
  size_t n = tile_zeroed_bytes(layers, rows, tile_w);
  n += align16(static_cast<size_t>(layers) * 4 * 4);
  n += align16(static_cast<size_t>(layers) * 6 * 4);
  n += align16(static_cast<size_t>(layers + 2) * 4);
  n += align16(static_cast<size_t>(kSweepMaxHits) * 4);
  if (styled) {
    n += align16(static_cast<size_t>(layers) * kPintStride * 4);
    n += align16(static_cast<size_t>(layers) * kPfltStride * 4);
  }
  return n;
}

__device__ inline SweepShared tile_carve(unsigned char* smem, int layers,
                                         int rows, int tile_w, bool styled) {
  SweepShared s{};
  s.plane = reinterpret_cast<long long*>(smem);
  size_t off = align16(static_cast<size_t>(layers) * rows * tile_w * 8);
  s.carry = reinterpret_cast<long long*>(smem + off);
  off = tile_zeroed_bytes(layers, rows, tile_w);
  s.col = reinterpret_cast<float*>(smem + off);
  off += align16(static_cast<size_t>(layers) * 4 * 4);
  s.mat = reinterpret_cast<float*>(smem + off);
  off += align16(static_cast<size_t>(layers) * 6 * 4);
  s.rule = reinterpret_cast<int*>(smem + off);
  s.touched = s.rule + layers;
  s.n_hits = s.touched + 1;
  off += align16(static_cast<size_t>(layers + 2) * 4);
  s.hits = reinterpret_cast<int*>(smem + off);
  off += align16(static_cast<size_t>(kSweepMaxHits) * 4);
  if (styled) {
    s.pint = reinterpret_cast<int*>(smem + off);
    off += align16(static_cast<size_t>(layers) * kPintStride * 4);
    s.pflt = reinterpret_cast<float*>(smem + off);
  }
  return s;
}

// Pre-pass of tile_sweep_block, one block of blockDim.x pieces per (piece
// run, layer, frame): the lowest and highest row base of each
// kFineChunk-piece chunk (bounds is (F, L, n_chunks, 2) with n_chunks =
// ceil(ep / kFineChunk)).  Pieces are path-ordered, so a chunk spans few
// rows and a tile's walk skips most chunks on two compares.
template <bool kMorph, bool kAffine>
__device__ void fine_bounds_block(const SweepArgs& a, float* red) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int l = blockIdx.y;
  const int f = blockIdx.z;
  const int p = blockIdx.x * nthr + tid;
  float lo = 3.0e38f;
  float hi = -3.0e38f;
  if (p < min(a.counts[l], a.ep)) {
    const float t = kMorph ? a.ratios[f] : 0.0f;
    const float* M = nullptr;
    if (kAffine) {
      M = a.mats + (a.mats_per_layer
                        ? (static_cast<long long>(f) * a.layers + l) * 6
                        : static_cast<long long>(f) * 6);
    }
    float x0, y0, x1, y1;
    device_piece<kMorph, kAffine>(
        a.tab_s + static_cast<long long>(l) * 4 * a.ep,
        kMorph ? a.tab_e + static_cast<long long>(l) * 4 * a.ep : nullptr,
        a.ep, p, t, 1.0f - t, M, x0, y0, x1, y1);
    lo = hi = floorf(fminf(y0, y1));
  }
  red[tid] = lo;
  red[nthr + tid] = hi;
  __syncthreads();
  for (int s = kFineChunk / 2; s > 0; s /= 2) {
    if (tid % kFineChunk < s) {
      red[tid] = fminf(red[tid], red[tid + s]);
      red[nthr + tid] = fmaxf(red[nthr + tid], red[nthr + tid + s]);
    }
    __syncthreads();
  }
  const int chunk = p / kFineChunk;
  if (tid % kFineChunk == 0 && chunk < a.n_chunks) {
    float* b = a.bounds + ((static_cast<long long>(f) * a.layers + l)
                           * a.n_chunks + chunk) * 2;
    b[0] = red[tid];
    b[1] = red[nthr + tid];
  }
}

// Adds q to a 32.32 slot as two native 32-bit shared atomics (a 64-bit
// shared atomicAdd is a compare-and-swap loop on this card): the adder
// whose add wraps the low word carries one into the high word, so the
// slot ends as the same sum modulo 2^64 in any order.
__device__ __forceinline__ void add_fixed(long long* slot, long long q) {
  const unsigned long long u = static_cast<unsigned long long>(q);
  unsigned* w = reinterpret_cast<unsigned*>(slot);
  const unsigned lo = static_cast<unsigned>(u);
  unsigned hi = static_cast<unsigned>(u >> 32);
  if (lo != 0u) {
    const unsigned old = atomicAdd(&w[0], lo);
    hi += old + lo < old ? 1u : 0u;
  }
  if (hi != 0u) atomicAdd(&w[1], hi);
}

// One device-space piece into a tile (B3, B5) or a band's chunk (B4):
// for each of the <= 2 rows it touches that lie in the tile, the
// differences ramp(x) - ramp(x - 1) over the columns [c0, c1) it
// crosses, ending with the step to dy, in 32.32 fixed point, each added
// by add_fixed (coverage.py edge_contribution's terms, operation for
// operation).  Without ``carry`` a piece wholly left
// of the tile (hi <= c0: its value at c0 is dy) adds to_fixed(dy) to its
// row's carry, which the scan adds at the row's front, and leaves the
// tile unmarked; a piece that reaches the tile's columns marks it.
__device__ __forceinline__ void tile_scatter(
    float x0, float y0, float x1, float y1, int r0, int c0, float r0f,
    float r1f, float c0f, float c1f, bool carry, long long* lplane,
    int stride, long long* lcarry, int* touched_s) {
  const float rowbase = floorf(fminf(y0, y1));
  for (int k = 0; k < 2; ++k) {
    const float py = rowbase + static_cast<float>(k);
    if (!(py >= r0f && py < r1f)) continue;
    const float sy0 = y0 - py;
    const float sy1 = y1 - py;
    const float cy0 = clamp01(sy0);
    const float cy1 = clamp01(sy1);
    const float dy = cy1 - cy0;
    if (dy == 0.0f) continue;
    const float dyd = sy1 - sy0;
    const float safe = fabsf(dyd) < 1e-9f ? 1.0f : dyd;
    const float t0 = (cy0 - sy0) / safe;
    const float t1 = (cy1 - sy0) / safe;
    const float dxs = x1 - x0;
    const float xa = x0 + t0 * dxs;
    const float xb = x0 + t1 * dxs;
    const float xmn = fminf(xa, xb);
    const float xmx = fmaxf(xa, xb);
    const float lo = floorf(xmn);
    const float hi = ceilf(xmx);
    if (lo >= c1f) continue;    // the ramp starts right of the tile
    if (carry && hi <= c0f - 1.0f) continue;   // complete before c0 - 1
    const int ri = static_cast<int>(py) - r0;
    if (!carry && hi <= c0f) {
      add_fixed(&lcarry[ri], to_fixed(dy));
      continue;
    }
    const float span = xmx - xmn;
    const bool thin = span < 1e-9f;
    const float safe_span = thin ? 1.0f : span;
    // The piece's value at pixel column px.
    auto value = [&](float px) {
      float v = dy;
      if (px < hi) {
        const float rel_mn = xmn - px;
        const float rel_mx = xmx - px;
        const float mean = thin
            ? clamp01(0.5f * (rel_mn + rel_mx))
            : (h01(rel_mx) - h01(rel_mn)) / safe_span;
        v = dy * (1.0f - mean);
      }
      return v;
    };
    const int xs = static_cast<int>(fmaxf(lo, c0f));
    const int xe = static_cast<int>(
        fminf(fmaxf(hi, static_cast<float>(xs)), c1f - 1.0f));
    long long* row = lplane + ri * stride;
    *touched_s = 1;
    long long prev = (carry && lo < c0f) ? to_fixed(value(c0f - 1.0f)) : 0;
    for (int x = xs; x <= xe; ++x) {
      const long long q = to_fixed(value(static_cast<float>(x)));
      add_fixed(&row[x - c0], q - prev);
      prev = q;
    }
  }
}

// The hit list of pairs [base, base + kSweepMaxHits) of L x n_chunks:
// (layer, chunk) pairs whose row bounds reach rows [r0, r1) (a chunk
// past its layer's count has the empty bounds +-3e38).  Returns the
// count; ends synchronised.
__device__ __forceinline__ int tile_hits(const SweepShared& s,
                                         const float* bounds, int base,
                                         int n_pairs, float r0f, float r1f) {
  const int tid = threadIdx.x;
  if (tid == 0) *s.n_hits = 0;
  __syncthreads();
  for (int pair = base + tid; pair < min(base + kSweepMaxHits, n_pairs);
       pair += blockDim.x) {
    if (bounds[2 * pair + 1] >= r0f - 1.0f && bounds[2 * pair] < r1f) {
      s.hits[atomicAdd(s.n_hits, 1)] = pair;
    }
  }
  __syncthreads();
  return *s.n_hits;
}

// The listed chunks' pieces, kFineChunk threads a chunk, into the tile:
// rows [r0, r1), columns [c0, c1) of frame f.
template <bool kMorph, bool kAffine>
__device__ __forceinline__ void tile_place(const SweepArgs& a,
                                           const SweepShared& s, int n_hits,
                                           float t, float omt, int stride,
                                           int r0, int r1, int c0, int c1,
                                           bool carry) {
  const int tid = threadIdx.x;
  const int R = a.rows;
  const float c0f = static_cast<float>(c0);
  const float c1f = static_cast<float>(c1);
  const float r0f = static_cast<float>(r0);
  const float r1f = static_cast<float>(r1);
  for (int h = tid / kFineChunk; h < n_hits;
       h += blockDim.x / kFineChunk) {
    const int l = s.hits[h] / a.n_chunks;
    const int p = (s.hits[h] % a.n_chunks) * kFineChunk + tid % kFineChunk;
    if (p >= min(a.counts[l], a.ep)) continue;
    float x0, y0, x1, y1;
    device_piece<kMorph, kAffine>(
        a.tab_s + static_cast<long long>(l) * 4 * a.ep,
        kMorph ? a.tab_e + static_cast<long long>(l) * 4 * a.ep : nullptr,
        a.ep, p, t, omt, s.mat + l * 6, x0, y0, x1, y1);
    tile_scatter(x0, y0, x1, y1, r0, c0, r0f, r1f, c0f, c1f, carry,
                 s.plane + static_cast<long long>(l) * R * stride, stride,
                 s.carry + l * R, s.touched);
  }
}

// B1's solid_composite (composite_pack's arithmetic, operation for
// operation) over windings wind(l) and straight colours colour(l).
template <bool kExact, int kLc, typename WindFn, typename ColourFn>
__device__ __forceinline__ uint32_t tile_composite(WindFn wind,
                                                   ColourFn colour,
                                                   unsigned eo, int L) {
  float cas[kLc];
  float4 cl[kLc];
#pragma unroll
  for (int l = 0; l < kLc; ++l) {
    if (kExact || l < L) {
      cl[l] = colour(l);
      cas[l] = cl[l].w * fill_cov(wind(l), static_cast<int>((eo >> l) & 1u));
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

// Words of the lane's four pixels from x on (px0 its first word),
// those at tile columns < tile_w: 16 bytes a store when rows are 16-byte
// aligned (kBin: when px0 is, a bin starting at any column).
template <bool kBin = false>
__device__ __forceinline__ void tile_store(const SweepArgs& a, long long px0,
                                           int cl, int tile_w,
                                           const uint32_t* w) {
  if (cl + 3 < tile_w && (kBin ? px0 % 4 == 0 : a.width % 4 == 0)) {
    *reinterpret_cast<int4*>(a.out + px0) = make_int4(
        static_cast<int>(w[0]), static_cast<int>(w[1]),
        static_cast<int>(w[2]), static_cast<int>(w[3]));
  } else {
    for (int k = 0; k < 4 && cl + k < tile_w; ++k) {
      a.out[px0 + k] = static_cast<int>(w[k]);
    }
  }
}

// The resolve of the lane's four pixels layer by layer (B2's single
// pass): the styled one (kPaint: gradient and field paints) and the
// solid one above 4 layers.  The plane slots of the row hold the
// windings as floats (the first word of each long long), then the
// weights; pixel k is column c0 + cl + k of row y, paints read at
// column x0 + c0 + cl + k of the global grid.  A pixel whose
// windings are all 0 is transparent black whatever its (finite) paints:
// its word is 0 without the composite.
template <bool kPaint>
__device__ __forceinline__ void tile_layered(const SweepArgs& a,
                                             const SweepShared& s, int r,
                                             int y, long long pix, int x0,
                                             int cl, int tile_w, int stride,
                                             uint32_t* words) {
  const int L = a.layers;
  const int R = a.rows;
  const float py = static_cast<float>(y) + 0.5f;
  const float px = static_cast<float>(pix % a.width + x0) + 0.5f;
  const long long plane_px =
      static_cast<long long>(a.frames) * a.height * a.width;
  auto slots = [&](int l) {
    return reinterpret_cast<float*>(
        s.plane + (static_cast<long long>(l) * R + r) * stride + cl);
  };
  auto field = [&](const int* I) {
    return reinterpret_cast<const float4*>(a.fields)
        + static_cast<long long>(I[3]) * plane_px + pix;
  };
  bool blank[4] = {true, true, true, true};
  for (int l = 0; l < L; ++l) {
    const float* w = slots(l);
#pragma unroll
    for (int k = 0; k < 4; ++k) blank[k] = blank[k] && w[2 * k] == 0.0f;
  }
  if (blank[0] && blank[1] && blank[2] && blank[3]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) words[k] = 0u;
    return;
  }
  // Top down: each layer's weight cas * (the suffix product of the
  // layers above it), into its slots.
  float suffix[4];
  for (int l = L - 1; l >= 0; --l) {
    const int* I = kPaint ? s.pint + l * kPintStride : nullptr;
    const float* P = kPaint ? s.pflt + l * kPfltStride : nullptr;
    const int rule = s.rule[l];
    const float col_a = s.col[4 * l + 3];
    float* w = slots(l);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float cov = fill_cov(w[2 * k], rule);
      float alpha = col_a;
      // An uncovered pixel-layer weighs exactly 0 whatever its paint.
      if (kPaint && cov != 0.0f && cl + k < tile_w) {
        if (I[0] == kPaintLinear || I[0] == kPaintFocal) {
          const float tg = grad_t(P, I, px + static_cast<float>(k), py);
          alpha = grad_ramp(P, I[2], tg, 3);
        } else if (I[0] == kPaintField) {
          alpha = field(I)[k].w;
        }
      }
      const float cas = alpha * cov;
      if (l == L - 1) {
        w[2 * k] = cas;
        suffix[k] = 1.0f - cas;
      } else {
        w[2 * k] = cas * suffix[k];
        suffix[k] = suffix[k] * (1.0f - cas);
      }
    }
  }
  // Bottom up: alpha and the premultiplied channels, summed left to
  // right (a weight of 0 adds exactly 0 whatever its colour).
  float alpha_out[4];
  float pm[4][3];
  for (int l = 0; l < L; ++l) {
    const int* I = kPaint ? s.pint + l * kPintStride : nullptr;
    const float* P = kPaint ? s.pflt + l * kPfltStride : nullptr;
    const float* w = slots(l);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float wgt = w[2 * k];
      float rgb[3] = {s.col[4 * l], s.col[4 * l + 1], s.col[4 * l + 2]};
      if (kPaint && wgt != 0.0f && cl + k < tile_w) {
        if (I[0] == kPaintLinear || I[0] == kPaintFocal) {
          const float tg = grad_t(P, I, px + static_cast<float>(k), py);
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            rgb[ch] = grad_ramp(P, I[2], tg, ch);
          }
        } else if (I[0] == kPaintField) {
          const float4 v = field(I)[k];
          rgb[0] = v.x;
          rgb[1] = v.y;
          rgb[2] = v.z;
        }
      }
      if (l == 0) {
        alpha_out[k] = wgt;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) pm[k][ch] = rgb[ch] * wgt;
      } else {
        alpha_out[k] = alpha_out[k] + wgt;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          pm[k][ch] = pm[k][ch] + rgb[ch] * wgt;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    words[k] = blank[k] ? 0u : quantize_pack(alpha_out[k], pm[k]);
  }
}

// Scan and resolve of a tile (B3) or a band's chunk (B4) whose planes
// hold the walk's differences and whose carries the winding at the
// tile's left border: warp w takes rows w, w + 8, ...; a lane takes four
// columns of each 128-column segment.  kLc: the solid composite's layer
// class (windings in registers and tile_composite when kLc <= 4, else
// tile_layered).  Leaves each row's carry at its winding in the tile's
// last column.  kBin: B5's tiles, whose first column is any.  x0: the
// global column of frame column 0, where the paints are read (the column
// sweeps' a.x_shift; 0 in B4 and B5).
template <bool kStyled, int kLc, int kTileW, bool kBin = false>
__device__ void tile_resolve(const SweepArgs& a, const SweepShared& s,
                             int f, int r0, int tile_h, int c0, int tile_w,
                             unsigned eo, const float4* creg, int x0 = 0) {
  constexpr bool kInReg = !kStyled && kLc <= 4;
  const int lane = threadIdx.x & 31;
  const int L = a.layers;
  const int R = a.rows;
  for (int r = threadIdx.x >> 5; r < tile_h; r += blockDim.x >> 5) {
    const int y = r0 + r;
#pragma unroll 1
    for (int seg = 0; seg < kTileW / kLane; ++seg) {
      const int cl = seg * kLane + 4 * lane;
      const long long pix =
          (static_cast<long long>(f) * a.height + y) * a.width + c0 + cl;
      float wr[kInReg ? kLc : 1][4];
      auto scan = [&](int l) {
        long long* row = s.plane + (static_cast<long long>(l) * R + r)
            * kTileW + cl;
        const longlong2 v01 = reinterpret_cast<const longlong2*>(row)[0];
        const longlong2 v23 = reinterpret_cast<const longlong2*>(row)[1];
        const long long d[4] = {v01.x, v01.y, v23.x, v23.y};
        long long q[4];
        long long acc = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc += d[k];
          q[k] = acc;
        }
        // Inclusive scan of the lane totals across the warp.
        long long inc = acc;
#pragma unroll
        for (int dl = 1; dl < 32; dl *= 2) {
          const long long u = __shfl_up_sync(0xffffffffu, inc, dl);
          if (lane >= dl) inc += u;
        }
        long long* cy = s.carry + l * R + r;
        const long long front = *cy + (inc - acc);
        const long long total = __shfl_sync(0xffffffffu, inc, 31);
        __syncwarp();
        if (lane == 0) *cy = *cy + total;
        __syncwarp();
        float w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = from_fixed(front + q[k]);
        if constexpr (kInReg) {
#pragma unroll
          for (int k = 0; k < 4; ++k) wr[l][k] = w[k];
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            reinterpret_cast<float*>(row + k)[0] = w[k];
          }
        }
      };
      uint32_t words[4];
      if constexpr (kInReg) {
#pragma unroll
        for (int l = 0; l < kLc; ++l) {
          if (l < L) scan(l);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          bool blank = true;
#pragma unroll
          for (int l = 0; l < kLc; ++l) {
            if (l < L) blank = blank && wr[l][k] == 0.0f;
          }
          auto wind = [&](int l) { return wr[l][k]; };
          auto colour = [&](int l) { return creg[l]; };
          words[k] = blank ? 0u
              : L == kLc ? tile_composite<true, kLc>(wind, colour, eo, L)
                         : tile_composite<false, kLc>(wind, colour, eo, L);
        }
      } else {
        for (int l = 0; l < L; ++l) scan(l);
        tile_layered<kStyled>(a, s, r, y, pix, x0, cl, tile_w, kTileW,
                              words);
      }
      if (cl < tile_w) tile_store<kBin>(a, pix, cl, tile_w, words);
    }
  }
}

// Zeroes n16 16-byte words of shared memory from p.
__device__ __forceinline__ void tile_zero_smem(unsigned char* p, size_t n16) {
  int4* z = reinterpret_cast<int4*>(p);
  for (size_t i = threadIdx.x; i < n16; i += blockDim.x) {
    z[i] = make_int4(0, 0, 0, 0);
  }
}

// Frame f's colours, matrices, rules and (styled) paint records for the
// tiled body, with the planes and carries (the first zero16 16-byte
// words) zeroed while they arrive:
// the colours, matrices and rules are loaded into registers (one value a
// thread) and the paint records by cp.async before the zeroing.  Ends
// synchronised.
template <bool kMorph, bool kAffine, bool kStyled>
__device__ void tile_setup(const SweepArgs& a, const SweepShared& s,
                           unsigned char* smem, size_t zero16, int f,
                           float t, float omt) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int L = a.layers;
  if (kStyled) {
    for (int i = tid; i < L * (kPintStride / 4); i += nthr) {
      cp_async16(reinterpret_cast<float*>(s.pint) + 4 * i,
                 reinterpret_cast<const float*>(a.pint) + 4 * i);
    }
    for (int i = tid; i < L * (kPfltStride / 4); i += nthr) {
      cp_async16(s.pflt + 4 * i, a.pflt + 4 * i);
    }
    cp_async_commit();
  }
  // Thread i < 11 L holds colour i, matrix entry i - 4 L or rule
  // i - 10 L (11 L <= 176 < kThreads).
  float v = 0.0f;
  int rv = 0;
  if (tid < L * 4) {
    if (kMorph) {
      v = omt * a.colors[tid] + t * a.colors_e[tid];
    } else if (a.colors_per_frame) {
      v = a.colors[static_cast<long long>(f) * L * 4 + tid];
    } else {
      v = a.colors[tid];
    }
  } else if (tid < L * 10) {
    const int i = tid - L * 4;
    if (kAffine) {
      v = a.mats_per_layer ? a.mats[static_cast<long long>(f) * L * 6 + i]
                           : a.mats[static_cast<long long>(f) * 6 + i % 6];
    }
  } else if (tid < L * 11) {
    rv = a.rules[tid - L * 10];
  }
  tile_zero_smem(smem, zero16);
  if (tid < L * 4) {
    s.col[tid] = v;
  } else if (tid < L * 10) {
    if (kAffine) s.mat[tid - L * 4] = v;
  } else if (tid < L * 11) {
    s.rule[tid - L * 10] = rv;
  }
  if (tid == 0) *s.touched = 0;
  if (kStyled) cp_async_wait(0);
  __syncthreads();
  if (kStyled) {
    // This frame's part of the gradient records: the composed device ->
    // gradient matrix and, with per-frame stops, the first stop and the
    // colour steps (f32 differences, as the reference takes them).
    for (int l = tid; l < L; l += nthr) {
      const int kind = s.pint[l * kPintStride];
      if (kind != kPaintLinear && kind != kPaintFocal) continue;
      float* P = s.pflt + l * kPfltStride;
      const float* gm = a.grad_mats + (static_cast<long long>(f) * L + l) * 6;
      for (int k = 0; k < 6; ++k) P[kPInv + k] = gm[k];
      if (a.stop_colors != nullptr) {
        const int n_stops = s.pint[l * kPintStride + 2];
        const float* sc = a.stop_colors
            + (static_cast<long long>(f) * L + l) * a.n_stop_slots * 4;
        for (int ch = 0; ch < 4; ++ch) P[kPC0 + ch] = sc[ch];
        for (int k = 0; k + 1 < n_stops; ++k) {
          for (int ch = 0; ch < 4; ++ch) {
            P[kPDc + 4 * k + ch] = sc[4 * (k + 1) + ch] - sc[4 * k + ch];
          }
        }
      }
    }
    __syncthreads();
  }
}

// Transparent black for a tile whose windings are all 0.
template <bool kBin = false>
__device__ __forceinline__ void tile_zero_words(const SweepArgs& a, int f,
                                                int r0, int tile_h, int c0,
                                                int tile_w) {
  const int quads = (tile_w + 3) / 4;
  const uint32_t zero[4] = {0u, 0u, 0u, 0u};
  for (int i = threadIdx.x; i < tile_h * quads; i += blockDim.x) {
    const int cl = 4 * (i % quads);
    tile_store<kBin>(a, (static_cast<long long>(f) * a.height + r0
                         + i / quads) * a.width + c0 + cl, cl, tile_w,
                     zero);
  }
}

// One block of B3 (kTileW = kLane: the a.bins_per_block tiles of columns
// from blockIdx.x * a.bins_per_block * kLane, each on its own) or of B4
// (kTileW = kRowChunk: the band's chunks left to right, each row's
// winding at a chunk's last column carried into the next), rows
// blockIdx.y * a.rows ... of frame blockIdx.z.
//
// The column sweeps' origin, a.x_shift (0 for a whole frame; a tile
// shard of a wider frame, ops/transform.py x_shift): frame column c is
// column c + x_shift of the global pixel grid.  The walk places the
// device-space pieces on the global columns and the gradients read them
// there; only the words land at local columns.  Every pixel's winding is
// the same sum of 32.32 integers as at that global column of the full
// frame (the zero shortcuts are exact), so a shard's words equal those
// columns of the unshifted frame whatever the shard's tiles.  The row
// bounds of the pre-pass do not depend on columns.  B4 takes no origin.
template <bool kMorph, bool kAffine, bool kStyled, int kLc, int kTileW>
__device__ void tile_sweep_block(const SweepArgs& a, unsigned char* smem) {
  constexpr bool kBand = kTileW != kLane;
  const int x0 = kBand ? 0 : a.x_shift;
  const int tid = threadIdx.x;
  const int L = a.layers;
  const int R = a.rows;
  const int r0 = blockIdx.y * R;
  const int f = blockIdx.z;
  const int r1 = min(r0 + R, a.height);
  const int tile_h = r1 - r0;
  const SweepShared s = tile_carve(smem, L, R, kTileW, kStyled);
  const float t = kMorph ? a.ratios[f] : 0.0f;
  const float omt = 1.0f - t;
  const size_t plane16 =
      align16(static_cast<size_t>(L) * R * kTileW * 8) / 16;

  tile_setup<kMorph, kAffine, kStyled>(
      a, s, smem, tile_zeroed_bytes(L, R, kTileW) / 16, f, t, omt);
  unsigned eo = 0;
  float4 creg[!kStyled && kLc <= 4 ? kLc : 1];
  if constexpr (!kStyled) {
#pragma unroll
    for (int l = 0; l < kLc; ++l) {
      if (l < L) {
        eo |= (s.rule[l] != 0 ? 1u : 0u) << l;
        if constexpr (kLc <= 4) {
          creg[l] = reinterpret_cast<const float4*>(s.col)[l];
        }
      }
    }
  }
  const float* bounds =
      a.bounds + static_cast<long long>(f) * L * a.n_chunks * 2;
  const int n_pairs = L * a.n_chunks;
  const float r0f = static_cast<float>(r0);
  const float r1f = static_cast<float>(r1);
  // A band's chunks or tiles share its rows, so one list serves them all
  // when it holds every pair.
  const int run = kBand ? 1 : a.bins_per_block;
  const bool listed = (kBand || run > 1) && n_pairs <= kSweepMaxHits;
  const int n_listed = listed ? tile_hits(s, bounds, 0, n_pairs, r0f, r1f)
                              : 0;
  const int c_first = kBand ? 0 : blockIdx.x * run * kTileW;
  const int c_end = kBand ? a.width : min(c_first + run * kTileW, a.width);
  for (int c0 = c_first; c0 < c_end; c0 += kTileW) {
    const int c1 = min(c0 + kTileW, a.width);
    const bool carry = kBand && c0 > 0;
    const int g0 = c0 + x0;   // the walk's columns, on the global grid
    const int g1 = c1 + x0;
    if (c0 > c_first) {
      __syncthreads();   // the previous chunk's resolve has read the planes
      if (tid == 0) *s.touched = 0;
      // B4 carries each row's winding on; a B3 tile starts its own.
      tile_zero_smem(smem, kBand ? plane16
                                 : tile_zeroed_bytes(L, R, kTileW) / 16);
      __syncthreads();
    }
    if (listed) {
      tile_place<kMorph, kAffine>(a, s, n_listed, t, omt, kTileW, r0, r1,
                                  g0, g1, carry);
    } else {
      for (int base = 0; base < n_pairs; base += kSweepMaxHits) {
        const int n_hits = tile_hits(s, bounds, base, n_pairs, r0f, r1f);
        tile_place<kMorph, kAffine>(a, s, n_hits, t, omt, kTileW, r0, r1,
                                    g0, g1, carry);
        __syncthreads();   // the next round rewrites the list
      }
    }
    __syncthreads();
    // Every winding of the tile is 0 when no piece reached its columns
    // and every row's carry is 0.
    for (int i = tid; i < L * tile_h; i += blockDim.x) {
      if (s.carry[(i / tile_h) * R + i % tile_h] != 0) *s.touched = 1;
    }
    __syncthreads();
    if (*s.touched == 0) {
      tile_zero_words(a, f, r0, tile_h, c0, c1 - c0);
      continue;
    }
    tile_resolve<kStyled, kLc, kTileW>(a, s, f, r0, tile_h, c0, c1 - c0,
                                       eo, creg, x0);
  }
}

// The listed chunks of bin (f, bin)'s gathered device-space pieces
// (fb = (f * n_bins + bin) * L), kFineChunk threads a chunk, into the
// tile: rows [r0, r1), columns [c0, c1).
__device__ __forceinline__ void bin_place(const SweepArgs& a,
                                          const SweepShared& s, long long fb,
                                          int n_hits, int r0, int r1, int c0,
                                          int c1) {
  const int tid = threadIdx.x;
  const int R = a.rows;
  const float c0f = static_cast<float>(c0);
  const float c1f = static_cast<float>(c1);
  const float r0f = static_cast<float>(r0);
  const float r1f = static_cast<float>(r1);
  for (int h = tid / kFineChunk; h < n_hits;
       h += blockDim.x / kFineChunk) {
    const int l = s.hits[h] / a.n_chunks;
    const int p = (s.hits[h] % a.n_chunks) * kFineChunk + tid % kFineChunk;
    if (p >= a.ccount[fb + l]) continue;
    const float* src = a.ctab + (fb + l) * 4 * a.cap;
    tile_scatter(src[p], src[a.cap + p], src[2 * a.cap + p],
                 src[3 * a.cap + p], r0, c0, r0f, r1f, c0f, c1f, false,
                 s.plane + static_cast<long long>(l) * R * kLane, kLane,
                 s.carry + l * R, s.touched);
  }
}

// One block of B5: bins blockIdx.x * a.bins_per_block + k of a.bin_w
// columns, rows blockIdx.y * a.rows ... of frame blockIdx.z, each in
// kLane-column tiles.  A tile seeds each row's carry with the prefix
// plane (the dy of the pieces wholly left of its bin) and walks only the
// bin's gathered pieces, through B3's steps: a gathered piece wholly left
// of the tile adds its dy to the carry, so a bin's second tile (bins
// wider than kLane) sums the same integers as the first's carry would.
template <bool kStyled, int kLc>
__device__ void bin_sweep_block(const SweepArgs& a, unsigned char* smem) {
  const int tid = threadIdx.x;
  const int L = a.layers;
  const int R = a.rows;
  const int r0 = blockIdx.y * R;
  const int f = blockIdx.z;
  const int r1 = min(r0 + R, a.height);
  const int tile_h = r1 - r0;
  const SweepShared s = tile_carve(smem, L, R, kLane, kStyled);
  const size_t plane16 = align16(static_cast<size_t>(L) * R * kLane * 8) / 16;

  tile_setup<false, false, kStyled>(
      a, s, smem, tile_zeroed_bytes(L, R, kLane) / 16, f, 0.0f, 1.0f);
  unsigned eo = 0;
  float4 creg[!kStyled && kLc <= 4 ? kLc : 1];
  if constexpr (!kStyled) {
#pragma unroll
    for (int l = 0; l < kLc; ++l) {
      if (l < L) {
        eo |= (s.rule[l] != 0 ? 1u : 0u) << l;
        if constexpr (kLc <= 4) {
          creg[l] = reinterpret_cast<const float4*>(s.col)[l];
        }
      }
    }
  }
  const int n_pairs = L * a.n_chunks;
  const float r0f = static_cast<float>(r0);
  const float r1f = static_cast<float>(r1);
  bool first = true;
  // Whether the planes may hold a walk's differences or a resolve's
  // weights: a tile written as zeros had no piece reach its columns, so
  // it leaves its planes zero for the next one (whose seeds overwrite
  // every carry it reads).
  bool dirty = false;
  for (int k = 0; k < a.bins_per_block; ++k) {
    const int bin = blockIdx.x * a.bins_per_block + k;
    if (bin >= a.n_bins) break;   // the same for every thread
    const long long fb = (static_cast<long long>(f) * a.n_bins + bin) * L;
    const float* bounds = a.cbounds + fb * a.n_chunks * 2;
    const int b0 = bin * a.bin_w;
    const int b1 = min(b0 + a.bin_w, a.width);
    for (int c0 = b0; c0 < b1; c0 += kLane) {
      const int c1 = min(c0 + kLane, b1);
      // The first walk round's row bounds and this thread's prefix seed
      // (L * rows <= 100 < kThreads: one a thread) load before the
      // zeroing, which hides their latency.
      float2 bp[kSweepMaxHits / kThreads];
#pragma unroll
      for (int q = 0; q < kSweepMaxHits / kThreads; ++q) {
        const int pair = tid + q * kThreads;
        bp[q] = pair < n_pairs ? make_float2(bounds[2 * pair],
                                             bounds[2 * pair + 1])
                               : make_float2(3.0e38f, -3.0e38f);
      }
      long long seed = 0;
      if (tid < L * tile_h) {
        seed = a.prefix[((static_cast<long long>(f) * L + tid / tile_h)
                         * a.n_bins + bin) * a.height + r0 + tid % tile_h];
      }
      if (!first) {
        __syncthreads();   // the previous tile's resolve has read the planes
        if (dirty) tile_zero_smem(smem, plane16);
      }
      first = false;
      if (tid == 0) {
        *s.touched = 0;
        *s.n_hits = 0;
      }
      __syncthreads();
      if (tid < L * tile_h) s.carry[(tid / tile_h) * R + tid % tile_h] = seed;
#pragma unroll
      for (int q = 0; q < kSweepMaxHits / kThreads; ++q) {
        if (bp[q].y >= r0f - 1.0f && bp[q].x < r1f) {
          s.hits[atomicAdd(s.n_hits, 1)] = tid + q * kThreads;
        }
      }
      __syncthreads();   // the seeds and the list are in place
      bin_place(a, s, fb, *s.n_hits, r0, r1, c0, c1);
      __syncthreads();   // the next round rewrites the list
      for (int base = kSweepMaxHits; base < n_pairs; base += kSweepMaxHits) {
        const int n_hits = tile_hits(s, bounds, base, n_pairs, r0f, r1f);
        bin_place(a, s, fb, n_hits, r0, r1, c0, c1);
        __syncthreads();
      }
      // Every winding of the tile is 0 when no piece reached its columns
      // and every row's carry is 0.
      for (int i = tid; i < L * tile_h; i += blockDim.x) {
        if (s.carry[(i / tile_h) * R + i % tile_h] != 0) *s.touched = 1;
      }
      __syncthreads();
      dirty = *s.touched != 0;
      if (!dirty) {
        tile_zero_words<true>(a, f, r0, tile_h, c0, c1 - c0);
        continue;
      }
      tile_resolve<kStyled, kLc, kLane, true>(a, s, f, r0, tile_h, c0,
                                              c1 - c0, eo, creg);
    }
  }
}

}  // namespace swf
