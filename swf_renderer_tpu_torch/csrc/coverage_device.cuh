// Device logic of the three direct coverage kernels: edge tables ->
// per-pixel analytic coverage.
//
// Replace the TPU kernels `_banded_kernel` (B9, swf_renderer_tpu/ops/
// coverage.py:559, pallas_call :645), `_coverage_kernel` (B10, :169,
// pallas_call :360) in its production `scalar_loop` body (:218-261) and
// `_grouped_kernel` (B11, :404, pallas_call :517).
//
// What they compute, per plane b and pixel cell (x, y): the sum over the
// plane's edges of the signed area of the part of the cell right of the
// edge, restricted to the edge's y-span (the integral of the winding
// number over the cell), then the fill rule (nonzero min(|acc|, 1),
// even-odd 1 - |mod(acc, 2) - 1|).  Both read the plane's edges sorted by
// ymin with a stable sort (padding, all-zero edges, last), which fixes the
// order of the float sums:
//   * B9 (banded): a 16-row band adds `edge_contribution` of the sorted
//     edges lo..hi-1 of its window, one edge after the other (IEEE
//     divisions by the clipped dy and by the span);
//   * B10 (tiled): a 16-row tile walks 128-edge blocks, skips blocks whose
//     (ymin, ymax) bounds miss its rows, and sums a hit block in the slope
//     form: x at the clipped row window from the segment start through the
//     edge's scalar slope, the ramp times 1 / max(span, 1e-9), four edges
//     a trip merged (p0 + p1) + (p2 + p3) into the block's partial, which
//     is then added to the tile's running sum;
//   * B11 (grouped): an 8-row strip walks the same blocks and bounds, and
//     sums a hit block in 8-edge groups with reciprocals: per (edge, row)
//     t = (cy - sy0) * (1 / safe_dyd) and the ramp times 1 / span; a
//     group's 8 terms merge ((c0 + c1) + (c2 + c3)) + ((c4 + c5) + (c6 +
//     c7)) and the groups add to the block's partial in turn, which is
//     then added to the strip's running sum.
// The three round differently in their y-only terms, so those are
// separate functions (B10's and B11's per-pixel halves are the same
// operations and share `tiled_pixel`).  Their
// plain versions (ops/coverage.py banded_plain, tiled_plain,
// grouped_plain) repeat each kernel's order; the host steps (sort, band
// windows, block bounds) run in PyTorch before the launch.
//
// Design.  The TPU grid walks (plane, tile row, tile column[, edge
// block]) in order with the tile in VMEM and the edges in SMEM.  Here one
// CUDA block of 256 threads owns one 16 x 128 tile (B11: two of its 8-row
// strips): thread t owns kCovCols = 4 neighbouring columns, 4 (t % 32),
// and 2 rows, 2 (t / 32), so a warp's pixels are the same 2 rows of all
// 128 columns (coalesced stores) and a staged term, read once, serves
// four columns.  The row sums live in shared memory (`CovSums`), read
// into registers once a round or hit block.  Rows and columns past the
// frame compute and are not stored.  Each kernel's per-edge term is split
// into its y-only half, computed once per (edge, row) of the tile and
// staged in shared memory, and its per-pixel half:
//   * y-only (`banded_row_terms`, `tiled_row_terms`,
//     `grouped_row_terms`): dy, the clipped x-range [xmn, xmx] and B9's
//     span or B10's / B11's 1 / span — the divisions by the clipped dy
//     (B9) and the reciprocals leave the pixel loop;
//   * per pixel (`banded_pixel`, `tiled_pixel`, B11's the same
//     operations as B10's): right of the range (xmx - px <= 0) both
//     antiderivatives are 0, the mean is +0 and the term is dy * 1 == dy
//     exactly, so it adds dy alone; else the ramp (B9's one IEEE division
//     by the span, B10's and B11's multiply).
// An (edge, row) pair whose computed dy is 0 adds +-0 to the row's sums,
// which leaves every sum as it is but for the sign of a zero, and the
// fill rule maps both zeros to +0 (inputs finite: the term is 0 times a
// finite mean).  So B9 stages, per row, only the edges whose computed dy
// is nonzero, in window order (a warp ballot and a popcount prefix),
// kBandChunk window edges a round; B10 and B11 keep their merge trees and
// mark, per row, the trips of four edges (B10) or the edges (B11, whose
// groups of 8 are walked where one of their bits is set) that cross it:
// a row walks only those trips or groups, a non-crossing edge in a walked
// one adds 0.0f.  Never a test on the raw y-range: one built from (ymin,
// |y1 - y0|) rounds and misses rows whose computed dy is nonzero
// (tests/test_torch_kernel_emulated_coverage.py).  The y-only values are
// the old per-pixel expressions operation for operation, and the library
// builds with -fmad=false, so every output byte is the one-edge-a-pixel
// form's.
//
// B11 on the TPU puts 8 edges on the sublanes and an 8-row strip on the
// lanes so the y-only terms cost one vector op per 8 (edge, row) pairs.
// Its first design here (one block of 128 threads an 8 x 128 strip tile,
// one column a thread, all 8 x 128 (edge, row) terms staged and walked)
// spent 83% of its cycles walking pairs of which 96% (direct1080) had a
// computed dy of 0 (PERF.md): 23.3 ms against B9's 2.2.  Its redesign is
// B10's tile with the strip kept as the unit of the bounds test: a
// 128-edge block is staged for the strips it reaches.
//
// Bound on this card: operations.  An (edge, pixel) pair of a row the
// edge crosses costs one add right of the edge and ~16 f32 operations
// elsewhere, against 4 bytes of output a pixel (PERF.md).
//
// Rounding: op by op in IEEE f32 — __fdiv_rn divisions, fminf/fmaxf as
// the reference's clip/minimum/maximum, and the library is built with
// -fmad=false, so no multiply-add contracts into an FMA.

#pragma once

#include "flatblock_device.cuh"   // fill_cov

namespace swf {

constexpr int kCovTileH = 16;
constexpr int kCovTileW = 128;
constexpr int kCovThreads = 256;
constexpr int kCovCols = 4;          // neighbouring columns a thread owns
constexpr int kCovRowsPerThread =
    kCovTileH * kCovTileW / (kCovThreads * kCovCols);
constexpr int kCovColThreads = kCovTileW / kCovCols;   // threads a row
constexpr int kCovEdgeCap = 2048;   // most edges a banded table holds
constexpr int kBandChunk = 64;      // window edges B9 stages a round
// B9 launches: a block walks several column tiles of its band while the
// grid keeps at least this many blocks an SM (coverage.cu).
constexpr int kBandMinBlocksPerSm = 24;
constexpr int kCovBlock = 128;      // edges per block (tiled, grouped)
constexpr int kGrpStripH = 8;       // rows of a grouped strip

struct CoverageArgs {
  const float* edges;   // (B, 4, E) sorted by ymin: rows x0, y0, x1, y1
  const int* ranges;    // banded: (B, TY, 2) window [lo, hi) per band
  const float* bounds;  // tiled, grouped: (B, E / 128, 2) (ymin, ymax)
  float* out;           // (B, H, W) coverage
  int planes, n_edges, height, width, tiles_y, rule;
};

__device__ __forceinline__ float cov_clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// Antiderivative of clamp(x, 0, 1): 0 | x^2 / 2 | x - 1/2.
__device__ __forceinline__ float cov_h01(float x) {
  return x <= 0.0f ? 0.0f : (x >= 1.0f ? x - 0.5f : 0.5f * x * x);
}

// B9's y-only half of `edge_contribution` (coverage.py:63) for pixel row
// py: (dy, xmn, xmx, span).
__device__ __forceinline__ float4 banded_row_terms(float x0, float y0,
                                                   float x1, float y1,
                                                   float py) {
  const float sy0 = y0 - py;
  const float sy1 = y1 - py;
  const float cy0 = cov_clamp01(sy0);
  const float cy1 = cov_clamp01(sy1);
  const float dy = cy1 - cy0;
  const float dyd = sy1 - sy0;
  const float safe_dyd = fabsf(dyd) < 1e-9f ? 1.0f : dyd;
  const float t0 = __fdiv_rn(cy0 - sy0, safe_dyd);
  const float t1 = __fdiv_rn(cy1 - sy0, safe_dyd);
  const float dx = x1 - x0;
  const float xa = x0 + t0 * dx;
  const float xb = x0 + t1 * dx;
  const float xmn = fminf(xa, xb);
  const float xmx = fmaxf(xa, xb);
  return make_float4(dy, xmn, xmx, xmx - xmn);
}

// B9's per-pixel half at column px: dy * (1 - mean).
__device__ __forceinline__ float banded_pixel(float4 t, float px) {
  const float rel_mx = t.z - px;
  if (rel_mx <= 0.0f) return t.x;   // right of the edge: dy * 1
  const float rel_mn = t.y - px;
  const float span = t.w;
  const float mean =
      span < 1e-9f ? cov_clamp01(0.5f * (rel_mn + rel_mx))
                   : __fdiv_rn(cov_h01(rel_mx) - cov_h01(rel_mn), span);
  return t.x * (1.0f - mean);
}

// B10's y-only half (the scalar-loop body, coverage.py:220-252) for row
// py: (dy, xmn, xmx, 1 / max(span, 1e-9)), the last -1 for a span under
// 1e-9 (the clamped-midpoint branch).
__device__ __forceinline__ float4 tiled_row_terms(float x0, float y0,
                                                  float y1, float slope,
                                                  float py) {
  const float sy0 = y0 - py;
  const float sy1 = y1 - py;
  const float cy0 = cov_clamp01(sy0);
  const float cy1 = cov_clamp01(sy1);
  const float dy = cy1 - cy0;
  const float xa = x0 + (cy0 - sy0) * slope;
  const float xb = x0 + (cy1 - sy0) * slope;
  const float xmn = fminf(xa, xb);
  const float xmx = fmaxf(xa, xb);
  const float span = xmx - xmn;
  const float inv_span =
      span < 1e-9f ? -1.0f : __fdiv_rn(1.0f, fmaxf(span, 1e-9f));
  return make_float4(dy, xmn, xmx, inv_span);
}

// B10's per-pixel half at column px (B11's too: its leaves are the same
// operations on its own y-only terms).
__device__ __forceinline__ float tiled_pixel(float4 t, float px) {
  const float rel_mx = t.z - px;
  if (rel_mx <= 0.0f) return t.x;   // right of the edge: dy * 1
  const float rel_mn = t.y - px;
  const float mean = t.w < 0.0f
                         ? cov_clamp01(0.5f * (rel_mn + rel_mx))
                         : (cov_h01(rel_mx) - cov_h01(rel_mn)) * t.w;
  return t.x * (1.0f - mean);
}

// Each thread's running sums, in shared memory (a thread reads and
// writes only its own): a row's sum is read into a register once a round
// or hit block, so the row loop needs no register array.
struct CovSums {
  float v[kCovRowsPerThread][kCovCols][kCovThreads];
};

// The pixels of this thread in its tile (kCovCols neighbouring columns
// of kCovRowsPerThread rows: the rows of a warp are the same), and the
// store.
struct CovPixel {
  int col, row0, half;   // first column, first row; that row in the tile
  float px[kCovCols];
  __device__ CovPixel(int tid, int tile_x) {
    col = tile_x * kCovTileW + (tid % kCovColThreads) * kCovCols;
    half = (tid / kCovColThreads) * kCovRowsPerThread;
    row0 = blockIdx.y * kCovTileH + half;
    for (int c = 0; c < kCovCols; ++c) px[c] = static_cast<float>(col + c);
  }
  __device__ void store(const CoverageArgs& a, const CovSums& acc,
                        int tid) const {
    float* out = a.out + static_cast<size_t>(blockIdx.z) * a.height * a.width;
    for (int j = 0; j < kCovRowsPerThread; ++j) {
      const int y = row0 + j;
      if (y >= a.height) break;
      for (int c = 0; c < kCovCols; ++c) {
        if (col + c < a.width) {
          out[static_cast<size_t>(y) * a.width + col + c] =
              fill_cov(acc.v[j][c][tid], a.rule);
        }
      }
    }
  }
};

// B9's staged round: per row of the band, the y-only terms of the
// round's window edges whose computed dy is nonzero, in window order.
struct BandedTerms {
  float4 t[kCovTileH][kBandChunk];
  int n[kCovTileH];
  CovSums acc;
};

// B10's staged block: per row of the tile, the y-only terms of the
// block's 128 edges ((0, 0, -inf, 0) for an edge that does not cross the
// row: it adds 0.0f) and the mask of the trips to walk.
struct TiledTerms {
  float4 t[kCovTileH][kCovBlock];
  unsigned trips[kCovTileH];   // bit u: edges 4u .. 4u + 3
  CovSums acc;
};

// B9's round of window edges c0 .. c0 + kBandChunk - 1: warp w stages
// rows w and w + 8, a lane an edge; ends at a barrier.
__device__ void banded_stage(const CoverageArgs& a, BandedTerms& s,
                             const float* e, int n, int c0, float band_y0) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int base0 = 0, base1 = 0;
  for (int g = c0; g < c0 + kBandChunk && g < n; g += 32) {
    const int k = g + lane;
    const bool valid = k < n;
    float x0 = 0.0f, y0 = 0.0f, x1 = 0.0f, y1 = 0.0f;
    if (valid) {
      x0 = e[k];
      y0 = e[a.n_edges + k];
      x1 = e[2 * a.n_edges + k];
      y1 = e[3 * a.n_edges + k];
    }
    const float4 t0 = banded_row_terms(
        x0, y0, x1, y1, band_y0 + static_cast<float>(warp));
    const float4 t1 = banded_row_terms(
        x0, y0, x1, y1, band_y0 + static_cast<float>(warp + 8));
    const unsigned m0 = __ballot_sync(0xffffffffu, valid && t0.x != 0.0f);
    const unsigned m1 = __ballot_sync(0xffffffffu, valid && t1.x != 0.0f);
    if ((m0 >> lane) & 1u) s.t[warp][base0 + __popc(m0 & below)] = t0;
    if ((m1 >> lane) & 1u) s.t[warp + 8][base1 + __popc(m1 & below)] = t1;
    base0 += __popc(m0);
    base1 += __popc(m1);
  }
  if (lane == 0) {
    s.n[warp] = base0;
    s.n[warp + 8] = base1;
  }
  __syncthreads();
}

// B9: one block = one (plane, band) and the column tiles blockIdx.x * per
// .. + per - 1 (per = the tiles a row / gridDim.x, rounded up).  A
// window of one round is staged once for all of them.
__device__ void banded_block(const CoverageArgs& a, BandedTerms& s) {
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int* r = a.ranges + (static_cast<size_t>(b) * a.tiles_y + blockIdx.y) * 2;
  const int lo = r[0];
  const int n = r[1] - lo > 0 ? r[1] - lo : 0;
  const float* e = a.edges + static_cast<size_t>(b) * 4 * a.n_edges + lo;
  const float band_y0 = static_cast<float>(blockIdx.y * kCovTileH);
  const int tiles_x = (a.width + kCovTileW - 1) / kCovTileW;
  const int per = (tiles_x + gridDim.x - 1) / gridDim.x;
  const int xt1 = min(static_cast<int>(blockIdx.x + 1) * per, tiles_x);
  const bool once = n <= kBandChunk;
  if (once && n > 0) banded_stage(a, s, e, n, 0, band_y0);
  for (int xt = blockIdx.x * per; xt < xt1; ++xt) {
    const CovPixel pix(tid, xt);
    for (int j = 0; j < kCovRowsPerThread; ++j) {
      for (int c = 0; c < kCovCols; ++c) s.acc.v[j][c][tid] = 0.0f;
    }
    for (int c0 = 0; c0 < n; c0 += kBandChunk) {
      if (!once) {
        __syncthreads();   // the previous round is no longer read
        banded_stage(a, s, e, n, c0, band_y0);
      }
#pragma unroll 1
      for (int j = 0; j < kCovRowsPerThread; ++j) {
        const int row = pix.half + j;
        const int cnt = s.n[row];
        float sum[kCovCols];
#pragma unroll
        for (int c = 0; c < kCovCols; ++c) sum[c] = s.acc.v[j][c][tid];
        for (int i = 0; i < cnt; ++i) {
          const float4 term = s.t[row][i];
#pragma unroll
          for (int c = 0; c < kCovCols; ++c) {
            sum[c] = sum[c] + banded_pixel(term, pix.px[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < kCovCols; ++c) s.acc.v[j][c][tid] = sum[c];
      }
    }
    pix.store(a, s.acc, tid);
  }
}

// B10: one block = one (plane, tile row, column tile).  Warp w stages
// edges 32 (w % 4) .. + 31 of each hit block for rows 8 (w / 4) .. + 7.
__device__ void tiled_block(const CoverageArgs& a, TiledTerms& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const int nb = a.n_edges / kCovBlock;
  const float tile_y0 = static_cast<float>(blockIdx.y * kCovTileH);
  const float tile_y1 = tile_y0 + static_cast<float>(kCovTileH);
  const float* e = a.edges + static_cast<size_t>(b) * 4 * a.n_edges;
  const float* bnd = a.bounds + static_cast<size_t>(b) * nb * 2;
  const int g = warp % 4;
  const int srow = (warp / 4) * (kCovTileH / 2);
  unsigned char* trip_bytes = reinterpret_cast<unsigned char*>(s.trips);
  const CovPixel pix(tid, blockIdx.x);
  for (int j = 0; j < kCovRowsPerThread; ++j) {
    for (int c = 0; c < kCovCols; ++c) s.acc.v[j][c][tid] = 0.0f;
  }
  for (int blk = 0; blk < nb; ++blk) {
    // The same test in every thread: the branch is uniform per block.
    if (!(bnd[2 * blk + 1] > tile_y0 && bnd[2 * blk] < tile_y1)) continue;
    __syncthreads();   // the previous block's terms are no longer read
    {
      const int k = 32 * g + lane;
      const int i = blk * kCovBlock + k;
      const float x0 = e[i];
      const float y0 = e[a.n_edges + i];
      const float x1 = e[2 * a.n_edges + i];
      const float y1 = e[3 * a.n_edges + i];
      const float dyd = y1 - y0;
      const float slope =
          fabsf(dyd) < 1e-9f ? 0.0f : __fdiv_rn(x1 - x0, dyd);
      for (int j = 0; j < kCovTileH / 2; ++j) {
        const int row = srow + j;
        const float4 t = tiled_row_terms(
            x0, y0, y1, slope, tile_y0 + static_cast<float>(row));
        const bool cross = t.x != 0.0f;
        s.t[row][k] = cross ? t : make_float4(0.0f, 0.0f, -INFINITY, 0.0f);
        const unsigned m = __ballot_sync(0xffffffffu, cross);
        unsigned tb = 0;
        for (int q = 0; q < 8; ++q) {
          tb |= ((m >> (4 * q)) & 0xfu) != 0u ? 1u << q : 0u;
        }
        if (lane == 0) {
          trip_bytes[row * 4 + g] = static_cast<unsigned char>(tb);
        }
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < kCovRowsPerThread; ++j) {
      const int row = pix.half + j;
      unsigned m = s.trips[row];
      float part[kCovCols] = {};
      while (m != 0u) {
        const int u = __ffs(m) - 1;
        m &= m - 1u;
        const float4 t0 = s.t[row][4 * u];
        const float4 t1 = s.t[row][4 * u + 1];
        const float4 t2 = s.t[row][4 * u + 2];
        const float4 t3 = s.t[row][4 * u + 3];
#pragma unroll
        for (int c = 0; c < kCovCols; ++c) {
          const float px = pix.px[c];
          part[c] = part[c] + ((tiled_pixel(t0, px) + tiled_pixel(t1, px)) +
                               (tiled_pixel(t2, px) + tiled_pixel(t3, px)));
        }
      }
#pragma unroll
      for (int c = 0; c < kCovCols; ++c) {
        s.acc.v[j][c][tid] = s.acc.v[j][c][tid] + part[c];
      }
    }
  }
  pix.store(a, s.acc, tid);
}

// B11's y-only half (coverage.py:440-466, through the reciprocals the
// reference multiplies by) of an edge for row py, after its dy: (dy, xmn,
// xmx, 1 / span), the last -1 for a span under 1e-9 (the clamped-midpoint
// branch).  inv_dyd = 1 / safe_dyd and dx = x1 - x0 are the edge's.
__device__ __forceinline__ float4 grouped_row_terms(float x0, float dx,
                                                    float inv_dyd, float sy0,
                                                    float cy0, float cy1,
                                                    float dy) {
  const float t0 = (cy0 - sy0) * inv_dyd;
  const float t1 = (cy1 - sy0) * inv_dyd;
  const float xa = x0 + t0 * dx;
  const float xb = x0 + t1 * dx;
  const float xmn = fminf(xa, xb);
  const float xmx = fmaxf(xa, xb);
  const float span = xmx - xmn;
  return make_float4(dy, xmn, xmx,
                     span < 1e-9f ? -1.0f : __fdiv_rn(1.0f, span));
}

// B11's staged block: per row of the tile (two 8-row strips), the y-only
// terms of the block's 128 edges, written only where the computed dy is
// nonzero, and the mask of those edges (bit k of word q: edge 32 q + k).
struct GroupedTerms {
  float4 t[kCovTileH][kCovBlock];
  unsigned leaves[kCovTileH][kCovBlock / 32];
  CovSums acc;
};

// One 8-edge group of B11 at the thread's columns: the leaves (B10's
// per-pixel half: the same operations) merged ((c0 + c1) + (c2 + c3)) +
// ((c4 + c5) + (c6 + c7)); a leaf whose bit in lm is clear adds 0.0f.
__device__ __forceinline__ void grouped_group(const float4* tg, unsigned lm,
                                              const float* px, float* grp) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float half[kCovCols];
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      const int u = 4 * h + 2 * pr;
      const bool l0 = (lm >> u) & 1u;
      const bool l1 = (lm >> (u + 1)) & 1u;
      float4 t0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 t1 = t0;
      if (l0) t0 = tg[u];
      if (l1) t1 = tg[u + 1];
#pragma unroll
      for (int c = 0; c < kCovCols; ++c) {
        const float pv = (l0 ? tiled_pixel(t0, px[c]) : 0.0f) +
                         (l1 ? tiled_pixel(t1, px[c]) : 0.0f);
        half[c] = pr == 0 ? pv : half[c] + pv;
      }
    }
#pragma unroll
    for (int c = 0; c < kCovCols; ++c) {
      grp[c] = h == 0 ? half[c] : grp[c] + half[c];
    }
  }
}

// B11: one block = one (plane, 16-row tile = 8-row strips 2 blockIdx.y
// and 2 blockIdx.y + 1, column tile).  A 128-edge block whose bounds
// reach either strip is staged once for both: warp w stages edges 32 (w
// % 4) .. + 31 for the rows of strip w / 4 (none for a strip the bounds
// miss: its rows add nothing, as the strip skips the block).  Each row
// then walks the 8-edge groups that hold an edge with a nonzero dy, in
// order, adding each group's sum to the block's partial, which is then
// added to the row's running sum.
__device__ void grouped_block(const CoverageArgs& a, GroupedTerms& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const int nb = a.n_edges / kCovBlock;
  const float tile_y0 = static_cast<float>(blockIdx.y * kCovTileH);
  const float* e = a.edges + static_cast<size_t>(b) * 4 * a.n_edges;
  const float* bnd = a.bounds + static_cast<size_t>(b) * nb * 2;
  const int q = warp % 4;                 // edges 32 q .. 32 q + 31
  const int strip = warp / 4;             // rows 8 strip .. 8 strip + 7
  const float strip_y0 = tile_y0 + static_cast<float>(strip * kGrpStripH);
  const CovPixel pix(tid, blockIdx.x);
  for (int j = 0; j < kCovRowsPerThread; ++j) {
    for (int c = 0; c < kCovCols; ++c) s.acc.v[j][c][tid] = 0.0f;
  }
  for (int blk = 0; blk < nb; ++blk) {
    // The same tests in every thread: the branch is uniform per block.
    const float lo = bnd[2 * blk];
    const float hi = bnd[2 * blk + 1];
    const float mid = tile_y0 + static_cast<float>(kGrpStripH);
    const bool hit0 = hi > tile_y0 && lo < mid;
    const bool hit1 = hi > mid && lo < mid + static_cast<float>(kGrpStripH);
    if (!hit0 && !hit1) continue;
    __syncthreads();   // the previous block's terms are no longer read
    if (strip == 0 ? hit0 : hit1) {
      const int k = 32 * q + lane;
      const int i = blk * kCovBlock + k;
      const float x0 = e[i];
      const float y0 = e[a.n_edges + i];
      const float x1 = e[2 * a.n_edges + i];
      const float y1 = e[3 * a.n_edges + i];
      const float dyd = y1 - y0;
      const float safe_dyd = fabsf(dyd) < 1e-9f ? 1.0f : dyd;
      const float inv_dyd = __fdiv_rn(1.0f, safe_dyd);
      const float dx = x1 - x0;
      for (int r = 0; r < kGrpStripH; ++r) {
        const int row = strip * kGrpStripH + r;
        const float py = strip_y0 + static_cast<float>(r);
        const float sy0 = y0 - py;
        const float sy1 = y1 - py;
        const float cy0 = cov_clamp01(sy0);
        const float cy1 = cov_clamp01(sy1);
        const float dy = cy1 - cy0;
        const bool cross = dy != 0.0f;
        if (cross) {
          s.t[row][k] = grouped_row_terms(x0, dx, inv_dyd, sy0, cy0, cy1,
                                          dy);
        }
        const unsigned m = __ballot_sync(0xffffffffu, cross);
        if (lane == 0) s.leaves[row][q] = m;
      }
    } else if (lane == 0) {
      for (int r = 0; r < kGrpStripH; ++r) {
        s.leaves[strip * kGrpStripH + r][q] = 0u;
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < kCovRowsPerThread; ++j) {
      const int row = pix.half + j;
      float part[kCovCols] = {};
#pragma unroll 1
      for (int w = 0; w < kCovBlock / 32; ++w) {
        unsigned m = s.leaves[row][w];
        while (m != 0u) {
          const int g = (__ffs(m) - 1) >> 3;   // the group in the word
          const unsigned lm = (m >> (8 * g)) & 0xffu;
          m &= ~(0xffu << (8 * g));
          float grp[kCovCols];
          grouped_group(&s.t[row][32 * w + 8 * g], lm, pix.px, grp);
#pragma unroll
          for (int c = 0; c < kCovCols; ++c) part[c] = part[c] + grp[c];
        }
      }
#pragma unroll
      for (int c = 0; c < kCovCols; ++c) {
        s.acc.v[j][c][tid] = s.acc.v[j][c][tid] + part[c];
      }
    }
  }
  pix.store(a, s.acc, tid);
}

}  // namespace swf
