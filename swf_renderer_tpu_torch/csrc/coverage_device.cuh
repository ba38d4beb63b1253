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
//     edges lo..hi-1 of its window, one edge after the other (two IEEE
//     divisions an edge and pixel: by the clipped dy and by the span);
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
// The three round differently, so they share no per-edge function.  Their
// plain versions (ops/coverage.py banded_plain, tiled_plain,
// grouped_plain) repeat each kernel's order; the host steps (sort, band
// windows, block bounds) run in PyTorch before the launch.
//
// Design.  The TPU grid walks (plane, tile row, tile column[, edge
// block]) in order with the tile in VMEM and the edges in SMEM.  Here one
// CUDA block of 256 threads owns one 16 x 128 tile: thread t owns column
// t % 128 and 8 rows (t / 128 selects the upper or lower half), so each
// edge's row terms are computed once per thread row and the pixels of a
// warp are 32 neighbouring columns (coalesced stores).  B9 stages its
// whole window (at most 2048 edges, 32 KB) in shared memory once; B10
// stages one 128-edge block at a time with its slopes (one IEEE division
// per edge, not per pixel).  Rows and columns past the frame compute and
// are not stored.
//
// B11 on the TPU puts 8 edges on the sublanes and an 8-row strip on the
// lanes so the y-only terms cost one vector op per 8 (edge, row) pairs.
// Here one block of 128 threads owns an 8 x 128 strip tile: for each hit
// block the 128 threads first compute the y-only terms of (their edge,
// each of the 8 rows) into shared memory (1024 pairs, 16 KB), then each
// thread walks them for its column with the 8 row sums in registers; the
// reads are broadcasts (every thread of a warp reads the same term).
//
// Bound on this card: operations.  Every (edge, pixel) pair of a window
// costs ~30 f32 operations (two IEEE divisions in B9, one in B10) against
// 4 bytes of output a pixel; at direct1080 that is ~1e11 operations for
// 2 GB of coverage (PERF.md).
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
constexpr int kCovRowsPerThread = kCovTileH * kCovTileW / kCovThreads;
constexpr int kCovEdgeCap = 2048;   // most edges a banded table holds
constexpr int kCovBlock = 128;      // edges per block (tiled, grouped)
constexpr int kGrpStripH = 8;       // rows of a grouped strip
constexpr int kGrpGroup = 8;        // edges a grouped sum merges
constexpr int kGrpThreads = 128;    // one column each

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

// B9's per-edge term: `edge_contribution` (coverage.py:63) at the cell
// origin (px, py).
__device__ __forceinline__ float banded_term(float x0, float y0, float x1,
                                             float y1, float px, float py) {
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
  const float span = xmx - xmn;
  const float safe_span = span < 1e-9f ? 1.0f : span;
  const float rel_mn = xmn - px;
  const float rel_mx = xmx - px;
  const float mean =
      span < 1e-9f ? cov_clamp01(0.5f * (rel_mn + rel_mx))
                   : __fdiv_rn(cov_h01(rel_mx) - cov_h01(rel_mn), safe_span);
  return dy * (1.0f - mean);
}

// B10's per-edge term: the scalar-loop body (coverage.py:220-252).
__device__ __forceinline__ float tiled_term(float x0, float y0, float y1,
                                            float slope, float px, float py) {
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
  const float inv_span = __fdiv_rn(1.0f, fmaxf(span, 1e-9f));
  const float rel_mn = xmn - px;
  const float rel_mx = xmx - px;
  const float ramp = (cov_h01(rel_mx) - cov_h01(rel_mn)) * inv_span;
  const float mean =
      span < 1e-9f ? cov_clamp01(0.5f * (rel_mn + rel_mx)) : ramp;
  return dy * (1.0f - mean);
}

// The pixel rows and column of this thread in its tile, and the store.
struct CovPixel {
  int col, row0;
  __device__ CovPixel(int tid) {
    col = blockIdx.x * kCovTileW + tid % kCovTileW;
    row0 = blockIdx.y * kCovTileH + (tid / kCovTileW) * kCovRowsPerThread;
  }
  __device__ void store(const CoverageArgs& a, const float* acc) const {
    if (col >= a.width) return;
    float* out = a.out + static_cast<size_t>(blockIdx.z) * a.height * a.width;
    for (int j = 0; j < kCovRowsPerThread; ++j) {
      const int y = row0 + j;
      if (y < a.height) {
        out[static_cast<size_t>(y) * a.width + col] = fill_cov(acc[j], a.rule);
      }
    }
  }
};

// B9: one block = one (plane, band, column tile).  `s` holds 4 x
// kCovEdgeCap floats of shared memory.
__device__ void banded_block(const CoverageArgs& a, float* s) {
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int* r = a.ranges + (static_cast<size_t>(b) * a.tiles_y + blockIdx.y) * 2;
  const int lo = r[0];
  const int n = r[1] - lo > 0 ? r[1] - lo : 0;
  const float* e = a.edges + static_cast<size_t>(b) * 4 * a.n_edges;
  for (int i = tid; i < n; i += kCovThreads) {
    for (int c = 0; c < 4; ++c) {
      s[c * kCovEdgeCap + i] = e[static_cast<size_t>(c) * a.n_edges + lo + i];
    }
  }
  __syncthreads();
  const CovPixel pix(tid);
  const float px = static_cast<float>(pix.col);
  float acc[kCovRowsPerThread];
  for (int j = 0; j < kCovRowsPerThread; ++j) acc[j] = 0.0f;
  for (int k = 0; k < n; ++k) {
    const float x0 = s[k];
    const float y0 = s[kCovEdgeCap + k];
    const float x1 = s[2 * kCovEdgeCap + k];
    const float y1 = s[3 * kCovEdgeCap + k];
    for (int j = 0; j < kCovRowsPerThread; ++j) {
      acc[j] = acc[j] + banded_term(x0, y0, x1, y1, px,
                                    static_cast<float>(pix.row0 + j));
    }
  }
  pix.store(a, acc);
}

// B10: one block = one (plane, tile row, column tile).  `s` holds 4 x
// kCovBlock floats of shared memory (x0, y0, y1, slope).
__device__ void tiled_block(const CoverageArgs& a, float* s) {
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int nb = a.n_edges / kCovBlock;
  const float tile_y0 = static_cast<float>(blockIdx.y * kCovTileH);
  const float tile_y1 = tile_y0 + static_cast<float>(kCovTileH);
  const float* e = a.edges + static_cast<size_t>(b) * 4 * a.n_edges;
  const float* bnd = a.bounds + static_cast<size_t>(b) * nb * 2;
  const CovPixel pix(tid);
  const float px = static_cast<float>(pix.col);
  float acc[kCovRowsPerThread];
  for (int j = 0; j < kCovRowsPerThread; ++j) acc[j] = 0.0f;
  for (int blk = 0; blk < nb; ++blk) {
    // The same test in every thread: the branch is uniform per block.
    if (!(bnd[2 * blk + 1] > tile_y0 && bnd[2 * blk] < tile_y1)) continue;
    __syncthreads();   // the previous block's edges are no longer read
    if (tid < kCovBlock) {
      const int i = blk * kCovBlock + tid;
      const float x0 = e[i];
      const float y0 = e[a.n_edges + i];
      const float x1 = e[2 * a.n_edges + i];
      const float y1 = e[3 * a.n_edges + i];
      const float dyd = y1 - y0;
      s[tid] = x0;
      s[kCovBlock + tid] = y0;
      s[2 * kCovBlock + tid] = y1;
      s[3 * kCovBlock + tid] =
          fabsf(dyd) < 1e-9f ? 0.0f : __fdiv_rn(x1 - x0, dyd);
    }
    __syncthreads();
    float part[kCovRowsPerThread];
    for (int j = 0; j < kCovRowsPerThread; ++j) part[j] = 0.0f;
    for (int k = 0; k < kCovBlock; k += 4) {
      for (int j = 0; j < kCovRowsPerThread; ++j) {
        const float py = static_cast<float>(pix.row0 + j);
        float p[4];
        for (int u = 0; u < 4; ++u) {
          p[u] = tiled_term(s[k + u], s[kCovBlock + k + u],
                            s[2 * kCovBlock + k + u],
                            s[3 * kCovBlock + k + u], px, py);
        }
        part[j] = part[j] + ((p[0] + p[1]) + (p[2] + p[3]));
      }
    }
    for (int j = 0; j < kCovRowsPerThread; ++j) acc[j] = acc[j] + part[j];
  }
  pix.store(a, acc);
}

// B11's staged terms of one 128-edge block: per row of the strip and
// edge, dy, xmn, xmx and inv_span (negative for a span under 1e-9).
struct GroupedTerms {
  float dy[kGrpStripH][kCovBlock];
  float xmn[kGrpStripH][kCovBlock];
  float xmx[kGrpStripH][kCovBlock];
  float inv[kGrpStripH][kCovBlock];
};

// B11: one block of kGrpThreads threads = one (plane, 8-row strip, column
// tile); thread t owns column t of the tile.
__device__ void grouped_block(const CoverageArgs& a, GroupedTerms& s) {
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int nb = a.n_edges / kCovBlock;
  const int col = blockIdx.x * kCovBlock + tid;
  const int row0 = blockIdx.y * kGrpStripH;
  const float strip_y0 = static_cast<float>(row0);
  const float px = static_cast<float>(col);
  const float* e = a.edges + static_cast<size_t>(b) * 4 * a.n_edges;
  const float* bnd = a.bounds + static_cast<size_t>(b) * nb * 2;
  float acc[kGrpStripH];
  for (int r = 0; r < kGrpStripH; ++r) acc[r] = 0.0f;
  for (int blk = 0; blk < nb; ++blk) {
    // The same test in every thread: the branch is uniform per block.
    if (!(bnd[2 * blk + 1] > strip_y0 &&
          bnd[2 * blk] < strip_y0 + static_cast<float>(kGrpStripH))) {
      continue;
    }
    __syncthreads();   // the previous block's terms are no longer read
    {
      const int i = blk * kCovBlock + tid;
      const float x0 = e[i];
      const float y0 = e[a.n_edges + i];
      const float x1 = e[2 * a.n_edges + i];
      const float y1 = e[3 * a.n_edges + i];
      const float dyd = y1 - y0;
      const float safe_dyd = fabsf(dyd) < 1e-9f ? 1.0f : dyd;
      const float inv_dyd = __fdiv_rn(1.0f, safe_dyd);
      const float dx = x1 - x0;
      for (int r = 0; r < kGrpStripH; ++r) {
        const float py = strip_y0 + static_cast<float>(r);
        const float sy0 = y0 - py;
        const float sy1 = y1 - py;
        const float cy0 = cov_clamp01(sy0);
        const float cy1 = cov_clamp01(sy1);
        const float t0 = (cy0 - sy0) * inv_dyd;
        const float t1 = (cy1 - sy0) * inv_dyd;
        const float xa = x0 + t0 * dx;
        const float xb = x0 + t1 * dx;
        const float xmn = fminf(xa, xb);
        const float xmx = fmaxf(xa, xb);
        const float span = xmx - xmn;
        s.dy[r][tid] = cy1 - cy0;
        s.xmn[r][tid] = xmn;
        s.xmx[r][tid] = xmx;
        s.inv[r][tid] = span < 1e-9f ? -1.0f : __fdiv_rn(1.0f, span);
      }
    }
    __syncthreads();
    for (int r = 0; r < kGrpStripH; ++r) {
      float part = 0.0f;
      for (int g = 0; g < kCovBlock; g += kGrpGroup) {
        float c[kGrpGroup];
#pragma unroll
        for (int u = 0; u < kGrpGroup; ++u) {
          const int k = g + u;
          const float rel_mn = s.xmn[r][k] - px;
          const float rel_mx = s.xmx[r][k] - px;
          const float inv = s.inv[r][k];
          const float mean =
              inv < 0.0f ? cov_clamp01(0.5f * (rel_mn + rel_mx))
                         : (cov_h01(rel_mx) - cov_h01(rel_mn)) * inv;
          c[u] = s.dy[r][k] * (1.0f - mean);
        }
        part = part + (((c[0] + c[1]) + (c[2] + c[3]))
                       + ((c[4] + c[5]) + (c[6] + c[7])));
      }
      acc[r] = acc[r] + part;
    }
  }
  if (col >= a.width) return;
  float* out = a.out + static_cast<size_t>(b) * a.height * a.width;
  for (int r = 0; r < kGrpStripH; ++r) {
    const int y = row0 + r;
    if (y < a.height) {
      out[static_cast<size_t>(y) * a.width + col] = fill_cov(acc[r], a.rule);
    }
  }
}

}  // namespace swf
