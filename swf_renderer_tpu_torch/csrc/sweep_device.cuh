// Device logic of the animation sweep kernels: per frame, lerp and/or
// transform LOCAL-space edge pieces, rasterize them analytically, resolve
// and pack — the frame count costs the host nothing.
//
// Replaces three TPU kernels:
//   * `_xform_kernel` (swf_renderer_tpu/ops/transform.py:586, pallas_call
//     :1710) — the affine sweep, solid and styled (kMorph=false,
//     kAffine=true);
//   * `_xform_kernel(morph=True)` (same file, pallas_call :1875) — the
//     morph + affine sweep (kMorph=true, kAffine=true);
//   * `_morph_kernel` (swf_renderer_tpu/ops/morph.py:98, pallas_call :213)
//     — the morph ratio sweep (kMorph=true, kAffine=false).
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
// layers' pieces (a few thousand, L2-resident, read coalesced), transform
// each, and for a piece that reaches the tile scatter the DIFFERENCES
// ramp(x) - ramp(x - 1) over the columns the piece crosses, ending with
// the step to dy; a piece wholly left of the tile adds dy at the tile's
// first column (a pre-pass kernel has written each 64-piece chunk's row
// bounds, so the walk skips chunks that miss the tile's rows).  A row
// prefix then rebuilds every pixel's winding.
// Differences and prefix are 32.32 fixed point in 64-bit shared atomics:
// integer sums telescope exactly and do not depend on the order the
// atomics land in, so the result is the same on every run, for every tile
// shape, and equal to the plain PyTorch version (ops/transform.py
// sweep_plain), which sums the same integers with index_add_.  The
// winding rounds to f32 once.  The resolve loops over the layers present
// and keeps each layer's weight in that layer's own plane slot: a form
// with per-thread arrays and 16-way unrolled paint code ran the styled
// kernel at 3x the solid one on the card.
//
// Bound on this card: bytes for the output (one u32 a pixel) at the main
// path's shapes.  The kernel's own cost is the resolve, the piece walk
// (without the chunk bounds it was two thirds of the kernel: every tile
// read every piece from L2), the setup and the serial row prefix; a tile
// no piece reaches skips prefix and resolve and writes zeros.
//
// Tolerance against the plain version on the card: at most 1 u8 level
// (chip_smoke.py); by construction byte-equal.  Rounding as in
// flatblock_device.cuh: op-by-op IEEE f32, -fmad=false, rintf, floored
// modulo.

#pragma once

#include "flatblock_device.cuh"

namespace swf {

constexpr size_t kSweepSmemBudget = 100 * 1024;
constexpr int kSweepMaxRows = 32;
constexpr int kSweepRowStride = kLane + 1;   // long longs, bank-shifted
constexpr int kSweepChunk = 64;              // pieces per row-bounds chunk
constexpr int kSweepMaxHits = 1024;          // chunk list of one walk round

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
  int n_chunks;              // ceil(ep / kSweepChunk)
  int rows;                  // tile rows
  int mats_per_layer, colors_per_frame, n_stop_slots;
};

// Tile rows: the most (a power of two, at most kSweepMaxRows) whose layer
// accumulators fit the shared-memory budget.
__host__ __device__ inline int sweep_tile_rows(int layers) {
  int rows = kSweepMaxRows;
  while (rows > 1 && static_cast<size_t>(layers) * rows * kSweepRowStride * 8
                         > kSweepSmemBudget) {
    rows /= 2;
  }
  return rows;
}

__host__ __device__ inline size_t sweep_plane_bytes(int layers, int rows) {
  return align16(static_cast<size_t>(layers) * rows * kSweepRowStride * 8);
}

// Shared-memory carve-up: accumulators, colours, matrices, rules with the
// tile's touched flag and the hit count, the hit list, then (styled) the
// paint records.
__host__ __device__ inline size_t sweep_smem_bytes(int layers, int rows,
                                                   bool styled) {
  size_t n = sweep_plane_bytes(layers, rows);
  n += align16(static_cast<size_t>(layers) * 4 * 4);   // colours
  n += align16(static_cast<size_t>(layers) * 6 * 4);   // matrices
  n += align16(static_cast<size_t>(layers + 2) * 4);   // rules, flags
  n += align16(static_cast<size_t>(kSweepMaxHits) * 4);
  if (styled) {
    n += align16(static_cast<size_t>(layers) * kPintStride * 4);
    n += align16(static_cast<size_t>(layers) * kPfltStride * 4);
  }
  return n;
}

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

// Scatter one device-space piece into a tile: for each of the <= 2 rows
// it touches that lie in the tile, the differences ramp(x) - ramp(x - 1)
// over the columns it crosses, ending with the step to dy (at the tile's
// first column when the piece lies left of it), in 32.32 fixed point.
// ``plane`` is the layer's accumulator; rows [r0, r1), columns [c0, c1).
__device__ __forceinline__ void scatter_piece(
    float x0, float y0, float x1, float y1, int r0, int c0, float r0f,
    float r1f, float c0f, float c1f, long long* lplane, int* touched_s) {
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
    const float span = xmx - xmn;
    const bool thin = span < 1e-9f;
    const float safe_span = thin ? 1.0f : span;
    const int xs = static_cast<int>(fmaxf(lo, c0f));
    const int xe = static_cast<int>(
        fminf(fmaxf(hi, static_cast<float>(xs)), c1f - 1.0f));
    long long* row = lplane + (static_cast<int>(py) - r0) * kSweepRowStride;
    *touched_s = 1;
    long long prev = 0;
    for (int x = xs; x <= xe; ++x) {
      const float px = static_cast<float>(x);
      float v = dy;
      if (px < hi) {
        const float rel_mn = xmn - px;
        const float rel_mx = xmx - px;
        const float mean = thin
            ? clamp01(0.5f * (rel_mn + rel_mx))
            : (h01(rel_mx) - h01(rel_mn)) / safe_span;
        v = dy * (1.0f - mean);
      }
      const long long q = to_fixed(v);
      atomicAdd(reinterpret_cast<unsigned long long*>(&row[x - c0]),
                static_cast<unsigned long long>(q - prev));
      prev = q;
    }
  }
}

// Pre-pass, one block of kSweepChunk threads per (chunk, layer, frame):
// the lowest and highest row base among the chunk's pieces.  Pieces are
// path-ordered, so a chunk spans few rows and a tile's walk skips most
// chunks on two compares instead of reading and transforming 64 pieces
// (the chunk bounds of transform.py:1630-1687, exact here: both kernels
// run device_piece).
template <bool kMorph, bool kAffine>
__device__ void sweep_bounds_block(const SweepArgs& a, float* red) {
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const int l = blockIdx.y;
  const int f = blockIdx.z;
  const int p = chunk * kSweepChunk + tid;
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
  red[kSweepChunk + tid] = hi;
  __syncthreads();
  for (int s = kSweepChunk / 2; s > 0; s /= 2) {
    if (tid < s) {
      red[tid] = fminf(red[tid], red[tid + s]);
      red[kSweepChunk + tid] =
          fmaxf(red[kSweepChunk + tid], red[kSweepChunk + tid + s]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    float* b = a.bounds + ((static_cast<long long>(f) * a.layers + l)
                           * a.n_chunks + chunk) * 2;
    b[0] = red[0];
    b[1] = red[kSweepChunk];
  }
}

// One block: a tile of kLane columns x a.rows rows of frame blockIdx.z.
template <bool kMorph, bool kAffine, bool kStyled>
__device__ void sweep_block(const SweepArgs& a, unsigned char* smem) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int c0 = blockIdx.x * kLane;
  const int r0 = blockIdx.y * a.rows;
  const int f = blockIdx.z;
  const int L = a.layers;
  const int R = a.rows;
  const int c1 = min(c0 + kLane, a.width);    // tile columns [c0, c1)
  const int r1 = min(r0 + R, a.height);       // tile rows [r0, r1)

  long long* plane = reinterpret_cast<long long*>(smem);
  size_t off = sweep_plane_bytes(L, R);
  float* col_s = reinterpret_cast<float*>(smem + off);
  off += align16(static_cast<size_t>(L) * 4 * 4);
  float* mat_s = reinterpret_cast<float*>(smem + off);
  off += align16(static_cast<size_t>(L) * 6 * 4);
  int* rule_s = reinterpret_cast<int*>(smem + off);
  int* touched_s = rule_s + L;   // set when a piece lands in the tile
  int* n_hits_s = touched_s + 1;
  off += align16(static_cast<size_t>(L + 2) * 4);
  int* hits_s = reinterpret_cast<int*>(smem + off);
  off += align16(static_cast<size_t>(kSweepMaxHits) * 4);
  int* pint_s = nullptr;
  float* pflt_s = nullptr;
  if (kStyled) {
    pint_s = reinterpret_cast<int*>(smem + off);
    off += align16(static_cast<size_t>(L) * kPintStride * 4);
    pflt_s = reinterpret_cast<float*>(smem + off);
  }

  const float t = kMorph ? a.ratios[f] : 0.0f;
  const float omt = 1.0f - t;

  for (int i = tid; i < L * R * kSweepRowStride; i += nthr) plane[i] = 0;
  for (int i = tid; i < L * 4; i += nthr) {
    if (kMorph) {
      col_s[i] = omt * a.colors[i] + t * a.colors_e[i];
    } else if (a.colors_per_frame) {
      col_s[i] = a.colors[static_cast<long long>(f) * L * 4 + i];
    } else {
      col_s[i] = a.colors[i];
    }
  }
  if (kAffine) {
    for (int i = tid; i < L * 6; i += nthr) {
      mat_s[i] = a.mats_per_layer
          ? a.mats[static_cast<long long>(f) * L * 6 + i]
          : a.mats[static_cast<long long>(f) * 6 + i % 6];
    }
  }
  for (int i = tid; i < L; i += nthr) rule_s[i] = a.rules[i];
  if (tid == 0) *touched_s = 0;
  if (kStyled) {
    for (int i = tid; i < L * kPintStride; i += nthr) pint_s[i] = a.pint[i];
    for (int i = tid; i < L * kPfltStride; i += nthr) pflt_s[i] = a.pflt[i];
  }
  __syncthreads();
  if (kStyled) {
    // This frame's part of the gradient records: the composed device ->
    // gradient matrix and, with per-frame stops, the first stop and the
    // colour steps (f32 differences, as the reference takes them).
    for (int l = tid; l < L; l += nthr) {
      const int kind = pint_s[l * kPintStride];
      if (kind != kPaintLinear && kind != kPaintFocal) continue;
      float* P = pflt_s + l * kPfltStride;
      const float* gm = a.grad_mats + (static_cast<long long>(f) * L + l) * 6;
      for (int k = 0; k < 6; ++k) P[kPInv + k] = gm[k];
      if (a.stop_colors != nullptr) {
        const int n_stops = pint_s[l * kPintStride + 2];
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

  // Placement: ramp differences of every piece that reaches the tile.
  const float c0f = static_cast<float>(c0);
  const float c1f = static_cast<float>(c1);
  const float r0f = static_cast<float>(r0);
  const float r1f = static_cast<float>(r1);
  // A chunk's pieces can land in the tile's rows only when some row base
  // lies in [r0 - 1, r1 - 1].  In rounds of kSweepMaxHits (layer, chunk)
  // pairs: every thread tests pairs and lists the hits, then kSweepChunk
  // threads take a listed chunk together.
  const float* bounds =
      a.bounds + static_cast<long long>(f) * L * a.n_chunks * 2;
  const int n_pairs = L * a.n_chunks;
  for (int base = 0; base < n_pairs; base += kSweepMaxHits) {
    if (tid == 0) *n_hits_s = 0;
    __syncthreads();
    for (int pair = base + tid; pair < min(base + kSweepMaxHits, n_pairs);
         pair += nthr) {
      // (a chunk past its layer's count has the empty bounds +-3e38)
      if (bounds[2 * pair + 1] >= r0f - 1.0f && bounds[2 * pair] < r1f) {
        hits_s[atomicAdd(n_hits_s, 1)] = pair;
      }
    }
    __syncthreads();
    const int n_hits = *n_hits_s;
    for (int h = tid / kSweepChunk; h < n_hits; h += nthr / kSweepChunk) {
      const int l = hits_s[h] / a.n_chunks;
      const int p = (hits_s[h] % a.n_chunks) * kSweepChunk
          + tid % kSweepChunk;
      if (p >= min(a.counts[l], a.ep)) continue;
      float x0, y0, x1, y1;
      device_piece<kMorph, kAffine>(
          a.tab_s + static_cast<long long>(l) * 4 * a.ep,
          kMorph ? a.tab_e + static_cast<long long>(l) * 4 * a.ep : nullptr,
          a.ep, p, t, omt, mat_s + l * 6, x0, y0, x1, y1);
      scatter_piece(x0, y0, x1, y1, r0, c0, r0f, r1f, c0f, c1f,
                    plane + static_cast<long long>(l) * R * kSweepRowStride,
                    touched_s);
    }
    __syncthreads();   // the next round rewrites the list
  }
  __syncthreads();

  const int tile_w = c1 - c0;
  const int tile_h = r1 - r0;
  if (*touched_s == 0) {
    // No piece reaches this tile: every winding is 0, every pixel
    // transparent black (what the resolve below would compute).
    for (int p = tid; p < tile_h * kLane; p += nthr) {
      const int c = p % kLane;
      if (c < tile_w) {
        a.out[(static_cast<long long>(f) * a.height + r0 + p / kLane)
              * a.width + c0 + c] = 0;
      }
    }
    return;
  }

  // Row prefix (exact integer sums): every pixel's winding, fixed point.
  for (int r = tid; r < L * R; r += nthr) {
    long long* p = plane + static_cast<long long>(r) * kSweepRowStride;
    long long acc = 0;
    for (int c = 0; c < kLane; ++c) {
      acc += p[c];
      p[c] = acc;
    }
  }
  __syncthreads();

  // Resolve: fill rule, paints, composite, quantize, pack.
  for (int p = tid; p < tile_h * kLane; p += nthr) {
    const int r = p / kLane;
    const int c = p % kLane;
    if (c >= tile_w) continue;
    const int x = c0 + c;
    const int y = r0 + r;
    const float px = static_cast<float>(x) + 0.5f;
    const float py = static_cast<float>(y) + 0.5f;
    const long long pix = (static_cast<long long>(f) * a.height + y) * a.width
        + x;

    // Two passes over the layers present, no per-thread arrays: top
    // down for the suffix-product weights (each layer's winding slot in
    // the plane is overwritten with its weight and gradient parameter —
    // this thread alone owns the pixel), then bottom up for the sums, in
    // composite_quantize_pack's order.
    float suffix = 1.0f;
    for (int l = L - 1; l >= 0; --l) {
      long long* slot =
          plane + (static_cast<long long>(l) * R + r) * kSweepRowStride + c;
      const float cov = fill_cov(from_fixed(*slot), rule_s[l]);
      float alpha = col_s[4 * l + 3];
      float t = 0.0f;
      // An uncovered pixel-layer weighs exactly 0 whatever its paint:
      // skip the gradient solve and the field read there.
      if (kStyled && cov != 0.0f) {
        const int* I = pint_s + l * kPintStride;
        const float* P = pflt_s + l * kPfltStride;
        if (I[0] == kPaintLinear || I[0] == kPaintFocal) {
          t = grad_t(P, I, px, py);
          alpha = grad_ramp(P, I[2], t, 3);
        } else if (I[0] == kPaintField) {
          alpha = a.fields[((static_cast<long long>(I[3]) * a.frames) * a.height
                            * a.width + pix) * 4 + 3];
        }
      }
      const float cas = alpha * cov;
      float wgt = cas;
      if (l == L - 1) {
        suffix = 1.0f - cas;
      } else {
        wgt = cas * suffix;
        suffix = suffix * (1.0f - cas);
      }
      float* out2 = reinterpret_cast<float*>(slot);
      out2[0] = wgt;
      out2[1] = t;
    }
    float alpha_out = 0.0f;
    float pm[3] = {0.0f, 0.0f, 0.0f};
    for (int l = 0; l < L; ++l) {
      const float* in2 = reinterpret_cast<const float*>(
          plane + (static_cast<long long>(l) * R + r) * kSweepRowStride + c);
      const float wgt = in2[0];
      alpha_out = (l == 0) ? wgt : alpha_out + wgt;
      const int* I = pint_s + l * kPintStride;
      const float* P = pflt_s + l * kPfltStride;
      // A layer of weight 0 (uncovered, transparent or hidden) adds
      // exactly 0 whatever its colour.
      const bool painted = kStyled && wgt != 0.0f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float color = col_s[4 * l + ch];
        if (painted) {
          if (I[0] == kPaintLinear || I[0] == kPaintFocal) {
            color = grad_ramp(P, I[2], in2[1], ch);
          } else if (I[0] == kPaintField) {
            color = a.fields[((static_cast<long long>(I[3]) * a.frames)
                              * a.height * a.width + pix) * 4 + ch];
          }
        }
        const float term = color * wgt;
        pm[ch] = (l == 0) ? term : pm[ch] + term;
      }
    }
    const uint32_t packed = quantize_pack(alpha_out, pm);
    a.out[pix] = static_cast<int>(packed);
  }
}

}  // namespace swf
