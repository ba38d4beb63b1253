// Device logic of the texfield kernel: bitmap fills sampled under any
// device->texel matrix into straight-RGBA field planes.
//
// Replaces the TPU kernel `_texfield_kernel` (swf_renderer_tpu/ops/
// texfield.py:186, frame body :207, pallas_call :494).
//
// What it computes, per (frame f, pixel x, y): the supersampled bilinear
// (or nearest) sample of a premultiplied texture at
//   sx = a*(x + ox) + c*(y + oy) + e,   sy = b*(x + ox) + d*(y + oy) + f
// for the n x n subsample offsets o = (k + 0.5) / n, with the texel
// fetch rules of the reference's `style._fetch`: repeat wraps (floored
// modulo), clipped fills clamp edge texels outward ("flash") or read
// transparent outside the image ("canvas").  The subsamples sum in the
// reference's order (ky outer, kx inner), the sum is divided by n*n and
// the result is un-premultiplied — the function of the reference's
// gather twin `style.paint_field_traced` for PAINT_BITMAP, which the
// plain version (ops/texfield.py texfield_plain) repeats op for op.
//
// Design.  The TPU kernel rewrites the gather as dense MXU contractions
// against the texture (bilinear weights built against a texel iota, a
// 3-pass bf16 split, a row window into VMEM).  Those are workarounds for
// a machine without a fast gather; a Hopper SM gathers from shared
// memory or L1 directly, so this kernel is a direct gather.  A pre-pass
// converts the u8 texture once into premultiplied f32 texels (Th x Tw
// float4).  The field kernel runs a 3-D grid of (32-column, 32-row tile,
// frame) blocks of 256 threads; a thread samples one column of its tile
// at 4 rows 8 apart (4 independent pixels), reads texels through the
// read-only cache (animtex's 64 KB of texels stay in L1) and stores one
// float4 per pixel into (F, H, W, 4): a warp writes 512 contiguous bytes.
// Frames beyond the grid's 65535 z-blocks loop.  The kernel is bound by
// instruction issue (PERF.md), so the work a pixel is cut where the
// result allows:
//   - no 64-bit or run-time division of an index: the grid is the tile;
//   - texfield_kernel<N, kSmooth, kEdge> is instantiated for n = 1, 2, 4
//     (the supersamples of every paint the renderer builds) with the
//     subsample loops unrolled and the offsets compile-time floats, and
//     for N = 0, any other n, with the run-time loops;
//   - where n * n is a power of two, x / (n * n) is x * 2^-k: the same
//     real number rounded once, so the same float;
//   - the repeat wrap of a power-of-two texture side is a mask: for an
//     int, x & (side - 1) is the floored modulo.
// Forms that lost (PERF.md): persistent blocks walking (frame, tile)
// items paid a 64-bit division and remainder a pixel; copying textures of
// up to 64 KB into shared memory kept fewer blocks resident.
//
// Bound on this card: bytes — the f32 planes it writes (16 B a pixel)
// outweigh its ~60 f32 operations a bilinear subsample at supersample 2.
//
// Rounding (shared with the plain version, ROADMAP.md queue C): texel
// normalisation, the division by n*n (when n*n is not a power of two) and
// the un-premultiply are IEEE divisions (__fdiv_rn), never a reciprocal
// multiply; the repeat wrap is a floored modulo (of integral values, so
// an integer remainder or mask gives the same index while they are exact
// in int, with fmodf beyond); floors are floorf; the subsample offsets
// are f32 roundings of the double (k + 0.5) / n, as JAX weak-types them;
// the library is built with -fmad=false so the coordinate multiply-adds
// run op by op.

#pragma once

#include "flatblock_device.cuh"

namespace swf {

constexpr int kTexTileW = 32;
constexpr int kTexTileH = 8;          // thread rows of a block
constexpr int kTexThreads = kTexTileW * kTexTileH;
constexpr int kTexRowsPerThread = 4;  // pixels a thread, kTexTileH apart
constexpr int kTexTileRows = kTexTileH * kTexRowsPerThread;
constexpr int kTexMaxN = 64;      // subsamples per axis
constexpr int kTexMaxGridZ = 65535;
// Below this magnitude an integral float is exact in int arithmetic and
// x + 1 is exact in float.
constexpr float kTexExact = 16777216.0f;

// Fetch rules (kEdge): repeat wraps; "flash" clamps edge texels outward;
// "canvas" reads transparent outside the image.
constexpr int kTexRepeat = 0;
constexpr int kTexFlash = 1;
constexpr int kTexCanvas = 2;

struct TexArgs {
  const unsigned char* img;  // (Th, Tw, 4) u8 straight RGBA
  float4* tex;               // (Th, Tw) premultiplied f32 texels
  const float* invs;         // (F, 6) device -> texel affines
  float4* out;               // (F, H, W) straight RGBA
  int th, tw, frames, height, width, n;
  int repeating, smoothed, canvas;
  float offs[kTexMaxN];      // subsample offsets, tex_offsets()
};

// The subsample offsets f32((k + 0.5) / n), the double quotient rounded
// once, as JAX weak-types the reference's Python floats (host side).
inline void tex_offsets(TexArgs& a) {
  for (int k = 0; k < a.n && k < kTexMaxN; ++k) {
    a.offs[k] = static_cast<float>((k + 0.5) / a.n);
  }
}

// The same offset at compile time, for the unrolled instantiations.
__host__ __device__ constexpr float tex_offset(int n, int k) {
  return static_cast<float>((k + 0.5) / n);
}

__host__ __device__ constexpr int tex_edge(int repeating, int canvas) {
  return repeating ? kTexRepeat : (canvas ? kTexCanvas : kTexFlash);
}

// Pre-pass: texel i of the u8 texture -> premultiplied f32.
__device__ __forceinline__ void texprep_texel(const TexArgs& a, int i) {
  const unsigned char* p = a.img + 4 * static_cast<size_t>(i);
  const float alpha = __fdiv_rn(static_cast<float>(p[3]), 255.0f);
  float4 v;
  v.x = __fdiv_rn(static_cast<float>(p[0]), 255.0f) * alpha;
  v.y = __fdiv_rn(static_cast<float>(p[1]), 255.0f) * alpha;
  v.z = __fdiv_rn(static_cast<float>(p[2]), 255.0f) * alpha;
  v.w = alpha;
  a.tex[i] = v;
}

__device__ __forceinline__ float4 tex_load(const float4* tex, int i) {
  return __ldg(tex + i);
}

// One axis of a repeating texture: its side n and, for a power-of-two
// side, the mask n - 1 (else -1).
struct TexAxis {
  int n, mask;
};

__device__ __forceinline__ TexAxis tex_axis(int n) {
  return TexAxis{n, (n & (n - 1)) == 0 ? n - 1 : -1};
}

// The repeat wrap of one axis: floor_mod(x, n) of an integral x (the
// reference's jnp.mod) as a texel index — a mask or an integer remainder
// while x is exact in int arithmetic, the float remainder beyond.
__device__ __forceinline__ int wrap_index(float x, TexAxis ax) {
  if (fabsf(x) < kTexExact) {
    const int i = static_cast<int>(x);
    if (ax.mask >= 0) return i & ax.mask;
    const int r = i % ax.n;
    return r < 0 ? r + ax.n : r;
  }
  return static_cast<int>(floor_mod(x, static_cast<float>(ax.n)));
}

// wrap_index(x0 + 1, n) from c0 = wrap_index(x0, n).
__device__ __forceinline__ int wrap_next(float x0, float x1, int c0,
                                         TexAxis ax) {
  if (fabsf(x0) < kTexExact) return c0 + 1 == ax.n ? 0 : c0 + 1;
  return wrap_index(x1, ax);
}

// style._fetch of a clipped fill at integral (floored) coordinates: edge
// texels clamp outward, or read transparent outside under "canvas".
template <int kEdge>
__device__ __forceinline__ float4 tex_clipped(const TexArgs& a,
                                              const float4* tex, float ix,
                                              float iy) {
  const float w = static_cast<float>(a.tw);
  const float h = static_cast<float>(a.th);
  const int cx = static_cast<int>(fminf(fmaxf(ix, 0.0f), w - 1.0f));
  const int cy = static_cast<int>(fminf(fmaxf(iy, 0.0f), h - 1.0f));
  if (kEdge == kTexCanvas &&
      !(ix >= 0.0f && ix <= w - 1.0f && iy >= 0.0f && iy <= h - 1.0f)) {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  return tex_load(tex, cy * a.tw + cx);
}

// One subsample at texel-space (sx, sy): style._bilinear_sample (texel
// centres at integer + 0.5) or style._nearest_sample.
template <bool kSmooth, int kEdge>
__device__ __forceinline__ float4 tex_sample(const TexArgs& a,
                                             const float4* tex, TexAxis ax,
                                             TexAxis ay, float sx,
                                             float sy) {
  if (!kSmooth) {
    const float fx = floorf(sx);
    const float fy = floorf(sy);
    if (kEdge == kTexRepeat) {
      return tex_load(tex, wrap_index(fy, ay) * a.tw + wrap_index(fx, ax));
    }
    return tex_clipped<kEdge>(a, tex, fx, fy);
  }
  const float x = sx - 0.5f;
  const float y = sy - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float tx = x - x0;
  const float ty = y - y0;
  const float x1 = x0 + 1.0f;
  const float y1 = y0 + 1.0f;
  float4 c00, c10, c01, c11;
  if (kEdge == kTexRepeat) {
    const int cx0 = wrap_index(x0, ax);
    const int cy0 = wrap_index(y0, ay);
    const int cx1 = wrap_next(x0, x1, cx0, ax);
    const int r0 = cy0 * a.tw;
    const int r1 = wrap_next(y0, y1, cy0, ay) * a.tw;
    c00 = tex_load(tex, r0 + cx0);
    c10 = tex_load(tex, r0 + cx1);
    c01 = tex_load(tex, r1 + cx0);
    c11 = tex_load(tex, r1 + cx1);
  } else {
    c00 = tex_clipped<kEdge>(a, tex, x0, y0);
    c10 = tex_clipped<kEdge>(a, tex, x1, y0);
    c01 = tex_clipped<kEdge>(a, tex, x0, y1);
    c11 = tex_clipped<kEdge>(a, tex, x1, y1);
  }
  const float ux = 1.0f - tx;
  const float uy = 1.0f - ty;
  float4 r;
  r.x = (c00.x * ux + c10.x * tx) * uy + (c01.x * ux + c11.x * tx) * ty;
  r.y = (c00.y * ux + c10.y * tx) * uy + (c01.y * ux + c11.y * tx) * ty;
  r.z = (c00.z * ux + c10.z * tx) * uy + (c01.z * ux + c11.z * tx) * ty;
  r.w = (c00.w * ux + c10.w * tx) * uy + (c01.w * ux + c11.w * tx) * ty;
  return r;
}

// One pixel (x, y) under the affine m: the n x n subsamples summed ky
// outer, kx inner, averaged and un-premultiplied.  N > 0: n == N, loops
// unrolled; N == 0: a.n at run time.
template <int N, bool kSmooth, int kEdge>
__device__ __forceinline__ float4 texfield_pixel(const TexArgs& a,
                                                 const float* m, TexAxis ax,
                                                 TexAxis ay, int x, int y) {
  const float ga = m[0], gb = m[1], gc = m[2], gd = m[3], ge = m[4],
              gf = m[5];
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto sub = [&](float ox, float oy) {
    const float pxo = px + ox;
    const float pyo = py + oy;
    const float sx = ga * pxo + gc * pyo + ge;
    const float sy = gb * pxo + gd * pyo + gf;
    const float4 s = tex_sample<kSmooth, kEdge>(a, a.tex, ax, ay, sx, sy);
    acc.x = acc.x + s.x;
    acc.y = acc.y + s.y;
    acc.z = acc.z + s.z;
    acc.w = acc.w + s.w;
  };
  const int n = N > 0 ? N : a.n;
  if constexpr (N > 0) {
#pragma unroll
    for (int ky = 0; ky < N; ++ky) {
#pragma unroll
      for (int kx = 0; kx < N; ++kx) sub(tex_offset(N, kx), tex_offset(N, ky));
    }
  } else {
    for (int ky = 0; ky < n; ++ky) {
      for (int kx = 0; kx < n; ++kx) sub(a.offs[kx], a.offs[ky]);
    }
  }
  // The average: x * 2^-k where n * n = 2^k (exactly x / (n * n)), else
  // the IEEE quotient.
  const int nn = n * n;
  const bool pow2 = (nn & (nn - 1)) == 0;
  const float nnf = static_cast<float>(nn);
  const float rcp = 1.0f / nnf;
  auto mean = [&](float v) { return pow2 ? v * rcp : __fdiv_rn(v, nnf); };
  const float alpha = mean(acc.w);
  const float safe = fmaxf(alpha, 1e-6f);
  float4 r;
  if (alpha > 1e-6f) {
    r.x = __fdiv_rn(mean(acc.x), safe);
    r.y = __fdiv_rn(mean(acc.y), safe);
    r.z = __fdiv_rn(mean(acc.z), safe);
  } else {
    r.x = r.y = r.z = 0.0f;
  }
  r.w = alpha;
  return r;
}

// One block: the (blockIdx.x, blockIdx.y) 32 x 32 tile of every frame
// blockIdx.z + k * gridDim.z.
template <int N, bool kSmooth, int kEdge>
__device__ void texfield_block(const TexArgs& a) {
  const int x = blockIdx.x * kTexTileW + threadIdx.x % kTexTileW;
  const int y0 = blockIdx.y * kTexTileRows + threadIdx.x / kTexTileW;
  if (x >= a.width) return;
  const TexAxis ax = tex_axis(a.tw);
  const TexAxis ay = tex_axis(a.th);
  for (int f = blockIdx.z; f < a.frames; f += gridDim.z) {
    const float* m = a.invs + 6 * static_cast<size_t>(f);
    float4* out = a.out + static_cast<size_t>(f) * a.height * a.width;
#pragma unroll
    for (int r = 0; r < kTexRowsPerThread; ++r) {
      const int y = y0 + r * kTexTileH;
      if (y < a.height) {
        out[static_cast<size_t>(y) * a.width + x] =
            texfield_pixel<N, kSmooth, kEdge>(a, m, ax, ay, x, y);
      }
    }
  }
}

}  // namespace swf
