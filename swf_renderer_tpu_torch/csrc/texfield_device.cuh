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
// float4).  The field kernel runs persistent blocks of 32 x 8 threads
// that walk (frame, 32 x 8 tile) items, one thread per pixel, read texels
// through the read-only cache (animtex's 64 KB of texels stay in L1) and
// store one float4 per pixel into (F, H, W, 4): a warp writes 512
// contiguous bytes.  A form that first copied textures of up to 64 KB
// into shared memory was no faster on the card (it kept fewer blocks
// resident) and was taken out.
//
// Bound on this card: bytes — the f32 planes it writes (16 B a pixel)
// outweigh its ~60 f32 operations a bilinear subsample at supersample 2.
// The kernel itself is bound by instruction issue: the wrap's integer
// remainders, the IEEE divisions and the tap arithmetic, ~8x the bound
// at animtex1080 (PERF.md).
//
// Rounding (shared with the plain version, ROADMAP.md queue C): texel
// normalisation and the division by n*n and the un-premultiply are IEEE
// divisions (__fdiv_rn), never a reciprocal multiply; the repeat wrap is
// a floored modulo (of integral values, so an integer remainder gives the
// same index while they are exact in int, with fmodf beyond); floors are
// floorf; the subsample offsets are f32 roundings of the double
// (k + 0.5) / n, as JAX weak-types them; the library is built with
// -fmad=false so the coordinate multiply-adds run op by op.

#pragma once

#include "flatblock_device.cuh"

namespace swf {

constexpr int kTexTileW = 32;
constexpr int kTexTileH = 8;
constexpr int kTexThreads = kTexTileW * kTexTileH;
constexpr int kTexMaxN = 64;      // subsamples per axis
// Below this magnitude an integral float is exact in int arithmetic and
// x + 1 is exact in float.
constexpr float kTexExact = 16777216.0f;

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

// The repeat wrap of one axis: floor_mod(x, n) of an integral x (the
// reference's jnp.mod) as a texel index — an integer remainder while x is
// exact in int arithmetic, the float remainder beyond.
__device__ __forceinline__ int wrap_index(float x, int n) {
  if (fabsf(x) < kTexExact) {
    const int r = static_cast<int>(x) % n;
    return r < 0 ? r + n : r;
  }
  return static_cast<int>(floor_mod(x, static_cast<float>(n)));
}

// wrap_index(x0 + 1, n) from c0 = wrap_index(x0, n).
__device__ __forceinline__ int wrap_next(float x0, float x1, int c0, int n) {
  if (fabsf(x0) < kTexExact) return c0 + 1 == n ? 0 : c0 + 1;
  return wrap_index(x1, n);
}

// style._fetch of a clipped fill at integral (floored) coordinates: edge
// texels clamp outward, or read transparent outside under "canvas".
__device__ __forceinline__ float4 tex_clipped(const TexArgs& a,
                                              const float4* tex, float ix,
                                              float iy) {
  const float w = static_cast<float>(a.tw);
  const float h = static_cast<float>(a.th);
  const int cx = static_cast<int>(fminf(fmaxf(ix, 0.0f), w - 1.0f));
  const int cy = static_cast<int>(fminf(fmaxf(iy, 0.0f), h - 1.0f));
  if (a.canvas &&
      !(ix >= 0.0f && ix <= w - 1.0f && iy >= 0.0f && iy <= h - 1.0f)) {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  return tex_load(tex, cy * a.tw + cx);
}

// One subsample at texel-space (sx, sy): style._bilinear_sample (texel
// centres at integer + 0.5) or style._nearest_sample.
__device__ __forceinline__ float4 tex_sample(const TexArgs& a,
                                             const float4* tex, float sx,
                                             float sy) {
  if (!a.smoothed) {
    const float fx = floorf(sx);
    const float fy = floorf(sy);
    if (a.repeating) {
      return tex_load(
          tex, wrap_index(fy, a.th) * a.tw + wrap_index(fx, a.tw));
    }
    return tex_clipped(a, tex, fx, fy);
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
  if (a.repeating) {
    const int cx0 = wrap_index(x0, a.tw);
    const int cy0 = wrap_index(y0, a.th);
    const int cx1 = wrap_next(x0, x1, cx0, a.tw);
    const int r0 = cy0 * a.tw;
    const int r1 = wrap_next(y0, y1, cy0, a.th) * a.tw;
    c00 = tex_load(tex, r0 + cx0);
    c10 = tex_load(tex, r0 + cx1);
    c01 = tex_load(tex, r1 + cx0);
    c11 = tex_load(tex, r1 + cx1);
  } else {
    c00 = tex_clipped(a, tex, x0, y0);
    c10 = tex_clipped(a, tex, x1, y0);
    c01 = tex_clipped(a, tex, x0, y1);
    c11 = tex_clipped(a, tex, x1, y1);
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

__device__ __forceinline__ float4 texfield_pixel(const TexArgs& a,
                                                 const float4* tex, int f,
                                                 int x, int y) {
  const float* m = a.invs + 6 * static_cast<size_t>(f);
  const float ga = m[0], gb = m[1], gc = m[2], gd = m[3], ge = m[4],
              gf = m[5];
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);
  const int n = a.n;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int ky = 0; ky < n; ++ky) {
    const float pyo = py + a.offs[ky];
    for (int kx = 0; kx < n; ++kx) {
      const float pxo = px + a.offs[kx];
      const float sx = ga * pxo + gc * pyo + ge;
      const float sy = gb * pxo + gd * pyo + gf;
      const float4 s = tex_sample(a, tex, sx, sy);
      acc.x = acc.x + s.x;
      acc.y = acc.y + s.y;
      acc.z = acc.z + s.z;
      acc.w = acc.w + s.w;
    }
  }
  const float nn = static_cast<float>(n * n);
  const float alpha = __fdiv_rn(acc.w, nn);
  const float safe = fmaxf(alpha, 1e-6f);
  float4 r;
  if (alpha > 1e-6f) {
    r.x = __fdiv_rn(__fdiv_rn(acc.x, nn), safe);
    r.y = __fdiv_rn(__fdiv_rn(acc.y, nn), safe);
    r.z = __fdiv_rn(__fdiv_rn(acc.z, nn), safe);
  } else {
    r.x = r.y = r.z = 0.0f;
  }
  r.w = alpha;
  return r;
}

// One persistent block: every (frame, tile) item of this block's stride.
__device__ void texfield_block(const TexArgs& a) {
  const int tid = threadIdx.x;
  const int tiles_x = (a.width + kTexTileW - 1) / kTexTileW;
  const int tiles_y = (a.height + kTexTileH - 1) / kTexTileH;
  const long long per_frame = static_cast<long long>(tiles_x) * tiles_y;
  const long long items = per_frame * a.frames;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int f = static_cast<int>(item / per_frame);
    const int t = static_cast<int>(item % per_frame);
    const int x = (t % tiles_x) * kTexTileW + tid % kTexTileW;
    const int y = (t / tiles_x) * kTexTileH + tid / kTexTileW;
    if (x < a.width && y < a.height) {
      a.out[(static_cast<size_t>(f) * a.height + y) * a.width + x] =
          texfield_pixel(a, a.tex, f, x, y);
    }
  }
}

}  // namespace swf
