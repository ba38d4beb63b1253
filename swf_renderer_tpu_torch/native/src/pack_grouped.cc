// Grouped flat-block packer: one frame's sorted coalesced delta updates ->
// the fused kernel's grouped block arrays DIRECTLY, replacing the Python
// pack_flat_blocks -> sort_blocks_fused -> group_blocks_fused chain (pure
// Python per-block loops that dominated the host wall: ~5.5 s for the
// 60-frame 1080p headline scene vs ~24 ms of device time).
//
// Contract (must stay bit-compatible with the Python chain, which remains
// the tested oracle):
//  * blocks ordered by (strip, layer, chunk) — the fused kernel's
//    supergroup order; every (frame, strip) supergroup emits >= 1 group;
//  * group g of a supergroup carries `group` sub-blocks side by side
//    (zero-padded), flags bit0 on the first group (zero the accumulator),
//    bit1 on the last (resolve + emit the strip);
//  * gsi packs (frame * layers) * (n_strips + 1) + strip — the kernel only
//    extracts frame and strip from it.
//
// Frames are independent: callers parallelize with one call per frame
// (ctypes releases the GIL, so a Python thread pool scales across cores).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {
constexpr int kStripH = 8;
constexpr int kLane = 128;
}  // namespace

extern "C" {

// Upper bound on groups for one frame.
int64_t swf_pack_grouped_capacity(int64_t n_updates, int32_t layers,
                                  int32_t n_strips, int32_t group,
                                  int32_t blk) {
  // Each (layer, strip) adds at most one partial block; each strip rounds
  // up to one extra group and empty strips still emit one group.
  int64_t blocks = n_updates / blk
      + static_cast<int64_t>(n_strips) * (layers + 1) + 1;
  return blocks / group + n_strips + 1;
}

// EXACT group count for one frame (the same strip/layer walk as
// swf_pack_grouped without the writes).  Lets callers pack frames in
// PARALLEL directly into the final arrays: count every frame first
// (cheap integer scan), prefix-sum the counts into exact per-frame write
// offsets, then run the packs concurrently — no staging copies, no
// compaction pass.
int64_t swf_pack_grouped_count(const int32_t* rows, const int64_t* offsets,
                               int32_t layers, int32_t n_strips,
                               int32_t group, int32_t blk, int32_t spp) {
  const int32_t block_rows = kStripH * spp;
  std::vector<int64_t> idx(layers);
  for (int32_t l = 0; l < layers; ++l) idx[l] = offsets[l];
  int64_t ng = 0;
  for (int32_t s = 0; s < n_strips; ++s) {
    int64_t total_blocks = 0;
    for (int32_t l = 0; l < layers; ++l) {
      int64_t i = idx[l];
      const int64_t hi = offsets[l + 1];
      while (i < hi && rows[i] / block_rows <= s) ++i;
      const int64_t cnt = i - idx[l];
      idx[l] = i;
      total_blocks += (cnt + blk - 1) / blk;
    }
    if (total_blocks == 0) total_blocks = 1;
    ng += (total_blocks + group - 1) / group;
  }
  return ng;
}

// rows/cols/vals: all layers' updates concatenated (each layer's slice
// sorted by (row, col)); offsets (layers+1) delimits layers.
// Returns groups written, or -1 if capacity would be exceeded.
// n_strips counts STRIP BLOCKS of `spp` packed 8-row strips each
// (spp == 1 is the classic one-strip-per-plane layout); rc addresses the
// local strip's window: rc = ((row/8) % spp) * n_chunks*8
//                            + (col/128)*8 + row%8.
int64_t swf_pack_grouped(const int32_t* rows, const int32_t* cols,
                         const float* vals, const int64_t* offsets,
                         int32_t layers, int32_t n_strips,
                         int32_t frame_base, int32_t group, int32_t blk,
                         int32_t spp, int32_t n_chunks, int64_t capacity,
                         int32_t* gsi, int32_t* gfl, int32_t* glay,
                         float* grc, float* gcm, float* gvv) {
  const int32_t ns1 = n_strips + 1;
  const int64_t gb = static_cast<int64_t>(group) * blk;
  const int32_t block_rows = kStripH * spp;
  const int32_t nc8 = n_chunks * kStripH;

  // Per-layer strip start indices (updates are row-major sorted).
  std::vector<int64_t> sstart(static_cast<size_t>(layers) * ns1);
  for (int32_t l = 0; l < layers; ++l) {
    int64_t i = offsets[l];
    const int64_t hi = offsets[l + 1];
    for (int32_t s = 0; s <= n_strips; ++s) {
      while (i < hi && rows[i] / block_rows < s) ++i;
      sstart[static_cast<size_t>(l) * ns1 + s] = i;
    }
  }

  int64_t ng = 0;
  for (int32_t s = 0; s < n_strips; ++s) {
    int64_t total_blocks = 0;
    for (int32_t l = 0; l < layers; ++l) {
      int64_t cnt = sstart[static_cast<size_t>(l) * ns1 + s + 1]
          - sstart[static_cast<size_t>(l) * ns1 + s];
      total_blocks += (cnt + blk - 1) / blk;
    }
    const int64_t real_blocks = total_blocks;
    if (total_blocks == 0) total_blocks = 1;  // empty supergroup: zero+emit
    const int64_t groups_s = (total_blocks + group - 1) / group;
    if (ng + groups_s > capacity) return -1;

    std::memset(grc + ng * gb, 0, groups_s * gb * sizeof(float));
    std::memset(gcm + ng * gb, 0, groups_s * gb * sizeof(float));
    std::memset(gvv + ng * gb, 0, groups_s * gb * sizeof(float));
    std::memset(glay + ng * group, 0, groups_s * group * sizeof(int32_t));
    for (int64_t g = 0; g < groups_s; ++g) {
      // Bits 2+ carry the step's used slot count so the kernel can skip
      // padded slots' matmuls (0 = legacy "process all": bit-identical,
      // since padded slots are zero-valued either way).
      const int64_t used = std::max<int64_t>(
          0, std::min<int64_t>(group, real_blocks - g * group));
      gsi[ng + g] = frame_base * ns1 + s;
      gfl[ng + g] = (g == 0 ? 1 : 0) | (g == groups_s - 1 ? 2 : 0)
          | static_cast<int32_t>(used << 2);
    }

    int64_t slot = 0;
    for (int32_t l = 0; l < layers; ++l) {
      const int64_t lo = sstart[static_cast<size_t>(l) * ns1 + s];
      const int64_t hi = sstart[static_cast<size_t>(l) * ns1 + s + 1];
      for (int64_t b = lo; b < hi; b += blk, ++slot) {
        const int64_t g = ng + slot / group;
        const int64_t k = slot % group;
        glay[g * group + k] = l;
        float* rc = grc + g * gb + k * blk;
        float* cm = gcm + g * gb + k * blk;
        float* vv = gvv + g * gb + k * blk;
        const int64_t take = std::min<int64_t>(blk, hi - b);
        for (int64_t u = 0; u < take; ++u) {
          const int32_t r = rows[b + u];
          const int32_t c = cols[b + u];
          rc[u] = static_cast<float>(
              ((r / kStripH) % spp) * nc8 + (c / kLane) * kStripH
              + r % kStripH);
          cm[u] = static_cast<float>(c % kLane);
          vv[u] = vals[b + u];
        }
      }
    }
    ng += groups_s;
  }
  return ng;
}

}  // extern "C"
