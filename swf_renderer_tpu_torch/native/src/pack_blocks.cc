// Flat-block packer: sorted coalesced delta updates -> placement blocks.
//
// The native runtime half of ops/flatblock.py: groups one draw's updates by
// 8-row strip and emits 128-update blocks with chunk-major addressing
// (rcid = (col/128)*8 + row%8, cmod = col%128).  Empty strips still emit one
// zero block so their plane gets zeroed on device.  The Python reference
// implementation (pack_flat_blocks) stays as the oracle; this runs the same
// contract at memcpy speed for the hot render path.

#include <cstdint>
#include <cstring>

namespace {
constexpr int kStripH = 8;
constexpr int kLane = 128;
constexpr int kBlk = 128;
}  // namespace

extern "C" {

// Worst-case block count for one draw (n updates over n_strips strips).
int64_t swf_pack_blocks_capacity(int64_t n, int32_t n_strips) {
  return n / kBlk + 2 * static_cast<int64_t>(n_strips) + 2;
}

// rows/cols/vals: n updates sorted by (row, col), rows in [0, height),
// cols in [0, width+1].  group_base = (frame*L + layer) * (n_strips + 1).
// Outputs (caller-allocated to >= capacity blocks):
//   sidx[b]              packed target group_base + strip
//   keep[b]              0 on a group's first block else 1
//   urc[b*kBlk + k]      chunk-major sublane id (f32)
//   ucm[b*kBlk + k]      column within chunk (f32)
//   uval[b*kBlk + k]     update value (0 padding)
// Returns blocks emitted, or -1 if capacity would be exceeded.
int64_t swf_pack_blocks(const int32_t* rows, const int32_t* cols,
                        const float* vals, int64_t n, int32_t n_strips,
                        int32_t group_base, int64_t capacity, int32_t* sidx,
                        int32_t* keep, float* urc, float* ucm, float* uval) {
  int64_t nb = 0;
  int64_t i = 0;
  for (int32_t s = 0; s < n_strips; ++s) {
    int64_t start = i;
    while (i < n && rows[i] / kStripH == s) ++i;
    int64_t cnt = i - start;
    int64_t blocks = cnt ? (cnt + kBlk - 1) / kBlk : 1;
    if (nb + blocks > capacity) return -1;
    for (int64_t b = 0; b < blocks; ++b, ++nb) {
      sidx[nb] = group_base + s;
      keep[nb] = b ? 1 : 0;
      float* rc = urc + nb * kBlk;
      float* cm = ucm + nb * kBlk;
      float* vv = uval + nb * kBlk;
      int64_t lo = start + b * kBlk;
      int64_t take = cnt - b * kBlk;
      if (take > kBlk) take = kBlk;
      if (take < 0) take = 0;
      for (int64_t k = 0; k < take; ++k) {
        int32_t r = rows[lo + k];
        int32_t c = cols[lo + k];
        rc[k] = static_cast<float>((c / kLane) * kStripH + r % kStripH);
        cm[k] = static_cast<float>(c % kLane);
        vv[k] = vals[lo + k];
      }
      if (take < kBlk) {
        std::memset(rc + take, 0, (kBlk - take) * sizeof(float));
        std::memset(cm + take, 0, (kBlk - take) * sizeof(float));
        std::memset(vv + take, 0, (kBlk - take) * sizeof(float));
      }
    }
  }
  return nb;
}

}  // extern "C"
