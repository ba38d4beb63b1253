// Scanline cell splitter: edges -> per-pixel-cell (row, col, area, cover).
//
// Native hot path of the scanline rasterization lowering (the Python
// reference implementation lives in ops/scanline.py:edges_to_cells and the
// algorithm derivation in that module's docstring).  Splits every edge at
// integer x/y crossings, clips to the viewport, and emits one record per
// cell crossing: 'area' is the exact in-cell trapezoid winding contribution,
// 'cover' the full-row contribution to pixels right of the cell.
//
// C ABI:
//   int64 swf_cells_split(edges*, n, h, w,
//                         rows*, cols*, area*, cover*, capacity)
//     -> number of records written, or -1 if capacity was insufficient
//   int64 swf_cells_split_delta(...) -> sorted coalesced delta updates
// (callers bound capacity host-side: <= |dx| + |dy| + 3 records per edge).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Sink {
  int32_t *rows;
  int32_t *cols;
  float *area;
  float *cover;
  int64_t capacity;
  int64_t count = 0;
  bool overflow = false;

  inline void emit(int32_t r, int32_t c, double a, double v) {
    if (count >= capacity) {
      overflow = true;
      ++count;
      return;
    }
    rows[count] = r;
    cols[count] = c;
    area[count] = static_cast<float>(a);
    cover[count] = static_cast<float>(v);
    ++count;
  }
};

template <typename Emit>
void split_edge(double x0, double y0, double x1, double y1, int height,
                int width, std::vector<double> &ts, Emit &&emit) {
  if (y0 == y1) return;  // horizontal edges contribute nothing

  // Clip the y-span to [0, height].
  double t_lo = std::clamp((0.0 - y0) / (y1 - y0), 0.0, 1.0);
  double t_hi = std::clamp((static_cast<double>(height) - y0) / (y1 - y0),
                           0.0, 1.0);
  double ta = std::min(t_lo, t_hi);
  double tb = std::max(t_lo, t_hi);
  double nx0 = x0 + (x1 - x0) * ta;
  double ny0 = y0 + (y1 - y0) * ta;
  double nx1 = x0 + (x1 - x0) * tb;
  double ny1 = y0 + (y1 - y0) * tb;
  if (ny0 == ny1) return;
  x0 = nx0; y0 = ny0; x1 = nx1; y1 = ny1;

  double dy = y1 - y0;
  double dx = x1 - x0;

  // Collect split parameters at integer y crossings and integer x crossings
  // within [0, width].  ``ts`` is caller-owned scratch (hoisted out of the
  // per-edge hot loop to avoid a malloc/free per edge).
  ts.clear();
  ts.push_back(0.0);
  ts.push_back(1.0);
  double ylo = std::min(y0, y1), yhi = std::max(y0, y1);
  for (int yc = static_cast<int>(std::floor(ylo)) + 1;
       yc < static_cast<int>(std::ceil(yhi)); ++yc) {
    ts.push_back((yc - y0) / dy);
  }
  if (dx != 0.0) {
    double xlo = std::min(x0, x1), xhi = std::max(x0, x1);
    int xc_start = std::max(0, static_cast<int>(std::floor(xlo)) + 1);
    int xc_stop = std::min(width, static_cast<int>(std::ceil(xhi)) - 1);
    for (int xc = xc_start; xc <= xc_stop; ++xc) {
      if (xlo < xc && xc < xhi) ts.push_back((xc - x0) / dx);
    }
  }
  std::sort(ts.begin(), ts.end());

  double prev_x = x0, prev_y = y0;
  for (size_t i = 1; i < ts.size(); ++i) {
    double t = std::clamp(ts[i], 0.0, 1.0);
    double sx = x0 + dx * t;
    double sy = y0 + dy * t;
    double sub_dy = sy - prev_y;
    if (sub_dy != 0.0) {
      double mx = std::clamp(0.5 * (prev_x + sx), 0.0,
                             static_cast<double>(width));
      double my = 0.5 * (prev_y + sy);
      int r = std::clamp(static_cast<int>(std::floor(my)), 0, height - 1);
      int c = std::clamp(static_cast<int>(std::floor(mx)), 0, width - 1);
      emit(r, c, sub_dy * (c + 1.0 - mx), sub_dy);
    }
    prev_x = sx;
    prev_y = sy;
  }
}

}  // namespace

extern "C" {

int64_t swf_cells_split(const float *edges, int64_t n_edges, int32_t height,
                        int32_t width, int32_t *rows, int32_t *cols,
                        float *area, float *cover, int64_t capacity) {
  Sink sink{rows, cols, area, cover, capacity};
  std::vector<double> ts;
  ts.reserve(64);
  for (int64_t i = 0; i < n_edges; ++i) {
    const float *e = edges + 4 * i;
    split_edge(e[0], e[1], e[2], e[3], height, width, ts,
               [&sink](int32_t r, int32_t c, double a, double v) {
                 sink.emit(r, c, a, v);
               });
  }
  return sink.overflow ? -1 : sink.count;
}

// Delta-update emission: the scanline pipeline's scatter consumes
// (row, col, value) updates where value at col c is
// area_c - (previous cell's area at c-1) + cover: concretely each cell
// contributes G[c] += area and G[c+1] += cover - area, and the row prefix
// sum of G is the exact per-pixel winding integral.  This entry point
// emits those updates SORTED by (row, col) and COALESCED (duplicate
// positions merged), which both shrinks the update list (~35% for typical
// shapes) and enables the device's sorted-scatter fast path.
int64_t swf_cells_split_delta(const float *edges, int64_t n_edges,
                              int32_t height, int32_t width, int32_t *rows,
                              int32_t *cols, float *vals, int64_t capacity) {
  struct Update {
    int64_t key;  // row * (width + 2) + col
    double val;
  };
  std::vector<Update> ups;
  ups.reserve(256);
  const int64_t kw = width + 2;
  std::vector<double> ts;
  ts.reserve(64);
  for (int64_t i = 0; i < n_edges; ++i) {
    const float *e = edges + 4 * i;
    split_edge(e[0], e[1], e[2], e[3], height, width, ts,
               [&](int32_t r, int32_t c, double a, double v) {
                 ups.push_back({static_cast<int64_t>(r) * kw + c, a});
                 ups.push_back({static_cast<int64_t>(r) * kw + c + 1, v - a});
               });
  }
  std::sort(ups.begin(), ups.end(),
            [](const Update &x, const Update &y) { return x.key < y.key; });
  int64_t count = 0;
  for (size_t i = 0; i < ups.size();) {
    double sum = 0.0;
    int64_t key = ups[i].key;
    while (i < ups.size() && ups[i].key == key) {
      sum += ups[i].val;
      ++i;
    }
    if (sum == 0.0) continue;
    if (count >= capacity) return -1;
    rows[count] = static_cast<int32_t>(key / kw);
    cols[count] = static_cast<int32_t>(key % kw);
    vals[count] = static_cast<float>(sum);
    ++count;
  }
  return count;
}

}  // extern "C"
