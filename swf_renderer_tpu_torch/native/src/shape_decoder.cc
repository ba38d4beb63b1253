// Native shape geometry compiler.
//
// C++ counterpart of the reference's native decoder
// (reference rs/src/decoder/shape_decoder.rs): consumes a compact binary
// stream of SWF shape records and produces stitched, flattened paths
// (MoveTo/LineTo verbs + points) per styled segment set.  The algorithm is
// the same record walk as the TypeScript decoder — left/right fill duality
// with reversed right-fill segments, style layers, greedy single-pass
// continuity stitching — with curves flattened to their endpoints, matching
// the reference Rust decoder's behavior (shape_decoder.rs:42-57) and hence
// the tests/*/shape.rs.log golden files.
//
// Input stream (little endian):
//   u32 magic = 0x53574644 ("SWFD")
//   u32 n_initial_fills, u32 n_initial_lines
//   u32 n_records
//   records:
//     u8 tag: 0 = straight edge, 1 = curved edge, 2 = style change
//     straight: i32 dx, i32 dy
//     curved:   i32 cdx, i32 cdy, i32 dx, i32 dy
//     style change: u8 flags (1 left, 2 right, 4 line, 8 move, 16 newStyles)
//       [u32 left] [u32 right] [u32 line] [i32 mx, i32 my]
//       [u32 n_fills, u32 n_lines]
//
// Output buffer (allocated with malloc, freed by swf_free):
//   u32 n_paths
//   per path: u32 style_kind (0 fill, 1 line), u32 layer_index,
//             u32 style_index, u32 n_verbs
//   then per path: n_verbs u8 verbs (0 MoveTo, 1 LineTo), padded to 4 bytes
//   then per path: n_verbs * 2 f32 points

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <vector>

namespace {

struct Vec2 {
  int32_t x = 0;
  int32_t y = 0;
  bool operator==(const Vec2 &o) const { return x == o.x && y == o.y; }
};

struct Segment {
  Vec2 start;
  Vec2 end;
  Vec2 control;
  bool curved = false;

  Segment reversed() const {
    Segment s = *this;
    s.start = end;
    s.end = start;
    return s;
  }
};

struct SegmentSet {
  std::deque<Segment> segments;
};

struct StyleLayer {
  std::vector<SegmentSet> fills;
  std::vector<SegmentSet> lines;
};

struct PathOut {
  uint32_t style_kind;   // 0 fill, 1 line
  uint32_t layer_index;
  uint32_t style_index;
  std::vector<uint8_t> verbs;   // 0 MoveTo, 1 LineTo
  std::vector<float> points;    // x,y per verb
};

// Single greedy pass growing a continuous run at either end
// (shape_decoder.rs:59-78).
std::deque<Segment> extract_continuous(std::deque<Segment> &open_set) {
  std::deque<Segment> result;
  Segment first = open_set.front();
  open_set.pop_front();
  Vec2 start = first.start;
  Vec2 end = first.end;
  result.push_back(first);
  std::deque<Segment> remaining;
  for (const Segment &seg : open_set) {
    if (seg.start == end) {
      end = seg.end;
      result.push_back(seg);
    } else if (seg.end == start) {
      start = seg.start;
      result.push_front(seg);
    } else {
      remaining.push_back(seg);
    }
  }
  open_set = std::move(remaining);
  return result;
}

// Stitch runs and emit MoveTo/LineTo, flattening curves to their endpoints
// (shape_decoder.rs:42-57 — control points are dropped on output).
void segments_to_path(std::deque<Segment> open_set, PathOut &out) {
  while (!open_set.empty()) {
    std::deque<Segment> run = extract_continuous(open_set);
    bool first = true;
    for (const Segment &seg : run) {
      if (first) {
        out.verbs.push_back(0);
        out.points.push_back(static_cast<float>(seg.start.x));
        out.points.push_back(static_cast<float>(seg.start.y));
        first = false;
      }
      out.verbs.push_back(1);
      out.points.push_back(static_cast<float>(seg.end.x));
      out.points.push_back(static_cast<float>(seg.end.y));
    }
  }
}

class Reader {
 public:
  Reader(const uint8_t *buf, size_t len) : buf_(buf), len_(len) {}

  bool ok() const { return ok_; }

  uint8_t u8() { return static_cast<uint8_t>(take(1)); }
  uint32_t u32() { return static_cast<uint32_t>(take(4)); }
  int32_t i32() { return static_cast<int32_t>(take(4)); }

 private:
  uint64_t take(size_t n) {
    if (pos_ + n > len_) {
      ok_ = false;
      return 0;
    }
    uint64_t v = 0;
    std::memcpy(&v, buf_ + pos_, n);  // little-endian host assumed
    pos_ += n;
    return v;
  }

  const uint8_t *buf_;
  size_t len_;
  size_t pos_ = 0;
  bool ok_ = true;
};

class Decoder {
 public:
  explicit Decoder(uint32_t n_fills, uint32_t n_lines) {
    new_layer(n_fills, n_lines);
  }

  void new_layer(uint32_t n_fills, uint32_t n_lines) {
    layers_.emplace_back();
    layers_.back().fills.resize(n_fills);
    layers_.back().lines.resize(n_lines);
    left_ = right_ = line_ = 0;
  }

  void add_segment(const Segment &seg) {
    StyleLayer &layer = layers_.back();
    if (left_ != 0 && left_ <= layer.fills.size()) {
      layer.fills[left_ - 1].segments.push_back(seg);
    }
    if (right_ != 0 && right_ <= layer.fills.size()) {
      layer.fills[right_ - 1].segments.push_back(seg.reversed());
    }
    if (line_ != 0 && line_ <= layer.lines.size()) {
      layer.lines[line_ - 1].segments.push_back(seg);
    }
  }

  Vec2 pos;
  uint32_t left_ = 0, right_ = 0, line_ = 0;
  std::vector<StyleLayer> layers_;
};

}  // namespace

extern "C" {

// Returns a malloc'd output buffer (see header comment); *out_len receives
// its size.  Returns nullptr on malformed input.
uint8_t *swf_decode_shape(const uint8_t *buf, size_t len, size_t *out_len) {
  Reader r(buf, len);
  if (r.u32() != 0x53574644u) return nullptr;
  uint32_t n_fills = r.u32();
  uint32_t n_lines = r.u32();
  uint32_t n_records = r.u32();
  if (!r.ok()) return nullptr;

  Decoder dec(n_fills, n_lines);

  for (uint32_t i = 0; i < n_records && r.ok(); ++i) {
    uint8_t tag = r.u8();
    if (tag == 0 || tag == 1) {
      Segment seg;
      seg.start = dec.pos;
      if (tag == 1) {
        seg.curved = true;
        seg.control.x = dec.pos.x + r.i32();
        seg.control.y = dec.pos.y + r.i32();
      }
      seg.end.x = dec.pos.x + r.i32();
      seg.end.y = dec.pos.y + r.i32();
      dec.add_segment(seg);
      dec.pos = seg.end;
    } else if (tag == 2) {
      uint8_t flags = r.u8();
      uint32_t left = (flags & 1) ? r.u32() : 0;
      uint32_t right = (flags & 2) ? r.u32() : 0;
      uint32_t line = (flags & 4) ? r.u32() : 0;
      int32_t mx = 0, my = 0;
      if (flags & 8) {
        mx = r.i32();
        my = r.i32();
      }
      if (flags & 16) {
        uint32_t nf = r.u32();
        uint32_t nl = r.u32();
        dec.new_layer(nf, nl);
      }
      if (flags & 1) dec.left_ = left;
      if (flags & 2) dec.right_ = right;
      if (flags & 4) dec.line_ = line;
      if (flags & 8) {
        dec.pos.x = mx;
        dec.pos.y = my;
      }
    } else {
      return nullptr;
    }
  }
  if (!r.ok()) return nullptr;

  std::vector<PathOut> paths;
  for (uint32_t li = 0; li < dec.layers_.size(); ++li) {
    StyleLayer &layer = dec.layers_[li];
    for (uint32_t fi = 0; fi < layer.fills.size(); ++fi) {
      if (layer.fills[fi].segments.empty()) continue;
      PathOut p{0, li, fi, {}, {}};
      segments_to_path(layer.fills[fi].segments, p);
      paths.push_back(std::move(p));
    }
    for (uint32_t si = 0; si < layer.lines.size(); ++si) {
      if (layer.lines[si].segments.empty()) continue;
      PathOut p{1, li, si, {}, {}};
      segments_to_path(layer.lines[si].segments, p);
      paths.push_back(std::move(p));
    }
  }

  // Serialize.
  size_t total = 4;
  for (const PathOut &p : paths) {
    total += 16;
    total += (p.verbs.size() + 3) / 4 * 4;
    total += p.points.size() * 4;
  }
  uint8_t *out = static_cast<uint8_t *>(std::malloc(total));
  if (out == nullptr) return nullptr;
  size_t off = 0;
  auto put_u32 = [&](uint32_t v) {
    std::memcpy(out + off, &v, 4);
    off += 4;
  };
  put_u32(static_cast<uint32_t>(paths.size()));
  for (const PathOut &p : paths) {
    put_u32(p.style_kind);
    put_u32(p.layer_index);
    put_u32(p.style_index);
    put_u32(static_cast<uint32_t>(p.verbs.size()));
  }
  for (const PathOut &p : paths) {
    size_t padded = (p.verbs.size() + 3) / 4 * 4;
    std::memset(out + off, 0, padded);
    std::memcpy(out + off, p.verbs.data(), p.verbs.size());
    off += padded;
    std::memcpy(out + off, p.points.data(), p.points.size() * 4);
    off += p.points.size() * 4;
  }
  *out_len = total;
  return out;
}

void swf_free(uint8_t *ptr) { std::free(ptr); }

}  // extern "C"
