"""Where the direct coverage kernels' time goes: banded (B9), tiled
(B10) and grouped (B11).

    python3 -m swf_renderer_tpu_torch.tools.coverage_phases [--csrc DIR]
        [--parent DIR] [--variants]

Needs one NVIDIA card and ``nvcc``.  Builds ``coverage.cu`` from ``DIR``
(default: this package's ``csrc``) twice, as it is and a copy with
``clock64()`` stamps around the phases of ``banded_block``,
``tiled_block`` and ``grouped_block`` (staging, edge loop, store, the
rest), thread 0's cycles summed over blocks into a device array.  On
direct1080 (B9 and B11: 60 x 4 planes of 1088x1920, 256 edges padded)
and dense1080 (B10 and B11: 4 x 4 planes, 3200 edges), built as
``chip_smoke.py`` builds them, it prints for each kernel and scene: ms
of every build (twice, in the order parent, change, stamped, variants,
then back), each output against the plain version (max abs, equality),
cycles a block and each phase's share, ptxas registers / stack /
spills, the SASS instruction count with its CALLs, local loads and
stores, compare-and-swap atomics and loops, and the (edge, pixel) pairs
the kernel's walk meets beside those whose computed dy is nonzero (of
those, the pixels right of the edge's clipped x-extent, which add dy
alone; for B11 also the 8-edge groups holding such a pair).
``--parent`` builds another checkout's ``csrc`` beside, ``--build
NAME=DIR`` any other ``csrc`` directory, ``--variants`` the design
elements of ``VARIANTS`` (edits of the committed form).  One
JSON object of the builds, one a kernel, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import tempfile

from .timing import card_line, time_ms

DIRECT = (60, 4, 1088, 1920, 16)    # frames, layers, height, width, shapes
DENSE = (4, 4, 1088, 1920, 320)
PHASES = ("stage", "loop", "store", "rest")
# (kernel, scene, its dimensions, first stamp slot)
CASES = (("banded", "direct1080", DIRECT, 0), ("tiled", "dense1080", DENSE, 8),
         ("grouped", "direct1080", DIRECT, 16),
         ("grouped", "dense1080", DENSE, 16))

_HELPER = """
__device__ unsigned long long swf_cov_stamp[24];
// Thread 0 of the block adds its phase cycles at slot base .. base + 4.
__device__ __forceinline__ void swf_stamp_out(int base, long long t0,
                                              long long stage,
                                              long long loop, long long t2) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long t3 = clock64();
    atomicAdd(&swf_cov_stamp[base], (unsigned long long)stage);
    atomicAdd(&swf_cov_stamp[base + 1], (unsigned long long)loop);
    atomicAdd(&swf_cov_stamp[base + 2], (unsigned long long)(t3 - t2));
    atomicAdd(&swf_cov_stamp[base + 3],
              (unsigned long long)((t2 - t0) - stage - loop));
    atomicAdd(&swf_cov_stamp[base + 4], 1ull);
  }
}
// The same with the store's cycles summed by the caller.
__device__ __forceinline__ void swf_stamp_sum(int base, long long t0,
                                              long long stage,
                                              long long loop,
                                              long long store) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long t3 = clock64();
    atomicAdd(&swf_cov_stamp[base], (unsigned long long)stage);
    atomicAdd(&swf_cov_stamp[base + 1], (unsigned long long)loop);
    atomicAdd(&swf_cov_stamp[base + 2], (unsigned long long)store);
    atomicAdd(&swf_cov_stamp[base + 3],
              (unsigned long long)((t3 - t0) - stage - loop - store));
    atomicAdd(&swf_cov_stamp[base + 4], 1ull);
  }
}
"""

_READ = """
extern "C" int swf_cov_stamps(unsigned long long* host, int zero) {
  if (zero) {
    unsigned long long z[24] = {0};
    return (int)cudaMemcpyToSymbol(swf::swf_cov_stamp, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(host, swf::swf_cov_stamp,
                                   24 * sizeof(unsigned long long));
}
"""

# (anchor, replacement) edits of coverage_device.cuh that stamp the
# phases, per form of the source; the first form whose anchors all occur
# exactly once is used.
_STAMP0 = ("  const long long st0_ = clock64();\n"
           "  long long sst_ = 0, slp_ = 0;\n")


def _entry(sig):
    return (sig, sig + _STAMP0)


def _close(tail, base):
    """The block's last loop closes with ``tail`` (its final lines, the
    loop's closing brace included, then the store)."""
    cut = tail.rindex("  }\n  pix.store(")
    store = tail[cut + 4:tail.rindex("\n}")]
    return (tail, tail[:cut] + "    slp_ += clock64() - sb_;\n  }\n"
            f"  const long long st2_ = clock64();\n{store}\n"
            f"  swf_stamp_out({base}, st0_, sst_, slp_, st2_);\n}}")


_SB = "    const long long sb_ = clock64();\n    sst_ += sb_ - sa_;\n"
# The end of the staged tiled_block (B10) and grouped_block (B11): the
# row loop's add of the block's partial, the loops' ends, the store.
_ACC_TAIL = ("#pragma unroll\n      for (int c = 0; c < kCovCols; ++c) {\n"
             "        s.acc.v[j][c][tid] = s.acc.v[j][c][tid] + part[c];\n"
             "      }\n    }\n  }\n  pix.store(a, s.acc, tid);\n}")
FORMS = {
    "staged terms": [
        _entry("__device__ void banded_block(const CoverageArgs& a, "
               "BandedTerms& s) {\n"),
        ("  if (once && n > 0) banded_stage(a, s, e, n, 0, band_y0);\n",
         "  const long long sa_ = clock64();\n"
         "  if (once && n > 0) banded_stage(a, s, e, n, 0, band_y0);\n"
         "  sst_ += clock64() - sa_;\n  long long sto_ = 0;\n"),
        ("        __syncthreads();   // the previous round is no longer read\n"
         "        banded_stage(a, s, e, n, c0, band_y0);\n",
         "        const long long sa_ = clock64();\n"
         "        __syncthreads();   // the previous round is no longer read\n"
         "        banded_stage(a, s, e, n, c0, band_y0);\n"
         "        sst_ += clock64() - sa_;\n"),
        ("#pragma unroll 1\n      for (int j = 0; j < kCovRowsPerThread; ++j) "
         "{\n        const int row = pix.half + j;\n        const int cnt",
         "      const long long sb_ = clock64();\n#pragma unroll 1\n      for "
         "(int j = 0; j < kCovRowsPerThread; ++j) {\n        const int row = "
         "pix.half + j;\n        const int cnt"),
        ("s.acc.v[j][c][tid] = sum[c];\n      }\n",
         "s.acc.v[j][c][tid] = sum[c];\n      }\n"
         "      slp_ += clock64() - sb_;\n"),
        ("    pix.store(a, s.acc, tid);\n  }\n}",
         "    const long long sc_ = clock64();\n"
         "    pix.store(a, s.acc, tid);\n"
         "    sto_ += clock64() - sc_;\n  }\n"
         "  swf_stamp_sum(0, st0_, sst_, slp_, sto_);\n}"),
        _entry("__device__ void tiled_block(const CoverageArgs& a, "
               "TiledTerms& s) {\n"),
        ("    __syncthreads();   // the previous block's terms are no longer "
         "read\n    {\n      const int k",
         "    const long long sa_ = clock64();\n"
         "    __syncthreads();   // the previous block's terms are no longer "
         "read\n    {\n      const int k"),
        ("    __syncthreads();\n#pragma unroll 1\n    for (int j = 0; j < "
         "kCovRowsPerThread; ++j) {\n      const int row = pix.half + j;\n"
         "      unsigned m",
         "    __syncthreads();\n" + _SB + "#pragma unroll 1\n    for (int j "
         "= 0; j < kCovRowsPerThread; ++j) {\n      const int row = pix.half "
         "+ j;\n      unsigned m"),
        _close("(tiled_pixel(t2, px) + tiled_pixel(t3, px)));\n"
               "        }\n      }\n" + _ACC_TAIL, 8),
    ],
    "one edge at a time": [
        _entry("__device__ void banded_block(const CoverageArgs& a, "
               "float* s) {\n"),
        ("  __syncthreads();\n  const CovPixel pix(tid);\n",
         "  __syncthreads();\n  const long long st1_ = clock64();\n"
         "  sst_ = st1_ - st0_;\n  const CovPixel pix(tid);\n"),
        ("  }\n  pix.store(a, acc);\n}\n\n// B10",
         "  }\n  const long long st2_ = clock64();\n  slp_ = st2_ - st1_;\n"
         "  pix.store(a, acc);\n  swf_stamp_out(0, st0_, sst_, slp_, st2_);"
         "\n}\n\n// B10"),
        _entry("__device__ void tiled_block(const CoverageArgs& a, "
               "float* s) {\n"),
        ("    __syncthreads();   // the previous block's edges are no longer "
         "read\n",
         "    const long long sa_ = clock64();\n"
         "    __syncthreads();   // the previous block's edges are no longer "
         "read\n"),
        ("    __syncthreads();\n    float part[kCovRowsPerThread];\n",
         "    __syncthreads();\n" + _SB
         + "    float part[kCovRowsPerThread];\n"),
        _close("acc[j] = acc[j] + part[j];\n  }\n  pix.store(a, acc);\n}", 8),
    ],
}

# The same for B11's grouped_block, applied beside FORMS (its slots 16
# .. 20).
GROUPED_FORMS = {
    "grouped staged terms": [
        _entry("__device__ void grouped_block(const CoverageArgs& a, "
               "GroupedTerms& s) {\n"),
        ("    __syncthreads();   // the previous block's terms are no longer "
         "read\n    if (strip == 0 ? hit0 : hit1) {\n",
         "    const long long sa_ = clock64();\n"
         "    __syncthreads();   // the previous block's terms are no longer "
         "read\n    if (strip == 0 ? hit0 : hit1) {\n"),
        ("    __syncthreads();\n#pragma unroll 1\n    for (int j = 0; j < "
         "kCovRowsPerThread; ++j) {\n      const int row = pix.half + j;\n"
         "      float part[kCovCols] = {};\n",
         "    __syncthreads();\n" + _SB + "#pragma unroll 1\n    for (int j "
         "= 0; j < kCovRowsPerThread; ++j) {\n      const int row = pix.half "
         "+ j;\n      float part[kCovCols] = {};\n"),
        _close("part[c] = part[c] + grp[c];\n        }\n      }\n"
               + _ACC_TAIL, 16),
    ],
    "grouped first design": [
        _entry("__device__ void grouped_block(const CoverageArgs& a, "
               "GroupedTerms& s) {\n"),
        ("    __syncthreads();   // the previous block's terms are no longer "
         "read\n    {\n      const int i = blk",
         "    const long long sa_ = clock64();\n"
         "    __syncthreads();   // the previous block's terms are no longer "
         "read\n    {\n      const int i = blk"),
        ("    __syncthreads();\n    for (int r = 0; r < kGrpStripH; ++r) {\n"
         "      float part = 0.0f;\n",
         "    __syncthreads();\n" + _SB + "    for (int r = 0; r < "
         "kGrpStripH; ++r) {\n      float part = 0.0f;\n"),
        ("      acc[r] = acc[r] + part;\n    }\n  }\n"
         "  if (col >= a.width) return;\n"
         "  float* out = a.out + static_cast<size_t>(b) * a.height * "
         "a.width;\n"
         "  for (int r = 0; r < kGrpStripH; ++r) {\n"
         "    const int y = row0 + r;\n"
         "    if (y < a.height) {\n"
         "      out[static_cast<size_t>(y) * a.width + col] = "
         "fill_cov(acc[r], a.rule);\n    }\n  }\n}",
         "      acc[r] = acc[r] + part;\n    }\n"
         "    slp_ += clock64() - sb_;\n  }\n"
         "  const long long st2_ = clock64();\n"
         "  float* out = a.out + static_cast<size_t>(b) * a.height * "
         "a.width;\n"
         "  for (int r = 0; r < kGrpStripH && col < a.width; ++r) {\n"
         "    const int y = row0 + r;\n"
         "    if (y < a.height) {\n"
         "      out[static_cast<size_t>(y) * a.width + col] = "
         "fill_cov(acc[r], a.rule);\n    }\n  }\n"
         "  swf_stamp_out(16, st0_, sst_, slp_, st2_);\n}"),
    ],
}

# Design elements measured beside the committed form, as edits
# (file, anchor, replacement) of its sources.
_RIGHT = "  if (rel_mx <= 0.0f) return t.x;   // right of the edge: dy * 1\n"
VARIANTS = {
    "B9 one column tile a block": [
        ("coverage_device.cuh", "kBandMinBlocksPerSm = 24;",
         "kBandMinBlocksPerSm = 1 << 20;")],
    "1 column a thread": [("coverage_device.cuh", "kCovCols = 4;",
                           "kCovCols = 1;")],
    "2 columns a thread": [("coverage_device.cuh", "kCovCols = 4;",
                            "kCovCols = 2;")],
    "chunk 32": [("coverage_device.cuh", "kBandChunk = 64;",
                  "kBandChunk = 32;")],
    "chunk 128": [("coverage_device.cuh", "kBandChunk = 64;",
                   "kBandChunk = 128;")],
    "B9 without the right-of-edge path": [
        ("coverage_device.cuh", _RIGHT + "  const float rel_mn = t.y - px;\n"
         "  const float span", "  const float rel_mn = t.y - px;\n"
         "  const float span")],
    "B10 and B11 without the right-of-edge path": [
        ("coverage_device.cuh", _RIGHT + "  const float rel_mn = t.y - px;\n"
         "  const float mean", "  const float rel_mn = t.y - px;\n"
         "  const float mean")],
    "4 blocks an SM": [
        ("coverage.cu", "__launch_bounds__(kCovThreads) banded_kernel",
         "__launch_bounds__(kCovThreads, 4) banded_kernel"),
        ("coverage.cu", "__launch_bounds__(kCovThreads) tiled_kernel",
         "__launch_bounds__(kCovThreads, 4) tiled_kernel")],
    "B11 without a block bound": [
        ("coverage.cu", "__launch_bounds__(kCovThreads, 5) grouped_kernel",
         "__launch_bounds__(kCovThreads) grouped_kernel")],
    "6 blocks an SM": [
        ("coverage.cu", "__launch_bounds__(kCovThreads) banded_kernel",
         "__launch_bounds__(kCovThreads, 6) banded_kernel"),
        ("coverage.cu", "__launch_bounds__(kCovThreads) tiled_kernel",
         "__launch_bounds__(kCovThreads, 6) tiled_kernel")],
}


def stamped_source(text: str):
    """coverage_device.cuh with the phase stamps: (form names, text)."""
    names = []
    for forms in (FORMS, GROUPED_FORMS):
        for name, edits in forms.items():
            if all(text.count(old) == 1 for old, _ in edits):
                for old, new in edits:
                    text = text.replace(old, new)
                names.append(name)
                break
        else:
            raise SystemExit("coverage_device.cuh matches no stamped form")
    head = "namespace swf {\n"
    return " + ".join(names), text.replace(head, head + _HELPER, 1)


def variant_sources(csrc: pathlib.Path, dest: pathlib.Path, edits):
    """Copy ``csrc`` to ``dest`` with ``edits`` applied; False when an
    anchor does not occur exactly once (the variant does not apply)."""
    shutil.copytree(csrc, dest)
    for name, old, new in edits:
        path = dest / name
        text = path.read_text()
        if text.count(old) != 1:
            return False
        path.write_text(text.replace(old, new))
    return True


def ptxas_of(log: str, kernel: str):
    """registers, stack and spill bytes of ``kernel`` from nvcc -Xptxas -v."""
    out, current = {}, False
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            current = kernel in m.group(1)
            continue
        if not current:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out["registers"] = int(m.group(1))
    return out


def sass_census(body: str):
    """Instructions, CALLs, local loads and stores (STL / LDL),
    compare-and-swap atomics (ATOMS.CAS / ATOM.CAS: a 64-bit shared
    atomicAdd is a loop of them) and loops (backward branches:
    instructions from target to branch, largest first) of one kernel's
    SASS text."""
    ins = [(int(a, 16), op) for a, op in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    loops = []
    for addr, op in ins:
        b = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
        if b and int(b.group(1), 16) < addr:
            lo = int(b.group(1), 16)
            loops.append(sum(1 for a, _ in ins if lo <= a <= addr))

    def count(pattern):
        return sum(1 for _, op in ins if re.search(pattern, op))

    return {"instructions": len(ins), "calls": count(r"\bCALL"),
            "stl": count(r"\bSTL\b"), "ldl": count(r"\bLDL\b"),
            "cas": count(r"\bATOMS?\.CAS"),
            "loops": sorted(loops, reverse=True)}


def sass_counts(lib: pathlib.Path, kernel: str):
    """``sass_census`` of the first kernel of ``lib`` whose mangled name
    holds ``kernel``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    heads = list(re.finditer(r"Function : (\S+)", text))
    for i, m in enumerate(heads):
        if kernel in m.group(1):
            return sass_census(text[m.end():heads[i + 1].start()
                                    if i + 1 < len(heads) else len(text)])
    return {}


def scene(np, cov, dims):
    from ..utils.scenes import build_scene_edges

    frames, layers, height, width, shapes = dims
    tables, _ = build_scene_edges(frames, layers, height, width,
                                  shapes_per_layer=shapes, seed=7)
    edges = cov.split_pad_tables([t for per in tables for t in per])
    return edges.reshape(frames * layers, 4, -1), height, width


def right_pixels(torch, xmx, width_p):
    """Pixels px in [0, width_p) with xmx - px <= 0."""
    first = torch.clamp(torch.ceil(xmx), 0, width_p)
    return (width_p - first).to(torch.int64)


def banded_pairs(torch, cov, es, ranges, height, width):
    """Pairs met by B9's walk (window edges x its band's pixels) against
    those whose computed dy is nonzero; crossing edges a row."""
    lo = ranges[..., 0].long()
    cnt = (ranges[..., 1].long() - lo).clamp(min=0)
    k_max = int(cnt.max().item())
    ty = ranges.shape[1]
    width_p = -(-width // cov.TILE_W) * cov.TILE_W
    k = torch.arange(k_max, device=es.device)
    valid = k[None, None, :] < cnt[..., None]                 # (P, TY, K)
    idx = (lo[..., None] + k).clamp(max=es.shape[-1] - 1)
    p = es.shape[0]
    x0, y0, x1, y1 = (torch.gather(es[:, c], 1, idx.view(p, -1)).view(
        p, ty, k_max)[..., None] for c in range(4))
    py = (torch.arange(ty, device=es.device)[:, None] * cov.TILE_H
          + torch.arange(cov.TILE_H, device=es.device)).float()
    py = py[None, :, None, :]                                 # (1, TY, 1, 16)
    dy, _, xmx = cov.edge_row_span(x0, y0, x1, y1, py)
    live = valid[..., None] & (py < height)
    cross = live & (dy != 0)
    per_row = cross.sum(dim=2)
    return {"evaluated": int(valid.sum()) * cov.TILE_H * width_p,
            "crossing": int(cross.sum()) * width_p,
            "crossing_right": int(right_pixels(torch, xmx, width_p)[cross]
                                  .sum()),
            "window_mean": float(cnt.float().mean()),
            "window_max": int(cnt.max()),
            "crossing_row_mean": float(per_row.float().mean()),
            "crossing_row_max": int(per_row.max())}


def tiled_pairs(torch, cov, es, bounds, height, width):
    """Pairs met by B10's walk (hit blocks x 128 edges x the tile's
    pixels), those whose computed dy is nonzero, and the trips of four
    edges with at least one such edge."""
    p, _, e = es.shape
    nb = e // cov.EDGE_BLOCK
    ty = -(-height // cov.TILE_H)
    width_p = -(-width // cov.TILE_W) * cov.TILE_W
    t0 = torch.arange(ty, device=es.device).float() * cov.TILE_H
    hit = ((bounds[..., 1, None] > t0) & (bounds[..., 0, None]
                                          < t0 + cov.TILE_H))  # (P, NB, TY)
    slope = cov.edge_slopes(es).view(p, nb, cov.EDGE_BLOCK)
    x0, y0, y1 = (es[:, c].view(p, nb, cov.EDGE_BLOCK) for c in (0, 1, 3))
    out = {"evaluated": int(hit.sum()) * cov.EDGE_BLOCK * cov.TILE_H
           * width_p, "crossing": 0, "crossing_right": 0, "trips": 0,
           "hit_blocks_mean": float(hit.sum(dim=1).float().mean())}
    rows_cross = torch.zeros((p, ty, cov.TILE_H), dtype=torch.int64,
                             device=es.device)
    for r in range(cov.TILE_H):
        py = (t0 + r)[None, None, None, :]                  # (1, 1, 1, TY)
        sy0 = y0[..., None] - py
        sy1 = y1[..., None] - py
        cy0 = torch.clamp(sy0, 0.0, 1.0)
        cy1 = torch.clamp(sy1, 0.0, 1.0)
        dy = cy1 - cy0                                      # (P, NB, 128, TY)
        xa = x0[..., None] + (cy0 - sy0) * slope[..., None]
        xb = x0[..., None] + (cy1 - sy0) * slope[..., None]
        cross = (dy != 0) & hit[:, :, None, :] & (py < height)
        out["crossing"] += int(cross.sum()) * width_p
        out["crossing_right"] += int(right_pixels(
            torch, torch.maximum(xa, xb), width_p)[cross].sum())
        out["trips"] += int(cross.view(p, nb, cov.EDGE_BLOCK // 4, 4, ty)
                            .any(dim=3).sum())
        rows_cross[:, :, r] = cross.sum(dim=(1, 2))
    out["trip_pairs"] = out.pop("trips") * 4 * width_p
    out["crossing_row_mean"] = float(rows_cross.float().mean())
    out["crossing_row_max"] = int(rows_cross.max())
    return out


def grouped_pairs(torch, cov, es, bounds, height, width):
    """Pairs met by B11's first design (hit blocks x 128 edges x the
    strip's 8 rows x its pixels), those whose computed dy is nonzero (of
    those, the pixels right of the clipped x-extent), and the 8-edge
    groups a row with at least one such edge."""
    p, _, e = es.shape
    nb = e // cov.EDGE_BLOCK
    ty = -(-height // cov.STRIP_H)
    width_p = -(-width // cov.EDGE_BLOCK) * cov.EDGE_BLOCK
    s0 = torch.arange(ty, device=es.device).float() * cov.STRIP_H
    hit = ((bounds[..., 1, None] > s0) & (bounds[..., 0, None]
                                          < s0 + cov.STRIP_H))  # (P, NB, TY)
    edges = es.view(p, 4, nb, cov.EDGE_BLOCK).permute(1, 0, 2, 3)[..., None]
    out = {"evaluated": int(hit.sum()) * cov.EDGE_BLOCK * cov.STRIP_H
           * width_p, "crossing": 0, "crossing_right": 0, "groups": 0,
           "hit_blocks_mean": float(hit.sum(dim=1).float().mean())}
    rows_cross = torch.zeros((p, ty, cov.STRIP_H), dtype=torch.int64,
                             device=es.device)
    for r in range(cov.STRIP_H):
        py = s0 + r                                         # (TY,)
        dy, _, xmx, _, _ = cov.grouped_row_terms(edges, py)  # (P, NB, 128, TY)
        cross = (dy != 0) & hit[:, :, None, :] & (py < height)
        out["crossing"] += int(cross.sum()) * width_p
        out["crossing_right"] += int(right_pixels(torch, xmx, width_p)[cross]
                                     .sum())
        out["groups"] += int(cross.view(p, nb, cov.EDGE_BLOCK // cov.GROUP,
                                        cov.GROUP, ty).any(dim=3).sum())
        rows_cross[:, :, r] = cross.sum(dim=(1, 2))
    out["group_pairs"] = out.pop("groups") * cov.GROUP * width_p
    out["crossing_row_mean"] = float(rows_cross.float().mean())
    out["crossing_row_max"] = int(rows_cross.max())
    return out


def build_all(cuda_lib, tmp, sources):
    """{name: csrc dir} -> {name: bound library}, ptxas logs; one nvcc a
    build, all started together."""
    import threading

    libs, logs, errors = {}, {}, {}

    def one(name, d):
        path = tmp / f"lib_{len(name)}_{abs(hash(name))}.so"
        try:
            logs[name] = cuda_lib._nvcc_all(d, {"swfcoverage": path})
            libs[name] = (cuda_lib.bind("swfcoverage",
                                        ctypes.CDLL(str(path))), path)
        except Exception as exc:  # reported below
            errors[name] = str(exc)[-2000:]

    threads = [threading.Thread(target=one, args=item)
               for item in sources.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return libs, logs, errors


def main() -> None:
    import numpy as np
    import torch

    from ..ops import coverage as cov, cuda_lib

    parser = argparse.ArgumentParser()
    parser.add_argument("--csrc", type=pathlib.Path,
                        default=cuda_lib.CSRC_DIR)
    parser.add_argument("--parent", type=pathlib.Path, default=None,
                        help="another checkout's csrc, timed beside")
    parser.add_argument("--variants", action="store_true",
                        help="also build and time VARIANTS")
    parser.add_argument("--build", action="append", default=[],
                        metavar="NAME=DIR",
                        help="another csrc directory, timed beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("coverage_phases needs a CUDA card")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="coverage_phases_"))
    try:
        sources = {"change": tmp / "change", "stamped": tmp / "stamped"}
        shutil.copytree(args.csrc, sources["change"])
        shutil.copytree(args.csrc, sources["stamped"])
        form, text = stamped_source(
            (sources["stamped"] / "coverage_device.cuh").read_text())
        (sources["stamped"] / "coverage_device.cuh").write_text(text)
        (sources["stamped"] / "coverage.cu").write_text(
            (sources["stamped"] / "coverage.cu").read_text() + _READ)
        if args.parent is not None:
            sources["parent"] = tmp / "parent"
            shutil.copytree(args.parent, sources["parent"])
        for i, spec in enumerate(args.build):
            name, _, d = spec.partition("=")
            sources[name] = tmp / f"build{i}"
            shutil.copytree(d, sources[name])
        skipped = []
        if args.variants:
            for i, (name, edits) in enumerate(VARIANTS.items()):
                d = tmp / f"variant{i}"
                if variant_sources(args.csrc, d, edits):
                    sources[name] = d
                else:
                    skipped.append(name)
        libs, logs, errors = build_all(cuda_lib, tmp, sources)
        if "change" not in libs or "stamped" not in libs:
            raise SystemExit(f"build failed: {errors}")
        stamps = libs["stamped"][0]
        stamps.swf_cov_stamps.restype = ctypes.c_int
        stamps.swf_cov_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        print(json.dumps({"csrc": str(args.csrc), "form": form,
                          "build_errors": errors,
                          "variants_not_applied": skipped}), flush=True)
        order = ["parent"] * ("parent" in libs) + ["change", "stamped"] + [
            n for n in libs if n not in ("parent", "change", "stamped")]
        mine = cuda_lib._libs.get("swfcoverage")
        scenes = {}
        for kind, what, dims, base in CASES:
            if what not in scenes:
                scenes[what] = scene(np, cov, dims)
            edges, height, width = scenes[what]
            d = torch.from_numpy(edges).cuda()
            es, key, pad = cov.sort_edges(d)
            table = (cov.band_ranges(d, key, height) if kind == "banded"
                     else cov.block_bounds(es, key, pad))
            plain_fn = {"banded": cov.banded_plain, "tiled": cov.tiled_plain,
                        "grouped": cov.grouped_plain}[kind]
            want = plain_fn(es, table, height, width, 0)

            def run():
                return cov._launch_coverage(kind, es, table, height, width,
                                            0)

            row = {"planes": int(es.shape[0]), "edges": int(es.shape[-1]),
                   "ms": {n: [] for n in order}, "max_abs_vs_plain": {}}
            try:
                for names in (order, order[::-1]):
                    for name in names:
                        cuda_lib._libs["swfcoverage"] = libs[name][0]
                        row["ms"][name].append(time_ms(torch, run))
                for name in order:
                    cuda_lib._libs["swfcoverage"] = libs[name][0]
                    got = run()
                    row["max_abs_vs_plain"][name] = float(
                        (got - want).abs().max().item())
                    row.setdefault("equal_plain", {})[name] = bool(
                        torch.equal(got, want))
                    del got
                buf = (ctypes.c_ulonglong * 24)()
                if stamps.swf_cov_stamps(buf, 1) != 0:
                    raise SystemExit("stamp reset failed")
                cuda_lib._libs["swfcoverage"] = stamps
                run()
                torch.cuda.synchronize()
                if stamps.swf_cov_stamps(buf, 0) != 0:
                    raise SystemExit("stamp read failed")
            finally:
                if mine is None:
                    cuda_lib._libs.pop("swfcoverage", None)
                else:
                    cuda_lib._libs["swfcoverage"] = mine
            blocks = buf[base + 4]
            total = sum(buf[base:base + 4])
            row["blocks"] = blocks
            row["cycles"] = total
            row["cycles_a_block"] = total / max(blocks, 1)
            row["share"] = {ph: buf[base + i] / max(total, 1)
                            for i, ph in enumerate(PHASES)}
            row["ptxas"] = {n: ptxas_of(logs[n], f"{kind}_kernel")
                            for n in order}
            row["sass"] = {n: sass_counts(libs[n][1], f"{kind}_kernel")
                           for n in ("change", "parent") if n in libs}
            row["pairs"] = {"banded": banded_pairs, "tiled": tiled_pairs,
                            "grouped": grouped_pairs}[kind](
                torch, cov, es, table, height, width)
            print(json.dumps({f"{kind} {what}": row}), flush=True)
            del d, es, table, want
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(card_line())


if __name__ == "__main__":
    main()
