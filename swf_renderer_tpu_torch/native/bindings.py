"""ctypes bindings of the native geometry library: the cell splitter and
the flat-block packers that feed the fused kernels.

The library also holds the C++ shape decoder (src/shape_decoder.cc, the
reference Rust decoder's counterpart); its Python surface (record
encoding, rs-log goldens) belongs to the decoder-golden slice and is not
bound here yet.

The port REQUIRES the library: it is built from ``src/`` with ``g++`` at
first use into the package's ``_build/`` directory, and a failed build
raises (there is no numpy splitter or Python packer fallback).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent
_SOURCES = tuple(_NATIVE_DIR / "src" / name for name in (
    "shape_decoder.cc", "cell_split.cc", "pack_blocks.cc",
    "pack_grouped.cc"))
BUILD_DIR = _NATIVE_DIR.parent / "_build"
_LIB_PATH = BUILD_DIR / "libswfnative.so"
_CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

_lib = None
_lib_lock = threading.Lock()


def build_library(force: bool = False) -> pathlib.Path:
    """Compile ``src/*.cc`` into ``_build/libswfnative.so`` (idempotent).

    Concurrent processes serialize on a lock file, and the library is
    written under a temporary name and renamed into place, so a reader
    never loads a half-written file."""
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    newest_src = max(p.stat().st_mtime for p in _SOURCES)
    with open(BUILD_DIR / "libswfnative.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (not force and _LIB_PATH.exists()
                and _LIB_PATH.stat().st_mtime >= newest_src):
            return _LIB_PATH
        tmp = BUILD_DIR / f"libswfnative.{os.getpid()}.tmp.so"
        cmd = [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", str(tmp),
               *(str(p) for p in _SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native library build failed ({' '.join(cmd)}):\n"
                f"{proc.stderr}")
        os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def load_library():
    """Load (building on first use) the native shared library; raises
    when the build fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        return _load_locked()


def _load_locked():
    global _lib
    lib = ctypes.CDLL(str(build_library()))
    lib.swf_cells_split.restype = ctypes.c_int64
    lib.swf_cells_split.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.swf_cells_split_delta.restype = ctypes.c_int64
    lib.swf_cells_split_delta.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.swf_pack_blocks_capacity.restype = ctypes.c_int64
    lib.swf_pack_blocks_capacity.argtypes = [ctypes.c_int64, ctypes.c_int32]
    lib.swf_pack_grouped_capacity.restype = ctypes.c_int64
    lib.swf_pack_grouped_capacity.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.swf_pack_grouped_count.restype = ctypes.c_int64
    lib.swf_pack_grouped_count.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.swf_pack_grouped.restype = ctypes.c_int64
    lib.swf_pack_grouped.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.swf_pack_blocks.restype = ctypes.c_int64
    lib.swf_pack_blocks.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    _lib = lib
    return lib


def pack_blocks_native(update_lists, height: int, width: int,
                       block_pad_multiple: int = 1024):
    """Native flat-block packer: same contract and arrays as
    ops.flatblock.pack_flat_blocks (the tested oracle,
    tests/test_torch_flat_blocks.py)."""
    import numpy as np

    from ..ops.flatblock import BLK, plane_geometry, MAX_CHUNKS, LANE

    lib = load_library()
    f = len(update_lists)
    l = len(update_lists[0])
    stride, n_chunks, n_strips = plane_geometry(height, width)
    if n_chunks > MAX_CHUNKS:
        raise ValueError(
            f"flat-block pipeline supports width < {MAX_CHUNKS * LANE}"
            f" (got padded stride {stride})")

    from ..ops.flatblock import _drop_overflow_cols

    parts = []
    for i in range(f):
        for j in range(l):
            rows, cols, vals = update_lists[i][j]
            if stride <= width:
                rows, cols, vals = _drop_overflow_cols(
                    np.asarray(rows), np.asarray(cols), np.asarray(vals),
                    stride)
            rows = np.ascontiguousarray(rows, np.int32)
            cols = np.ascontiguousarray(cols, np.int32)
            vals = np.ascontiguousarray(vals, np.float32)
            n = len(rows)
            cap = lib.swf_pack_blocks_capacity(n, n_strips)
            sidx = np.empty(cap, np.int32)
            keep = np.empty(cap, np.int32)
            urc = np.empty(cap * BLK, np.float32)
            ucm = np.empty(cap * BLK, np.float32)
            uval = np.empty(cap * BLK, np.float32)
            nb = lib.swf_pack_blocks(
                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                n, n_strips, (i * l + j) * (n_strips + 1), cap,
                sidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                urc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ucm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                uval.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            if nb < 0:
                raise RuntimeError("pack_blocks capacity underestimated")
            parts.append((sidx[:nb], keep[:nb], urc[: nb * BLK],
                          ucm[: nb * BLK], uval[: nb * BLK]))

    nb = sum(len(p[0]) for p in parts)
    nb_pad = ((nb + block_pad_multiple - 1)
              // block_pad_multiple) * block_pad_multiple
    sidx = np.full(nb_pad, n_strips, np.int32)  # sentinel default
    keep = np.zeros(nb_pad, np.int32)
    urc = np.zeros((nb_pad, 1, BLK), np.float32)
    ucm = np.zeros((nb_pad, BLK, 1), np.float32)
    uval = np.zeros((nb_pad, 1, BLK), np.float32)
    off = 0
    for psi, pke, prc, pcm, pvv in parts:
        k = len(psi)
        sidx[off:off + k] = psi
        keep[off:off + k] = pke
        urc[off:off + k, 0, :] = prc.reshape(k, BLK)
        ucm[off:off + k, :, 0] = pcm.reshape(k, BLK)
        uval[off:off + k, 0, :] = pvv.reshape(k, BLK)
        off += k
    return sidx, keep, urc, ucm, uval, n_strips, n_chunks


def _pool_workers() -> int:
    """Thread-pool width for host lowering: the native C ABI drops the GIL
    for its whole run, so frames/layers scale across cores."""
    import os

    return max(1, min(32, os.cpu_count() or 1))


def pack_grouped_native(update_lists, height: int, width: int,
                        group: int = 6, group_pad_multiple: int = 256,
                        blk: int = None, spp: int = 1,
                        max_workers: int = None):
    """One-pass native packer: per-draw sorted delta updates -> the fused
    kernel's GROUPED block arrays (render_fused_blocksn inputs), replacing
    pack_flat_blocks + sort_blocks_fused + group_blocks_fused.

    Frames pack in PARALLEL: a cheap exact-count pass
    (swf_pack_grouped_count) fixes every frame's write offset, then the
    packs run concurrently on a thread pool straight into the final arrays
    (ctypes releases the GIL; no staging copies, no compaction).

    Returns (gsi, gfl, glay(group, NG), grc, gcm, gvv, n_strips, n_chunks).
    """
    import numpy as np

    from ..ops.flatblock import BLK, LANE, MAX_CHUNKS, plane_geometry

    lib = load_library()
    if blk is None:
        blk = BLK
    frames = len(update_lists)
    layers = len(update_lists[0])
    stride, n_chunks, n_strips = plane_geometry(height, width)
    if spp > 1:
        # n_strips becomes the STRIP-BLOCK count (spp strips per plane).
        n_strips = -(-n_strips // spp)
    if n_chunks > MAX_CHUNKS:
        raise ValueError(
            f"flat-block pipeline supports width < {MAX_CHUNKS * LANE}"
            f" (got padded stride {stride})")

    gb = group * blk
    counts = np.array([[len(p[0]) for p in per] for per in update_lists],
                      np.int64)

    def frame_inputs(f):
        per = update_lists[f]
        if stride <= width:
            from ..ops.flatblock import _drop_overflow_cols

            per = [_drop_overflow_cols(np.asarray(p[0]), np.asarray(p[1]),
                                       np.asarray(p[2]), stride)
                   for p in per]
            counts[f] = [len(p[0]) for p in per]
        rows = np.ascontiguousarray(
            np.concatenate([np.asarray(p[0], np.int32) for p in per]))
        cols = np.ascontiguousarray(
            np.concatenate([np.asarray(p[1], np.int32) for p in per]))
        vals = np.ascontiguousarray(
            np.concatenate([np.asarray(p[2], np.float32) for p in per]))
        offsets = np.zeros(layers + 1, np.int64)
        np.cumsum(counts[f], out=offsets[1:])
        return rows, cols, vals, offsets

    inputs = [frame_inputs(f) for f in range(frames)]
    per_frame_ng = [
        lib.swf_pack_grouped_count(
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            layers, n_strips, group, blk, spp)
        for rows, _, _, offsets in inputs
    ]
    frame_off = np.zeros(frames + 1, np.int64)
    np.cumsum(per_frame_ng, out=frame_off[1:])
    ng = int(frame_off[-1])
    ng_pad = ((ng + group_pad_multiple - 1)
              // group_pad_multiple) * group_pad_multiple
    gsi = np.empty(ng_pad, np.int32)
    gfl = np.empty(ng_pad, np.int32)
    gla = np.empty((ng_pad, group), np.int32)
    grc = np.empty((ng_pad, 1, gb), np.float32)
    gcm = np.empty((ng_pad, gb, 1), np.float32)
    gvv = np.empty((ng_pad, 1, gb), np.float32)

    def ptr(arr, off, ctype, scale):
        return ctypes.cast(
            arr.ctypes.data + off * scale * ctypes.sizeof(ctype),
            ctypes.POINTER(ctype))

    def pack_frame(f):
        rows, cols, vals, offsets = inputs[f]
        off = int(frame_off[f])
        k = lib.swf_pack_grouped(
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            layers, n_strips, f * layers, group, blk, spp, n_chunks,
            int(per_frame_ng[f]),
            ptr(gsi, off, ctypes.c_int32, 1),
            ptr(gfl, off, ctypes.c_int32, 1),
            ptr(gla, off, ctypes.c_int32, group),
            ptr(grc, off, ctypes.c_float, gb),
            ptr(gcm, off, ctypes.c_float, gb),
            ptr(gvv, off, ctypes.c_float, gb),
        )
        if k != per_frame_ng[f]:
            raise RuntimeError(
                f"pack_grouped count mismatch: {k} vs {per_frame_ng[f]}")

    workers = max_workers if max_workers is not None else _pool_workers()
    if workers > 1 and frames > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(pack_frame, range(frames)))
    else:
        for f in range(frames):
            pack_frame(f)

    gsi[ng:ng_pad] = n_strips  # sentinel garbage strip
    gfl[ng:ng_pad] = 0
    gla[ng:ng_pad] = 0
    grc[ng:ng_pad] = 0.0
    gcm[ng:ng_pad] = 0.0
    gvv[ng:ng_pad] = 0.0
    return (gsi, gfl, gla.T.copy(),
            grc, gcm, gvv, n_strips, n_chunks)


def cells_split_delta_native(edges, height: int, width: int):
    """Native edge -> sorted, coalesced delta updates (row, col, value)
    for the scanline winding plane (see cell_split.cc)."""
    import numpy as np

    lib = load_library()
    edges = np.ascontiguousarray(edges, dtype=np.float32)
    if edges.size and not np.isfinite(edges).all():
        raise ValueError("non-finite edge coordinates")
    n = edges.shape[0]
    if n:
        spans = (
            np.abs(edges[:, 2] - edges[:, 0])
            + np.abs(edges[:, 3] - edges[:, 1])
        )
        capacity = int(
            2 * (np.sum(np.minimum(spans, height + width)) + 3 * n) + 16
        )
    else:
        capacity = 16
    rows = np.empty(capacity, np.int32)
    cols = np.empty(capacity, np.int32)
    vals = np.empty(capacity, np.float32)
    count = lib.swf_cells_split_delta(
        edges.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, height, width,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        capacity,
    )
    if count < 0:
        raise RuntimeError("delta update capacity estimate too small")
    return rows[:count], cols[:count], vals[:count]


def cells_split_native(edges, height: int, width: int):
    """Native edge->cell splitting (same contract as
    ops.scanline.edges_to_cells, ~100x faster than the Python loop)."""
    import numpy as np

    lib = load_library()
    edges = np.ascontiguousarray(edges, dtype=np.float32)
    if edges.size and not np.isfinite(edges).all():
        raise ValueError("non-finite edge coordinates")
    n = edges.shape[0]
    # Capacity bound: every edge emits at most y-crossings + x-crossings
    # + 1 <= |dx| + |dy| + 3 records.
    if n:
        spans = (
            np.abs(edges[:, 2] - edges[:, 0])
            + np.abs(edges[:, 3] - edges[:, 1])
        )
        capacity = int(np.sum(np.minimum(spans, height + width)) + 3 * n + 16)
    else:
        capacity = 16
    rows = np.empty(capacity, np.int32)
    cols = np.empty(capacity, np.int32)
    area = np.empty(capacity, np.float32)
    cover = np.empty(capacity, np.float32)
    count = lib.swf_cells_split(
        edges.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, height, width,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        area.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cover.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        capacity,
    )
    if count < 0:
        raise RuntimeError("cell capacity estimate too small")
    return rows[:count], cols[:count], area[:count], cover[:count]
