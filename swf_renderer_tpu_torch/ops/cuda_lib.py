"""Build and load the port's CUDA libraries (``csrc/*.cu`` -> ctypes).

The kernels have a plain C interface: ``nvcc`` compiles each source for
``sm_90a`` into its own ``_build/lib<name>.so`` at first use (seconds,
since no PyTorch header is included; all sources compile at the same
time), and the wrappers in ``ops/`` pass device pointers and the current
stream as integers.  Nothing here runs at import time: the CPU tests
import every module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
# Library name -> (source, headers it includes).
LIBRARIES = {
    "swfkernels": ("flatblock.cu", ("flatblock_device.cuh",
                                    "place_mma_device.cuh",
                                    "coarse_device.cuh")),
    "swfsweep": ("sweep.cu", ("sweep_device.cuh", "flatblock_device.cuh")),
    "swftexfield": ("texfield.cu", ("texfield_device.cuh",
                                    "flatblock_device.cuh")),
    "swfcoverage": ("coverage.cu", ("coverage_device.cuh",
                                    "flatblock_device.cuh")),
    "swfresolve": ("resolve.cu", ("resolve_device.cuh",
                                  "flatblock_device.cuh")),
    "swfplanes": ("planes.cu", ("planes_device.cuh", "resolve_device.cuh",
                                "flatblock_device.cuh")),
    "swfprobes": ("probes.cu", ("probes_device.cuh",)),
}
# -fmad=false: no a*b+c contracts into an FMA the reference does not do;
# IEEE division and square root stay on (no --use_fast_math).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_libs = {}
_lock = threading.Lock()
build_log = ""


def lib_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}.so"


def nvcc_path() -> str:
    env = os.environ.get("NVCC")
    if env:
        return env
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _stale(name: str) -> bool:
    source, headers = LIBRARIES[name]
    newest = max((CSRC_DIR / p).stat().st_mtime for p in (source,) + headers)
    path = lib_path(name)
    return not path.exists() or path.stat().st_mtime < newest


def build(force: bool = False) -> None:
    """Compile every stale CUDA library, one ``nvcc`` per source, all
    started together (idempotent, safe across processes)."""
    import fcntl

    global build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libswfkernels.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        names = [n for n in LIBRARIES if force or _stale(n)]
        if not names:
            return
        tmps = {n: BUILD_DIR / f"lib{n}.{os.getpid()}.tmp.so" for n in names}
        build_log = _nvcc_all(CSRC_DIR, tmps)
        for name, tmp in tmps.items():
            os.replace(tmp, lib_path(name))


def _nvcc_all(csrc_dir, outputs: dict):
    """Compile LIBRARIES[name]'s source from ``csrc_dir`` into
    outputs[name] for every name, one ``nvcc`` each, all started
    together.  Returns the compilers' output; raises RuntimeError naming
    every build that failed."""
    nvcc = nvcc_path()
    procs = []
    for name, out_path in outputs.items():
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(out_path),
               str(pathlib.Path(csrc_dir) / LIBRARIES[name][0])]
        procs.append((name, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for name, cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"CUDA build failed ({' '.join(cmd)}):\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def load(name: str = "swfkernels"):
    """The loaded library ``name``, built on first use; raises if the
    build fails or the name is not one of LIBRARIES."""
    if name not in LIBRARIES:
        raise ValueError(f"unknown CUDA library {name!r}: one of "
                         f"{sorted(LIBRARIES)}")
    with _lock:
        if name not in _libs:
            if _stale(name):
                build()
            _libs[name] = bind(name, ctypes.CDLL(str(lib_path(name))))
        return _libs[name]


def bind(name: str, lib):
    """Set the ctypes signatures of library ``name``'s entry points on
    ``lib`` (a CDLL of that library, from any build) and return it."""
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "swfkernels":
        lib.swf_fused_flatblock.restype = i
        lib.swf_fused_flatblock.argtypes = ([i] * 2 + [p] * 17 + [i] * 9
                                            + [p])
        lib.swf_strips_per_block.restype = i
        lib.swf_strips_per_block.argtypes = [i, i, i]
        lib.swf_fused_blocks1.restype = i
        lib.swf_fused_blocks1.argtypes = [p] * 10 + [i] * 6 + [p]
        lib.swf_fused_variant.restype = i
        lib.swf_fused_variant.argtypes = [i] * 3 + [p] * 10 + [i] * 8 \
            + [p]
        lib.swf_fused_int8.restype = i
        lib.swf_fused_int8.argtypes = [p] * 12 + [i] * 6 + [p]
        lib.swf_fused_win.restype = i
        lib.swf_fused_win.argtypes = [p] * 11 + [i] * 8 + [p]
        lib.swf_fused_coarse.restype = i
        lib.swf_fused_coarse.argtypes = [i] + [p] * 10 + [i] * 6 \
            + [p]
    elif name == "swfsweep":
        lib.swf_sweep.restype = i
        lib.swf_sweep.argtypes = [i] + [p] * 15 + [i] * 8 + [p]
        lib.swf_sweep_shift.restype = i
        lib.swf_sweep_shift.argtypes = [i] + [p] * 15 + [i] * 9 + [p]
        lib.swf_sweep_rows.restype = i
        lib.swf_sweep_rows.argtypes = [i] + [p] * 15 + [i] * 8 + [p]
        lib.swf_sweep_compact.restype = i
        lib.swf_sweep_compact.argtypes = [p] * 12 + [i] * 10 + [p]
    elif name == "swftexfield":
        lib.swf_texfield.restype = i
        lib.swf_texfield.argtypes = [p] * 4 + [i] * 9 + [p]
    elif name == "swfcoverage":
        for fn in (lib.swf_coverage_banded, lib.swf_coverage_tiled,
                   lib.swf_coverage_grouped):
            fn.restype = i
            fn.argtypes = [p] * 3 + [i] * 5 + [p]
    elif name == "swfresolve":
        lib.swf_resolve.restype = i
        lib.swf_resolve.argtypes = [p] * 4 + [i] * 4 + [p]
    elif name == "swfplanes":
        lib.swf_place.restype = i
        lib.swf_place.argtypes = [p] * 7 + [i] * 4 + [p]
        lib.swf_resolve_u32.restype = i
        lib.swf_resolve_u32.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.swf_resolve_u32_dma.restype = i
        lib.swf_resolve_u32_dma.argtypes = [p] * 4 + [i] * 5 + [p]
    elif name == "swfprobes":
        q = ctypes.c_longlong
        lib.swf_passthrough.restype = i
        lib.swf_passthrough.argtypes = [p] * 2 + [i] * 4 + [q] * 3 \
            + [p]
        lib.swf_read_sum.restype = i
        lib.swf_read_sum.argtypes = [p] * 2 + [i] * 4 + [q] * 5 + [p]
    else:
        raise RuntimeError(f"no ctypes signatures for {name!r}")
    return lib


def build_other(csrc_dir, build_dir):
    """Compile every library from another checkout's ``csrc_dir`` into
    ``build_dir`` (one ``nvcc`` per source, all started together, this
    module's flags) and return ({name: CDLL bound by that checkout's own
    ``bind``, so each build takes its own entry points}, the compilers'
    output); raises on a failed build.  The A/B timings of
    ``chip_smoke.py --parent`` load the parent commit's kernels this
    way."""
    import importlib.util

    build_dir = pathlib.Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    outputs = {name: build_dir / f"lib{name}.so" for name in LIBRARIES}
    log = _nvcc_all(csrc_dir, outputs)
    own = pathlib.Path(csrc_dir).parent / "ops" / "cuda_lib.py"
    spec = importlib.util.spec_from_file_location("_other_cuda_lib", own)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    return ({name: other.bind(name, ctypes.CDLL(str(path)))
             for name, path in outputs.items()}, log)
