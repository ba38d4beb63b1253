"""Build and load the port's CUDA library (``csrc/*.cu`` -> ctypes).

The kernels have a plain C interface: ``nvcc`` compiles them for
``sm_90a`` into ``_build/libswfkernels.so`` at first use (seconds, since
no PyTorch header is included), and the wrappers in ``ops/flatblock.py``
pass device pointers and the current stream as integers.  Nothing here
runs at import time: the CPU tests import every module without ``nvcc``.
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
LIB_PATH = BUILD_DIR / "libswfkernels.so"
SOURCES = (CSRC_DIR / "flatblock.cu",)
HEADERS = (CSRC_DIR / "flatblock_device.cuh",)
# -fmad=false: no a*b+c contracts into an FMA the reference does not do;
# IEEE division and square root stay on (no --use_fast_math).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_lib = None
_lock = threading.Lock()
build_log = ""


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


def build(force: bool = False) -> pathlib.Path:
    """Compile the CUDA sources (idempotent, safe across processes)."""
    import fcntl

    global build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    newest = max(p.stat().st_mtime for p in SOURCES + HEADERS)
    with open(BUILD_DIR / "libswfkernels.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (not force and LIB_PATH.exists()
                and LIB_PATH.stat().st_mtime >= newest):
            return LIB_PATH
        tmp = BUILD_DIR / f"libswfkernels.{os.getpid()}.tmp.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(p) for p in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"CUDA build failed ({' '.join(cmd)}):\n{build_log}")
        os.replace(tmp, LIB_PATH)
    return LIB_PATH


def load():
    """The loaded library, built on first use; raises if the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.swf_fused_flatblock.restype = i
            lib.swf_fused_flatblock.argtypes = [i] + [p] * 16 + [i] * 8 + [p]
            lib.swf_strips_per_block.restype = i
            lib.swf_strips_per_block.argtypes = [i, i, i]
            _lib = lib
        return _lib
