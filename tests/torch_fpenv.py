"""The calling thread's floating-point environment, read and set through
a few lines of x86-64 inline assembly (built with g++ into a temporary
directory on first use): MXCSR (SSE rounding, flush-to-zero,
denormals-are-zero, exception masks) and the x87 control word.

``default_env_error()`` names what differs from the environment a
process starts with (MXCSR 0x1F80 without its sticky exception flags,
x87 control word 0x037F), or returns None; ``set_mxcsr`` exists for the
tests that check this guard.  Not collected (no ``test_`` prefix).
"""

import atexit
import ctypes
import functools
import pathlib
import platform
import shutil
import subprocess
import tempfile

DEFAULT_MXCSR = 0x1F80      # all exceptions masked, round to nearest
DEFAULT_X87_CW = 0x037F     # extended precision, round to nearest
MXCSR_FLAGS = 0x3F          # sticky exception flags, set by any arithmetic

SOURCE = r"""
extern "C" unsigned get_mxcsr() {
  unsigned v;
  asm volatile("stmxcsr %0" : "=m"(v));
  return v;
}
extern "C" void set_mxcsr(unsigned v) { asm volatile("ldmxcsr %0" : : "m"(v)); }
extern "C" unsigned get_x87_cw() {
  unsigned short v;
  asm volatile("fnstcw %0" : "=m"(v));
  return v;
}
"""


@functools.lru_cache(maxsize=None)
def _lib():
    if platform.machine() not in ("x86_64", "AMD64"):
        return None
    if shutil.which("g++") is None:
        return None
    d = pathlib.Path(tempfile.mkdtemp(prefix="fpenv"))
    atexit.register(shutil.rmtree, d, ignore_errors=True)
    (d / "fpenv.cc").write_text(SOURCE)
    subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-o",
                    str(d / "libfpenv.so"), str(d / "fpenv.cc")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "libfpenv.so"))
    lib.get_mxcsr.restype = ctypes.c_uint
    lib.get_mxcsr.argtypes = []
    lib.set_mxcsr.restype = None
    lib.set_mxcsr.argtypes = [ctypes.c_uint]
    lib.get_x87_cw.restype = ctypes.c_uint
    lib.get_x87_cw.argtypes = []
    return lib


def available() -> bool:
    return _lib() is not None


def mxcsr() -> int:
    return _lib().get_mxcsr()


def x87_cw() -> int:
    return _lib().get_x87_cw()


def set_mxcsr(value: int) -> None:
    _lib().set_mxcsr(value)


def describe() -> str:
    if not available():
        return "MXCSR unreadable here"
    return f"MXCSR {mxcsr():#06x}, x87 control word {x87_cw():#06x}"


def default_env_error():
    """None when this thread's MXCSR (flags aside) and x87 control word
    are the defaults, else what differs."""
    if not available():
        return None
    m, cw = mxcsr(), x87_cw()
    if (m & ~MXCSR_FLAGS) == DEFAULT_MXCSR and cw == DEFAULT_X87_CW:
        return None
    return (f"the thread's floating-point environment is not the default: "
            f"{describe()} (default MXCSR {DEFAULT_MXCSR:#06x} without "
            f"flags, x87 {DEFAULT_X87_CW:#06x})")
