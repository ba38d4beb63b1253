"""Where the plane resolves' time goes: the pipelined resolve (B16)
beside the grid one (B15).

    python3 -m swf_renderer_tpu_torch.tools.planes_phases [--csrc DIR]
        [--parent DIR] [--build NAME=DIR] [--variants [NAME,...]]
        [--n-buf N,...] [--rounds N]

Needs one NVIDIA card and ``nvcc``.  Builds ``planes.cu`` from ``DIR``
(default: this package's ``csrc``) as it is and a copy with ``clock64()``
stamps around the phases of ``resolve_dma_block`` (thread 0's cycles
summed over blocks into a device array: the copies' issue, the wait for
a stage, the carries, the resolve of a chunk row and the barrier or the
slot's release; the producer thread's wait for a free slot where the
form has one), and each block's SM and its first and last
``%globaltimer`` reading.  On planes of headline_planes' shape (60
frames x 4 layers x 137 strip planes of 128 x 128 f32, 15 chunks: 2.15
GB; random prefixed values, seed 5: neither resolve branches on them) it
prints for each ``n_buf``: ms of every build and of B15 on the same
planes (in the order parent, change, the rest, then back, ``--rounds``
times), each output
against ``resolve_u32_plain`` (equal words), cycles a stage and each
phase's share, the blocks' spread over the SMs (strips a block, blocks
an SM, each SM's busy span from its first block's start to its last
block's end), ptxas registers / stack / spills and the SASS census of
both kernels (bulk copies UBLKCP, ``cp.async`` LDGSTS, block barriers,
mbarrier operations).  ``--parent`` builds another checkout's ``csrc``
beside, ``--build NAME=DIR`` any other ``csrc`` directory,
``--variants`` the design elements of ``VARIANTS`` (edits of the
committed form; all, or the named ones).  One JSON object of the builds,
one an ``n_buf``, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import tempfile

from .coverage_phases import ptxas_of, sass_census, variant_sources
from .timing import card_line, time_ms

PLANES = (60, 4, 137, 15)   # frames, layers, strip planes, chunks
PHASES = ("issue", "wait", "carries", "resolve", "release", "slot_wait")
MAX_BLOCKS = 8192           # block records kept (SM, start, end)

_HELPER = """
__device__ unsigned long long swf_pl_stamp[8];
__device__ unsigned long long swf_pl_block[3 * 8192];
// Thread 0 of the block (or the producer) adds v at slot k.
__device__ __forceinline__ void swf_stamp(int k, long long v) {
  atomicAdd(&swf_pl_stamp[k], static_cast<unsigned long long>(v));
}
__device__ __forceinline__ unsigned long long swf_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// The block's SM, start and end (globaltimer ns), by thread 0.
__device__ __forceinline__ void swf_block_end(unsigned long long t0) {
  if (threadIdx.x != 0) return;
  unsigned sm;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  const unsigned b = blockIdx.y * gridDim.x + blockIdx.x;
  if (b < 8192) {
    swf_pl_block[3 * b] = sm;
    swf_pl_block[3 * b + 1] = t0;
    swf_pl_block[3 * b + 2] = swf_gtime();
  }
  atomicAdd(&swf_pl_stamp[7], 1ull);
}
"""

_READ = """
extern "C" int swf_pl_stamps(unsigned long long* host,
                             unsigned long long* blocks, int zero) {
  if (zero) {
    static unsigned long long z[3 * 8192] = {0};
    int err = (int)cudaMemcpyToSymbol(swf::swf_pl_stamp, z,
                                      8 * sizeof(unsigned long long));
    if (err) return err;
    return (int)cudaMemcpyToSymbol(swf::swf_pl_block, z, sizeof(z));
  }
  int err = (int)cudaMemcpyFromSymbol(host, swf::swf_pl_stamp,
                                      8 * sizeof(unsigned long long));
  if (err) return err;
  return (int)cudaMemcpyFromSymbol(blocks, swf::swf_pl_block,
                                   3 * 8192 * sizeof(unsigned long long));
}
"""

# (anchor, replacement) edits of planes_device.cuh that stamp the phases,
# per form of the source; the first form whose anchors all occur exactly
# once is used.  Slots: 0 issue, 1 wait, 2 carries, 3 resolve, 4 release
# (barrier), 5 the producer's wait for a free slot, 6 stages, 7 blocks.
FORMS = {
    "cp.async ring, block barriers": [
        ("__device__ void resolve_dma_block(const PlanesArgs& a, unsigned "
         "char* smem) {\n",
         "__device__ void resolve_dma_block(const PlanesArgs& a, unsigned "
         "char* smem) {\n  const unsigned long long gt0_ = swf_gtime();\n"),
        ("  if (s0 >= s1) return;                       // uniform across "
         "the block\n",
         "  if (s0 >= s1) { swf_block_end(gt0_); return; }\n"),
        ("  for (int t = 0; t < n_stages; ++t) {\n"
         "    if (t + depth - 1 < n_stages) fetch(t + depth - 1);\n"
         "    cp_async_commit();\n"
         "    cp_async_wait(depth - 1);                 // stage t has landed\n"
         "    __syncthreads();\n",
         "  for (int t = 0; t < n_stages; ++t) {\n"
         "    const long long c0_ = clock64();\n"
         "    if (t + depth - 1 < n_stages) fetch(t + depth - 1);\n"
         "    cp_async_commit();\n    const long long c1_ = clock64();\n"
         "    cp_async_wait(depth - 1);                 // stage t has landed\n"
         "    __syncthreads();\n    const long long c2_ = clock64();\n"
         "    if (tid == 0) { swf_stamp(0, c1_ - c0_); "
         "swf_stamp(1, c2_ - c1_); swf_stamp(6, 1); }\n"),
        ("    if (j == 0) strip_carries(a, f, s, y, carry);\n",
         "    if (j == 0) strip_carries(a, f, s, y, carry);\n"
         "    const long long c3_ = clock64();\n"
         "    if (tid == 0) swf_stamp(2, c3_ - c2_);\n"),
        ("        carry, j, col_s, rule_s, out_row + j * kLane);\n"
         "    __syncthreads();                          // slot t % depth is "
         "free\n  }\n}\n",
         "        carry, j, col_s, rule_s, out_row + j * kLane);\n"
         "    const long long c4_ = clock64();\n"
         "    __syncthreads();                          // slot t % depth is "
         "free\n    if (tid == 0) { swf_stamp(3, c4_ - c3_); "
         "swf_stamp(4, clock64() - c4_); }\n  }\n"
         "  swf_block_end(gt0_);\n}\n"),
    ],
}
FORMS["bulk copies, mbarrier ring"] = [
    ("__device__ void resolve_dma_block(const PlanesArgs& a, unsigned "
     "char* smem) {\n",
     "__device__ void resolve_dma_block(const PlanesArgs& a, unsigned "
     "char* smem) {\n  const unsigned long long gt0_ = swf_gtime();\n"),
    ("    // The producer: one thread issues every stage's copies.\n",
     "    // The producer: one thread issues every stage's copies.\n"
     "    long long pw_ = 0, pi_ = 0;\n"),
    ("      if (t >= depth) mbar_wait(empty + c.slot, c.phase ^ 1u);\n",
     "      const long long p0_ = clock64();\n"
     "      if (t >= depth) mbar_wait(empty + c.slot, c.phase ^ 1u);\n"
     "      const long long p1_ = clock64();\n      pw_ += p1_ - p0_;\n"),
    ("                    a.layers * 16, full + c.slot);\n    }\n",
     "                    a.layers * 16, full + c.slot);\n"
     "      pi_ += clock64() - p1_;\n    }\n"
     "    if (lane == 0) { swf_stamp(5, pw_); swf_stamp(0, pi_); }\n"),
    ("    const float* stage = ring + c.slot * stage_floats;\n"
     "    mbar_wait(full + c.slot, c.phase);\n",
     "    const long long c1_ = clock64();\n"
     "    const float* stage = ring + c.slot * stage_floats;\n"
     "    mbar_wait(full + c.slot, c.phase);\n"
     "    const long long c2_ = clock64();\n"
     "    if (tid == 0) { swf_stamp(1, c2_ - c1_); swf_stamp(6, 1); }\n"),
    ("    __syncwarp();   // every lane's carry is written\n",
     "    __syncwarp();   // every lane's carry is written\n"
     "    const long long c3_ = clock64();\n"
     "    if (tid == 0) swf_stamp(2, c3_ - c2_);\n"),
    ("        out_row + j * kLane);\n"
     "    mbar_arrive(empty + c.slot);\n    __syncwarp();\n  }\n}\n",
     "        out_row + j * kLane);\n    const long long c4_ = clock64();\n"
     "    mbar_arrive(empty + c.slot);\n    __syncwarp();\n"
     "    if (tid == 0) { swf_stamp(3, c4_ - c3_); "
     "swf_stamp(4, clock64() - c4_); }\n  }\n"
     "  swf_block_end(gt0_);\n}\n"),
]


# Design elements measured beside the committed form, as edits (file,
# anchor, replacement) of its sources.
_BOUND = "__launch_bounds__(kDmaThreads) resolve_dma_kernel("
# Stage t's place recomputed by division, as before the stage cursor.
_DIVIDE = ("    {\n      const long long item_ = i0 + t / nc;\n"
           "      c.f = static_cast<int>(item_ / ns);\n"
           "      c.s = static_cast<int>(item_ % ns);\n"
           "      c.j = t % nc;\n      c.slot = t % depth;\n"
           "      c.phase = (t / depth) & 1;\n    }\n")
VARIANTS = {
    "5 blocks an SM by a register bound": [
        ("planes.cu", _BOUND,
         "__launch_bounds__(kDmaThreads, 5) resolve_dma_kernel(")],
    "6 blocks an SM by a register bound": [
        ("planes.cu", _BOUND,
         "__launch_bounds__(kDmaThreads, 6) resolve_dma_kernel(")],
    "per-stage divisions (no stage cursor)": [
        ("planes_device.cuh",
         "      if (t >= depth) mbar_wait(empty + c.slot, c.phase ^ 1u);\n",
         _DIVIDE.replace("    ", "      ", 1).replace("\n    ", "\n      ")
         + "      if (t >= depth) mbar_wait(empty + c.slot, c.phase ^ 1u);\n"),
        ("planes_device.cuh", "    const int j = c.j;\n",
         _DIVIDE + "    const int j = c.j;\n")],
}


def stamped_source(text: str):
    """planes_device.cuh with the phase stamps: (form name, text)."""
    for name, edits in FORMS.items():
        if all(text.count(old) == 1 for old, _ in edits):
            for old, new in edits:
                text = text.replace(old, new)
            head = "namespace swf {\n"
            return name, text.replace(head, head + _HELPER, 1)
    bad = {name: [old[:60] for old, _ in edits if text.count(old) != 1]
           for name, edits in FORMS.items()}
    raise SystemExit(f"planes_device.cuh matches no stamped form: {bad}")


def census(lib: pathlib.Path):
    """{kernel: sass_census + bulk copies, cp.async, block barriers and
    mbarrier operations} of the resolve kernels of ``lib``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    heads = list(re.finditer(r"Function : (\S+)", text))
    out = {}
    for i, m in enumerate(heads):
        if "resolve" not in m.group(1):
            continue
        body = text[m.end():heads[i + 1].start() if i + 1 < len(heads)
                    else len(text)]
        v = sass_census(body)
        v.pop("loops")
        for key, pattern in (("ublkcp", r"\bUBLKCP\b"),
                             ("ldgsts", r"\bLDGSTS\b"),
                             ("bar_sync", r"\bBAR\.SYNC"),
                             ("syncs", r"\bSYNCS\b")):
            v[key] = len(re.findall(pattern, body))
        out[m.group(1)] = v
    return out


def build_all(cuda_lib, tmp, sources):
    """{name: csrc dir} -> {name: (bound swfplanes library, path)}, ptxas
    logs, errors; one nvcc a build, all started together."""
    import threading

    libs, logs, errors = {}, {}, {}

    def one(i, name, d):
        path = tmp / f"libplanes_{i}.so"
        try:
            logs[name] = cuda_lib._nvcc_all(d, {"swfplanes": path})
            libs[name] = (cuda_lib.bind("swfplanes",
                                        ctypes.CDLL(str(path))), path)
        except Exception as exc:  # reported below
            errors[name] = str(exc)[-2000:]

    threads = [threading.Thread(target=one, args=(i, *item))
               for i, item in enumerate(sources.items())]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return libs, logs, errors


def sm_spread(blocks, n_blocks):
    """Block records (SM, start, end) -> blocks an SM and each SM's busy
    span (ms from the kernel's first start to the SM's last end)."""
    recs = [(int(blocks[3 * b]), blocks[3 * b + 1], blocks[3 * b + 2])
            for b in range(min(n_blocks, MAX_BLOCKS)) if blocks[3 * b + 2]]
    if not recs:
        return {}
    t0 = min(r[1] for r in recs)
    per_sm = {}
    for sm, _, end in recs:
        n, last = per_sm.get(sm, (0, 0))
        per_sm[sm] = (n + 1, max(last, end))
    ends = sorted((last - t0) / 1e6 for _, last in per_sm.values())
    counts = sorted(n for n, _ in per_sm.values())
    return {"sms": len(per_sm), "blocks_an_sm_min": counts[0],
            "blocks_an_sm_max": counts[-1],
            "sm_end_ms_min": ends[0], "sm_end_ms_median":
                statistics.median(ends), "sm_end_ms_max": ends[-1]}


def main() -> None:
    import sys

    import torch

    from ..ops import cuda_lib, flatblock as fb

    parser = argparse.ArgumentParser()
    parser.add_argument("--csrc", type=pathlib.Path,
                        default=cuda_lib.CSRC_DIR)
    parser.add_argument("--parent", type=pathlib.Path, default=None,
                        help="another checkout's csrc, timed beside")
    parser.add_argument("--build", action="append", default=[],
                        metavar="NAME=DIR",
                        help="another csrc directory, timed beside")
    parser.add_argument("--variants", nargs="?", const="", default=None,
                        metavar="NAME,...",
                        help="also build and time VARIANTS (all, or these)")
    parser.add_argument("--n-buf", default="3", metavar="N,...",
                        help="ring depths asked for (default 3)")
    parser.add_argument("--rounds", type=int, default=1,
                        help="passes there and back over the builds")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("planes_phases needs a CUDA card")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="planes_phases_"))
    try:
        sources = {"change": tmp / "change", "stamped": tmp / "stamped"}
        shutil.copytree(args.csrc, sources["change"])
        shutil.copytree(args.csrc, sources["stamped"])
        form, text = stamped_source(
            (sources["stamped"] / "planes_device.cuh").read_text())
        (sources["stamped"] / "planes_device.cuh").write_text(text)
        (sources["stamped"] / "planes.cu").write_text(
            (sources["stamped"] / "planes.cu").read_text() + _READ)
        if args.parent is not None:
            sources["parent"] = tmp / "parent"
            shutil.copytree(args.parent, sources["parent"])
        for i, spec in enumerate(args.build):
            name, _, d = spec.partition("=")
            sources[name] = tmp / f"build{i}"
            shutil.copytree(d, sources[name])
        skipped = []
        if args.variants is not None:
            wanted = set(args.variants.split(",")) if args.variants else \
                set(VARIANTS)
            unknown = sorted(wanted - set(VARIANTS))
            if unknown:
                raise SystemExit(f"unknown variants {unknown}")
            for i, (name, edits) in enumerate(VARIANTS.items()):
                if name not in wanted:
                    continue
                d = tmp / f"variant{i}"
                if variant_sources(args.csrc, d, edits):
                    sources[name] = d
                else:
                    skipped.append(name)
        libs, logs, errors = build_all(cuda_lib, tmp, sources)
        if "change" not in libs or "stamped" not in libs:
            raise SystemExit(f"build failed: {errors}")
        stamps = libs["stamped"][0]
        stamps.swf_pl_stamps.restype = ctypes.c_int
        stamps.swf_pl_stamps.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int]
        ptx = {n: {k: ptxas_of(logs[n], k) for k in
                   ("resolve_dma_kernel", "resolve_u32_kernel")}
               for n in logs}
        sass = {n: census(libs[n][1]) for n in libs if n != "stamped"}
        print(json.dumps({"csrc": str(args.csrc), "form": form,
                          "build_errors": errors,
                          "variants_not_applied": skipped, "ptxas": ptx,
                          "sass": sass}), flush=True)

        frames, layers, ns1, nc = PLANES
        gen = torch.Generator(device="cuda").manual_seed(5)
        planes = torch.randn((frames, layers, ns1, 128, 128),
                             generator=gen, device="cuda")
        planes = torch.cumsum(planes, -1, out=planes)
        cols = torch.rand((frames, layers, 4), generator=gen,
                          device="cuda")
        want = fb.resolve_u32_plain(planes, cols, nc)
        order = ["parent"] * ("parent" in libs) + ["change"] + [
            n for n in libs if n not in ("parent", "change", "stamped")]
        mine = cuda_lib._libs.get("swfplanes")
        try:
            for n_buf in (int(x) for x in args.n_buf.split(",")):
                row = {"n_buf": n_buf, "ms": {n: [] for n in order},
                       "b15_ms": {n: [] for n in order}, "equal_plain": {}}

                def dma():
                    return fb.resolve_planes_u32_dma(planes, cols, nc,
                                                     n_buf=n_buf)

                def grid():
                    return fb.resolve_planes_u32(planes, cols, nc)

                for n in order:
                    print(f"planes_phases: n_buf {n_buf}: {n}",
                          file=sys.stderr, flush=True)
                    cuda_lib._libs["swfplanes"] = libs[n][0]
                    row["equal_plain"][n] = bool(torch.equal(dma(), want))
                for names in (order, order[::-1]) * args.rounds:
                    for n in names:
                        cuda_lib._libs["swfplanes"] = libs[n][0]
                        row["ms"][n].append(time_ms(torch, dma))
                        row["b15_ms"][n].append(time_ms(torch, grid))
                buf = (ctypes.c_ulonglong * 8)()
                blocks = (ctypes.c_ulonglong * (3 * MAX_BLOCKS))()
                cuda_lib._libs["swfplanes"] = stamps
                dma()   # warm
                torch.cuda.synchronize()
                if stamps.swf_pl_stamps(buf, blocks, 1) != 0:
                    raise SystemExit("stamp reset failed")
                row["equal_plain"]["stamped"] = bool(torch.equal(dma(),
                                                                 want))
                torch.cuda.synchronize()
                if stamps.swf_pl_stamps(buf, blocks, 0) != 0:
                    raise SystemExit("stamp read failed")
                total = sum(buf[:6])
                row["stages"] = buf[6]
                row["blocks"] = buf[7]
                row["strips_a_block"] = frames * (ns1 - 1) / max(buf[7], 1)
                row["cycles_a_stage"] = (buf[1] + buf[2] + buf[3] + buf[4]
                                         ) / max(buf[6], 1)
                row["share"] = {ph: buf[i] / max(total, 1)
                                for i, ph in enumerate(PHASES)}
                row["sm_spread"] = sm_spread(blocks, buf[7])
                print(json.dumps(row), flush=True)
        finally:
            if mine is None:
                cuda_lib._libs.pop("swfplanes", None)
            else:
                cuda_lib._libs["swfplanes"] = mine
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(card_line())


if __name__ == "__main__":
    main()
