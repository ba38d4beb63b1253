"""The streaming probes' designs side by side: the passthrough (18a, 19a)
and the read+sum (18b) of ``csrc/probes.cu``.

    python3 -m swf_renderer_tpu_torch.tools.probe_phases [--csrc DIR]
        [--parent DIR] [--build NAME=DIR] [--variants [NAME,...]]
        [--rounds N]

Needs one NVIDIA card and ``nvcc``.  Builds ``probes.cu`` from ``DIR``
(default: this package's ``csrc``) as it is, ``--parent`` another
checkout's ``csrc`` beside, ``--build NAME=DIR`` any other ``csrc``
directory and ``--variants`` the design elements of ``VARIANTS`` (edits
of the committed form: all, or the named ones; one nvcc a build, all
started together).  On ``chip_smoke.py``'s inputs (exp_bw's 60 x 4 x 137
planes of 128 x 128 f32 in both layouts, 2.15 GB, and exp_scatter D's
16384 and 131072 tiles of 8 x 128) it prints for each row: ms a call of
every build's bare launches into one buffer, issued back to back
between one pair of CUDA events (``tools/timing.py`` ``time_run_ms``; in
the order parent, change, the rest, then back, ``--rounds`` times),
beside the library call that computes the same (``torch.add``,
``torch.sum(dim=2)``) timed the same way in each turn; the share of
3.35 TB/s; every build's output against the plain version (equal).
Per build: ptxas registers / stack / spills and the SASS opcodes of
global, shared and bulk memory of both kernels.  One JSON object of the
builds, one a row, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import tempfile
import threading

from .coverage_phases import ptxas_of, variant_sources
from .timing import card_line, time_run_ms

PEAK_BYTES_PER_S = 3.35e12
KERNELS = ("passthrough_kernel", "read_sum_kernel")
MEMORY_OPS = r"^(LDG|STG|LDS|STS|UBLKCP|SYNCS|LD|ST)\b"

# The TMA ring, the alternative to the streaming loads for the
# passthrough: a producer warp copies each chunk of the grid's walk into
# a ring of kRingStages shared slots (cp.async.bulk onto the slot's full
# mbarrier); eight consumer warps add 1 in shared memory; the first
# consumer thread copies the slot back (cp.async.bulk shared -> global,
# a bulk group a chunk) and releases the slot before on its empty
# mbarrier once that copy has read it.
_RING = r"""
constexpr int kRingStages = 3;
constexpr int kRingVec = kProbeThreads * kPassUnroll;   // a chunk
constexpr int kRingThreads = kProbeThreads + 32;
constexpr int kRingSmem = kRingStages * kRingVec * 16 + 2 * kRingStages * 8;

__device__ __forceinline__ unsigned ring_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ring_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "RING_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra RING_WAIT;\n"
      "}\n" ::"r"(ring_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ void passthrough_ring(const ProbeArgs& a, unsigned char* smem) {
  float4* ring = reinterpret_cast<float4*>(smem);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(
      smem + kRingStages * kRingVec * 16);
  unsigned long long* empty = full + kRingStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       ring_u32(full + s)) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       ring_u32(empty + s)) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long mine = a.tasks > blockIdx.x
      ? (a.tasks - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  if (tid >= kProbeThreads) {   // the producer warp: lane 0 copies in
    if (tid != kProbeThreads) return;
    for (long long k = 0; k < mine; ++k) {
      const int slot = static_cast<int>(k % kRingStages);
      if (k >= kRingStages)
        ring_wait(empty + slot,
                  static_cast<unsigned>((k / kRingStages - 1) & 1));
      const long long v0 = (blockIdx.x + k * gridDim.x) * kRingVec;
      const long long n = a.n4 - v0 < kRingVec ? a.n4 - v0 : kRingVec;
      const unsigned bytes = static_cast<unsigned>(n * 16);
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              ring_u32(full + slot)), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(ring_u32(ring + slot * kRingVec)),
          "l"(a.x + v0 * 4), "r"(bytes), "r"(ring_u32(full + slot))
          : "memory");
    }
    return;
  }
  for (long long k = 0; k < mine; ++k) {
    const int slot = static_cast<int>(k % kRingStages);
    ring_wait(full + slot, static_cast<unsigned>((k / kRingStages) & 1));
    const long long v0 = (blockIdx.x + k * gridDim.x) * kRingVec;
    const int n = static_cast<int>(a.n4 - v0 < kRingVec ? a.n4 - v0
                                                        : kRingVec);
    float4* s = ring + slot * kRingVec;
    for (int i = tid; i < n; i += kProbeThreads) s[i] = add_one(s[i]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(kProbeThreads) : "memory");
    if (tid == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          ::"l"(a.out + v0 * 4), "r"(ring_u32(s)), "r"(n * 16) : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (k > 0) {   // the copy of chunk k - 1 has read its slot
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                         ring_u32(empty + (k - 1) % kRingStages))
                     : "memory");
      }
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace swf
"""

_LOAD = "__device__ __forceinline__ float4 load_vec(const float4* p) { " \
    "return *p; }\n"
_STORE = "__device__ __forceinline__ void store_vec(float4* p, float4 v) { " \
    "*p = v; }\n"


def _load(body):
    return ("probes_device.cuh", _LOAD, "__device__ __forceinline__ float4 "
            "load_vec(const float4* p) {\n" + body + "}\n")


def _store(body):
    return ("probes_device.cuh", _STORE, "__device__ __forceinline__ void "
            "store_vec(float4* p, float4 v) {\n" + body + "}\n")


def _asm_load(op):
    return _load(f"  float4 v;\n  asm volatile(\"{op}.v4.f32 {{%0, %1, %2, "
                 "%3}, [%4];\" : \"=f\"(v.x), \"=f\"(v.y), \"=f\"(v.z), "
                 "\"=f\"(v.w) : \"l\"(p));\n  return v;\n")


def _const(name, old, new):
    return ("probes_device.cuh", f"constexpr int {name} = {old};",
            f"constexpr int {name} = {new};")


_STREAMING = [_load("  return __ldcs(p);\n"), _store("  __stcs(p, v);\n")]
_GRID = ("int grid_for(long long tasks) {\n"
         "  constexpr long long kMaxGrid = 0x7fffffffLL;\n"
         "  return static_cast<int>(tasks < kMaxGrid ? tasks : kMaxGrid);\n"
         "}\n")


def _persistent(threads="kProbeThreads", smem="0"):
    """The persistent grid: the SMs times the blocks of the kernel an SM
    holds, at most one a task."""
    body = (
        "template <class K>\n"
        "int persistent_grid(K kernel, int threads, int smem, "
        "long long tasks) {\n"
        "  int dev = 0, sms = 0, per_sm = 0;\n"
        "  cudaGetDevice(&dev);\n"
        "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, "
        "dev);\n"
        "  if (smem > 48 * 1024)\n"
        "    cudaFuncSetAttribute(kernel, "
        "cudaFuncAttributeMaxDynamicSharedMemorySize, smem);\n"
        "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, "
        "threads, smem);\n"
        "  const long long grid = static_cast<long long>(sms) * per_sm;\n"
        "  return static_cast<int>(tasks < grid ? tasks : grid);\n}\n")
    return [
        ("probes.cu", _GRID, body),
        ("probes.cu", "  swf::passthrough_kernel<<<swf::grid_for(a.tasks), "
         "swf::kProbeThreads, 0,\n",
         "  swf::passthrough_kernel<<<swf::persistent_grid(\n"
         f"      swf::passthrough_kernel, swf::{threads}, {smem}, a.tasks), "
         f"swf::{threads}, {smem},\n"),
        ("probes.cu", "  swf::read_sum_kernel<<<swf::grid_for(a.tasks), "
         "swf::kProbeThreads, 0,\n",
         "  swf::read_sum_kernel<<<swf::persistent_grid(\n"
         "      swf::read_sum_kernel, swf::kProbeThreads, 0, a.tasks), "
         "swf::kProbeThreads, 0,\n")]


# The ring's kernel: 288 threads, the ring in dynamic shared memory.
_RING_KERNEL = (
    "probes.cu",
    "__global__ void __launch_bounds__(kProbeThreads)\n"
    "passthrough_kernel(ProbeArgs a) {\n  passthrough_span(a);\n}\n",
    "__global__ void __launch_bounds__(kRingThreads)\n"
    "passthrough_kernel(ProbeArgs a) {\n"
    "  extern __shared__ __align__(128) unsigned char smem[];\n"
    "  passthrough_ring(a, smem);\n}\n")
VARIANTS = {
    # the first redesign: 256 threads, a persistent grid, eight read-once
    # loads a thread in flight before its streaming stores
    "persistent, 8 streaming loads in flight": [
        _const("kProbeThreads", 1024, 256),
        _const("kPassUnroll", 1, 8)] + _STREAMING + _persistent(),
    "persistent, 8 loads in flight": [
        _const("kProbeThreads", 1024, 256),
        _const("kPassUnroll", 1, 8)] + _persistent(),
    "persistent": _persistent(),
    "TMA ring (passthrough), persistent": [
        _const("kProbeThreads", 1024, 256), _const("kPassUnroll", 1, 8),
        ("probes_device.cuh", "}  // namespace swf\n", _RING),
        _RING_KERNEL] + _persistent("kRingThreads", "swf::kRingSmem"),
    "streaming loads and stores": _STREAMING,
    "streaming loads": _STREAMING[:1],
    "streaming stores": _STREAMING[1:],
    "nc loads": [_asm_load("ld.global.nc")],
    "L2 256B prefetch loads": [_asm_load("ld.global.L2::256B")],
    "L1 no_allocate loads": [_asm_load("ld.global.L1::no_allocate")],
    "U 2": [_const("kPassUnroll", 1, 2)],
    "U 4": [_const("kPassUnroll", 1, 4)],
    "128 threads": [_const("kProbeThreads", 1024, 128)],
    "256 threads": [_const("kProbeThreads", 1024, 256)],
    "256 threads, streaming loads and stores": [
        _const("kProbeThreads", 1024, 256)] + _STREAMING,
    "512 threads": [_const("kProbeThreads", 1024, 512)],
    "read+sum 1 vector a thread": [_const("kSumVectors", 2, 1)],
    "read+sum 4 vectors a thread": [_const("kSumVectors", 2, 4)],
    "read+sum batches of 2 loads": [_const("kSumBatch", 4, 2)],
}


def build_all(cuda_lib, tmp, sources):
    """{name: csrc dir} -> {name: (bound swfprobes library, path)}, ptxas
    logs, errors; one nvcc a build, all started together."""
    libs, logs, errors = {}, {}, {}

    def one(i, name, d):
        path = tmp / f"libprobes_{i}.so"
        try:
            logs[name] = cuda_lib._nvcc_all(d, {"swfprobes": path})
            libs[name] = (cuda_lib.bind("swfprobes",
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


def memory_ops(lib: pathlib.Path):
    """{kernel: {opcode with modifiers: count}} of the global, shared and
    bulk memory instructions of the probe kernels of ``lib``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    heads = list(re.finditer(r"Function : (\S+)", text))
    out = {}
    for i, m in enumerate(heads):
        kernel = next((k for k in KERNELS if k in m.group(1)), None)
        if kernel is None:
            continue
        body = text[m.end():heads[i + 1].start() if i + 1 < len(heads)
                    else len(text)]
        ops = collections.Counter()
        for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_.]*)", body):
            if re.match(MEMORY_OPS, op):
                ops[op] += 1
        out[kernel] = dict(sorted(ops.items()))
    return out


def rows(torch):
    """{row: (bare launch into the row's buffer, plain version, library
    call, that buffer, bytes moved)} on chip_smoke.py's inputs."""
    from . import exp_bw, exp_scatter

    x, x_t = exp_bw.planes("cuda")
    n_f, n_s, n_l, r, c = x_t.shape
    buf = torch.empty_like(x)
    sums = torch.empty((n_f, n_s, r, c), device="cuda")
    nbytes = 2 * x.numel() * 4
    out = {
        "bw_lns": (lambda: exp_bw.launch_probe(
            "swf_passthrough", x, buf, exp_bw.geometry(tuple(x.shape),
                                                       "lns")),
            lambda: x + 1.0, lambda: torch.add(x, 1.0), buf, nbytes),
        "bw_nsl": (lambda: exp_bw.launch_probe(
            "swf_passthrough", x_t, buf, exp_bw.geometry(tuple(x_t.shape),
                                                         "nsl")),
            lambda: x_t + 1.0, lambda: torch.add(x_t, 1.0), buf, nbytes),
        "bw_read_sum": (lambda: exp_bw.launch_probe(
            "swf_read_sum", x_t, sums, exp_bw.geometry(tuple(x_t.shape),
                                                       "nsl"),
            n_s * r * c, r * c),
            lambda: exp_bw.read_sum_plain(x_t),
            lambda: torch.sum(x_t, dim=2), sums,
            x.numel() * 4 * (1 + 1 / n_l))}
    for steps in exp_scatter.STEPS:
        gen = torch.Generator(device="cuda").manual_seed(steps)
        s = torch.randn((steps, 8, 128), generator=gen, device="cuda")
        out[f"step_{steps}"] = (
            lambda s=s: exp_bw.launch_probe(
                "swf_passthrough", s, buf,
                exp_bw.geometry((1, s.shape[0], 1, 8, 128), "nsl")),
            lambda s=s: s + 1.0, lambda s=s: torch.add(s, 1.0), buf,
            2 * s.numel() * 4)
    return out


def main() -> None:
    import sys

    import torch

    from ..ops import cuda_lib

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
    parser.add_argument("--rounds", type=int, default=1,
                        help="passes there and back over the builds")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_phases needs a CUDA card")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="probe_phases_"))
    try:
        sources = {"change": tmp / "change"}
        shutil.copytree(args.csrc, sources["change"])
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
        if "change" not in libs:
            raise SystemExit(f"build failed: {errors}")
        ptx = {n: {k: ptxas_of(logs[n], k) for k in KERNELS} for n in logs}
        sass = {n: memory_ops(libs[n][1]) for n in libs}
        print(json.dumps({"csrc": str(args.csrc), "build_errors": errors,
                          "variants_not_applied": skipped, "ptxas": ptx,
                          "sass": sass}), flush=True)
        order = ["parent"] * ("parent" in libs) + ["change"] + [
            n for n in libs if n not in ("parent", "change")]
        mine = cuda_lib._libs.get("swfprobes")
        try:
            for row, (launch, plain, library, dest, nbytes) in \
                    rows(torch).items():
                want = plain()
                res = {"row": row, "bytes": nbytes, "equal_plain": {},
                       "ms": {n: [] for n in order}, "library_ms": []}
                for n in order:
                    cuda_lib._libs["swfprobes"] = libs[n][0]
                    print(f"probe_phases: {row}: {n}", file=sys.stderr,
                          flush=True)
                    dest.fill_(float("nan"))   # unwritten words show
                    launch()
                    torch.cuda.synchronize()
                    res["equal_plain"][n] = bool(torch.equal(
                        dest.view(-1)[:want.numel()].view(want.shape),
                        want))
                cuda_lib._libs["swfprobes"] = libs["change"][0]
                first, _ = time_run_ms(torch, launch, 20)
                run = max(20, min(1000, int(20 / first)))
                for names in (order, order[::-1]) * args.rounds:
                    for n in names:
                        cuda_lib._libs["swfprobes"] = libs[n][0]
                        res["ms"][n].append(time_run_ms(torch, launch,
                                                        run)[0])
                        res["library_ms"].append(
                            time_run_ms(torch, library, run)[0])
                del want
                res["run"] = run
                res["mean_ms"] = {n: statistics.mean(v)
                                  for n, v in res["ms"].items()}
                res["library_mean_ms"] = statistics.mean(res["library_ms"])
                res["share_of_peak"] = {
                    n: nbytes / (v * 1e-3) / PEAK_BYTES_PER_S
                    for n, v in res["mean_ms"].items()}
                res["library_share_of_peak"] = nbytes / (
                    res["library_mean_ms"] * 1e-3) / PEAK_BYTES_PER_S
                print(json.dumps(res), flush=True)
        finally:
            if mine is None:
                cuda_lib._libs.pop("swfprobes", None)
            else:
                cuda_lib._libs["swfprobes"] = mine
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(card_line())


if __name__ == "__main__":
    main()
