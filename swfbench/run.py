"""Run one cell of the benchmark once and print its result line.

    python3 swfbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  The run needs the CUDA card(s) the cell
asks for; without them it names what is missing on standard error and
exits 3 with no result.  Build and kernel caches stay inside the
checkout, at fixed paths.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / ".swfbench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    from swfbench import harness

    if not (ROOT / "BENCHMARK.json").exists() or not (
            ROOT / "swf_renderer_tpu_torch").is_dir():
        print("swfbench: no BENCHMARK.json or no swf_renderer_tpu_torch "
              f"beside {ROOT / 'swfbench'}", file=sys.stderr)
        return 3
    cell = harness.Cell(harness.load_bench(), args.workload)

    import torch

    marks = {"import_torch": time.perf_counter() - T_START}
    if not torch.cuda.is_available():
        print("swfbench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"swfbench: {torch.cuda.device_count()} CUDA devices, the "
              f"cell needs {cell.chips}", file=sys.stderr)
        return 3
    torch.cuda.init()
    marks["cuda_init"] = time.perf_counter() - T_START
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), T_START, marks=marks)
    found = harness.forbidden_modules()
    if found:
        print(f"swfbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 4
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
