"""Readings that set the check's limits, at a cell's own size, on the
card: for each seed, the program's frames of one call against the plain
reference (the lower readings), the reference in the program's place
against the same, computed in bfloat16 (the control) and with only its
paints, composite and quantize in bfloat16 (the upper readings), and the
program's frames with each fault of ``faults`` planted.  Besides the
check's numbers it reads ``over<k>_share`` for k = 1 to 4.  One process
reads every seed.

    python3 swfbench/control.py --workload <cell> --seeds 1,2,3 \\
        --out chiprun_out/<name>.jsonl
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def readings(frames, want) -> dict:
    from swfbench import check

    tally = check.Tally(levels=(1, 2, 3, 4))
    for got, ref_frame in zip(frames, want):
        tally.add(got, ref_frame)
    return tally.values


def reference(clip, dev, dtype, paint_dtype=None):
    from swfbench.reference import frames as ref

    return [ref.frame(clip, f, dtype, dev, paint_dtype)
            for f in range(len(clip.frames))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from swfbench import entries, faults, gen, harness

    cell = harness.Cell(harness.load_bench(), args.workload)
    dev = torch.device("cuda")
    entry = entries.load(cell.mix["entry"], None)
    warm = gen.make_clip(cell.config, cell.mix, 1, -1,
                         frames=cell.mix["warm_frames"])
    entry.call(entry.build(entry.prepare(warm)))
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as log:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            clip = gen.make_clip(cell.config, cell.mix, seed, 0)
            got = entry.call(entry.build(entry.prepare(clip)))
            want = reference(clip, dev, torch.float64)
            rec = {"workload": cell.name, "seed": seed,
                   "program": readings(got, want),
                   "control_bf16": readings(
                       reference(clip, dev, torch.bfloat16), want),
                   "control_bf16_paint": readings(
                       reference(clip, dev, torch.float32, torch.bfloat16),
                       want)}
            for name, fault in faults.FAULTS.items():
                rec[name] = readings(fault(got), want)
            rec["seconds"] = time.perf_counter() - t0
            log.write(json.dumps(rec) + "\n")
            log.flush()
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
