"""One run of one cell: inputs from the seed, warm-up, a closed loop of
whole calls for the window, the check against the plain reference, one
JSON line.

Everything a cell is made of is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``configs[].file``) and its
traffic mix (``mixes/<traffic>.json``); the mix names its content form
(``forms/<content>.py``) and its entry (``entries/<entry>.py``); each
per-layer metric that lists the cell is read by ``metrics/<name>.py``;
the limits of its check are in ``checks/<cell>.json``.  Adding a
configuration, mix, form, entry, cell or metric adds files and entries
and edits none.
"""

from __future__ import annotations

import gc
import importlib
import json
import pathlib
import sys
import time
import traceback

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "swf_renderer_tpu")


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, mix and
    metrics resolved."""

    def __init__(self, bench: dict, name: str, root: pathlib.Path = ROOT):
        cells = {c["name"]: c for c in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        self.name = name
        self.spec = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.spec["config"]]
        self.config = json.loads((root / conf["file"]).read_text())
        self.mix = json.loads(
            (root / "swfbench" / "mixes" / f"{self.spec['traffic']}.json")
            .read_text())
        self.chips = int(self.spec["chips"])

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def reader(self, metric: str):
        return importlib.import_module(f"swfbench.metrics.{metric}").read


def load_bench(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _rss_bytes() -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return -1


class Traced:
    """What the per-layer readers read: the timeline, the frames of the
    traced calls and their least work, the card's peaks."""

    def __init__(self, timeline, frames, work, peak):
        self.timeline = timeline
        self.frames = frames
        self.work = work
        self.peak = peak


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, size=None, fault=None,
             log=sys.stderr, marks=None) -> dict:
    """Run ``cell`` once and return its result line (a dict).

    ``device`` None drives the card through the entries' defaults;
    "cpu" (tests) takes the program's plain versions.  ``size`` =
    (width, height, frames) shrinks the configuration (tests); ``fault``
    maps the frames each call returns before they are kept (tests of the
    check).  ``marks`` holds set-up times already taken (seconds from
    ``t_start``); the run adds its own."""
    import torch

    from . import check, entries, gen, trace as tr
    from .reference import frames as ref

    cfg = dict(cell.config)
    if size is not None:
        cfg["width"], cfg["height"], cfg["frames_per_call"] = size
    mix = cell.mix
    on_card = device is None
    dev = torch.device("cuda" if on_card else device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    entry = entries.load(mix["entry"], device)
    clips = [gen.make_clip(cfg, mix, seed, i) for i in range(mix["pool"])]
    pool = [entry.prepare(c) for c in clips]
    marks = dict(marks or {}, inputs=time.perf_counter() - t_start)
    warm = entry.prepare(gen.make_clip(cfg, mix, seed, -1,
                                       frames=mix["warm_frames"]))
    for _ in range(mix["warm_calls"]):
        if trace:
            entry.traced_call(entry.build(warm), tr.span)
        else:
            entry.call(entry.build(warm))
    entry.reset_counters()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    marks["warm"] = setup_s

    keep = max(1, int(mix["check_calls"]))
    pick = np.random.default_rng([int(seed) % (1 << 64), 2])
    kept, calls, frames, failed, in_calls = [], 0, 0, 0, 0.0
    per_call = []
    launches0 = entries.launch_counts() if trace else {}
    rss0 = _rss_bytes()
    per_call_cpu = []
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        k = calls % len(pool)
        if trace:
            with tr.span("prepare"):
                built = entry.build(pool[k])
        else:
            built = entry.build(pool[k])
        c0, t0 = time.process_time(), time.perf_counter()
        try:
            out = (entry.traced_call(built, tr.span) if trace
                   else entry.call(built))
        except Exception:   # a failed call counts, and the run goes on
            traceback.print_exc(file=log)
            out = None
        per_call.append(time.perf_counter() - t0)
        per_call_cpu.append(round(time.process_time() - c0, 4))
        in_calls += per_call[-1]
        del built
        if out is None:
            failed += 1
        else:
            if fault is not None:
                out = fault(out)
            frames += len(out)
            if len(kept) < keep:
                kept.append((calls, out))
            else:
                j = int(pick.integers(0, calls + 1))
                if j < keep:
                    kept[j] = (calls, out)
        calls += 1
        out = None
    window_s = time.perf_counter() - w0
    if prof is not None:
        prof.__exit__(None, None, None)
    rss1 = _rss_bytes()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    found = forbidden_modules()
    if found:
        print(f"swfbench: forbidden modules loaded: {found}", file=log)
        raise SystemExit(4)

    result = {"correct": False, "attempted": calls, "failed": failed,
              "metrics": {}, "device": {}}
    counters = {"setup_marks_s": marks, "path": entry.paths,
                "caches": entry.cache, "rss_bytes": [rss0, rss1]}
    if trace:
        after = entries.launch_counts()
        counters["launches"] = {k: v - launches0.get(k, 0)
                                for k, v in after.items()
                                if v != launches0.get(k, 0)}
    entry.close()
    entry = pool = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        name = torch.cuda.get_device_name(0)
        result["device"] = {"platform": "gpu", "kind": name,
                            "count": cell.chips, "memory_peak_bytes": peak}
    else:
        name = "cpu"
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": peak}

    if trace:
        from .workcount import clip_work, peaks

        timeline = tr.Timeline(prof)
        prof = None
        per_clip = {}
        for i in range(calls):
            k = i % len(clips)
            if k not in per_clip:
                c = clips[k]
                per_clip[k] = clip_work(
                    c, [ref.covered_pixels(c, f, dev)
                        for f in range(len(c.frames))])
        work = [sum(per_clip[i % len(clips)][j] for i in range(calls))
                for j in (0, 1)]
        traced = Traced(timeline, frames, work, peaks(name))
        for m in cell.per_layer:
            value = cell.reader(m["name"])(traced)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["device"]["busy_s"] = timeline.busy_total()
        result["device"]["window_s"] = window_s
        result["breakdown"] = {"device_ops": timeline.top_device_ops(),
                               "idle_gaps": timeline.idle_gaps()}
    else:
        e2e = {"export_fps": frames / in_calls if in_calls > 0 else 0.0,
               "setup_s": setup_s}
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}
    counters["window_s"] = window_s
    counters["calls_s"] = in_calls
    counters["per_call_s"] = per_call
    counters["per_call_cpu_s"] = per_call_cpu

    counters["kept_bytes"] = sum(out.nbytes for _, out in kept)
    t_check = time.perf_counter()
    lim = check.limits(cell.name)
    tally = check.Tally(check.levels(lim))
    for i, out in kept:
        clip = clips[i % len(clips)]
        for f in range(len(clip.frames)):
            want = ref.frame(clip, f, torch.float64, dev)
            tally.add(out[f] if f < len(out) else np.zeros(0, np.uint8),
                      want)
        if len(out) != len(clip.frames):
            tally.faults.append(f"call {i}: {len(out)} frames for "
                                f"{len(clip.frames)}")
    counters["check_s"] = time.perf_counter() - t_check
    ok, shown = tally.verdict(lim)
    result["correct"] = bool(ok and not failed)
    result["check"] = shown
    result["_counters"] = counters
    result["_faults"] = tally.faults
    return result


def emit(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    """Earlier lines: the counters; the check's numbers as the last lines
    of standard error; the result as the last line of standard output,
    its ``check`` key last."""
    counters = result.pop("_counters")
    faults = result.pop("_faults")
    print("swfbench.counters " + json.dumps(counters), file=out, flush=True)
    for f in faults:
        print(f"check fault: {f}", file=err)
    for k, v in result["check"].items():
        lim = "" if v["limit"] is None else f" limit {v['limit']!r}"
        print(f"check {k} {v['value']!r}{lim}", file=err, flush=True)
    check_part = result.pop("check")
    result["check"] = check_part
    print(json.dumps(result), file=out, flush=True)
