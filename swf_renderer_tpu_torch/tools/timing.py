"""Timing helpers shared by the measurement tools (card only)."""

from __future__ import annotations

import statistics
import subprocess
import time


def time_ms(torch, fn, reps: int = 5, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` between CUDA events, after
    ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_run_ms(torch, fn, n: int, warmup: int = 1):
    """(device ms a call, host ms a call) of ``n`` calls of ``fn`` issued
    back to back between one pair of CUDA events, after ``warmup`` untimed
    calls: the device time divides the events' span by ``n``, so the
    enqueue of one call overlaps the kernel of the one before; the host
    time is the Python wall of issuing the ``n`` calls (no synchronise in
    between) over ``n``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / n
    end.synchronize()
    return start.elapsed_time(end) / n, host


def card_line() -> str:
    """The first card's name and power limit as nvidia-smi prints them;
    RuntimeError when nvidia-smi fails."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]
