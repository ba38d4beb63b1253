"""Timing helpers shared by the measurement tools (card only)."""

from __future__ import annotations

import statistics
import subprocess


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
