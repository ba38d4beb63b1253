"""The entries a cell drives, one module each, named by a mix's ``entry``
key: ``entries/<entry>.py`` has a class ``Entry(device)`` with this
module's ``Base`` surface:

- ``prepare(clip)``: set-up work on one call's content (say, writing it
  as SWF bytes), outside the window;
- ``build(prepared)``: the objects a call takes, made just before it and
  outside the timed call;
- ``call(built)`` and ``traced_call(built, span)``: the timed call,
  returning (frames, H, W, 4) u8 on the host; the traced one marks the
  benchmark's spans and records the route and the caches' counters;
- ``reset_counters()``, ``close()``.

Nothing here is imported until a run needs it, and nothing imports JAX
or the JAX package.
"""

from __future__ import annotations

import importlib

# The program's launch counters: (module, function, attribute).
LAUNCH_COUNTERS = (
    ("ops.flatblock", "render_fused_styled", "launches"),
    ("ops.flatblock", "render_fused_blocksn", "launches"),
    ("ops.transform", "render_affine_sweep", "launches"),
    ("ops.transform", "render_affine_sweep", "row_launches"),
    ("ops.transform", "render_affine_sweep", "compact_launches"),
    ("ops.transform", "render_morph_affine_sweep", "launches"),
    ("ops.morph", "render_morph_sweep", "launches"),
    ("ops.coverage", "coverage_banded", "launches"),
    ("ops.coverage", "coverage_tiled", "launches"),
)
PKG = "swf_renderer_tpu_torch"


def load(name: str, device):
    """The entry ``entries/<name>.py``, made for ``device`` (None: the
    card through the program's defaults; "cpu": its plain versions)."""
    return importlib.import_module(f"swfbench.entries.{name}").Entry(device)


def launch_counts() -> dict:
    out = {}
    for mod, fn, attr in LAUNCH_COUNTERS:
        f = getattr(importlib.import_module(f"{PKG}.{mod}"), fn, None)
        if f is not None and hasattr(f, attr):
            out[f"{fn}.{attr}"] = int(getattr(f, attr))
    return out


class Base:
    """Counters the traced run reads: the route of the last call and the
    content-keyed caches' hits and misses, summed over calls."""

    def __init__(self, device):
        self.device = device
        self.reset_counters()

    def reset_counters(self):
        self.paths = {}
        self.cache = {"packed_hits": 0, "packed_misses": 0,
                      "draws_hits": 0, "draws_misses": 0}

    @staticmethod
    def cache_counts(renderer) -> dict:
        return {"packed_hits": renderer._packed_cache.hits,
                "packed_misses": renderer._packed_cache.misses,
                "draws_hits": renderer._draws_cache.hits,
                "draws_misses": renderer._draws_cache.misses}

    def record(self, renderer, since=None):
        self.paths[renderer.last_stats.path] = self.paths.get(
            renderer.last_stats.path, 0) + 1
        now = self.cache_counts(renderer)
        for k, v in now.items():
            self.cache[k] += v - (since or {}).get(k, 0)
        return now

    def prepare(self, clip):
        return clip

    def build(self, prepared):
        return prepared

    def close(self):
        pass
