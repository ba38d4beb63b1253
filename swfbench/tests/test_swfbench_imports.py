"""Module hygiene in a fresh interpreter: a run loads no module whose
top-level name is jax, jaxlib, flax or swf_renderer_tpu (whole names;
swf_renderer_tpu_torch starts with the last), and the reference and the
work counts load nothing of swf_renderer_tpu_torch."""

import json
import subprocess
import sys

import pytest

from .conftest import ROOT

PROBE = """
import json, sys, time
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(body: str) -> set:
    p = subprocess.run([sys.executable, "-c", PROBE.format(body=body)],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _top_level(
        "from swfbench import harness\n"
        "cell = harness.Cell(harness.load_bench(), 'export1080.tween')\n"
        "r = harness.run_cell(cell, 3, 0.1, False, time.perf_counter(),\n"
        "                     device='cpu', size=(960, 540, 4))\n"
        "assert r['correct']\n")
    assert "swf_renderer_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "swf_renderer_tpu"}


@pytest.mark.parametrize("module", ["swfbench.reference.frames",
                                    "swfbench.workcount", "swfbench.check"])
def test_yardstick_loads_nothing_of_the_program(module):
    mods = _top_level(f"import {module}\n")
    assert not mods & {"swf_renderer_tpu_torch", "swf_renderer_tpu", "jax"}


def test_forbidden_names_compare_whole():
    from swfbench import harness

    sys.modules.setdefault("swf_renderer_tpu_torch", sys.modules[__name__])
    assert "swf_renderer_tpu" not in harness.forbidden_modules()
