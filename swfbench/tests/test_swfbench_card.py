"""On the card: one short run of each cell through ``run.py``, as the
benchmark is started, with its result line read back."""

import json
import subprocess
import sys

import pytest

from .conftest import ROOT


@pytest.mark.chip
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_card(card, bench, trace):
    for spec in bench["workloads"]:
        p = subprocess.run(
            [sys.executable, str(ROOT / "swfbench/run.py"), "--workload",
             spec["name"], "--seed", "3141592653", "--seconds", "2",
             "--trace", str(trace)], cwd=ROOT, capture_output=True,
            text=True, timeout=900)
        assert p.returncode == 0, p.stderr[-3000:]
        res = json.loads(p.stdout.strip().splitlines()[-1])
        assert res["correct"] is True, res["check"]
        assert res["device"]["platform"] == "gpu"
        names = {m["name"] for m in (bench["per_layer"] if trace
                                     else bench["end_to_end"])
                 if spec["name"] in m.get("workloads", [spec["name"]])}
        assert set(res["metrics"]) == names
