"""The check fails what it has to: the controls (the reference computed
in bfloat16, or with its paints in bfloat16, in the program's place)
and, through a whole run with the look for a chip skipped, each fault a
renderer's timed path can have.  (No cell spans chips, so no exchange
between chips can be left out.)"""

import time

import pytest
import torch

from swfbench import check, control, entries, faults, gen, harness

from .conftest import CHECK

CELLS = ["export1080.tween", "export1080.keyframes", "export1080.morph"]


def _clip(bench, name, seed):
    cell = harness.Cell(bench, name)
    cfg = dict(cell.config, width=CHECK[0], height=CHECK[1],
               frames_per_call=CHECK[2])
    return cell, gen.make_clip(cfg, cell.mix, seed, 0)


# The controls: the reference in bfloat16 throughout, and with only its
# paints, composite and quantize in bfloat16 (geometry in float32).
CONTROLS = {"bf16": (torch.bfloat16, None),
            "bf16_paint": (torch.float32, torch.bfloat16)}


# The paint control is caught in the cells whose limits name a share it
# fails (morph; PERF.md section 2).
@pytest.mark.parametrize("name, ctl", [(c, "bf16") for c in CELLS] + [
    ("export1080.morph", "bf16_paint")])
def test_control_fails_and_program_passes(bench, name, ctl):
    cell, clip = _clip(bench, name, 99)
    dev = torch.device("cpu")
    want = control.reference(clip, dev, torch.float64)
    lim = check.limits(name)
    low = control.readings(
        control.reference(clip, dev, *CONTROLS[ctl]), want)
    assert any(low[k] > v for k, v in lim.items()), low
    entry = entries.load(cell.mix["entry"], "cpu")
    got = entry.call(entry.build(entry.prepare(clip)))
    sound = control.readings(got, want)
    assert all(sound[k] <= v for k, v in lim.items()), sound


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_run_with_a_fault_is_not_correct(bench, name, fault):
    cell = harness.Cell(bench, name)
    res = harness.run_cell(cell, 5, 0.05, False, time.perf_counter(),
                           device="cpu", size=CHECK,
                           fault=faults.FAULTS[fault])
    assert res["correct"] is False, res["check"]


def test_sound_run_is_correct(bench):
    cell = harness.Cell(bench, "export1080.morph")
    res = harness.run_cell(cell, 5, 0.05, False, time.perf_counter(),
                           device="cpu", size=CHECK)
    assert res["correct"] is True, res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_wrong_shape_is_a_fault():
    t = check.Tally()
    t.add(torch.zeros((4, 4, 4), dtype=torch.uint8),
          torch.zeros((4, 5, 4), dtype=torch.uint8))
    ok, _ = t.verdict({"over_share": 1.0, "mean_gap": 255.0})
    assert not ok
