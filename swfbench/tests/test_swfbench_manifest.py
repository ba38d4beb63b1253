"""BENCHMARK.json against the contract's shape, every cell resolving by
name, and a new cell and metric picked up from files alone."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from swfbench import check, harness

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_keys_names_and_units(bench):
    assert set(bench) == KEYS
    names = [c["name"] for c in bench["configs"]] + [
        c["name"] for c in bench["workloads"]] + [
        m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in bench["workloads"]:
        assert NAME.match(c["config"]) and NAME.match(c["traffic"])
        assert c["chips"] in (1, 4)
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_every_cell_resolves(bench):
    for spec in bench["workloads"]:
        cell = harness.Cell(bench, spec["name"])
        assert cell.config["width"] > 0 and cell.mix["entry"]
        assert cell.per_layer and {m["name"] for m in cell.end_to_end} >= {
            "setup_s"}
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]))
        lim = check.limits(spec["name"])
        assert set(check.COMPARED) <= set(lim)


def test_paths_hold_the_benchmark(bench):
    for p in bench["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    for c in bench["configs"]:
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
    assert bench["command"][1].startswith(bench["paths"][0] + "/")


NEW_METRIC = '''
def read(traced):
    return float(traced.frames)
'''

# A content form that draws squares with a new kind of character, a
# shape whose only contour is an axis-aligned square.
NEW_FORM = '''
import numpy as np

from swfbench.chars.shape import Shape
from swfbench.fills.solid import Solid
from swfbench.gen import TWIPS, Clip, Instance, rgba


class Square(Shape):
    @classmethod
    def of(cls, cid, x, y, side, fill):
        pts = np.array([[x, y], [x + side, y], [x + side, y + side],
                        [x, y + side]], np.int64)
        return cls(cid, [pts], [pts], [np.zeros(4, bool)], fill)


def make(cfg, p, rng, frames):
    w, h = cfg["width"] * TWIPS, cfg["height"] * TWIPS
    chars, timeline = [], []
    for f in range(frames):
        row = []
        for d in range(p["squares"]):
            x, y = (int(v) for v in rng.integers(0, (w, h)))
            s = Square.of(len(chars) + 1, x, y, int(h * 0.4),
                          Solid(rgba(rng, 30, 128)))
            chars.append(s)
            row.append(Instance(d + 1, s))
        timeline.append(row)
    return Clip(cfg["width"], cfg["height"], (0, 0, 0, 0),
                cfg["frame_rate"], chars, timeline)
'''

# An entry that renders the stages one by one through TorchRenderer.render.
NEW_ENTRY = '''
import numpy as np

from swfbench.entries import Base
from swfbench.port import stages


class Entry(Base):
    renderer = None

    def build(self, clip):
        return stages(clip)

    def call(self, built):
        from swf_renderer_tpu_torch import TorchRenderer

        if self.renderer is None:
            self.renderer = TorchRenderer(built[0].width, built[0].height,
                                          device=self.device)
        return np.stack([self.renderer.render(s) for s in built])

    def traced_call(self, built, span):
        with span("render_batch"):
            return self.call(built)
'''


def _run_copy(tmp_path, bench, cell, files, workloads, per_layer):
    shutil.copytree(ROOT / "swfbench", tmp_path / "swfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "swf_renderer_tpu_torch").symlink_to(
        ROOT / "swf_renderer_tpu_torch")
    for rel, text in files.items():
        assert not (tmp_path / rel).exists(), rel
        (tmp_path / rel).write_text(text)
    b = json.loads(json.dumps(bench))
    b["workloads"] += workloads
    b["per_layer"] += per_layer
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    script = (
        "import sys, time, json\n"
        "from swfbench import harness\n"
        f"cell = harness.Cell(harness.load_bench(), {cell!r})\n"
        "r = harness.run_cell(cell, 7, 0.1, True, time.perf_counter(),\n"
        "                     device='cpu', size=(960, 540, 4))\n"
        "harness.emit(r)\n")
    p = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["check"]
    assert list(res)[-1] == "check"
    return res


def test_new_cell_and_metric_from_files_alone(tmp_path, bench):
    # A cell, a mix, a check and a per-layer metric added as files and
    # entries in a copy are run without editing any file there.
    mix = json.loads((ROOT / "swfbench/mixes/tween.json").read_text())
    mix.update(shapes=3, gradients=1, pool=2)
    res = _run_copy(
        tmp_path, bench, "export1080.tiny_tween",
        {"swfbench/mixes/tiny_tween.json": json.dumps(mix),
         "swfbench/metrics/frames_traced.py": NEW_METRIC,
         "swfbench/checks/export1080.tiny_tween.json":
             (ROOT / "swfbench/checks/export1080.tween.json").read_text()},
        [{"name": "export1080.tiny_tween", "config": "export1080",
          "traffic": "tiny_tween", "chips": 1, "why": "a test cell"}],
        [{"name": "frames_traced", "unit": "frames", "better": "higher",
          "source": "host_clock", "layer": "test", "moves": "export_fps",
          "workloads": ["export1080.tiny_tween"]}])
    assert res["metrics"]["frames_traced"]["value"] >= 2


def test_new_form_character_and_entry_from_files_alone(tmp_path, bench):
    # A content form with a character of its own, and an entry, added as
    # files: the writer, the stage builder, the reference and the work
    # count take them without an edit.
    mix = {"entry": "render_frames", "content": "squares", "squares": 3,
           "pool": 2, "warm_frames": 1, "warm_calls": 1, "check_calls": 2}
    res = _run_copy(
        tmp_path, bench, "export1080.squares",
        {"swfbench/forms/squares.py": NEW_FORM,
         "swfbench/entries/render_frames.py": NEW_ENTRY,
         "swfbench/mixes/squares.json": json.dumps(mix),
         "swfbench/checks/export1080.squares.json":
             (ROOT / "swfbench/checks/export1080.morph.json").read_text()},
        [{"name": "export1080.squares", "config": "export1080",
          "traffic": "squares", "chips": 1, "why": "a test cell"}], [])
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_no_result_without_the_program(tmp_path, bench):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits non-zero and prints no result."""
    for p in bench["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run(bench["command"] + [
        "--workload", bench["workloads"][0]["name"], "--seed", "1",
        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("argv", [["--seed", "1"], ["--workload", "x"]])
def test_arguments_required(argv):
    p = subprocess.run([sys.executable, str(ROOT / "swfbench/run.py")]
                       + argv, capture_output=True, text=True, timeout=60)
    assert p.returncode != 0 and p.stdout == ""
