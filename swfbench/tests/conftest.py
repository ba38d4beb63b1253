"""Tests of the benchmark harness.  They run on the CPU at tiny sizes;
those that need the CUDA card carry the ``chip`` marker and take the
``card`` fixture, which skips them when no card is present:

    python -m pytest swfbench/tests -q            # here, on the CPU
    python -m pytest swfbench/tests -q -m chip    # on the card
"""

import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs the CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this machine")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


TINY = (96, 64, 3)     # width, height, frames a call
# A size at which a cell's limits hold as they do at 1080p: the shapes
# scale with the frame, so their antialiased edges are a share of the
# pixels that grows as the frame shrinks (``over1_share``), and the
# morphs reach fractional ratios only between their first and last frame.
CHECK = (960, 540, 8)
