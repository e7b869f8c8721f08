"""On a card: a small run of each cell through the hand kernels comes out
correct, and each planted fault, and the control, is caught. Marked `cuda`; each test looks
for a card itself and skips without one. Run them on the card with
`python -m pytest -q -m cuda portbench/tests/test_pb_card.py`."""

import time

import pytest
import torch

from portbench.faults import FAULTS, applies
from portbench.run import run_cell
from portbench.tests.conftest import small_cell

CELLS = ["hifi-dmel.exact", "ont-chr1.ivf", "hifi-dmel.exact-k100"]
# the genome of each small run: the IVF's share of the exact top k that it
# misses grows with the rows at these small sizes (sound: 0.08 at 0.8 Mb,
# 0.17-0.18 at 3 Mb, on the CPU) before it falls to 0.06-0.08 at the
# cell's own 249 Mb, so its small run keeps to the CPU tests' 0.8 Mb
GENOME = {"hifi-dmel.exact": 3_000_000, "hifi-dmel.exact-k100": 3_000_000,
          "ont-chr1.ivf": 800_000}


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def run(cell, fault=None, trace=False):
    result, lines = run_cell(small_cell(cell, GENOME[cell]), 2**33 + 1, 1.0,
                             trace, card(), time.perf_counter(),
                             wrap=FAULTS.get(fault),
                             log=lambda *a, **k: None)
    return result, lines


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_small_run_on_the_card_is_correct(cell):
    result, lines = run(cell, trace=True)
    assert result["correct"], lines
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert "k10_roofline" in result["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in sorted(FAULTS)
    if applies(f, "ivf" if c.endswith(".ivf") else "exact")])
def test_a_fault_on_the_card_is_caught(cell, fault):
    result, lines = run(cell, fault)
    assert not result["correct"], lines
