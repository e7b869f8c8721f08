"""A run whose timed path is broken underneath comes out not correct, for
each fault a one-chip search on the cell's route can have, and so does a
run with the control (the exact search on fp8 rows) in the program's
place, with the cells' own limits; the same run unbroken comes out
correct. The run is driven whole but for the harness's look for a card
(run.main), on the CPU at a small genome. On the card at each cell's own
size: portbench/control.py."""

import time

import pytest
import torch

from portbench.faults import FAULTS, applies
from portbench.run import run_cell
from portbench.tests.conftest import small_cell

CELLS = ["hifi-dmel.exact", "ont-chr1.ivf", "hifi-dmel.exact-k100"]
# past 4,096 rows, so that the IVF runs and does not fall back to the
# exact search
GENOME = {"hifi-dmel.exact": 600_000, "hifi-dmel.exact-k100": 600_000,
          "ont-chr1.ivf": 800_000}


def run(cell, fault=None, trace=False, seed=2**31 + 5):
    c = small_cell(cell, GENOME[cell])
    result, lines = run_cell(c, seed, 0.5, trace, torch.device("cpu"),
                             time.perf_counter(), wrap=FAULTS.get(fault),
                             log=lambda *a, **k: None)
    return result, lines


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result, lines = run(cell)
    assert result["correct"], lines
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert {m for m in result["metrics"]} == {
        "reads_per_s", "truth_recall", "peak_device_gib", "setup_s"}
    assert len(lines) == len(result["checks"])


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in sorted(FAULTS)
    if applies(f, "ivf" if c.endswith(".ivf") else "exact")])
def test_a_fault_is_caught(cell, fault):
    result, lines = run(cell, fault)
    assert not result["correct"], lines


def test_a_traced_run_reads_its_per_layer_metrics():
    result, _ = run("ont-chr1.ivf", trace=True)
    assert result["correct"]
    # no device on the CPU: only the program's own count is read
    assert set(result["metrics"]) == {"ivf_pairs_per_row"}
    assert result["metrics"]["ivf_pairs_per_row"]["value"] > 0
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
