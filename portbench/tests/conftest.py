"""Shared helpers of the benchmark's CPU tests: small copies of the real
cells. A small cell keeps its cell's flags, mix, limits and metrics and
cuts only the genome, so that a run fits a CPU test; the SRP density is
pinned to the one the full genome gives (1 / sqrt(2 (G - k + 1) f)), so
the rows keep the full size's sparsity (~26 nonzeros a HiFi row, ~7 an
ONT row)."""

from __future__ import annotations

import copy
import math
from pathlib import Path

import pytest

from portbench import cells

ROOT = Path(__file__).resolve().parents[2]
SMALL_GENOME = 1_000_000


def small_cell(name: str, genome: int = SMALL_GENOME) -> cells.Cell:
    cell = cells.resolve(cells.load_benchmark(ROOT), name)
    config = copy.deepcopy(cell.config)
    full = config["dataset"]["genome_bases"]
    flags = config["flags"]
    k = int(flags[flags.index("-k") + 1])
    f = float(flags[flags.index("--kmer-sample-fraction") + 1])
    density = 1.0 / math.sqrt(2 * (full - k + 1) * f)
    config["flags"] = [*flags, "--projection-density", repr(density)]
    config["dataset"]["genome_bases"] = genome
    cell.config = config
    return cell


@pytest.fixture
def small():
    return small_cell
