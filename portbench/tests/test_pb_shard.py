"""The sharded cell's readers (shard_serial_ms, shard_wire_ms,
shard_k6_roofline) on a synthetic trace and record, and a run of the
cell's configuration on the sharded route on the CPU."""

import time

import pytest
import torch

from portbench import cells, work
from portbench.faults import FAULTS
from portbench.run import run_cell
from portbench.tests.conftest import small_cell
from portbench.trace import Context, Trace

CELL = "ont-grch38-chr1-5.ivf-sharded"
ROWS = 6_367_190


def record(serial_ms, wire_s, entry_pairs):
    rows = [ROWS // 4 + (e < ROWS % 4) for e in range(4)]
    return {"clusters": 4096, "probes": 8, "entries": 4,
            "real_pair_scores": sum(entry_pairs), "entry_rows": rows,
            "entry_pairs": list(entry_pairs), "serial_ms": serial_ms,
            "wire_s": wire_s}


STATS = [record(700.0, 1.5, [6 * 10**10] * 4),
         record(900.0, 2.5, [5 * 10**10, 6 * 10**10, 7 * 10**10,
                             6 * 10**10])]


def context(route, stats, device=()):
    return Context(Trace(0.0, 10.0, list(device),
                         [("portbench.window", 0.0, 10.0)]),
                   route, "bf16", ROWS, 500, 50, len(stats), list(stats))


def k6_least(s):
    return sum(work.k6_seconds(p, r, 8, 500, 50, "bf16")
               for p, r in zip(s["entry_pairs"], s["entry_rows"]))


def test_serial_and_wire_readers_take_the_mean_over_jobs():
    assert cells.load_reader("shard_serial_ms")(
        context("ivf_sharded", STATS)) == pytest.approx(800.0)
    assert cells.load_reader("shard_wire_ms")(
        context("ivf_sharded", STATS)) == pytest.approx(2000.0)


def test_k6_roofline_of_the_kept_launches_on_every_card():
    least = (k6_least(STATS[0]) + k6_least(STATS[1])) / 2
    # one job's four launches kept (one a card, overlapping), each taking
    # four times its share of the least time
    dev = [("ivf_rescore_kernel<true, true>", 1.0, 1.0 + least)
           for _ in range(4)]
    dev.append(("knn_merge_wgmma<true>", 0.0, 1.0))
    got = cells.load_reader("shard_k6_roofline")(
        context("ivf_sharded", STATS, dev))
    assert got == pytest.approx(25.0)
    # by hand: at 6e10 pairs over 1,591,798 rows the bound is operations
    assert work.k6_seconds(6 * 10**10, 1_591_798, 8, 500, 50, "bf16") \
        == pytest.approx(2 * 6e10 * 500 / 989e12)


@pytest.mark.parametrize("name", ["shard_serial_ms", "shard_wire_ms",
                                  "shard_k6_roofline"])
def test_a_reader_finds_nothing_off_the_route_or_record(name):
    read = cells.load_reader(name)
    dev = [("ivf_rescore_kernel<true, true>", 1.0, 2.0)]
    assert read(context("ivf", STATS, dev)) is None
    assert read(context("ivf_sharded", [], dev)) is None
    bare = [{k: v for k, v in s.items()
             if k not in ("serial_ms", "wire_s", "entry_rows",
                          "entry_pairs")} for s in STATS]
    assert read(context("ivf_sharded", bare, dev)) is None


def test_the_cell_resolves_with_four_chips_and_its_readers():
    cell = cells.resolve(cells.load_benchmark(cells.HERE.parent), CELL)
    assert cell.chips == 4
    assert cell.config["rows"] == 2 * cell.config["reads"] == ROWS
    assert [m["name"] for m in cell.per_layer] == [
        "shard_serial_ms", "shard_wire_ms", "shard_k6_roofline"]


def run(fault=None, trace=False, seed=2**33 + 17):
    """The cell's configuration cut to 0.8 Mb on the CPU, on the sharded
    route (--knn-sharded always: the CPU is a mesh of one entry)."""
    c = small_cell(CELL, 800_000)
    c.config["flags"] = [*c.config["flags"], "--knn-sharded", "always"]
    return run_cell(c, seed, 0.5, trace, torch.device("cpu"),
                    time.perf_counter(), wrap=FAULTS.get(fault),
                    log=lambda *a, **k: None)[0]


def test_a_sound_sharded_run_is_correct_and_traces():
    result = run(trace=True)
    assert result["correct"] and result["failed"] == 0
    # no card: no device time and no timed record to read
    assert result["metrics"] == {}
    assert result["device"]["window_s"] > 0


@pytest.mark.parametrize("fault", ["members_half", "control", "stale"])
def test_a_fault_on_the_sharded_route_is_caught(fault):
    assert not run(fault)["correct"]
