"""The registry finds every piece of a cell by its name, so that a new
configuration, mix, cell or per-layer metric is new files and new entries
only."""

import json
import shutil

import pytest

from portbench import cells

BENCH = cells.load_benchmark(cells.HERE.parent)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = cells.resolve(BENCH, cell)
    assert c.config["dataset"]["genome_bases"] > 0
    assert c.mix["check_rows_per_job"] > 0
    assert set(c.limits) >= {"dist_err"}
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "reads_per_s"}
    assert c.per_layer
    for m in c.per_layer:
        assert callable(cells.load_reader(m["name"]))


def test_a_new_cell_needs_new_files_only(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(cells.HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p.relative_to(base): p.read_bytes()
              for p in base.rglob("*") if p.is_file()}
    config = json.loads((base / "configs" / "hifi-dmel.json").read_text())
    config.update(name="hifi-dmel-half",
                  dataset={**config["dataset"], "genome_bases": 70_000_000})
    (base / "configs" / "hifi-dmel-half.json").write_text(json.dumps(config))
    (base / "mixes" / "k20.json").write_text(json.dumps(
        {"name": "k20", "flags": ["--nndescent-n-neighbors", "20"],
         "check_rows_per_job": 64, "truth_overlap_share": 0.5}))
    (base / "cells" / "hifi-dmel-half.k20.json").write_text(json.dumps(
        {"limits": {"dist_err": 0.02, "rank_gap": 0.02}}))
    (base / "metrics" / "jobs_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx.jobs)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(
        {"name": "hifi-dmel-half.k20", "config": "hifi-dmel-half",
         "traffic": "k20", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append(
        {"name": "jobs_in_window", "unit": "jobs", "better": "higher",
         "source": "host_clock", "layer": "device", "moves": "reads_per_s",
         "workloads": ["hifi-dmel-half.k20"]})
    cell = cells.resolve(bench, "hifi-dmel-half.k20", base)
    assert cell.flags[-2:] == ["--nndescent-n-neighbors", "20"]
    assert cell.config["dataset"]["genome_bases"] == 70_000_000
    assert [m["name"] for m in cell.per_layer] == ["jobs_in_window"]
    assert cells.load_reader("jobs_in_window", base)(
        type("Ctx", (), {"jobs": 7})) == 7.0
    after = {p.relative_to(base): p.read_bytes()
             for p in base.rglob("*") if p.is_file()}
    assert all(after[p] == b for p, b in before.items())


def test_reports_follows_workloads_and_moves():
    e2e = [{"name": "reads_per_s"},
           {"name": "only_b", "workloads": ["b"]}]
    assert cells.reports({"name": "x", "workloads": ["a"]}, "a", e2e)
    assert not cells.reports({"name": "x", "workloads": ["a"]}, "b", e2e)
    assert cells.reports({"name": "x", "moves": "reads_per_s"}, "a", e2e)
    assert not cells.reports({"name": "x", "moves": "only_b"}, "a", e2e)
    assert cells.reports({"name": "x", "moves": "only_b"}, "b", e2e)


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.resolve(BENCH, "no-such.cell")
