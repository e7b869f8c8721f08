"""The benchmark's registry, driven by data: a cell of BENCHMARK.json names
a configuration and a traffic mix, and the harness finds each piece by its
name under portbench/:

- configs/<config>.json: the configuration's source, its CLI flags (as a
  user passes them to fedrann-tpu-torch), its dataset (genome bases,
  coverage, mean read length, error rate), `reduced` and `assumed`;
- mixes/<traffic>.json: the traffic mix: more CLI flags (appended, so
  they win), the query rows judged a job, and the truth pairs' overlap
  as a share of the mean read length;
- cells/<cell>.json: the limits of the numbers that decide `correct`,
  with the readings each was set from;
- metrics/<metric>.py: a per-layer metric's reader, `read(ctx)`, which
  returns the metric's value or None where the trace holds nothing for it.

A new configuration, mix, cell or per-layer metric is new files and new
entries in BENCHMARK.json; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    """One cell, resolved: its entry, configuration, mix, limits and the
    names of the metrics it reports."""

    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def flags(self) -> list[str]:
        return [*self.config["flags"], *self.mix.get("flags", [])]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path) -> dict:
    """BENCHMARK.json at the root of the checkout."""
    return _load_json(root / "BENCHMARK.json")


def reports(metric: dict, cell: str, end_to_end: list[dict]) -> bool:
    """Whether `cell` reports `metric`: the cells its `workloads` lists;
    without that key, every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it moves (a per-layer metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    return any(m["name"] == moves and reports(m, cell, end_to_end)
               for m in end_to_end)


def resolve(bench: dict, cell_name: str, base: Path = HERE) -> Cell:
    """The cell named `cell_name` of `bench`, its files read from `base`
    (portbench/). Raises KeyError for a cell the benchmark lacks."""
    entry = next((w for w in bench["workloads"] if w["name"] == cell_name),
                 None)
    if entry is None:
        raise KeyError(f"no cell {cell_name!r} in BENCHMARK.json")
    e2e = bench["end_to_end"]
    return Cell(
        name=cell_name,
        chips=int(entry["chips"]),
        config=_load_json(base / "configs" / f"{entry['config']}.json"),
        mix=_load_json(base / "mixes" / f"{entry['traffic']}.json"),
        limits=_load_json(base / "cells" / f"{cell_name}.json")["limits"],
        end_to_end=[m for m in e2e if reports(m, cell_name, e2e)],
        per_layer=[m for m in bench["per_layer"]
                   if reports(m, cell_name, e2e)])


def load_reader(name: str, base: Path = HERE):
    """The `read(ctx)` function of metrics/<name>.py."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
