"""Run one cell of BENCHMARK.json on this machine's CUDA cards:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes two read sets on the first card from --seed and a seed
derived from it (portbench/gen), resolves the configuration's and the
mix's CLI flags with fedrann_tpu_torch.cli.config_from_args, and runs one
warm-up search job on each read set. The window then runs search jobs back
to back, alternating between the read sets, until --seconds have passed:
a job is one call of fedrann_tpu_torch.pipeline.search on a read set's
(2R, d) float32 rows, from the rows on the card to the neighbor indices
and distances in host memory. With --trace 1 the window runs under
torch.profiler and the result carries the per-layer metrics
(portbench/metrics) and a breakdown instead of the end-to-end ones.

After the window the plain reference (portbench/reference) judges every
answer of each read set's last job and a seeded sample of query rows of
every job; `correct` is whether each compared number is within its limit
(portbench/cells/<cell>.json). The last line of standard output is the
result as one JSON object; the compared numbers, each beside its limit,
are the last lines of standard error.

Exits 2, printing no result, without as many CUDA cards as the cell asks
for, and 3 when a module of JAX or of the JAX package (jax, jaxlib, flax,
fedrann_tpu, by whole top-level name) is loaded once the window has
closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import cells  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "fedrann_tpu")
GIB = float(1 << 30)
SEED_MASK = (1 << 64) - 1


def read_set_seeds(seed: int) -> tuple[int, int]:
    """The seeds of the two read sets: --seed itself, and one derived from
    it (an LCG step), both in [0, 2**64)."""
    a = seed & SEED_MASK
    return a, (a * 6364136223846793005 + 1442695040888963407) & SEED_MASK


def check_rows(seed: int, job: int, n_rows: int, count: int):
    """The query rows of job `job` the reference judges: `count` distinct
    rows drawn from the seed and the job's number."""
    import numpy as np

    rng = np.random.default_rng([seed & SEED_MASK, job])
    return np.sort(rng.choice(n_rows, size=min(count, n_rows),
                              replace=False))


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def program(cell: cells.Cell, n_reads: int, device):
    """The system under test for `cell`: (its PipelineConfig, its route,
    a job: rows -> (indices, distances)). The flags resolve as a user's
    would through cli.config_from_args; -i and -o are placeholders that the
    search neither reads nor writes. The mesh is the cell's first `chips`
    cards, and --knn-sharded auto shards over it where it holds more than
    one, as run_pipeline decides."""
    import torch

    from fedrann_tpu_torch import pipeline
    from fedrann_tpu_torch.cli import config_from_args
    from fedrann_tpu_torch.logging_utils import set_logging_level
    from fedrann_tpu_torch.metrics import StageMetrics

    scratch = Path(tempfile.gettempdir())
    config = config_from_args(["-i", str(scratch / "portbench-reads.fa"),
                               "-o", str(scratch / "portbench-out"),
                               *cell.flags])
    set_logging_level("WARNING")
    ooc = pipeline.out_of_core(config, n_reads)
    mesh = ([torch.device("cuda", i) for i in range(cell.chips)]
            if device.type == "cuda" else [device])
    use_mesh = config.knn_sharded == "always" or (
        config.knn_sharded == "auto" and len(mesh) > 1)
    route = (("ivf" if config.knn_method == "ivf" else "exact")
             + ("_ooc" if ooc else "_sharded" if use_mesh else ""))
    metrics = StageMetrics(device)

    def job(rows):
        return pipeline.search(config, rows, ooc, use_mesh, mesh, device,
                               metrics)

    job.config = config
    return config, route, job


def judge(cell: cells.Cell, k: int, sets, samples,
          held) -> tuple[dict, float]:
    """The reference's verdict, once the window has closed: (the compared
    numbers, the truth recall). Each read set's sampled answers of every
    job on every number the cell's limits name, and every answer of its
    last job on dist_err, against the exact search in float32; the truth
    recall of each read set's last job over every true pair (overlap of at
    least the mix's share of the mean read length)."""
    import numpy as np

    from portbench.gen import truth_pairs
    from portbench.reference import knn as ref
    from portbench.reference.recall import truth_found

    readings, found, pairs = [], 0, 0
    min_overlap = round(cell.mix["truth_overlap_share"]
                        * cell.config["dataset"]["mean_read_length"])
    for s, rs in enumerate(sets):
        unit = ref.unit_rows(rs.rows)
        mine = [x for x in samples if x[0] == s]
        if mine:
            readings.append(ref.judge(
                rs.rows, *(np.concatenate([x[i] for x in mine])
                           for i in (1, 2, 3)), k, cell.limits, unit))
        idx, dist = held[s]
        readings.append(ref.judge(rs.rows, np.arange(rs.rows.shape[0]),
                                  idx, dist, k, {"dist_err"}, unit))
        del unit
        truth = truth_pairs(rs.layout, min_overlap)
        found += truth_found(idx, truth)
        pairs += truth.shape[0]
    return ref.merge_readings(readings), found / max(pairs, 1)


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device, t0: float, wrap=None, log=print) -> tuple[dict, list]:
    """One run of `cell` on `device`: (the result object, the lines of
    the compared numbers). `wrap` (for the fault tests) wraps the job."""
    import torch

    from fedrann_tpu_torch.knn.ivf import knn_ivf
    from portbench import trace as tr
    from portbench.gen import Dataset, Features, make_read_set
    from portbench.reference.knn import BROKEN
    from portbench.window import rate, run_window

    ds = Dataset(**cell.config["dataset"])
    config, route, job = program(cell, ds.n_reads, device)
    if wrap is not None:
        job = wrap(job)
    ft = Features(config.kmer_size, config.kmer_sample_fraction,
                  config.kmer_min_multiplicity, config.embedding_dimension,
                  config.projection_density)
    cuda = device.type == "cuda"

    def mark(what: str) -> None:
        if cuda:
            torch.cuda.synchronize(device)
        marks.append(f"{what} at {time.perf_counter() - t0:.3f}")

    marks: list = []
    mark("start")
    sets = []
    for s in read_set_seeds(seed):
        sets.append(make_read_set(ds, ft, s, device))
        mark(f"read set {len(sets)}")
    n_rows = sets[0].rows.shape[0]
    k = min(config.n_neighbors, n_rows)
    held: list = [None, None]
    for s in (0, 1):  # warm-up: every kernel built, every cache filled
        held[s] = job(sets[s].rows)
        mark(f"warm-up job {s + 1}")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    samples, ivf_stats, releases = [], [], []
    failed = 0

    def one_job(j: int) -> None:
        nonlocal failed
        s = j % 2
        start = time.perf_counter()
        with torch.profiler.record_function(tr.RELEASE):
            held[s] = None  # the read set's previous result goes first
        releases.append(time.perf_counter() - start)
        ran_ivf = (knn_ivf.calls, knn_ivf.exact_fallbacks)
        with torch.profiler.record_function(tr.SEARCH):
            idx, dist = job(sets[s].rows)
        with torch.profiler.record_function(tr.COLLECT):
            failed += idx.shape != (n_rows, k) or dist.shape != idx.shape
            q = check_rows(seed, j, n_rows, int(cell.mix[
                "check_rows_per_job"]))
            samples.append((s, q, idx[q].copy(), dist[q].copy()))
            held[s] = (idx, dist)
            # the IVF's own counts, where this job ran it (and did not
            # fall back to the exact search)
            if trace and knn_ivf.calls > ran_ivf[0] \
                    and knn_ivf.exact_fallbacks == ran_ivf[1]:
                ivf_stats.append(dict(knn_ivf.last))

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if cuda else []))
        prof.__enter__()
    try:
        with torch.profiler.record_function(tr.WINDOW):
            win = run_window(one_job, seconds)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # the reference, once the window has closed and the peak is read
    if cuda:
        torch.cuda.empty_cache()
    closed = time.perf_counter()
    checks, recall = judge(cell, k, sets, samples, held)
    log(f"portbench: {cell.name}: set-up {win.opened - t0:.3f} s ("
        + ", ".join(marks) + f"), {len(win.jobs)} jobs in "
        f"{win.seconds:.3f} s, route {route}, the reference "
        f"{time.perf_counter() - closed:.3f} s; job seconds "
        + " ".join(f"{b - a:.4f}" for a, b in win.jobs)
        + "; of which the release of the previous result "
        + " ".join(f"{r:.4f}" for r in releases), file=sys.stderr)

    limits = cell.limits
    result = {"correct": failed == 0 and set(checks) == set(limits)
              and all(checks[n] <= limits[n] for n in limits),
              "attempted": len(win.jobs), "failed": failed}
    device_line = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        ctx = tr.Context(tr.from_profiler(prof), route, config.knn_precision,
                         n_rows, config.embedding_dimension, k,
                         len(win.jobs), ivf_stats)
        values = {m["name"]: cells.load_reader(m["name"])(ctx)
                  for m in cell.per_layer}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.per_layer
                             if values[m["name"]] is not None}
        device_line.update(busy_s=ctx.trace.busy_s,
                           window_s=ctx.trace.window_s)
        result["device"] = device_line
        result["breakdown"] = tr.breakdown(ctx.trace)
    else:
        e2e = {"reads_per_s": rate(win, ds.n_reads),
               "truth_recall": recall,
               "peak_device_gib": peak / GIB,
               "setup_s": win.opened - t0}
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = device_line
    result["checks"] = {n: {"value": checks.get(n, BROKEN),
                            "limit": limits[n]} for n in limits}
    lines = [f"check {n} {c['value']!r} limit {c['limit']!r}"
             for n, c in result["checks"].items()]
    return result, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = cells.resolve(cells.load_benchmark(ROOT), args.workload)

    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s), "
              f"this machine shows {found}; no result", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, lines = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), device, T0)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package loaded: {loaded}; no "
              "result", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
