#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (fedrann_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from fedrann_tpu_torch/csrc/;
  3. run each kernel against its plain PyTorch version on the card, at the
     shapes of the main-path run below: canonical_sample and
     select_candidates must match bitwise (dropped counts included),
     membership_embed to rtol 1e-5, atol 1e-6 * max|mags| * hits (float32
     sums taken in another order);
  4. drive the main path through fedrann_tpu_torch.cli.main on ~7,500
     simulated reads (5 Mb genome, 12x, 8 kb, 5% error) with the flags of
     the bench.py workload (k=15, 5% sampling, d=512, 50 neighbors), with every
     kernel's launch count reset just before: overlaps.tsv must hold 50
     neighbor slots per embedding row less the self rows, every kernel must
     have launched, and the truth recall of pairs overlapping >= 4 kb must
     reach 0.9.
The second-to-last line is a JSON object of per-kernel launches, errors and
times; the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GENOME, COVERAGE, READ_LEN, ERROR_RATE, SIM_SEED = 5_000_000, 12, 8000, 0.05, 1234
FLAGS = ["-k", "15", "--kmer-sample-fraction", "0.05",
         "--kmer-min-multiplicity", "2", "-n", "512",
         "--nndescent-n-neighbors", "50", "--seed", "602"]
MIN_OVERLAP, MIN_RECALL = 4000, 0.9


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_cuda(fn, reps: int) -> float:
    """Milliseconds per call of fn on the current stream (one warm-up)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernels(fasta: str, out_dir: str, dev) -> dict:
    """Phase 3: each kernel vs its plain version at the main-path shapes
    (the first staging chunk of the largest length bucket)."""
    import torch

    from fedrann_tpu_torch import pipeline
    from fedrann_tpu_torch.cli import config_from_args
    from fedrann_tpu_torch.kmers.codec import (
        _canonical_sample_plain,
        canonical_sample,
        sample_threshold,
    )
    from fedrann_tpu_torch.kmers.library import build_library
    from fedrann_tpu_torch.kmers.membership import (
        _select_candidates_plain,
        select_candidates,
    )
    from fedrann_tpu_torch.project.embed import (
        _membership_embed_plain,
        membership_embed,
    )
    from fedrann_tpu_torch.project.srp import build_precompute_signs

    config = config_from_args(["-i", fasta, "-o", out_dir, *FLAGS])
    packed = pipeline.load_reads(config)
    bucket = max(packed.buckets, key=lambda b: b.length)
    rows = pipeline.chunk_rows(bucket.length, bucket.bases.shape[0], config)
    bases = torch.from_numpy(bucket.bases[:rows]).to(dev)
    hit_buffer, keep_all, block_cap = pipeline.staging_params(bucket.length,
                                                              config)
    k, seed = config.kmer_size, config.seed
    thr = sample_threshold(config.kmer_sample_fraction)
    log(f"kernel shapes: bases {tuple(bases.shape)} k={k} "
        f"hit_buffer={hit_buffer} block_cap={block_cap}")
    report = {}

    slots = canonical_sample(bases, k, seed, thr, keep_all)
    slots_p = _canonical_sample_plain(bases, k, seed, thr, keep_all)
    if not torch.equal(slots, slots_p):
        fail(f"canonical_sample differs from its plain version in "
             f"{int((slots != slots_p).sum())} slots")
    report["canonical_sample"] = dict(
        max_abs_err=0.0,
        ms=time_cuda(lambda: canonical_sample(bases, k, seed, thr, keep_all), 10),
        plain_ms=time_cuda(
            lambda: _canonical_sample_plain(bases, k, seed, thr, keep_all), 3))

    staged, dropped = select_candidates(slots, hit_buffer, keep_all, block_cap)
    staged_p, dropped_p = _select_candidates_plain(slots, hit_buffer,
                                                   keep_all, block_cap)
    if not (torch.equal(staged, staged_p) and torch.equal(dropped, dropped_p)):
        fail("select_candidates differs from its plain version")
    report["select_candidates"] = dict(
        max_abs_err=0.0,
        ms=time_cuda(lambda: select_candidates(slots, hit_buffer, keep_all,
                                               block_cap), 10),
        plain_ms=time_cuda(lambda: _select_candidates_plain(
            slots, hit_buffer, keep_all, block_cap), 3))

    library = build_library([staged], config.kmer_min_multiplicity,
                            config.kmer_sample_fraction, seed)
    signs, mags = build_precompute_signs(
        library.counts, config.embedding_dimension, config.projection_seed,
        config.projection_density)
    r = staged.shape[0]
    ids = torch.arange(r, dtype=torch.int64, device=dev)
    targets = torch.stack([2 * ids, 2 * ids + 1], dim=1)
    out = torch.zeros((2 * r, config.embedding_dimension), device=dev)
    out_p = torch.zeros_like(out)
    n_hits = membership_embed(staged, library.codes, signs, mags, targets, out)
    n_hits_p = _membership_embed_plain(staged, library.codes, signs, mags,
                                       targets, out_p)
    if not torch.equal(n_hits, n_hits_p):
        fail("membership_embed hit counts differ from its plain version")
    atol = 1e-6 * float(mags.abs().max()) * max(int(n_hits.max()), 1)
    err = float((out - out_p).abs().max())
    if not (torch.isfinite(out).all()
            and torch.allclose(out, out_p, rtol=1e-5, atol=atol)):
        fail(f"membership_embed differs from its plain version: max abs "
             f"error {err} (atol {atol})")
    log(f"membership_embed: library {library.size} k-mers, "
        f"mean hits/row {float(n_hits.float().mean()):.1f}, max abs error "
        f"{err} (atol {atol})")
    report["membership_embed"] = dict(
        max_abs_err=err,
        ms=time_cuda(lambda: membership_embed(staged, library.codes, signs,
                                              mags, targets, out), 10),
        plain_ms=time_cuda(lambda: _membership_embed_plain(
            staged, library.codes, signs, mags, targets, out_p), 3))
    return report


def read_overlaps(path: str, names: list[str]):
    """(header, rows per (query, orientation), '+'-row neighbor read sets)."""
    index = {n: i for i, n in enumerate(names)}
    per_query: dict[tuple[str, str], int] = {}
    nbrs: dict[int, set[int]] = {}
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        for line in f:
            q, qo, t, _to, _rank, dist = line.rstrip("\n").split("\t")
            per_query[(q, qo)] = per_query.get((q, qo), 0) + 1
            if not 0.0 <= float(dist) <= 2.001:
                fail(f"distance {dist} outside [0, 2]")
            if qo == "+":
                nbrs.setdefault(index[q], set()).add(index[t])
    return header, per_query, nbrs


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, HERE)
    try:
        import fedrann_tpu_torch  # noqa: F401
        from fedrann_tpu_torch import _build
        from fedrann_tpu_torch.cli import main as cli_main
        from fedrann_tpu_torch.device import get_device
        from fedrann_tpu_torch.io.tsv import HEADER
        from fedrann_tpu_torch.kmers.codec import canonical_sample
        from fedrann_tpu_torch.kmers.membership import select_candidates
        from fedrann_tpu_torch.project.embed import membership_embed
        from fedrann_tpu_torch.sim import simulate_reads, write_fasta
    except ImportError as e:
        fail(f"cannot import the port from {HERE}: {e}")

    dev = get_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    so = _build.build()
    _build.kernels()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.basename(so)}")
    build_log = str(so) + ".log"
    if os.path.exists(build_log):
        for line in open(build_log).read().splitlines():
            if "registers" in line or "error" in line.lower():
                log(f"  ptxas: {line.strip()}")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sim = simulate_reads(genome_length=GENOME, coverage=COVERAGE,
                             mean_read_length=READ_LEN,
                             error_rate=ERROR_RATE, seed=SIM_SEED)
        fasta = os.path.join(tmp, "reads.fasta")
        write_fasta(fasta, sim.names, sim.sequences)
        n_reads = len(sim.names)
        log(f"simulated {n_reads} reads in {time.perf_counter() - t0:.1f} s")

        report = check_kernels(fasta, os.path.join(tmp, "check"), dev)
        for name, r in report.items():
            log(f"kernel {name}: {r['ms']:.4f} ms vs plain "
                f"{r['plain_ms']:.4f} ms, max abs error {r['max_abs_err']} "
                f"[{card}]")

        wrappers = {"canonical_sample": canonical_sample,
                    "select_candidates": select_candidates,
                    "membership_embed": membership_embed}
        for fn in wrappers.values():
            fn.launches = 0
        out_dir = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        rc = cli_main(["-i", fasta, "-o", out_dir, *FLAGS])
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        if rc != 0:
            fail(f"cli.main returned {rc}")
        for name, n in launches.items():
            if n <= 0:
                fail(f"kernel {name} was not launched by the main path")
        log(f"main path launches: {launches}")

        with open(os.path.join(out_dir, "metrics.json")) as f:
            stages = json.load(f)
        secs = {s: stages[s]["seconds"] for s in
                ("load", "stage", "count", "project", "embed", "knn",
                 "output")}
        log(f"stage seconds [{card}]: "
            + ", ".join(f"{s} {v:.3f}" for s, v in secs.items()))
        log(f"main path: {n_reads} reads in {wall:.2f} s wall = "
            f"{n_reads / wall:.1f} reads/s; device stages (stage..knn) "
            f"{sum(secs[s] for s in ('stage', 'count', 'project', 'embed', 'knn')):.3f} s "
            f"[{card}]")

        header, per_query, nbrs = read_overlaps(
            os.path.join(out_dir, "overlaps.tsv"), sim.names)
        if header != HEADER.rstrip("\n").split("\t"):
            fail(f"bad overlaps.tsv header {header}")
        n_rows = sum(per_query.values())
        if len(per_query) != 2 * n_reads or not all(
                c in (49, 50) for c in per_query.values()):
            fail(f"overlaps.tsv: {len(per_query)} queries (want "
                 f"{2 * n_reads}), rows per query "
                 f"{sorted(set(per_query.values()))} (want 50 less self)")
        log(f"overlaps.tsv: {n_rows} rows = {2 * n_reads} x 50 less "
            f"{2 * n_reads * 50 - n_rows} self rows")

        truth = sim.truth_overlaps(min_overlap=MIN_OVERLAP)
        found = sum(1 for a, b in truth
                    if b in nbrs.get(a, ()) or a in nbrs.get(b, ()))
        recall = found / max(len(truth), 1)
        log(f"truth recall (overlap >= {MIN_OVERLAP}): {recall:.4f} over "
            f"{len(truth)} pairs")
        if not truth or recall < MIN_RECALL:
            fail(f"truth recall {recall:.4f} below {MIN_RECALL}")

    if "jax" in sys.modules or "fedrann_tpu" in sys.modules:
        fail("the port imported jax or fedrann_tpu")
    sources = {
        "canonical_sample": ("fedrann_tpu_torch/csrc/canonical_sample.cu",
                             "bench/pallas_kernels.py:128"),
        "select_candidates": ("fedrann_tpu_torch/csrc/select_stage_rows.cu",
                              "bench/pallas_sort.py:128"),
        "membership_embed": ("fedrann_tpu_torch/csrc/membership_embed.cu",
                             "bench/pallas_embed.py:277"),
    }
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": report[name]["max_abs_err"],
         "ms": report[name]["ms"], "plain_ms": report[name]["plain_ms"]}
        for name in wrappers]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
