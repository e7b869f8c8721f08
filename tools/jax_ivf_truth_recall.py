#!/usr/bin/env python3
"""The JAX package's own truth recall with --knn-method ivf on the reads
and flags of chip_smoke.py's main path (phase 4), on the CPU: the
reference figure chip_smoke.py phase 11a holds the port's IVF run to.

    JAX_PLATFORMS=cpu python3 tools/jax_ivf_truth_recall.py [out_dir]

Simulates phase 4's reads with fedrann_tpu_torch.sim (the generator
chip_smoke.py uses), runs fedrann_tpu.pipeline.run_pipeline on one CPU
device with chip_smoke.FLAGS + --knn-method ivf, and scores its
overlaps.tsv as chip_smoke.py scores every CLI run
(fedrann_tpu_torch.eval.truth_recall over the pairs overlapping >=
MIN_OVERLAP, every row, both orientations). Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> None:
    import chip_smoke as cs
    from fedrann_tpu.cli import config_from_args
    from fedrann_tpu.pipeline import run_pipeline
    from fedrann_tpu_torch.eval import truth_recall
    from fedrann_tpu_torch.sim import simulate_reads, write_fasta

    out = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp()
    sim = simulate_reads(genome_length=cs.GENOME, coverage=cs.COVERAGE,
                         mean_read_length=cs.READ_LEN,
                         error_rate=cs.ERROR_RATE, seed=cs.SIM_SEED)
    fasta = os.path.join(out, "reads.fasta")
    write_fasta(fasta, sim.names, sim.sequences)
    flags = [*cs.FLAGS, "--knn-method", "ivf"]
    truth = sim.truth_overlaps(min_overlap=cs.MIN_OVERLAP)

    def report(package: str, sub: str, secs: float, **extra) -> None:
        rows = cs.tsv_neighbor_rows(os.path.join(out, sub, "overlaps.tsv"),
                                    sim.names)
        print(json.dumps({
            "package": package, "reads": len(sim.names), "flags": flags,
            "min_overlap": cs.MIN_OVERLAP, "pairs": len(truth),
            "truth_recall": truth_recall(rows, truth, len(sim.names)),
            "seconds": secs, **extra}), flush=True)

    t0 = time.perf_counter()
    run_pipeline(config_from_args(["-i", fasta, "-o",
                                   os.path.join(out, "ivf"), *flags]))
    report("fedrann_tpu (JAX, CPU)", "ivf", time.perf_counter() - t0)

    import torch

    from fedrann_tpu_torch.cli import config_from_args as port_config
    from fedrann_tpu_torch.knn.ivf import knn_ivf
    from fedrann_tpu_torch.pipeline import run_pipeline as port_run

    t0 = time.perf_counter()
    port_run(port_config(["-i", fasta, "-o", os.path.join(out, "port"),
                          *flags]), torch.device("cpu"))
    report("fedrann_tpu_torch (plain versions, CPU)", "port",
           time.perf_counter() - t0, knn_ivf=knn_ivf.last)


if __name__ == "__main__":
    main()
