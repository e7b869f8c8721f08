#!/usr/bin/env python3
"""chip_smoke.py phase 11 (the IVF k-NN on every path) alone, on the
cards of this machine, with the phase 4 runs it compares with:

    python3 tools/chip_phase11.py

Builds the kernels and the host library, simulates phase 4's reads, runs
phase 4 through the CLI (its overlaps.tsv) and again with
--keep-intermediates (its library.npz), then chip_smoke.check_ivf: 11a-e,
with the multi-card cases (11d over every card, 11e over NCCL) where two
or more cards are visible. 11c's comparison with 8b is left out (8b does
not run here). Any failure exits non-zero.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> None:
    import torch

    import chip_smoke as cs
    from fedrann_tpu_torch import _build
    from fedrann_tpu_torch.device import get_device
    from fedrann_tpu_torch.sim import simulate_reads, write_fasta

    cs.register_counters()
    dev = get_device("cuda")
    card = f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}"
    _build.build()
    _build.kernels()
    _build.build_host()
    with tempfile.TemporaryDirectory() as tmp:
        sim = simulate_reads(genome_length=cs.GENOME, coverage=cs.COVERAGE,
                             mean_read_length=cs.READ_LEN,
                             error_rate=cs.ERROR_RATE, seed=cs.SIM_SEED)
        fasta = os.path.join(tmp, "reads.fasta")
        write_fasta(fasta, sim.names, sim.sequences)
        cs.drive_cli(fasta, os.path.join(tmp, "out"), sim, cs.MIN_OVERLAP,
                     card, dev)
        cs.drive_cli(fasta, os.path.join(tmp, "ckpt"), sim, cs.MIN_OVERLAP,
                     card, dev, [*cs.FLAGS, "--keep-intermediates"])
        t0 = time.perf_counter()
        launches = cs.check_ivf(
            fasta, os.path.join(tmp, "ivf"), sim, card, dev,
            os.path.join(tmp, "out", "overlaps.tsv"),
            os.path.join(tmp, "ckpt", "checkpoints", "library.npz"),
            float("nan"))
        cs.log(f"phase 11: {time.perf_counter() - t0:.1f} s; launches "
               f"{launches} [{card}]")


if __name__ == "__main__":
    main()
