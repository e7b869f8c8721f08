"""fedrann_tpu_torch library build against the JAX device build (as the JAX
pipeline drives it, from the staged candidates) and the numpy oracle:
codes and counts bitwise."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedrann_tpu import oracle
from fedrann_tpu.kmers import membership as jmem
from fedrann_tpu.kmers.library_device import build_library_on_device
from fedrann_tpu_torch.convert import library_words_to_codes
from fedrann_tpu_torch.io.fastx import FastxRecord
from fedrann_tpu_torch.io.packing import pack_reads
from fedrann_tpu_torch.kmers.codec import sample_threshold
from fedrann_tpu_torch.kmers.library import build_library
from fedrann_tpu_torch.kmers.membership import (
    selection_cap,
    stage_candidates,
    staging_width,
)
from fedrann_tpu_torch.sim import simulate_reads

SEED = 17


@pytest.mark.parametrize("k,fraction", [(13, 0.3), (21, 0.3), (13, 1.0)])
def test_library_matches_jax_and_oracle(k, fraction):
    sim = simulate_reads(genome_length=8000, coverage=6, mean_read_length=900,
                         error_rate=0.01, seed=5)
    bases = pack_reads(
        [FastxRecord(n, s) for n, s in zip(sim.names, sim.sequences)],
        length_buckets=(2048,)).buckets[0].bases
    w = bases.shape[1] - k + 1
    keep_all = fraction >= 1.0
    hb = w if keep_all else staging_width(w, fraction)
    cap = None if keep_all else selection_cap(fraction)
    thr = sample_threshold(fraction)

    staged, dropped = stage_candidates(torch.from_numpy(bases), k, hb,
                                       keep_all, SEED, thr, cap)
    assert not dropped.any()
    lib = build_library([staged], 2, fraction, SEED)
    codes, counts = lib.numpy()

    planes, _ = jmem.stage_candidates(
        jnp.asarray(bases), k, hb, keep_all, jnp.uint32(SEED),
        jnp.uint32(thr), block_cap=cap)
    lib_j = build_library_on_device(
        [jmem.staged_codes(planes, k)], k, 2, fraction, SEED,
        presampled=fraction < 1.0)
    codes_j, counts_j = library_words_to_codes(
        tuple(np.asarray(wd) for wd in lib_j.words_dev),
        np.asarray(lib_j.counts_dev))
    np.testing.assert_array_equal(codes.astype(np.int64), codes_j)
    np.testing.assert_array_equal(counts, counts_j)

    lib_o = oracle.build_library(sim.sequences, k, 2, fraction, SEED)
    np.testing.assert_array_equal(codes, lib_o.codes)
    np.testing.assert_array_equal(counts, lib_o.counts)
    assert lib.size == len(lib_o.codes) > 0
