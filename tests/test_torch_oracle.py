"""fedrann_tpu_torch's numpy oracle against `fedrann_tpu.oracle`, function
by function and end to end, on seeded inputs: integers, codes, hashes and
index sets bitwise; floats bitwise too (the same numpy operations in the
same order). The port's library is its own KmerLibrary (int64 codes)."""

from __future__ import annotations

import numpy as np
import pytest

from fedrann_tpu import oracle as jo
from fedrann_tpu.sim import simulate_reads
from fedrann_tpu_torch import oracle as po
from fedrann_tpu_torch.kmers.library import KmerLibrary


def _seqs(seed=3, n_reads=None):
    sim = simulate_reads(genome_length=6000, coverage=4,
                         mean_read_length=700, error_rate=0.03, seed=seed)
    seqs = list(sim.sequences[:n_reads])
    seqs[0] = seqs[0][:50] + "NNN" + seqs[0][53:]  # invalid windows
    seqs.append("ACG")                             # shorter than k
    return seqs


def _same_library(ours: KmerLibrary, theirs: jo.KmerLibrary):
    codes, counts = ours.numpy()
    assert np.array_equal(codes, theirs.codes)
    assert np.array_equal(counts, theirs.counts)
    assert ours.size == theirs.size and ours.n_features == theirs.n_features


@pytest.mark.parametrize("k", [5, 13, 31])
def test_codec_and_hashes_bitwise(k):
    rng = np.random.default_rng(k)
    bases = rng.integers(0, 5, 500).astype(np.uint8)
    codes = po.kmer_code(bases, k)
    assert np.array_equal(codes, jo.kmer_code(bases, k))
    assert np.array_equal(po.kmer_code(bases[: k - 1], k),
                          jo.kmer_code(bases[: k - 1], k))
    valid = codes[codes != po.INVALID_CODE]
    assert np.array_equal(po.revcomp_code(valid, k),
                          jo.revcomp_code(valid, k))
    assert np.array_equal(po.canonical_code(valid, k),
                          jo.canonical_code(valid, k))
    raw = rng.integers(0, 2**63, 1000, dtype=np.uint64)
    assert np.array_equal(po.splitmix64(raw), jo.splitmix64(raw))
    assert np.array_equal(po.fmix32(raw.astype(np.uint32)),
                          jo.fmix32(raw.astype(np.uint32)))
    for seed in (0, 7, 2**40 + 5):
        assert np.array_equal(po.sample_hash32(valid, seed),
                              jo.sample_hash32(valid, seed))
        for frac in (0.01, 0.3, 1.0):
            assert np.array_equal(po.sample_mask(valid, frac, seed),
                                  jo.sample_mask(valid, frac, seed))


@pytest.mark.parametrize("k,frac,mult", [(13, 0.4, 2), (15, 1.0, 1),
                                         (11, 0.05, 3)])
def test_library_rows_and_embedding_bitwise(k, frac, mult):
    seqs = _seqs()
    ours = po.build_library(seqs, k, mult, frac, 77)
    theirs = jo.build_library(seqs, k, mult, frac, 77)
    _same_library(ours, theirs)
    for seq in seqs[:5]:
        assert np.array_equal(po.read_feature_indices(seq, k, ours),
                              jo.read_feature_indices(seq, k, theirs))
    rows, rows_j = (po.feature_rows(seqs, k, ours),
                    jo.feature_rows(seqs, k, theirs))
    assert len(rows) == len(rows_j) == 2 * len(seqs)
    for a, b in zip(rows, rows_j):
        assert np.array_equal(a, b)
    feat = rows[0]
    assert np.array_equal(po.mirror_indices(feat, ours.size),
                          jo.mirror_indices(feat, theirs.size))
    assert np.array_equal(po.icf_weights(ours), jo.icf_weights(theirs))
    for density in (None, 0.2):
        assert np.array_equal(po.srp_matrix(ours.n_features, 24, 9, density),
                              jo.srp_matrix(theirs.n_features, 24, 9,
                                            density))
        emb = po.embed(rows, ours, 24, 9, density)
        assert np.array_equal(emb, jo.embed(rows_j, theirs, 24, 9, density))
    idx, dist = po.knn_cosine(emb, 6)
    idx_j, dist_j = jo.knn_cosine(emb, 6)
    assert np.array_equal(idx, idx_j) and np.array_equal(dist, dist_j)


def test_empty_library_and_inputs_match():
    """No reads: an empty library; a lookup in it fails in both (numpy
    indexes the empty code array)."""
    ours = po.build_library([], 13, 1, 0.5, 1)
    theirs = jo.build_library([], 13, 1, 0.5, 1)
    _same_library(ours, theirs)
    for mod, lib in ((po, ours), (jo, theirs)):
        assert len(mod.read_feature_indices("ACG", 13, lib)) == 0
        with pytest.raises(IndexError):
            mod.read_feature_indices("ACGTACGTACGTACGT", 13, lib)


def test_run_oracle_pipeline_bitwise():
    seqs = _seqs(seed=11)
    args = (seqs, 13, 0.3, 2, 32, 8, 5, 21)
    lib, emb, idx, dist = po.run_oracle_pipeline(*args)
    lib_j, emb_j, idx_j, dist_j = jo.run_oracle_pipeline(*args)
    _same_library(lib, lib_j)
    assert isinstance(lib, KmerLibrary)
    assert np.array_equal(emb, emb_j)
    assert np.array_equal(idx, idx_j) and np.array_equal(dist, dist_j)
