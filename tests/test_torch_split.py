"""Reads longer than the largest length bucket in fedrann_tpu_torch: the
split into k - 1-overlapped segments and the packing against the JAX
package's, the merged segment rows against the JAX package's per-segment
union, and the whole slice against JAX `run_pipeline` on the input of
tests/test_split_reads.py (a 100 kb read, buckets 2048 and 16384, k = 13):
library bitwise, embeddings to rtol 1e-5, the split read's rows nonzero."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fedrann_tpu.cli import config_from_args as jax_config
from fedrann_tpu.io.fastx import FastxRecord as JaxRecord
from fedrann_tpu.io.packing import pack_reads as jax_pack_reads
from fedrann_tpu.io.packing import segment_spans as jax_segment_spans
from fedrann_tpu.pipeline import run_pipeline as jax_run
from fedrann_tpu_torch import pipeline
from fedrann_tpu_torch.cli import config_from_args
from fedrann_tpu_torch.config import PipelineConfig
from fedrann_tpu_torch.io.fastx import FastxRecord
from fedrann_tpu_torch.io.packing import pack_reads, segment_spans
from fedrann_tpu_torch.kmers.library import build_library
from fedrann_tpu_torch.project.embed import embed_staged
from fedrann_tpu_torch.project.srp import (
    build_precompute_paired,
    build_precompute_signs,
)
from fedrann_tpu_torch.sim import simulate_reads, write_fasta

CPU = torch.device("cpu")
K = 13


@pytest.mark.parametrize("length,max_len,overlap", [
    (100_000, 16384, 12), (16385, 16384, 12), (32768, 16384, 20),
    (5, 4, 0), (1_000_000, 262144, 14), (262145, 262144, 30)])
def test_segment_spans_match_jax(length, max_len, overlap):
    spans = segment_spans(length, max_len, overlap)
    assert spans == jax_segment_spans(length, max_len, overlap)
    # every window of k = overlap + 1 bases lies in exactly one segment
    owned = [(s, s + n - overlap) for s, n in spans]
    assert owned[0][0] == 0 and owned[-1][1] == length - overlap
    assert all(a[1] == b[0] for a, b in zip(owned, owned[1:]))


def test_segment_spans_refuse_overlap_past_the_segment():
    with pytest.raises(ValueError, match="overlap"):
        segment_spans(100, 16, 16)


@pytest.mark.parametrize("split_overlap", [K - 1, None])
def test_pack_reads_split_matches_jax(split_overlap):
    """Split ids, per-bucket rows and read indices equal the JAX packer's;
    the last segment of a read sits in the smallest bucket that fits it;
    without a split overlap the read is truncated and counted."""
    rng = np.random.default_rng(3)
    seqs = ["".join("ACGTN"[b] for b in rng.integers(0, 5, n))
            for n in (900, 3000, 40_000, 5000, 17_000, 4096, 4097)]
    names = [f"r{i}" for i in range(len(seqs))]
    got = pack_reads([FastxRecord(n, q) for n, q in zip(names, seqs)],
                     (2048, 4096), split_overlap=split_overlap)
    want = jax_pack_reads([JaxRecord(n, q) for n, q in zip(names, seqs)],
                          (2048, 4096), split_overlap=split_overlap)
    assert got.names == want.names
    assert got.n_truncated == want.n_truncated
    if split_overlap is None:
        assert got.split_read_ids is None and got.n_truncated == 4
    else:
        np.testing.assert_array_equal(got.split_read_ids,
                                      want.split_read_ids)
        assert list(got.split_read_ids) == [2, 3, 4, 6]
    assert len(got.buckets) == len(want.buckets)
    for b, wb in zip(got.buckets, want.buckets):
        np.testing.assert_array_equal(b.bases, wb.bases)
        np.testing.assert_array_equal(b.read_index, wb.read_index)


def _split_case(dense: bool):
    """Staged buckets (on the CPU) of reads with two split reads, their
    sampled library and projection."""
    rng = np.random.default_rng(11)
    genome = "".join("ACGT"[b] for b in rng.integers(0, 4, 60_000))
    seqs = [genome[s : s + 3000] for s in rng.integers(0, 57_000, 30)]
    seqs += [genome[1000:41_000], genome[20_000:29_000]]
    packed = pack_reads([FastxRecord(f"r{i}", q) for i, q in
                         enumerate(seqs)], (4096, 8192), split_overlap=14)
    config = PipelineConfig(kmer_size=15, kmer_sample_fraction=0.3)
    staged = pipeline.stage_reads(packed, config, CPU)
    library = build_library([b.staged for b in staged], 2, 0.3, config.seed)
    proj = (build_precompute_paired(library.counts, 64, 2094) if dense
            else build_precompute_signs(library.counts, 64, 2094))
    return staged, library, proj


@pytest.mark.parametrize("dense", [False, True])
def test_merged_rows_embed_the_exact_union(dense):
    """Each merged row is its read's segment slots sorted, PAD_SLOT-padded
    to a multiple of 8; embedding it (the plain versions of kernel C) gives
    the JAX package's union: per-segment hits, unique, embedded."""
    staged, library, proj = _split_case(dense)
    split = torch.tensor([30, 31])
    rows = pipeline.split_union_rows(staged, split)
    assert rows.shape[1] % 8 == 0
    for i, rid in enumerate(split.tolist()):
        segs = torch.cat([b.staged[b.read_index == rid].reshape(-1)
                          for b in staged])
        segs = torch.sort(segs[segs != pipeline.PAD_SLOT]).values
        assert torch.equal(rows[i, : segs.shape[0]], segs)
        assert (rows[i, segs.shape[0]:] == pipeline.PAD_SLOT).all()
    out = torch.zeros((64, 64))
    n = embed_staged(rows, library.codes, proj,
                     torch.stack([2 * split, 2 * split + 1], dim=1), out)
    fwd, rev = pipeline._split_union_plain(staged, split, library.codes,
                                           proj, 64)
    scale = proj.abs().max() if dense else proj[1].abs().max()
    atol = 1e-6 * float(scale) * int(n.max())
    torch.testing.assert_close(out[60::2], fwd, rtol=1e-5, atol=atol)
    torch.testing.assert_close(out[61::2], rev, rtol=1e-5, atol=atol)
    assert int(n.min()) > 0 and (out[:60] == 0).all()


@pytest.mark.parametrize("dense", [False, True])
def test_split_union_in_two_groups(dense):
    """A union budget of one merged row's slots cuts the two split reads
    into two groups, the read with fewer slots first; twice that budget
    keeps them in one. The embeddings are the same either way."""
    staged, library, proj = _split_case(dense)
    split = torch.tensor([30, 31])
    width = pipeline.split_union_rows(staged, split).shape[1]
    groups = pipeline.split_union_groups(staged, split, width)
    assert [g.tolist() for g in groups] == [[31], [30]]
    assert [g.tolist() for g in pipeline.split_union_groups(
        staged, split, 2 * width)] == [[30, 31]]
    embs = [pipeline.compute_embeddings(32, staged, library, proj, 64,
                                        np.array([31, 30]), slots, CPU)
            for slots in (width, 2 * width)]
    assert torch.equal(embs[0], embs[1])
    assert (embs[0][60:].norm(dim=1) > 0).all()


def test_split_read_without_hits_is_a_zero_row():
    staged, library, proj = _split_case(False)
    split = torch.tensor([30, 31])
    empty = build_library([b.staged[:0] for b in staged], 2, 0.3, 1)
    assert empty.size == 0
    rows = pipeline.split_union_rows(staged, split)
    out = torch.full((64, 64), 7.0)
    n = embed_staged(rows, empty.codes, build_precompute_signs(
        empty.counts, 64, 2094), torch.stack([2 * split, 2 * split + 1],
                                             dim=1), out)
    assert (n == 0).all() and (out[60:] == 0).all()


@pytest.fixture(scope="module")
def long_read_input(tmp_path_factory):
    """tests/test_split_reads.py's input: reads of a 120 kb genome and one
    read of 100 kb, six times the largest bucket."""
    tmp = tmp_path_factory.mktemp("split")
    sim = simulate_reads(genome_length=120_000, coverage=4,
                         mean_read_length=2500, error_rate=0.02, seed=11)
    names = list(sim.names) + ["long_read"]
    seqs = list(sim.sequences) + [sim.genome[5_000:105_000]]
    path = str(tmp / "reads.fasta")
    write_fasta(path, names, seqs)
    return names, path


@pytest.mark.parametrize("dtype", ["signs", "f32"])
def test_split_read_matches_jax_pipeline(long_read_input, tmp_path, dtype):
    names, path = long_read_input
    args = ["-i", path, "-k", str(K), "--kmer-sample-fraction", "0.2",
            "--kmer-min-multiplicity", "2", "-n", "128",
            "--nndescent-n-neighbors", "10", "--seed", "602",
            "--length-buckets", "2048,16384", "--projection-dtype", dtype]
    res = pipeline.run_pipeline(
        config_from_args([*args, "-o", str(tmp_path / "torch")]), CPU)
    ref = jax_run(jax_config([*args, "-o", str(tmp_path / "jax")]))
    codes, counts = res.library.numpy()
    np.testing.assert_array_equal(codes, ref.library.codes)
    np.testing.assert_array_equal(counts, ref.library.counts)
    emb, emb_j = res.embeddings.numpy(), np.asarray(ref.embeddings)
    np.testing.assert_allclose(emb, emb_j, rtol=1e-5,
                               atol=1e-5 * np.abs(emb_j).max())
    last = len(names) - 1
    assert np.linalg.norm(emb[2 * last]) > 0
    assert np.linalg.norm(emb[2 * last + 1]) > 0
    agree = np.mean([len(set(a) & set(b)) / len(b) for a, b in
                     zip(res.neighbor_indices, ref.neighbor_indices)])
    assert agree >= 0.99, agree
    assert np.abs(res.neighbor_distances
                  - ref.neighbor_distances).max() < 5e-3
