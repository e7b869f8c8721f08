"""The port's out-of-core IVF search (fedrann_tpu_torch/knn/ooc.py
`knn_ivf_ooc`, plain torch ops on the CPU) against the JAX package's
`fedrann_tpu/knn/ooc.py` on the same numpy rows (tests/test_knn_ooc.py's
rank-16 rows), and through the CLI past --knn-hbm-budget:

- recall against knn_exact >= the port's in-core knn_ivf's - 1e-9 at the
  same (C, p, spill), self at rank 0, every distance within 6e-2 of a
  recompute (the bf16 rows and the u16 wire), neighbor agreement with
  JAX's knn_ivf_ooc >= 0.99, on both wires;
- three slabs under a small budget, on tight blobs: JAX's block
  selection (the uploads and dropped votes JAX logs) and agreement >=
  0.99 with JAX;
- _centroid_order equal to JAX's on the same centroids;
- below the small-N valve, knn_exact_ooc's result exactly;
- the CLI with C = p = 16 in tests/test_knn_ooc.py's setting against
  the in-core exact CLI, at its 4M budget (in core) and at 1M (out of
  core): recall > 0.99.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fedrann_tpu.knn import ooc as jooc
from fedrann_tpu_torch.knn import ooc
from fedrann_tpu_torch.knn.ivf import knn_ivf
from fedrann_tpu_torch.knn.topk import knn_exact

from test_knn_ooc import _emb, _recall

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def rows():
    emb = _emb(6000, 64, seed=3)
    ref, _ = knn_exact(torch.from_numpy(emb), 10, transfer="f32")
    return emb, ref


@pytest.mark.parametrize("transfer", ["f32", "u16"])
def test_ivf_ooc_matches_ivf_recall(rows, transfer):
    emb, ref = rows
    n, k = emb.shape[0], 10
    idx_i, _ = knn_ivf(torch.from_numpy(emb), k, n_clusters=64, n_probes=8,
                       spill=2, transfer="f32")
    before = ooc.knn_ivf_ooc.calls, ooc.knn_ivf_ooc.exact_fallbacks
    kw = dict(hbm_budget=1 << 26, n_clusters=64, n_probes=8, spill=2,
              block_rows=1024, query_tile=256, transfer=transfer)
    idx_o, dist_o = ooc.knn_ivf_ooc(emb, k, device=CPU, **kw)
    assert (ooc.knn_ivf_ooc.calls, ooc.knn_ivf_ooc.exact_fallbacks) == (
        before[0] + 1, before[1])
    assert idx_o.shape == ref.shape
    assert _recall(idx_o, ref) >= _recall(idx_i, ref) - 1e-9
    assert (idx_o[:, 0] == np.arange(n)).mean() > 0.99
    en = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    true = 1.0 - np.einsum("rd,rkd->rk", en, en[idx_o])
    assert np.abs(dist_o - true).max() < 6e-2
    assert (np.diff(dist_o, axis=1) >= 0).all()
    idx_j, _ = jooc.knn_ivf_ooc(emb, k, **kw)
    assert _recall(idx_o, np.asarray(idx_j)) >= 0.99


def test_ivf_ooc_selects_blocks_as_jax(monkeypatch):
    """Tight blobs (tests/test_knn_ivf.py's), C = 256 over 40 blobs, so a
    query's probes stay in its blob, at a 1.3 MiB budget: three query
    slabs, each uploading its own blocks and those with >= 0.1% of its
    probe votes, some votes dropped. The port's plan counts more of what
    a slab holds than JAX's, so JAX's run is given the port's slab rows
    (its plan_ooc patched); then the uploads and the dropped-vote share
    equal the ones JAX logs (the same k-means within float32 sums, the
    same reordering), and the neighbors agree >= 0.99."""
    import logging
    import re

    from fedrann_tpu.logging_utils import logger as jax_logger
    from test_knn_ivf import _clustered_embeddings

    emb = _clustered_embeddings(8000, 64, 40, np.random.default_rng(11))
    kw = dict(hbm_budget=int(1.3 * (1 << 20)), n_clusters=256, n_probes=4,
              spill=2, block_rows=256, query_tile=128, transfer="f32")
    before = ooc.knn_ivf_ooc.blocks_uploaded
    idx_o, _ = ooc.knn_ivf_ooc(emb, 10, device=CPU, **kw)
    last = ooc.knn_ivf_ooc.last
    assert last["slabs"] == 3 and last["uploads"] < last["exact_uploads"]
    assert 0 < last["dropped_votes"]
    assert ooc.knn_ivf_ooc.blocks_uploaded - before == last["uploads"]
    monkeypatch.setattr(jooc, "plan_ooc",
                        lambda *args: (last["q_rows"], None))
    lines: list[str] = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    jax_logger.addHandler(handler)
    try:
        idx_j, _ = jooc.knn_ivf_ooc(emb, 10, **kw)
    finally:
        jax_logger.removeHandler(handler)
    m = re.search(r"-> (\d+)/(\d+) candidate-block uploads .*?; "
                  r"([\d.]+)% of probe votes", "\n".join(lines))
    assert m, lines
    assert (last["uploads"], last["exact_uploads"]) == (int(m.group(1)),
                                                        int(m.group(2)))
    dropped = 100.0 * last["dropped_votes"] / last["votes"]
    assert abs(dropped - float(m.group(3))) < 1e-3
    assert _recall(idx_o, np.asarray(idx_j)) >= 0.99


def test_centroid_order_matches_jax():
    rng = np.random.default_rng(0)
    cent = rng.standard_normal((200, 32)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    cent[50] = cent[7]  # a tie: the lowest id first
    np.testing.assert_array_equal(ooc._centroid_order(cent),
                                  jooc._centroid_order(cent))


def test_small_n_falls_back_to_exact_ooc():
    emb = _emb(700, 32, seed=1)
    before = ooc.knn_ivf_ooc.exact_fallbacks, ooc.knn_exact_ooc.slabs
    idx, dist = ooc.knn_ivf_ooc(emb, 10, 1 << 20, query_tile=64,
                                device=CPU)
    assert ooc.knn_ivf_ooc.exact_fallbacks == before[0] + 1
    assert ooc.knn_exact_ooc.slabs > before[1]
    ref_i, ref_d = ooc.knn_exact_ooc(emb, 10, 1 << 20, query_tile=64,
                                     device=CPU)
    np.testing.assert_array_equal(idx, ref_i)
    np.testing.assert_array_equal(dist, ref_d)


@pytest.mark.parametrize("budget", ["4M", "1M"])
def test_pipeline_ivf_ooc_valve(tmp_path, budget):
    """--knn-method ivf --knn-hbm-budget with C = p = 16 in
    tests/test_knn_ooc.py's setting on a longer genome (150 kb, so that
    the smallest budget the CLI takes, 1M, passes the valve): 4M keeps
    its (2R, 128) matrix in core (knn_ivf runs, as in the JAX package),
    1M does not (knn_ivf_ooc runs, through the streamed search). Every
    cluster is scored, so the neighbor sets are the in-core exact run's
    (recall > 0.99); knn_exact_ooc does not run."""
    from fedrann_tpu_torch.cli import config_from_args
    from fedrann_tpu_torch.knn import ivf
    from fedrann_tpu_torch.pipeline import run_pipeline
    from fedrann_tpu_torch.sim import simulate_reads, write_fasta

    sim = simulate_reads(genome_length=150_000, coverage=8,
                         mean_read_length=1500, error_rate=0.02, seed=11)
    fasta = str(tmp_path / "reads.fasta")
    write_fasta(fasta, sim.names, sim.sequences)
    base = ["-i", fasta, "-k", "13", "--kmer-sample-fraction", "0.2",
            "--kmer-min-multiplicity", "2", "-n", "128",
            "--nndescent-n-neighbors", "10", "--seed", "7",
            "--length-buckets", "2048"]
    exact = run_pipeline(config_from_args(
        base + ["-o", str(tmp_path / "exact")]), CPU)
    before = (ooc.knn_ivf_ooc.calls, ooc.knn_ivf_ooc.exact_fallbacks,
              ooc.knn_exact_ooc.slabs, ivf.knn_ivf.calls)
    got = run_pipeline(config_from_args(base + [
        "-o", str(tmp_path / "ivf"), "--knn-method", "ivf",
        "--knn-ivf-clusters", "16", "--knn-ivf-probes", "16",
        "--knn-hbm-budget", budget]), CPU)
    ooc_run = budget == "1M"
    assert (ooc.knn_ivf_ooc.calls, ooc.knn_ivf_ooc.exact_fallbacks,
            ooc.knn_exact_ooc.slabs, ivf.knn_ivf.calls) == (
        before[0] + ooc_run, before[1], before[2], before[3] + 1 - ooc_run)
    # out of core the matrix is a host bfloat16 one
    assert (got.embeddings.dtype == torch.bfloat16) == ooc_run
    assert _recall(got.neighbor_indices, exact.neighbor_indices) > 0.99
    assert (got.metrics["knn"].get("h2d_bytes", 0) > 0) == ooc_run
