"""Golden parity of fedrann_tpu_torch, the twins of
tests/test_golden_parity.py: the port (plain versions, on the CPU) runs on
bench/golden/data (k = 15) and data_k21 (k = 21) with the reference's own
library and projection imported (--import-library, --import-projection)
and must meet the same bars against the reference's artifacts:
recall@20 >= 0.99, distance MAE < 5e-3 and query coverage 1.0 against
overlaps_ref.tsv (scored by the port's eval.py), cosine > 0.999 against
ref_embeddings.npy matched by read name and strand. Beside them, the
port's run against the JAX package's on the same flags: library bitwise,
embeddings to rtol 1e-5."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from fedrann_tpu.cli import config_from_args as jax_config
from fedrann_tpu.pipeline import run_pipeline as jax_run
from fedrann_tpu_torch.cli import config_from_args
from fedrann_tpu_torch.eval import OverlapTable, neighbor_recall
from fedrann_tpu_torch.pipeline import run_pipeline, staging_params

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bench", "golden")
CPU = torch.device("cpu")


def _args(name: str, *imports: str) -> tuple[list[str], str]:
    data = os.path.join(GOLDEN, name)
    meta = os.path.join(data, "meta.json")
    k = 15
    if os.path.exists(meta):
        with open(meta) as f:
            k = int(json.load(f)["k"])
    flags = {"library": ["--import-library",
                         os.path.join(data, "fwd_kmer_library.fasta")],
             "projection": ["--import-projection",
                            os.path.join(data, "precompute.npz")]}
    return ["-i", os.path.join(data, "reads.fasta.gz"), "-k", str(k),
            *(f for i in imports for f in flags[i]),
            "--nndescent-n-neighbors", "20", "--seed", "20260817"], data


@pytest.fixture(scope="module", params=["data", "data_k21"])
def golden_run(request, tmp_path_factory):
    """One port run and one JAX run per dataset, both imports."""
    args, data = _args(request.param, "library", "projection")
    out = tmp_path_factory.mktemp(request.param)
    config = config_from_args([*args, "-o", str(out / "torch")])
    result = run_pipeline(config, CPU)
    ref = jax_run(jax_config([*args, "-o", str(out / "jax")]))
    return config, result, ref, data


def test_neighbor_recall_vs_reference_output(golden_run):
    _, result, _, data = golden_run
    ref = OverlapTable.read(os.path.join(data, "overlaps_ref.tsv"))
    ours = OverlapTable.read(result.overlaps_path)
    rep = neighbor_recall(ref, ours, k=20)
    assert rep.query_coverage == 1.0
    assert rep.recall_at_k >= 0.99, rep
    assert rep.distance_mae < 5e-3, rep


def test_embeddings_match_reference(golden_run):
    """Row-matched (read name + strand) cosine similarity between the
    port's embeddings and the reference's feature_extraction output."""
    _, result, _, data = golden_run
    ref_emb = np.load(os.path.join(data, "ref_embeddings.npy"))
    with open(os.path.join(data, "ref_row_names.txt")) as f:
        ref_names = [ln.rstrip("\n") for ln in f]
    ref_row = {(ref_names[i], i % 2): i for i in range(len(ref_names))}
    ours = result.embeddings.numpy()
    sims = []
    for r, name in enumerate(result.names):
        for strand in (0, 1):
            a, b = ours[2 * r + strand], ref_emb[ref_row[(name, strand)]]
            na, nb = np.linalg.norm(a), np.linalg.norm(b)
            if na == 0 or nb == 0:
                assert na == nb == 0
                continue
            sims.append(float(a @ b / (na * nb)))
    assert len(sims) > 600
    assert np.min(sims) > 0.999, (np.min(sims), np.mean(sims))


def test_golden_run_matches_jax(golden_run):
    """The imported library bitwise, the embeddings to rtol 1e-5, the
    neighbors and distances as the JAX golden run's; the imported library
    stages keep_all, and the embedding width is the projection's."""
    config, result, ref, _ = golden_run
    codes, counts = result.library.numpy()
    np.testing.assert_array_equal(codes, ref.library.codes)
    np.testing.assert_array_equal(counts, ref.library.counts)
    emb, emb_j = result.embeddings.numpy(), np.asarray(ref.embeddings)
    assert emb.shape == emb_j.shape == (2 * len(result.names), 256)
    np.testing.assert_allclose(emb, emb_j, rtol=1e-5,
                               atol=1e-5 * np.abs(emb_j).max())
    agree = np.mean([len(set(a) & set(b)) / len(b) for a, b in
                     zip(result.neighbor_indices, ref.neighbor_indices)])
    assert agree >= 0.99, agree
    assert np.abs(result.neighbor_distances
                  - ref.neighbor_distances).max() < 5e-3
    assert staging_params(4096, config)[1]


@pytest.mark.parametrize("dtype", ["signs", "bf16"])
def test_imported_library_alone_matches_jax(tmp_path, dtype):
    """--import-library without a projection: keep_all staging of every
    window, then the projection built from the imported counts (signs, or
    a dense bfloat16 table)."""
    args, _ = _args("data", "library")
    args += ["-n", "64", "--projection-dtype", dtype]
    result = run_pipeline(config_from_args([*args, "-o", str(tmp_path / "t")]),
                          CPU)
    ref = jax_run(jax_config([*args, "-o", str(tmp_path / "j")]))
    codes, _ = result.library.numpy()
    np.testing.assert_array_equal(codes, ref.library.codes)
    emb, emb_j = result.embeddings.numpy(), np.asarray(ref.embeddings)
    np.testing.assert_allclose(emb, emb_j, rtol=1e-5,
                               atol=1e-5 * np.abs(emb_j).max())
    assert (np.linalg.norm(emb, axis=1) > 0).mean() > 0.9
