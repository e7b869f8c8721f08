"""The generator: seeded and deterministic, strands mirrored, sparse as at
full size, and checked against the port's own run_pipeline on reads of the
CI workload's shape (fedrann_tpu_torch/sim.py reads, k = 15, 5% sampling,
8 kb at 12x, 5% error; a 400 kb genome so the run fits a CPU test)."""

import numpy as np
import pytest
import torch

from portbench.gen import (
    Dataset,
    Features,
    Layout,
    draw_layout,
    make_read_set,
    make_rows,
    truth_pairs,
)
from portbench.tests.conftest import small_cell

CPU = torch.device("cpu")


def test_a_seed_gives_the_same_rows():
    ds, ft = Dataset(500_000, 20, 5000, 0.02), Features(16, 0.01, 2, 128)
    a = make_read_set(ds, ft, 2**31 + 77, CPU)
    b = make_read_set(ds, ft, 2**31 + 77, CPU)
    c = make_read_set(ds, ft, 2**31 + 78, CPU)
    assert torch.equal(a.rows, b.rows)
    assert torch.equal(a.layout.starts, b.layout.starts)
    assert a.rows.shape == c.rows.shape == (2 * ds.n_reads, 128)
    assert not torch.equal(a.rows, c.rows)


def test_a_reads_reverse_row_mirrors_its_forward_row():
    ds, ft = Dataset(300_000, 10, 4000, 0.01), Features(16, 0.02, 2, 64)
    g = torch.Generator()
    g.manual_seed(5)
    lay = draw_layout(ds, g, CPU)
    flipped = Layout(lay.starts, lay.ends, 1 - lay.strands)
    rows = []
    for layout in (lay, flipped):
        g.manual_seed(9)
        rows.append(make_rows(layout, ds, ft, g).rows)
    assert torch.equal(rows[0][0::2], rows[1][1::2])
    assert torch.equal(rows[0][1::2], rows[1][0::2])


@pytest.mark.parametrize("cell,nnz", [("hifi-dmel.exact", (22, 30)),
                                      ("ont-chr1.ivf", (5.5, 8.5))])
def test_rows_are_as_sparse_as_at_full_size(cell, nnz):
    from fedrann_tpu_torch.cli import config_from_args

    c = small_cell(cell, 3_000_000)
    config = config_from_args(["-i", "-", "-o", "-", *c.flags])
    rs = make_read_set(Dataset(**c.config["dataset"]),
                       Features(config.kmer_size, config.kmer_sample_fraction,
                                config.kmer_min_multiplicity,
                                config.embedding_dimension,
                                config.projection_density), 11, CPU)
    mean = float((rs.rows != 0).sum(1).float().mean())
    assert nnz[0] < mean < nnz[1]


def test_truth_pairs_are_the_simulators():
    from fedrann_tpu_torch.sim import simulate_reads

    sim = simulate_reads(genome_length=60_000, coverage=8,
                         mean_read_length=3000, seed=4)
    lay = Layout(torch.from_numpy(sim.starts), torch.from_numpy(sim.ends),
                 torch.from_numpy(sim.strands.astype(np.int64)))
    got = {tuple(p) for p in truth_pairs(lay, 1500).tolist()}
    assert got == sim.truth_overlaps(1500)


def _cosines(rows, pairs):
    u = torch.nn.functional.normalize(rows.float(), dim=1)
    a, b = pairs[:, 0], pairs[:, 1]
    same = (u[2 * a] * u[2 * b]).sum(1)
    other = (u[2 * a] * u[2 * b + 1]).sum(1)
    return torch.maximum(same, other)


def model_and_program(seed: int):
    """The port's run_pipeline on simulated reads and the generator's rows
    on the same read layout: {"program": .., "model": ..} of (mean nonzeros
    a row, library size, mean cosine of true pairs by overlap bin, truth
    recall at 50 neighbors)."""
    import tempfile

    from fedrann_tpu_torch.cli import config_from_args
    from fedrann_tpu_torch.eval import truth_recall
    from fedrann_tpu_torch.knn.topk import knn_exact
    from fedrann_tpu_torch.pipeline import run_pipeline
    from fedrann_tpu_torch.sim import simulate_reads, write_fasta

    g_len, cov, mean, err = 400_000, 12, 8000, 0.05
    sim = simulate_reads(genome_length=g_len, coverage=cov,
                         mean_read_length=mean, error_rate=err, seed=seed)
    with tempfile.TemporaryDirectory() as tmp:
        write_fasta(f"{tmp}/reads.fa", sim.names, sim.sequences)
        config = config_from_args(
            ["-i", f"{tmp}/reads.fa", "-o", f"{tmp}/out", "-k", "15",
             "--kmer-sample-fraction", "0.05", "--no-pack-cache",
             "--log-level", "WARNING"])
        res = run_pipeline(config, CPU)
    lay = Layout(torch.from_numpy(sim.starts), torch.from_numpy(sim.ends),
                 torch.from_numpy(sim.strands.astype(np.int64)))
    g = torch.Generator()
    g.manual_seed(seed)
    model = make_rows(lay, Dataset(g_len, cov, mean, err),
                      Features(15, 0.05, 2, 500), g)
    truth = sorted(sim.truth_overlaps(mean // 2))
    pairs = torch.tensor(truth)
    share = np.array([min(sim.ends[a], sim.ends[b])
                      - max(sim.starts[a], sim.starts[b])
                      for a, b in truth]) / mean
    out = {}
    for name, rows, idx, lib in (
            ("program", res.embeddings, res.neighbor_indices,
             res.library.size),
            ("model", model.rows,
             knn_exact(model.rows, 50, precision="bf16",
                       transfer="u16")[0], model.library_size)):
        cos = _cosines(rows, pairs).numpy()
        out[name] = {
            "nonzeros": float((rows != 0).sum(1).float().mean()),
            "library": int(lib),
            "cosine": [float(cos[(share >= lo) & (share < hi)].mean())
                       for lo, hi in ((0.5, 0.75), (0.75, 1.0),
                                      (1.0, 1.25))],
            "recall": truth_recall(idx, truth, len(sim.names))}
    return out


def test_the_model_follows_run_pipeline():
    got = model_and_program(3)
    prog, model = got["program"], got["model"]
    # the model leaves out error k-mers that recur in two or more reads,
    # which the program's library keeps (+17% library at this shape): the
    # model's rows run some 8% sparser and its true pairs some 10% less
    # alike (PERF.md, the generator's check)
    assert model["library"] < prog["library"] < 1.25 * model["library"]
    assert abs(model["nonzeros"] / prog["nonzeros"] - 1) < 0.15
    for m, p in zip(model["cosine"], prog["cosine"]):
        assert abs(m / p - 1) < 0.15
    assert abs(model["recall"] - prog["recall"]) < 0.05
