"""The whole fedrann_tpu_torch slice (plain versions, on the CPU) against
the JAX `run_pipeline` on the same reads and flags, with the sign table
and with dense paired tables (--projection-dtype f32 and bf16): library
bitwise, embeddings to rtol 1e-5, neighbor agreement >= 0.99, distances
within 5e-3, the same TSV header, and truth recall > 0.75."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from fedrann_tpu.cli import config_from_args as jax_config
from fedrann_tpu.pipeline import run_pipeline as jax_run
from fedrann_tpu_torch.cli import config_from_args, main
from fedrann_tpu_torch.pipeline import run_pipeline
from fedrann_tpu_torch.sim import simulate_reads, write_fasta

CPU = torch.device("cpu")
ARGS = ["--kmer-sample-fraction", "0.2", "--kmer-min-multiplicity", "2",
        "--seed", "602", "-n", "128", "--nndescent-n-neighbors", "10",
        "--length-buckets", "4096", "--knn-query-tile", "64"]


@pytest.fixture(scope="module")
def sim_input(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    sim = simulate_reads(genome_length=15000, coverage=6,
                         mean_read_length=1500, error_rate=0.02, seed=21)
    path = str(d / "reads.fasta.gz")
    write_fasta(path, sim.names, sim.sequences)
    return sim, path


@pytest.mark.parametrize("dtype", ["signs", "f32", "bf16"])
@pytest.mark.parametrize("k", [13, 21])
def test_slice_matches_jax_pipeline(sim_input, tmp_path, k, dtype):
    sim, path = sim_input
    args = ["-i", path, "-k", str(k), *ARGS, "--projection-dtype", dtype]
    res = run_pipeline(
        config_from_args([*args, "-o", str(tmp_path / "torch")]), CPU)
    ref = jax_run(jax_config([*args, "-o", str(tmp_path / "jax")]))

    codes, counts = res.library.numpy()
    np.testing.assert_array_equal(codes, ref.library.codes)
    np.testing.assert_array_equal(counts, ref.library.counts)
    emb, emb_j = res.embeddings.numpy(), np.asarray(ref.embeddings)
    np.testing.assert_allclose(emb, emb_j, rtol=1e-5,
                               atol=1e-5 * np.abs(emb_j).max())
    agree = np.mean([len(set(a) & set(b)) / len(b) for a, b in
                     zip(res.neighbor_indices, ref.neighbor_indices)])
    assert agree >= 0.99, agree
    assert np.abs(res.neighbor_distances
                  - ref.neighbor_distances).max() < 5e-3
    with open(res.overlaps_path) as f, open(ref.overlaps_path) as g:
        assert f.readline() == g.readline()

    truth = sim.truth_overlaps(min_overlap=800)
    idx = res.neighbor_indices
    found = sum(1 for a, b in truth
                if b in {int(t) // 2 for t in idx[2 * a]}
                or a in {int(t) // 2 for t in idx[2 * b]})
    assert found / len(truth) > 0.75

    with open(os.path.join(tmp_path / "torch", "metrics.json")) as f:
        stages = json.load(f)
    for name in ("load", "stage", "count", "project", "embed", "knn",
                 "output"):
        assert stages[name]["seconds"] >= 0


@pytest.mark.parametrize("flag,search", [
    (["--knn-method", "ivf"], "knn_ivf"),
    (["--knn-method", "ivf", "--knn-hbm-budget", "8G"], "knn_ivf"),
    (["--num-processes", "2", "--knn-method", "ivf"],
     "knn_ivf_sharded_multihost"),
    (["--coordinator", "localhost:1234", "--knn-method", "ivf"],
     "knn_ivf_sharded_multihost"),
    (["--knn-sharded", "always", "--knn-method", "ivf"], "knn_ivf_sharded"),
    (["--mesh-shape", "2", "--num-processes", "2", "--knn-method", "ivf"],
     "knn_ivf_sharded_multihost"),
])
def test_ivf_flags_reach_their_search(sim_input, tmp_path, flag, search):
    """Each --knn-method ivf flag set reaches the IVF search of its path,
    counted by the search's `.calls`: one process in core (8G is above the
    valve for these reads) -> knn_ivf, --knn-sharded always -> knn_ivf_sharded
    over the run's mesh, and two rank processes (a coordinator, here on a
    free port, with --num-processes 2 and each rank's --process-id) ->
    knn_ivf_sharded_multihost on each rank. The reads are below the IVF
    valve, so each then takes its exact path."""
    from fedrann_tpu_torch.knn import ivf, ooc

    _, path = sim_input
    if search == "knn_ivf_sharded_multihost":
        from test_torch_multihost import ivf_counts, launch

        outs = launch(path, str(tmp_path), flag)
        assert [ivf_counts(o) for o in outs] == [
            {"calls": 1, "exact_fallbacks": 1}] * 2
        assert os.path.exists(tmp_path / "overlaps.tsv")
        return
    fns = (ivf.knn_ivf, ivf.knn_ivf_sharded, ooc.knn_ivf_ooc,
           ivf.knn_ivf_sharded_multihost)
    before = [fn.calls for fn in fns]
    run_pipeline(config_from_args(["-i", path, "-o", str(tmp_path), *flag]),
                 CPU)
    assert [fn.calls - b for fn, b in zip(fns, before)] == [
        int(fn.__name__ == search) for fn in fns]


def test_load_is_native_and_uploads_the_2bit_form(sim_input, tmp_path):
    """The run loads through the native packer (never the Python reader
    or packer), saves the packed-reads cache, and uploads each bucket in
    its 2-bit form: a quarter of the byte matrix plus the row lengths."""
    from fedrann_tpu_torch.io import fastx, native, packing
    from fedrann_tpu_torch.pipeline import upload_bucket

    _, path = sim_input
    before = (native.pack_reads_native.calls, fastx.read_fastx.calls,
              packing.pack_reads.calls, upload_bucket.bytes)
    res = run_pipeline(config_from_args(
        ["-i", path, "-o", str(tmp_path), "-k", "13", *ARGS]), CPU)
    after = (native.pack_reads_native.calls, fastx.read_fastx.calls,
             packing.pack_reads.calls, upload_bucket.bytes)
    rows = -(-len(res.names) // 8) * 8
    assert after[:3] == (before[0] + 1, before[1], before[2])
    assert after[3] - before[3] == rows * (4096 // 4 + 4) \
        == res.metrics["stage"]["h2d_bytes"]
    assert os.path.exists(tmp_path / "fxcache.npz")


def test_imported_projection_of_another_library_raises(sim_input, tmp_path):
    """A projection whose row count does not fit the library raises the
    JAX package's ValueError, in both packages."""
    _, path = sim_input
    npz = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "bench", "golden", "data", "precompute.npz")
    args = ["-i", path, "-o", str(tmp_path), "-k", "13", *ARGS,
            "--import-projection", npz]
    with pytest.raises(ValueError, match="library needs") as port:
        run_pipeline(config_from_args(args), CPU)
    with pytest.raises(ValueError, match="library needs") as jax:
        jax_run(jax_config(args))
    assert str(port.value) == str(jax.value)


def test_cli_needs_a_gpu(sim_input, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would run")
    _, path = sim_input
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-i", path, "-o", str(tmp_path)])
