"""Stage checkpoints (--keep-intermediates) across the two packages, and
the --profile, --mprof and --save-feature-matrix outputs, on the CPU.

A checkpoint directory written by the JAX `run_pipeline` is resumed by the
port's `run_pipeline(config, cpu)` and the port's by JAX's: the same
library bitwise, the same embeddings, and no staging on resume. A changed
input invalidates the checkpoints."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import fedrann_tpu.pipeline as jax_pipeline
from fedrann_tpu.cli import config_from_args as jax_config
from fedrann_tpu_torch import pipeline
from fedrann_tpu_torch.cli import config_from_args
from fedrann_tpu_torch.sim import simulate_reads, write_fasta
from test_torch_native_io import host_toolchain  # noqa: F401

pytestmark = pytest.mark.usefixtures("host_toolchain")

CPU = torch.device("cpu")
ARGS = ["-k", "13", "--kmer-sample-fraction", "0.2",
        "--kmer-min-multiplicity", "2", "--seed", "602", "-n", "96",
        "--nndescent-n-neighbors", "10", "--length-buckets", "4096",
        "--knn-query-tile", "64", "--keep-intermediates"]


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    sim = simulate_reads(genome_length=15000, coverage=6,
                         mean_read_length=1500, error_rate=0.02, seed=21)
    path = str(d / "reads.fasta.gz")
    write_fasta(path, sim.names, sim.sequences)
    return path


def _no_staging(*args, **kwargs):
    raise AssertionError("a resumed run staged the reads")


def _assert_library(codes, counts, ref):
    np.testing.assert_array_equal(codes, ref.codes)
    np.testing.assert_array_equal(counts, ref.counts)


def test_jax_checkpoint_resumed_by_port(reads, tmp_path, monkeypatch):
    out = str(tmp_path / "out")
    ref = jax_pipeline.run_pipeline(jax_config(["-i", reads, "-o", out,
                                                *ARGS]))
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == [
        "embeddings.npy", "embeddings_meta.json", "library.npz"]
    monkeypatch.setattr(pipeline, "stage_reads", _no_staging)
    res = pipeline.run_pipeline(config_from_args(["-i", reads, "-o", out,
                                                  *ARGS]), CPU)
    assert "stage" not in res.metrics
    _assert_library(*res.library.numpy(), ref.library)
    np.testing.assert_allclose(res.embeddings.numpy(),
                               np.asarray(ref.embeddings), rtol=1e-5)
    agree = np.mean([len(set(a) & set(b)) / len(b) for a, b in
                     zip(res.neighbor_indices, ref.neighbor_indices)])
    assert agree >= 0.99, agree


def test_port_checkpoint_resumed_by_jax(reads, tmp_path, monkeypatch):
    out = str(tmp_path / "out")
    res = pipeline.run_pipeline(config_from_args(["-i", reads, "-o", out,
                                                  *ARGS]), CPU)
    with np.load(os.path.join(out, "checkpoints", "library.npz")) as lib:
        assert lib["codes"].dtype == np.uint64
        assert lib["counts"].dtype == np.int64
    monkeypatch.setattr(jax_pipeline, "_stage_chunks", _no_staging)
    ref = jax_pipeline.run_pipeline(jax_config(["-i", reads, "-o", out,
                                                *ARGS]))
    assert "stage" not in ref.metrics
    _assert_library(*res.library.numpy(), ref.library)
    np.testing.assert_allclose(np.asarray(ref.embeddings),
                               res.embeddings.numpy(), rtol=1e-5)


def test_changed_input_invalidates_checkpoint(reads, tmp_path):
    """Touching the input changes its identity: the rerun stages again
    and writes the same checkpoints; a changed embedding dimension keeps
    the library and recomputes the embeddings."""
    out = str(tmp_path / "out")
    config = config_from_args(["-i", reads, "-o", out, *ARGS])
    first = pipeline.run_pipeline(config, CPU)
    assert "stage" in first.metrics
    resumed = pipeline.run_pipeline(config, CPU)
    assert "stage" not in resumed.metrics
    assert torch.equal(resumed.embeddings, first.embeddings)
    st = os.stat(reads)
    os.utime(reads, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    again = pipeline.run_pipeline(config, CPU)
    assert "stage" in again.metrics
    assert torch.equal(again.embeddings, first.embeddings)
    with open(os.path.join(out, "checkpoints", "embeddings_meta.json")) as f:
        assert json.load(f)["input"]["mtime_ns"] == os.stat(
            reads).st_mtime_ns
    wider = pipeline.run_pipeline(config_from_args(
        ["-i", reads, "-o", out, *ARGS, "-n", "64"]), CPU)
    assert "stage" in wider.metrics  # embeddings recomputed: staged
    assert wider.embeddings.shape[1] == 64
    _assert_library(*wider.library.numpy(), first.library)


@pytest.mark.parametrize("flag", ["--profile", "--mprof",
                                  "--save-feature-matrix"])
def test_feature_flags_write_their_files(reads, tmp_path, flag):
    out = str(tmp_path / "out")
    res = pipeline.run_pipeline(config_from_args(
        ["-i", reads, "-o", out, *ARGS[:-1], flag]), CPU)
    written = {"--profile": "trace", "--mprof": "mprof.dat",
               "--save-feature-matrix": "feature_matrix.npz"}
    assert [f for f in written.values()
            if os.path.exists(os.path.join(out, f))] == [written[flag]]
    if flag == "--profile":
        with open(os.path.join(out, "trace", "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("cat") == "cpu_op" for e in events)
    elif flag == "--mprof":
        with open(os.path.join(out, "mprof.dat")) as f:
            lines = f.read().splitlines()
        assert lines[0] == "MT 1.0" and lines[1].startswith("MEM ")
        assert all(float(ln.split()[1]) > 0 for ln in lines[1:])
    else:
        with np.load(os.path.join(out, "feature_matrix.npz")) as saved:
            np.testing.assert_array_equal(saved["embeddings"],
                                          res.embeddings.numpy())
            assert saved["names"].tolist() == res.names
