"""fedrann_tpu_torch's fused sharded step (a mesh of eight `cpu` entries)
against the JAX `make_sharded_step` on its 8-device CPU mesh, both given
the same `pack_reads` bucket, library and paired table (through
convert.py), as tests/test_sharded_step.py holds the JAX step; and the
pipeline with --knn-sharded always against the JAX `run_pipeline` on its
eight CPU devices, at PERF.md section 2's bars."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedrann_tpu import oracle
from fedrann_tpu.cli import config_from_args as jax_config
from fedrann_tpu.io.fastx import FastxRecord
from fedrann_tpu.io.packing import pack_reads
from fedrann_tpu.parallel import mesh as jmesh
from fedrann_tpu.parallel import step as jstep
from fedrann_tpu.pipeline import run_pipeline as jax_run
from fedrann_tpu.project.srp import build_precompute_paired
from fedrann_tpu.sim import simulate_reads
from fedrann_tpu_torch import convert
from fedrann_tpu_torch.cli import config_from_args
from fedrann_tpu_torch.knn.ring import knn_exact_sharded
from fedrann_tpu_torch.parallel import mesh
from fedrann_tpu_torch.parallel.step import (
    make_sharded_step,
    shard_step_inputs,
)
from fedrann_tpu_torch.pipeline import knn_mesh, run_pipeline
from fedrann_tpu_torch.sim import simulate_reads as port_simulate
from fedrann_tpu_torch.sim import write_fasta

CPU = torch.device("cpu")
CPU8 = [CPU] * 8


def _inputs(sim, k, frac, seed, n_real=None, pad_rows_to=8):
    """The JAX step's inputs and the port's, from one bucket, library and
    paired table."""
    lib = oracle.build_library(sim.sequences, k, 2, frac, seed)
    names, seqs = sim.names[:n_real], sim.sequences[:n_real]
    bucket = pack_reads([FastxRecord(n, s) for n, s in zip(names, seqs)],
                        length_buckets=(2048,),
                        pad_rows_to=pad_rows_to).buckets[0]
    p_pair = build_precompute_paired(jnp.asarray(lib.counts), 64, 2094)
    args, index = jstep.shard_step_inputs(
        jmesh.make_mesh(), jnp.asarray(bucket.bases), lib.codes, k, p_pair)
    port_args = shard_step_inputs(
        mesh.make_mesh(devices=CPU8), torch.from_numpy(bucket.bases),
        torch.from_numpy(lib.codes.astype(np.int64)),
        convert.paired_table_to_port(p_pair))
    return bucket, args, index, port_args


@pytest.mark.parametrize("k,precision,dist_atol", [
    (13, "fp32", 2e-4),
    (21, "bf16", 2e-2),
])
def test_sharded_step_matches_jax(k, precision, dist_atol):
    assert len(jax.devices()) == 8
    sim = simulate_reads(genome_length=10000, coverage=5,
                         mean_read_length=1000, seed=81)
    frac, seed = 0.3, 44
    bucket, args, index, port_args = _inputs(sim, k, frac, seed)
    kw = dict(k=k, max_hits=1024, n_neighbors=6, precision=precision,
              strategy="ring", sampling=(seed, frac))
    dist_j, idx_j = jstep.make_sharded_step(
        jmesh.make_mesh(), bits=index.bits, steps=index.steps,
        table_packed=index.packed, **kw)(*args)
    dist_j, idx_j = np.asarray(dist_j), np.asarray(idx_j)
    dist, idx = make_sharded_step(mesh.make_mesh(devices=CPU8), **kw)(
        *port_args)

    assert dist.shape == dist_j.shape and idx.dtype == np.int32
    np.testing.assert_allclose(dist, dist_j, atol=dist_atol)
    assert idx.min() >= 0 and idx.max() < dist.shape[0]
    # agreement where distances resolve the neighbors: padding reads embed
    # as zero rows, at distance exactly 1 from everything
    real_rows = [2 * i + o for i, r in enumerate(bucket.read_index)
                 if r >= 0 for o in (0, 1)]
    agrees = []
    for q in real_rows:
        resolved = dist_j[q] < 0.99
        if resolved.any():
            agrees.append(len(set(idx[q][resolved]) & set(idx_j[q][resolved]))
                          / int(resolved.sum()))
    assert len(agrees) > 0.9 * len(real_rows)
    assert np.mean(agrees) >= 0.99, np.mean(agrees)


@pytest.mark.parametrize("strategy", ["ring", "allgather"])
def test_sharded_step_masks_padding_rows(strategy):
    """With n_reads set, the padding rows never enter a real read's top-k,
    and their own lists are dropped."""
    sim = simulate_reads(genome_length=8000, coverage=5,
                         mean_read_length=1000, seed=82)
    k, frac, seed, n_real = 13, 0.5, 45, 11
    bucket, args, index, port_args = _inputs(sim, k, frac, seed, n_real, 16)
    assert (bucket.read_index >= 0).sum() == n_real
    assert bucket.bases.shape[0] == 16
    kw = dict(k=k, max_hits=1024, n_neighbors=8, precision="fp32",
              strategy=strategy, sampling=(seed, frac), n_reads=n_real)
    dist, idx = make_sharded_step(mesh.make_mesh(devices=CPU8), **kw)(
        *port_args)
    assert dist.shape == idx.shape == (2 * n_real, 8)
    assert idx.min() >= 0 and idx.max() < 2 * n_real
    assert np.isfinite(dist).all()
    dist_j, idx_j = jstep.make_sharded_step(
        jmesh.make_mesh(), bits=index.bits, steps=index.steps,
        table_packed=index.packed, **kw)(*args)
    real_j = np.asarray(idx_j)[: 2 * n_real]
    assert real_j.max() < 2 * n_real
    np.testing.assert_allclose(dist, np.asarray(dist_j)[: 2 * n_real],
                               atol=2e-4)


@pytest.fixture(scope="module")
def sim_input(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    sim = port_simulate(genome_length=15000, coverage=6,
                        mean_read_length=1500, error_rate=0.02, seed=21)
    path = str(d / "reads.fasta.gz")
    write_fasta(path, sim.names, sim.sequences)
    return path


ARGS = ["-k", "13", "--kmer-sample-fraction", "0.2",
        "--kmer-min-multiplicity", "2", "--seed", "602", "-n", "128",
        "--nndescent-n-neighbors", "10", "--length-buckets", "4096",
        "--knn-query-tile", "64", "--knn-sharded", "always"]


@pytest.mark.parametrize("strategy", ["ring", "allgather", "ring2d"])
def test_sharded_pipeline_matches_jax(sim_input, tmp_path, strategy):
    """run_pipeline with --knn-sharded always over eight cpu entries
    against the JAX run_pipeline, sharded over its eight CPU devices:
    library bitwise, embeddings to rtol 1e-5, neighbor agreement >= 0.99,
    distances within 5e-3."""
    args = ["-i", sim_input, *ARGS, "--knn-shard-strategy", strategy]
    calls = knn_exact_sharded.calls
    res = run_pipeline(config_from_args([*args, "-o", str(tmp_path / "t")]),
                       CPU, mesh=CPU8)
    assert knn_exact_sharded.calls == calls + 1
    assert knn_exact_sharded.devices == 8
    ref = jax_run(jax_config([*args, "-o", str(tmp_path / "j")]))

    codes, counts = res.library.numpy()
    np.testing.assert_array_equal(codes, ref.library.codes)
    np.testing.assert_array_equal(counts, ref.library.counts)
    emb, emb_j = res.embeddings.numpy(), np.asarray(ref.embeddings)
    np.testing.assert_allclose(emb, emb_j, rtol=1e-5,
                               atol=1e-5 * np.abs(emb_j).max())
    idx = res.neighbor_indices
    assert idx.shape == ref.neighbor_indices.shape
    assert idx.min() >= 0 and idx.max() < emb.shape[0]
    agree = np.mean([len(set(a) & set(b)) / len(b) for a, b in
                     zip(idx, ref.neighbor_indices)])
    assert agree >= 0.99, agree
    assert np.abs(res.neighbor_distances
                  - ref.neighbor_distances).max() < 5e-3


def test_pipeline_shards_only_where_asked(sim_input, tmp_path):
    """auto shards over a mesh of more than one entry, never does not; a
    CPU run without a mesh has one device, so auto stays on it."""
    base = ["-i", sim_input, *ARGS[:-2]]
    for flags, mesh_arg, sharded in (
            (["--knn-sharded", "auto"], CPU8, True),
            (["--knn-sharded", "never"], CPU8, False),
            (["--knn-sharded", "auto"], None, False)):
        calls = knn_exact_sharded.calls
        run_pipeline(config_from_args(
            [*base, *flags, "-o", str(tmp_path / str(len(flags)))]), CPU,
            mesh=mesh_arg)
        assert knn_exact_sharded.calls == calls + sharded, flags


@pytest.mark.parametrize("shape,strategy,want", [
    (None, "ring", (8,)), ("4", "ring", (4,)), ("2,4", "allgather", (8,)),
    ("2,4", "ring2d", (2, 4)), ("2,2", "ring2d", (2, 2)),
    (None, "ring2d", (1, 8)), ("4", "ring2d", (1, 8)),
])
def test_knn_mesh_follows_jax(shape, strategy, want):
    """--mesh-shape and --knn-shard-strategy build the mesh as the JAX
    pipeline does from its devices (a shape ring2d cannot use falls back
    to (1, n))."""
    flags = ["-i", "x", "-o", "y", "--knn-shard-strategy", strategy]
    if shape:
        flags += ["--mesh-shape", shape]
    assert knn_mesh(config_from_args(flags), CPU8).shape == want
