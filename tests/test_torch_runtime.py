"""The host pieces of fedrann_tpu_torch's multi-process runtime against
the JAX package's `fedrann_tpu.parallel.runtime`, in one process:

- the read partition (process_quota, host_read_range, with row_multiple)
  and both library merges, bitwise;
- the byte-range bindings (is_plain_fasta, scan_records_native,
  pack_reads_native(byte_range=)), `_local_slice` on bit-packed buckets
  with split reads, `write_overlaps_path(row_offset=)` and
  `_merge_rank_tables`: bitwise, bytes for bytes;
- knn_exact_block against JAX's (fp32 distances within 1e-5, indices as
  sets: ties may order otherwise) and against the port's knn_exact
  (equal);
- the multi-process search in one process over several local entries
  against knn_exact (equal), the process-group helpers of one process,
  and `run_pipeline_multihost` with one process equal to `run_pipeline`;
- the locked, atomic host-library build: two processes building one new
  library at once both load a whole library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fedrann_tpu import oracle as jo
from fedrann_tpu.io import native as jnative
from fedrann_tpu.io.tsv import write_overlaps_path as jax_write_path
from fedrann_tpu.knn.topk import knn_exact_block as jax_knn_block
from fedrann_tpu.knn.topk import normalize_rows as jax_normalize
from fedrann_tpu.parallel import runtime as jrt
from fedrann_tpu.sim import simulate_reads, write_fasta
from fedrann_tpu_torch import _build, oracle as po
from fedrann_tpu_torch.io import native
from fedrann_tpu_torch.io.tsv import write_overlaps_path
from fedrann_tpu_torch.knn.ring import knn_exact_sharded_multihost
from fedrann_tpu_torch.knn.topk import knn_exact, knn_exact_block
from fedrann_tpu_torch.parallel import dist, runtime as prt
from fedrann_tpu_torch.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Reads past the 2,048 bucket (they split), a name with a space."""
    sim = simulate_reads(genome_length=20000, coverage=6,
                         mean_read_length=1800, error_rate=0.02, seed=7)
    names = list(sim.names)
    names[3] = "read 3 with a description"
    path = str(tmp_path_factory.mktemp("rt") / "reads.fasta")
    write_fasta(path, names, sim.sequences)
    assert any(len(s) > 2048 for s in sim.sequences)
    return path, sim


@pytest.mark.parametrize("row_multiple", [1, 2, 3, 4, 8])
def test_partition_matches_jax(row_multiple):
    for n, h in [(10, 3), (8, 8), (5, 8), (100, 7), (0, 4), (1001, 2),
                 (37, 5)]:
        per = prt.process_quota(n, h, row_multiple)
        assert per == jrt.process_quota(n, h, row_multiple)
        assert (2 * per) % row_multiple == 0 or row_multiple % 2
        got = []
        for p in range(h):
            rng = prt.host_read_range(n, p, h, row_multiple)
            assert rng == jrt.host_read_range(n, p, h, row_multiple)
            got.extend(range(*rng))
        assert got == list(range(n))


def test_library_merges_match_jax_and_one_process():
    sim = simulate_reads(genome_length=12000, coverage=8,
                         mean_read_length=900, seed=51)
    k, frac, seed, min_mult, n_hosts = 13, 0.4, 77, 2, 3
    ours, theirs = [], []
    for p in range(n_hosts):
        s, e = prt.host_read_range(len(sim.sequences), p, n_hosts)
        ours.append(po.build_library(sim.sequences[s:e], k, 1, frac, seed))
        theirs.append(jo.build_library(sim.sequences[s:e], k, 1, frac, seed))
    for got, want in ((prt.merge_library_shards(ours),
                       jrt.merge_library_shards(theirs)),
                      (prt.partition_counts_threshold(ours, min_mult),
                       jrt.partition_counts_threshold(theirs, min_mult))):
        codes, counts = got.numpy()
        assert np.array_equal(codes, want.codes)
        assert np.array_equal(counts, want.counts)
    whole = po.build_library(sim.sequences, k, min_mult, frac, seed)
    merged = prt.allgather_library(dist.ProcessGroup(),
                                   prt.merge_library_shards(ours), min_mult)
    assert torch.equal(merged.codes, whole.codes)
    assert torch.equal(merged.counts, whole.counts)
    assert prt.merge_library_shards(ours[:1]) is ours[0]


def _same_packed(a, b, prefix: bool = True):
    assert a.names == b.names
    ids = [None if x.split_read_ids is None else list(x.split_read_ids)
           for x in (a, b)]
    assert ids[0] == ids[1]
    assert len(a.buckets) == len(b.buckets)
    for x, y in zip(a.buckets, b.buckets):
        assert x.length == y.length
        for f in ("lengths", "read_index", "packed_bases", "valid_bits"):
            assert np.array_equal(getattr(x, f), getattr(y, f)), f
        if prefix:
            assert x.prefix_valid == y.prefix_valid


def test_byte_range_bindings_match_jax(fasta, tmp_path):
    path, _ = fasta
    assert native.is_plain_fasta(path) and jnative.is_plain_fasta(path)
    gz = str(tmp_path / "r.fasta.gz")
    write_fasta(gz, ["a"], ["ACGT" * 10])
    assert not native.is_plain_fasta(gz) and not jnative.is_plain_fasta(gz)
    size = os.path.getsize(path)
    cuts = [0, size // 3, size // 2, size]
    all_offs = []
    for lo, hi in zip(cuts, cuts[1:]):
        names, offs = native.scan_records_native(path, lo, hi)
        names_j, offs_j = jnative.scan_records_native(path, lo, hi)
        assert names == names_j and np.array_equal(offs, offs_j)
        assert offs.dtype == np.int64
        all_offs.append(offs)
    offs = np.concatenate(all_offs)
    assert offs[0] == 0 and np.all(np.diff(offs) > 0)
    with pytest.raises(ValueError):
        native.scan_records_native(gz, 0, 10)
    for lo, hi in ((int(offs[0]), int(offs[5])),
                   (int(offs[5]), size), (int(offs[2]), int(offs[3]))):
        for buckets in ((1024, 2048), None):
            ours = native.pack_reads_native(path, buckets, split_overlap=12,
                                            byte_range=(lo, hi))
            theirs = jnative.pack_reads_native(path, buckets,
                                               bit_packed=True,
                                               split_overlap=12,
                                               byte_range=(lo, hi))
            _same_packed(ours, theirs)


def test_local_slice_matches_jax(fasta):
    path, sim = fasta
    ours_all = native.pack_reads_native(path, (1024, 2048), split_overlap=12)
    theirs_all = jnative.pack_reads_native(path, (1024, 2048),
                                           bit_packed=True, split_overlap=12)
    assert ours_all.split_read_ids is not None
    n = ours_all.n_reads
    for h, row_multiple in ((2, 1), (3, 2), (4, 4)):
        for p in range(h):
            start, end = prt.host_read_range(n, p, h, row_multiple)
            ours = prt._local_slice(ours_all, start, end)
            # JAX's slice drops prefix_valid (re-derived at upload); the
            # port's keeps the whole bucket's, which holds for its rows
            _same_packed(ours, jrt._local_slice(theirs_all, start, end),
                         prefix=False)
            whole = {b.length: b.prefix_valid for b in ours_all.buckets}
            assert all(b.prefix_valid == whole[b.length]
                       for b in ours.buckets)


def test_rank_tables_and_merge_match_jax(tmp_path):
    n_reads, k = 25, 6
    names = [f"read_{i}" for i in range(n_reads)]
    names[4] = "read_4 x"
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 2 * n_reads, (2 * n_reads, k)).astype(np.int32)
    idx[:, 0] = np.arange(2 * n_reads)
    dist_ = rng.random(idx.shape).astype(np.float32)
    bounds = [0, 8, 19, n_reads]
    for tag, write in (("ours", write_overlaps_path),
                       ("jax", jax_write_path)):
        out = tmp_path / tag
        out.mkdir()
        for r, (s, e) in enumerate(zip(bounds, bounds[1:])):
            write(str(out / f"overlaps.rank{r}.tsv"), names,
                  idx[2 * s : 2 * e], dist_[2 * s : 2 * e], row_offset=2 * s)
        merge = prt._merge_rank_tables if tag == "ours" \
            else jrt._merge_rank_tables
        merge(str(out), 3, keep=tag == "ours")
    with open(tmp_path / "jax" / "overlaps.tsv", "rb") as f:
        want = f.read()
    with open(tmp_path / "ours" / "overlaps.tsv", "rb") as f:
        assert f.read() == want
    for r in range(3):
        with open(tmp_path / "ours" / f"overlaps.rank{r}.tsv", "rb") as f:
            assert f.read().startswith(want[: want.index(b"\n") + 1])
    assert not (tmp_path / "jax" / "overlaps.rank1.tsv").exists()
    assert (tmp_path / "ours" / "overlaps.rank1.tsv").exists()
    # a latin-1 name byte survives the merge (JAX's text-mode merge
    # cannot decode it): the merged table is the one-process table
    names[4] = "r\xe9ad_4 x"
    out = tmp_path / "latin1"
    out.mkdir()
    for r, (s, e) in enumerate(zip(bounds, bounds[1:])):
        write_overlaps_path(str(out / f"overlaps.rank{r}.tsv"), names,
                            idx[2 * s : 2 * e], dist_[2 * s : 2 * e],
                            row_offset=2 * s)
    prt._merge_rank_tables(str(out), 3, keep=False)
    whole = str(tmp_path / "whole.tsv")
    write_overlaps_path(whole, names, idx, dist_)
    with open(whole, "rb") as a, open(out / "overlaps.tsv", "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_knn_exact_block_matches_jax_and_knn_exact(precision):
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((300, 24)).astype(np.float32)
    emb[7] = 0.0
    en = torch.from_numpy(emb)
    en = en / torch.linalg.vector_norm(en, dim=1, keepdim=True).clamp_min(
        1e-30)
    en[7] = 0.0
    idx, dist_ = knn_exact_block(en[100:180], en, 9, query_tile=32,
                                 candidate_tile=64, precision=precision)
    full = knn_exact(torch.from_numpy(emb), 9, query_tile=32,
                     candidate_tile=64, precision=precision)
    assert np.array_equal(idx, full[0][100:180])
    assert np.array_equal(dist_, full[1][100:180])
    if precision == "fp32":
        jen = jax_normalize(emb)
        idx_j, dist_j = jax_knn_block(jen[100:180], jen, 9, query_tile=32,
                                      candidate_tile=64, precision="fp32")
        assert np.allclose(dist_, np.asarray(dist_j), atol=1e-5)
        same = [len(set(a) & set(b)) for a, b in zip(idx, np.asarray(idx_j))]
        assert min(same) >= 8


@pytest.mark.parametrize("strategy", ["ring", "allgather", "ring2d"])
@pytest.mark.parametrize("entries", [1, 4])
def test_multihost_search_in_one_process_equals_knn_exact(strategy, entries):
    """One process, `entries` local entries: no block crosses a process,
    and the rows (padded to 2 * per) give knn_exact's result."""
    rng = np.random.default_rng(entries)
    n_reads, d = 101, 16
    emb = torch.from_numpy(rng.standard_normal((2 * n_reads, d))
                           .astype(np.float32))
    per = prt.process_quota(n_reads, 1, entries)
    mesh = make_mesh(devices=[CPU] * entries)
    transport = dist.DeviceTransport(dist.ProcessGroup(), mesh.devices)
    assert transport.kind == "gloo"
    idx, dist_ = knn_exact_sharded_multihost(
        emb, n_reads, per, 7, strategy=strategy, transfer="u16",
        candidate_tile=32, mesh=mesh, transport=transport, query_tile=16)
    want = knn_exact(emb, 7, query_tile=16, candidate_tile=32,
                     transfer="u16")
    assert np.array_equal(idx, want[0]) and np.array_equal(dist_, want[1])
    assert transport.blocks == 0


def test_process_group_of_one():
    g = dist.initialize_distributed(None, None, None)
    assert (g.rank, g.size) == (0, 1)
    arr = np.arange(6, dtype=np.uint64).reshape(2, 3)
    assert np.array_equal(g.process_allgather(arr), arr[None])
    [got] = g.allgather_ragged(np.arange(4))
    assert np.array_equal(got, np.arange(4))
    g.barrier("noop")
    with pytest.raises(ValueError, match="--coordinator"):
        dist.initialize_distributed(None, 2, 0)
    with pytest.raises(ValueError, match="--process-id"):
        dist.initialize_distributed("127.0.0.1:1", 2, 2)
    assert dist.initialize_distributed("127.0.0.1:1", 1, 0).size == 1


def test_one_process_is_run_pipeline(fasta, tmp_path):
    from fedrann_tpu_torch.cli import config_from_args
    from fedrann_tpu_torch.pipeline import run_pipeline

    path, _ = fasta
    args = ["-i", path, "-o", str(tmp_path / "o"), "-k", "13",
            "--kmer-sample-fraction", "0.3", "-n", "64",
            "--nndescent-n-neighbors", "5", "--seed", "9",
            "--length-buckets", "2048", "--knn-query-tile", "64"]
    r_multi = prt.run_pipeline_multihost(config_from_args(args), CPU)
    r_single = run_pipeline(config_from_args(
        args[:3] + [str(tmp_path / "o2")] + args[4:]), CPU)
    assert torch.equal(r_multi.library.codes, r_single.library.codes)
    assert np.array_equal(r_multi.neighbor_indices,
                          r_single.neighbor_indices)
    assert r_multi.row_offset == 0


BUILD = r"""
import ctypes, sys
from pathlib import Path
sys.path.insert(0, {repo!r})
from fedrann_tpu_torch import _build
_build.BUILD_DIR = Path(sys.argv[1])
so = _build.build_host(Path(sys.argv[2]))
lib = ctypes.CDLL(str(so))
assert lib.fastx_is_plain_fasta(sys.argv[2].encode()) == 0
print(so)
"""


def test_concurrent_host_builds_load_a_whole_library(tmp_path):
    """Two processes build one new host library at once (a source no
    build has seen): both load it, one library file results, no temporary
    file is left, and the compiler ran once (one log beside it)."""
    if _build.shutil.which("g++") is None:
        pytest.skip("g++ not found: the host library builds from source")
    src = tmp_path / "fastxpack.cpp"
    src.write_text(open(_build.HOST_SOURCE).read()
                   + f"\n// {tmp_path.name}\n")
    build_dir = tmp_path / "kernels"
    code = BUILD.format(repo=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build_dir),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0]
    files = sorted(f.name for f in build_dir.iterdir())
    assert [f for f in files if f.endswith(".so")] == [
        os.path.basename(outs[0][0].strip())]
    assert len([f for f in files if f.endswith(".log")]) == 1
    assert ctypes.CDLL(outs[0][0].strip()).fastx_is_plain_fasta
