"""The packed-reads cache (`io/cache.py`, <output_dir>/fxcache.npz) against
the JAX package's `fedrann_tpu/io/cache.py`: a round trip, a stale meta
that re-parses, --no-pack-cache, and a cache written by one package read
by the other."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from fedrann_tpu.io import cache as jax_cache
from fedrann_tpu.io.native import pack_reads_native as jax_pack_native
from fedrann_tpu_torch import pipeline
from fedrann_tpu_torch.cli import config_from_args
from fedrann_tpu_torch.io import cache, native
from fedrann_tpu_torch.io.fastx import read_fastx
from fedrann_tpu_torch.io.packing import pack_reads
from fedrann_tpu_torch.kmers.membership import stage_candidates
from fedrann_tpu_torch.sim import simulate_reads, write_fasta
from test_torch_native_io import host_toolchain  # noqa: F401

pytestmark = pytest.mark.usefixtures("host_toolchain")

FIELDS = ("lengths", "read_index", "packed_bases", "valid_bits", "bases")


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Simulated reads, three of them past the largest bucket of 2,048
    (split), one with a mid-read N."""
    d = tmp_path_factory.mktemp("cache")
    sim = simulate_reads(genome_length=30000, coverage=4,
                         mean_read_length=1800, error_rate=0.02, seed=11)
    seqs = list(sim.sequences)
    seqs[3] = seqs[3][:100] + "N" + seqs[3][101:]
    names = list(sim.names)
    for i in range(3):
        names.append(f"long{i}")
        seqs.append(sim.genome[i * 1000 : i * 1000 + 5000 + 700 * i])
    path = str(d / "reads.fasta")
    write_fasta(path, names, seqs)
    return path


def _assert_same(a, b):
    assert a.names == b.names and a.n_truncated == b.n_truncated
    np.testing.assert_array_equal(
        a.split_read_ids if a.split_read_ids is not None else [],
        b.split_read_ids if b.split_read_ids is not None else [])
    assert len(a.buckets) == len(b.buckets)
    for x, y in zip(a.buckets, b.buckets):
        assert x.length == y.length and x.prefix_valid == y.prefix_valid
        for name in FIELDS:
            u, v = getattr(x, name), getattr(y, name)
            assert (u is None) == (v is None), name
            if u is not None:
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("buckets", [None, (1024, 2048)])
def test_cache_round_trip(tmp_path, reads, buckets):
    packed = native.pack_reads_native(reads, buckets, split_overlap=14)
    meta = cache.cache_meta(reads, buckets, 14)
    path = str(tmp_path / "fxcache.npz")
    cache.save_packed_cache(path, packed, meta)
    hits = cache.load_packed_cache.hits
    _assert_same(cache.load_packed_cache(path, meta), packed)
    assert cache.load_packed_cache.hits == hits + 1
    # the fixed ladder splits the long reads; the auto one holds them
    assert (packed.split_read_ids is not None) == (buckets is not None)
    assert [b.prefix_valid for b in packed.buckets].count(False) == 1
    assert not os.path.exists(path + ".tmp")


def test_stale_meta_reparses(tmp_path, reads):
    """A cache whose input changed (mtime) or whose buckets differ is not
    loaded; the pipeline parses again and rewrites it."""
    config = config_from_args(["-i", reads, "-o", str(tmp_path), "-k", "15"])
    calls = native.pack_reads_native.calls
    first = pipeline.load_reads(config)
    assert native.pack_reads_native.calls == calls + 1
    _assert_same(pipeline.load_reads(config), first)
    assert native.pack_reads_native.calls == calls + 1  # from the cache
    meta = cache.cache_meta(reads, None, 14)
    assert cache.load_packed_cache(str(tmp_path / "fxcache.npz"),
                                   {**meta, "buckets": [1024]}) is None
    st = os.stat(reads)
    os.utime(reads, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    assert cache.load_packed_cache(str(tmp_path / "fxcache.npz"),
                                   cache.cache_meta(reads, None, 14)) is None
    _assert_same(pipeline.load_reads(config), first)
    assert native.pack_reads_native.calls == calls + 2


def test_no_pack_cache_parses_every_run(tmp_path, reads):
    config = config_from_args(["-i", reads, "-o", str(tmp_path), "-k", "15",
                               "--no-pack-cache"])
    calls = native.pack_reads_native.calls
    pipeline.load_reads(config)
    pipeline.load_reads(config)
    assert native.pack_reads_native.calls == calls + 2
    assert not os.path.exists(tmp_path / "fxcache.npz")


@pytest.mark.parametrize("bit_packed", [True, False])
def test_jax_cache_read_by_the_port(tmp_path, reads, bit_packed):
    """A cache the JAX package wrote (2-bit planes, or the byte matrices of
    its plain packer) loads in the port as the port's packing; a byte
    bucket uploads bit-packed and stages as the port's own."""
    meta = jax_cache.cache_meta(reads, None, 14)
    theirs = jax_pack_native(reads, None, bit_packed=bit_packed,
                             split_overlap=14)
    path = str(tmp_path / "fxcache.npz")
    jax_cache.save_packed_cache(path, theirs, meta)
    got = cache.load_packed_cache(path, cache.cache_meta(reads, None, 14))
    _assert_same(got, theirs)
    ours = native.pack_reads_native(reads, None, split_overlap=14)
    for g, o in zip(got.buckets, ours.buckets):
        a = pipeline.upload_bucket(g, torch.device("cpu"))
        b = pipeline.upload_bucket(o, torch.device("cpu"))
        assert a.source == b.source
        for x, y in zip(stage_candidates(a[:16], 15, 512, False, 602,
                                         1 << 30, 54),
                        stage_candidates(b[:16], 15, 512, False, 602,
                                         1 << 30, 54)):
            assert torch.equal(x, y)


def test_port_cache_read_by_jax(tmp_path, reads):
    meta = cache.cache_meta(reads, (1024, 2048), 14)
    assert meta == jax_cache.cache_meta(reads, (1024, 2048), 14)
    ours = native.pack_reads_native(reads, (1024, 2048), split_overlap=14)
    path = str(tmp_path / "fxcache.npz")
    cache.save_packed_cache(path, ours, meta)
    _assert_same(jax_cache.load_packed_cache(path, meta), ours)


def test_plain_packing_uploads_bit_packed():
    """A bucket of the plain packer (a byte matrix) uploads in the same
    2-bit form as the native packer's, never as bytes."""
    recs = list(read_fastx(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "bench", "golden", "data", "reads.fasta.gz")))
    bucket = pack_reads(recs, (8192,)).buckets[0]
    chunk = pipeline.upload_bucket(bucket, torch.device("cpu"))
    assert chunk.packed.shape == (bucket.bases.shape[0], 2048)
    assert torch.equal(chunk.unpack(), torch.from_numpy(bucket.bases))
