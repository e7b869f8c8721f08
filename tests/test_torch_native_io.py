"""The port's native FASTX packer and TSV writer (`io/native.py`, the host
library built from native/fastxpack.cpp by `_build.build_host`) against the
port's plain Python reader and packer and against the JAX package's
`pack_reads_native`, `pack_reads` and `write_overlaps_path`: names,
lengths, read indices, 2-bit planes, valid bits and prefix_valid bitwise;
overlaps.tsv byte for byte."""

from __future__ import annotations

import functools
import gzip
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fedrann_tpu.io.fastx import read_fastx as jax_read_fastx
from fedrann_tpu.io.native import pack_reads_native as jax_pack_native
from fedrann_tpu.io.packing import pack_reads as jax_pack_reads
from fedrann_tpu.io.tsv import write_overlaps_path as jax_write_path
from fedrann_tpu_torch import _build
from fedrann_tpu_torch.io import native
from fedrann_tpu_torch.io.fastx import read_fastx
from fedrann_tpu_torch.io.packing import bit_pack, pack_reads
from fedrann_tpu_torch.io.tsv import write_overlaps_path, write_overlaps_tsv
from fedrann_tpu_torch.kmers.codec import unpack_bases, unpack_bases_len
from fedrann_tpu_torch.sim import simulate_reads


@functools.cache
def _host_toolchain_missing() -> str | None:
    """Why the host library cannot build here (no g++, no zlib.h), or
    None."""
    cxx = shutil.which("g++")
    if cxx is None:
        return "g++ not found: the host library builds from source"
    proc = subprocess.run([cxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                          input="#include <zlib.h>\n", capture_output=True,
                          text=True)
    return None if proc.returncode == 0 else "zlib.h not found"


@pytest.fixture
def host_toolchain():
    """Skips a test that builds the host library where it cannot build."""
    reason = _host_toolchain_missing()
    if reason is not None:
        pytest.skip(reason)


pytestmark = pytest.mark.usefixtures("host_toolchain")


def _sim(seed=45, length=1500, genome=20000):
    return simulate_reads(genome_length=genome, coverage=4,
                          mean_read_length=length, error_rate=0.03,
                          seed=seed)


def _write_case(tmp_path, case) -> tuple[str, tuple | None]:
    """(input path, length buckets) of one input case."""
    if case == "fasta":
        sim = _sim()
        path = tmp_path / "r.fasta"
        path.write_text("".join(f">{n} desc\n{s[:700]}\n{s[700:]}\n"
                                for n, s in zip(sim.names, sim.sequences)))
        return str(path), (1024, 2048, 4096)
    if case == "fastq_gz":
        sim = _sim(seed=46)
        path = tmp_path / "r.fastq.gz"
        with gzip.open(path, "wt") as f:
            for n, s in zip(sim.names, sim.sequences):
                f.write(f"@{n} extra\n{s}\n+\n{'I' * len(s)}\n")
        return str(path), None
    if case == "lower_n":
        rng = np.random.default_rng(7)
        path = tmp_path / "r.fasta"
        with open(path, "w") as f:
            for i in range(30):
                s = list("".join(rng.choice(list("ACGTacgt"), 900)))
                for j in rng.integers(0, 900, i % 4):  # mid-read N
                    s[j] = "Nn"[j % 2]
                f.write(f">low{i}\n{''.join(s)}\n")
            f.write(">iupac\nACGTRYKMNNacgt\n>empty\n>tail\nACGT\n")
        return str(path), (1024,)
    if case == "empty_lines":
        path = tmp_path / "r.fasta"
        path.write_text("\n\n>a one\nACGT\n\nACGT\n>b\n\nGGGG\n\n\n>c\nT\n\n")
        return str(path), (16, 64)
    if case == "split":  # reads past the largest bucket, split k - 1
        sim = _sim(seed=47, length=3000, genome=30000)
        path = tmp_path / "r.fasta.gz"
        with gzip.open(path, "wt") as f:
            for n, s in zip(sim.names, sim.sequences):
                f.write(f">{n}\n{s}\n")
        return str(path), (512, 1024)
    raise ValueError(case)


def _rows_in_read_order(bucket):
    """Each bucket's rows sorted stably by read index (pad rows last): the
    packers agree row for row within a read; the native one puts the
    segments of split reads after the reads that fit."""
    key = np.where(bucket.read_index < 0, np.iinfo(np.int32).max,
                   bucket.read_index)
    return np.argsort(key, kind="stable")


def _planes(bucket):
    if bucket.packed_bases is not None:
        return bucket.packed_bases, bucket.valid_bits
    return bit_pack(bucket.bases)


@pytest.mark.parametrize("case", ["fasta", "fastq_gz", "lower_n",
                                  "empty_lines", "split"])
def test_native_pack_matches_plain_and_jax(tmp_path, case):
    path, buckets = _write_case(tmp_path, case)
    split = 14 if case == "split" else None
    got = native.pack_reads_native(path, buckets, split_overlap=split)
    plain = pack_reads(read_fastx(path), buckets, split_overlap=split)
    jax_native = jax_pack_native(path, buckets, bit_packed=True,
                                 split_overlap=split)
    jax_plain = jax_pack_reads(jax_read_fastx(path), buckets,
                               split_overlap=split)
    for other in (plain, jax_native, jax_plain):
        assert got.names == other.names
        assert got.n_truncated == other.n_truncated
        assert len(got.buckets) == len(other.buckets)
        np.testing.assert_array_equal(
            got.split_read_ids if got.split_read_ids is not None else [],
            other.split_read_ids if other.split_read_ids is not None else [])
    if case == "split":
        assert got.split_read_ids is not None and len(got.split_read_ids)
    for b, p, jn, jp in zip(got.buckets, plain.buckets, jax_native.buckets,
                            jax_plain.buckets):
        # the JAX native packer: the same rows in the same order
        assert b.bases is None and b.length == jn.length
        for name in ("lengths", "read_index", "packed_bases", "valid_bits"):
            np.testing.assert_array_equal(getattr(b, name),
                                          getattr(jn, name))
        assert b.prefix_valid == jn.prefix_valid
        # the plain packers: the same rows in read order
        np.testing.assert_array_equal(p.bases, jp.bases)
        mine = _rows_in_read_order(b)
        theirs = _rows_in_read_order(p)
        for x, y in zip(_planes(b), _planes(p)):
            np.testing.assert_array_equal(x[mine], y[theirs])
        np.testing.assert_array_equal(b.lengths[mine], p.lengths[theirs])
        np.testing.assert_array_equal(b.read_index[mine],
                                      p.read_index[theirs])
        assert b.prefix_valid == p.prefix_valid == jp.prefix_valid
    if case == "lower_n":
        assert not got.buckets[0].prefix_valid
    elif case in ("fasta", "split"):
        assert all(b.prefix_valid for b in got.buckets)


@pytest.mark.parametrize("case", ["lower_n", "fastq_gz"])
def test_native_planes_unpack_to_plain_bytes(tmp_path, case):
    """The native 2-bit planes unpack (`unpack_bases`, and `unpack_bases_len`
    where the bucket is prefix-valid) to the byte matrix the plain packer
    builds, INVALID for N and padding included."""
    path, buckets = _write_case(tmp_path, case)
    got = native.pack_reads_native(path, buckets)
    want = pack_reads(read_fastx(path), buckets)
    assert len(got.buckets) == len(want.buckets)
    for b, w in zip(got.buckets, want.buckets):
        pk = torch.from_numpy(b.packed_bases)
        unpacked = unpack_bases(pk, torch.from_numpy(b.valid_bits), b.length)
        np.testing.assert_array_equal(unpacked.numpy(), w.bases)
        assert b.prefix_valid == (case == "fastq_gz")
        if b.prefix_valid:
            by_len = unpack_bases_len(pk, torch.from_numpy(b.lengths),
                                      b.length)
            assert torch.equal(by_len, unpacked)
        np.testing.assert_array_equal(b.lengths, w.lengths)


def test_threads_give_the_same_packing(tmp_path):
    """A plain FASTA parsed in 4 segments packs as it does on one thread."""
    sim = _sim(seed=48, length=1200, genome=40000)
    path = str(tmp_path / "r.fasta")
    with open(path, "w") as f:
        for n, s in zip(sim.names, sim.sequences):
            f.write(f">{n}\n{s}\n")
    one = native.pack_reads_native(path, None, threads=1)
    four = native.pack_reads_native(path, None, threads=4)
    assert one.names == four.names and len(one.names) > 50
    for a, b in zip(one.buckets, four.buckets):
        for name in ("lengths", "read_index", "packed_bases", "valid_bits"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_truncated_gzip_raises(tmp_path):
    sim = _sim(seed=5, length=1500, genome=40000)
    gz = tmp_path / "r.fasta.gz"
    with gzip.open(gz, "wt") as f:
        for n, s in zip(sim.names, sim.sequences):
            f.write(f">{n}\n{s}\n")
    data = gz.read_bytes()
    trunc = tmp_path / "trunc.fasta.gz"
    trunc.write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError, match="fastx_parse failed"):
        native.pack_reads_native(str(trunc), (2048,))


def test_malformed_fastq_raises(tmp_path):
    bad = tmp_path / "bad.fastq"
    bad.write_text("@r1\nACGTACGT\n+\nIIIIIIII\nEXTRA\n@r2\nACGT\n+\nIIII\n")
    with pytest.raises(ValueError, match="fastx_parse failed"):
        native.pack_reads_native(str(bad), (2048,))


def _neighbors(n_reads, k, seed):
    """(idx, dist) neighbor matrices of 2 n_reads rows with self rows and
    -1 (unset) entries."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 2 * n_reads, (2 * n_reads, k)).astype(np.int32)
    idx[:, 0] = np.arange(2 * n_reads)             # self rows
    idx[rng.random(idx.shape) < 0.1] = -1          # unset entries
    dist = rng.random(idx.shape).astype(np.float32) * 2
    dist[0, 1] = 0.1 + 2 ** -20                    # needs all 9 digits
    return idx, dist


@pytest.mark.parametrize("n_reads,k", [(7, 5), (1500, 12)])
def test_writer_matches_jax_and_plain(tmp_path, n_reads, k):
    """The C writer's overlaps.tsv is the JAX writer's and the port's plain
    writer's, byte for byte (names with latin-1 bytes included)."""
    names = [f"read_{i}" for i in range(n_reads)]
    names[1] = "r\xe9ad_1 with space"
    idx, dist = _neighbors(n_reads, k, n_reads)
    ours, theirs, plain = (str(tmp_path / f) for f in ("a", "b", "c"))
    rows = write_overlaps_path(ours, names, idx, dist)
    assert rows == jax_write_path(theirs, names, idx, dist)
    with open(plain, "w", encoding="latin-1") as f:
        assert rows == write_overlaps_tsv(f, names, idx, dist)
    with open(ours, "rb") as a, open(theirs, "rb") as b, \
            open(plain, "rb") as c:
        data = a.read()
        assert data == b.read() == c.read()
    assert rows == int(((idx >= 0) & (idx != np.arange(2 * n_reads)[:, None])
                        ).sum()) and rows > 0


def test_host_library_builds_into_kernels_dir():
    """The library loads from the port's own build (_kernels/, named by a
    hash of the source), never from the committed native/ build."""
    lib = native.load_native()
    path = os.path.realpath(lib._name)
    assert os.path.dirname(path) == os.path.realpath(_build.BUILD_DIR)
    assert path == os.path.realpath(_build.host_library_path())
    assert "native" not in os.path.relpath(path, _build.BUILD_DIR)


def test_failed_build_raises_with_compiler_output(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match=r"g\+\+ failed") as err:
        _build.build_host(bad)
    assert "error" in str(err.value)
    assert not _build.host_library_path(bad).exists()
