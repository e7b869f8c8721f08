"""fedrann_tpu_torch's eval (`truth_recall`, the two-table `main`) and the
compat reader of the reference's output.bin against the JAX package's:
the recall and the printed line exactly; the scan's names and indices
bitwise, its embedding bitwise (the same numpy sums), and the same
ValueError on a truncated or foreign file."""

from __future__ import annotations

import struct

import numpy as np
import pytest

from fedrann_tpu import compat as jcompat
from fedrann_tpu import eval as jeval
from fedrann_tpu.io.tsv import write_overlaps_path
from fedrann_tpu_torch import compat, eval as peval


def _neighbors(n_reads: int, k: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 2 * n_reads, (2 * n_reads, k)).astype(np.int32)
    idx[:, 0] = np.arange(2 * n_reads)
    idx[3, 2] = -1
    dist = np.sort(rng.random(idx.shape).astype(np.float32), axis=1)
    return idx, dist


def test_truth_recall_matches_jax():
    idx, _ = _neighbors(40, 6)
    rng = np.random.default_rng(1)
    truth = {(int(a), int(b)) for a, b in rng.integers(0, 40, (120, 2))
             if a < b}
    got = peval.truth_recall(idx, truth, 40)
    assert got == jeval.truth_recall(idx, truth, 40)
    assert 0.0 < got < 1.0
    assert peval.truth_recall(idx, set(), 40) == jeval.truth_recall(
        idx, set(), 40) == 0.0


@pytest.mark.parametrize("k", [None, 3])
def test_main_prints_jax_line(tmp_path, capsys, k):
    names = [f"r{i}" for i in range(30)]
    paths = []
    for seed in (0, 1):
        idx, dist = _neighbors(30, 8, seed)
        if seed:  # share most neighbors with the reference
            ref_idx, ref_dist = _neighbors(30, 8, 0)
            idx[::2], dist[::2] = ref_idx[::2], ref_dist[::2] + 1e-4
        paths.append(str(tmp_path / f"t{seed}.tsv"))
        write_overlaps_path(paths[-1], names, idx, dist)
    argv = paths + ([] if k is None else ["-k", str(k)])
    assert peval.main(argv) == 0
    ours = capsys.readouterr().out
    assert jeval.main(argv) == 0
    assert ours == capsys.readouterr().out
    assert ours.startswith("recall@k=")


def _write_scan(path, records, magic=b"KMER", version=1, total=None):
    with open(path, "wb") as f:
        f.write(struct.pack("<4sB3sQ", magic, version, b"\0\0\0",
                            len(records) if total is None else total))
        for name, idx in records:
            raw = name.encode("latin-1")
            f.write(struct.pack("<H", len(raw)) + raw)
            f.write(struct.pack("<I", len(idx)))
            f.write(np.asarray(idx, "<u8").tobytes())


def test_scan_reader_and_embedding_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    kmer_count = 50
    records = [(f"read_{i}", np.sort(rng.choice(2 * kmer_count, n,
                                                replace=False)))
               for i, n in enumerate((7, 0, 30, 1))]
    records[2] = ("r\xe9ad with space", records[2][1])
    path = str(tmp_path / "output.bin")
    _write_scan(path, records)
    names, rows = compat.load_reference_scan(path)
    names_j, rows_j = jcompat.load_reference_scan(path)
    assert names == names_j == [r[0] for r in records]
    for a, b in zip(rows, rows_j):
        assert a.dtype == b.dtype == np.int64 and np.array_equal(a, b)
    assert [n for n, _ in compat.read_reference_scan(path)] == names
    assert np.array_equal(
        compat.mirror_reference_indices(rows[0], kmer_count),
        jcompat.mirror_reference_indices(rows[0], kmer_count))
    p_ext = rng.standard_normal((2 * kmer_count + 1, 16)).astype(np.float32)
    emb = compat.embed_reference_rows(rows, p_ext, kmer_count)
    assert np.array_equal(
        emb, jcompat.embed_reference_rows(rows_j, p_ext, kmer_count))
    assert emb.shape == (8, 16) and not emb[2:4].any()


@pytest.mark.parametrize("broken,message", [
    ("header", "truncated output.bin header"),
    ("magic", "bad magic"),
    ("version", "unsupported version 2"),
    ("record", "truncated record header"),
    ("block", "truncated index block for b"),
])
def test_scan_reader_errors_match_jax(tmp_path, broken, message):
    path = str(tmp_path / "output.bin")
    records = [("a", [1, 2]), ("b", [3, 4, 5])]
    if broken == "header":
        with open(path, "wb") as f:
            f.write(b"KMER\x01\0\0")
    elif broken == "magic":
        _write_scan(path, records, magic=b"KMEX")
    elif broken == "version":
        _write_scan(path, records, version=2)
    elif broken == "record":
        _write_scan(path, records, total=3)
    else:
        _write_scan(path, records)
        with open(path, "r+b") as f:
            f.truncate(f.seek(0, 2) - 4)
    for mod in (compat, jcompat):
        with pytest.raises(ValueError, match=message):
            mod.load_reference_scan(path)
