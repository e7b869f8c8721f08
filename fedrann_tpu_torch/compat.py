"""Imports of a reference run's library and projection (the port's copy of
the loaders in `fedrann_tpu/compat.py`), for `--import-library` and
`--import-projection`:

- a jellyfish-dump k-mer library FASTA: header `>count`, sequence = k-mer;
- a scipy sparse precompute matrix .npz (n_features, d);
- the reference's `output.bin` of per-read library index sets ("KMER" v1),
  read by `read_reference_scan` and embedded through our math by
  `embed_reference_rows`.

Index spaces: the reference's feature f is the position of the k-mer in
its library file (f + L_file for the reverse complement); ours is the rank
of the canonical code in the sorted library, with [L, 2L) meaning the read
strand was the reverse complement. jellyfish's canonical choice differs
from ours, so a file entry listed in our non-canonical form swaps its two
halves. `load_reference_library_mapping` returns the permutation that
covers the sort and these swaps, so the reference's projection rows can be
permuted into our index space exactly.
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np
import torch

from fedrann_tpu_torch.io.fastx import read_fastx
from fedrann_tpu_torch.io.packing import encode_bases
from fedrann_tpu_torch.kmers.library import KmerLibrary
from fedrann_tpu_torch.oracle import INVALID_CODE, canonical_code, kmer_code

def _parse_library_entries(fasta_path: str, k: int):
    """(canonical codes uint64, counts int64, flipped bool) of the file's
    valid entries in file order. Entries of another length than k, or
    holding a base other than ACGT, are skipped; a header that is not an
    integer counts 1. All entries are coded at once: their concatenation's
    windows at multiples of k are exactly the entries."""
    seqs, counts = [], []
    for rec in read_fastx(fasta_path):
        if len(rec.sequence) != k:
            continue
        seqs.append(rec.sequence)
        try:
            counts.append(int(rec.name))
        except ValueError:
            counts.append(1)
    codes = kmer_code(encode_bases("".join(seqs)), k)[::k]
    ok = codes != INVALID_CODE
    codes = codes[ok]
    canon = canonical_code(codes, k)
    return (canon, np.asarray(counts, dtype=np.int64)[ok], canon != codes)


def load_reference_library(fasta_path: str, k: int) -> KmerLibrary:
    """A jellyfish-dump library as a port KmerLibrary sorted by our
    canonical code (see load_reference_library_mapping)."""
    return load_reference_library_mapping(fasta_path, k)[0]


def load_reference_library_mapping(
    fasta_path: str, k: int
) -> tuple[KmerLibrary, np.ndarray]:
    """(library, perm): the library sorted by our canonical code, first
    file occurrence kept among duplicates, and perm (2L + 1,) int64 mapping
    our extended feature index (i < L: read strand canonical; L <= i < 2L:
    reverse complement; 2L: sentinel) to the reference's (file position f
    for the listed string, f + n_file for its reverse complement, 2 * n_file
    for the sentinel). An entry listed in flipped form swaps its halves."""
    codes, counts, flipped = _parse_library_entries(fasta_path, k)
    n_file = len(codes)
    order = np.argsort(codes, kind="stable")
    codes, counts, flipped = codes[order], counts[order], flipped[order]
    file_pos = order.astype(np.int64)
    if n_file:
        keep = np.concatenate([[True], codes[1:] != codes[:-1]])
        codes, counts = codes[keep], counts[keep]
        flipped, file_pos = flipped[keep], file_pos[keep]
    size = len(codes)
    perm = np.empty(2 * size + 1, dtype=np.int64)
    perm[:size] = np.where(flipped, file_pos + n_file, file_pos)
    perm[size : 2 * size] = np.where(flipped, file_pos, file_pos + n_file)
    perm[2 * size] = 2 * max(n_file, 1)
    library = KmerLibrary(codes=torch.from_numpy(codes.astype(np.int64)),
                          counts=torch.from_numpy(counts))
    return library, perm


def load_reference_precompute(
    npz_path: str, perm: np.ndarray | None = None
) -> np.ndarray:
    """A scipy-sparse .npz precompute matrix P (n_features, d) as dense
    float32 with a trailing zero sentinel row; with perm (from
    load_reference_library_mapping) its rows permuted into our extended
    index space."""
    import scipy.sparse as sp

    p = sp.load_npz(npz_path).toarray().astype(np.float32)
    p_ext = np.concatenate([p, np.zeros((1, p.shape[1]), np.float32)])
    if perm is None:
        return p_ext
    if perm.max() >= p_ext.shape[0]:
        raise ValueError(
            f"permutation references row {perm.max()} but precompute has "
            f"{p_ext.shape[0]} rows (library/projection mismatch?)")
    return p_ext[perm]


# --- output.bin ("KMER" v1) ------------------------------------------------


def read_reference_scan(path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Stream (read name, forward-row library indices int64) records of
    the reference's output.bin. Little endian: 4s magic "KMER", u8 version
    1, 3 reserved bytes, u64 record count; per record u16 name length, the
    name, u32 index count, u64 indices. Only the forward row is stored
    (mirror_reference_indices gives the reverse). Raises ValueError on a
    truncated file, a foreign magic or another version."""
    with open(path, "rb") as f:
        header = f.read(16)
        if len(header) < 16:
            raise ValueError(f"{path}: truncated output.bin header")
        magic, version, _reserved, total = struct.unpack("<4sB3sQ", header)
        if magic != b"KMER":
            raise ValueError(f"{path}: bad magic {magic!r}")
        if version != 1:
            raise ValueError(f"{path}: unsupported version {version}")
        for _ in range(total):
            raw = f.read(2)
            if len(raw) < 2:
                raise ValueError(f"{path}: truncated record header")
            (id_len,) = struct.unpack("<H", raw)
            name = f.read(id_len).decode("latin-1")
            (count,) = struct.unpack("<I", f.read(4))
            data = f.read(8 * count)
            if len(data) < 8 * count:
                raise ValueError(f"{path}: truncated index block for {name}")
            yield name, np.frombuffer(data, dtype="<u8").astype(np.int64)


def load_reference_scan(path: str) -> tuple[list[str], list[np.ndarray]]:
    """output.bin as (names, each read's forward index array)."""
    names, rows = [], []
    for name, idx in read_reference_scan(path):
        names.append(name)
        rows.append(idx)
    return names, rows


def mirror_reference_indices(indices: np.ndarray,
                             kmer_count: int) -> np.ndarray:
    """The reference's reverse-row mirror i <-> i + kmer_count."""
    return np.where(indices < kmer_count, indices + kmer_count,
                    indices - kmer_count)


def embed_reference_rows(rows: list[np.ndarray], p_ext: np.ndarray,
                         kmer_count: int) -> np.ndarray:
    """The reference's per-read index sets through our embedding math: a
    row is the sum of the precompute rows at its indices (binary presence
    times P), fwd/rev interleaved into (2R, d) float32. p_ext is in the
    reference's index space (load_reference_precompute without perm)."""
    out = np.zeros((2 * len(rows), p_ext.shape[1]), dtype=np.float32)
    for r, idx in enumerate(rows):
        if len(idx):
            out[2 * r] = p_ext[idx].sum(axis=0)
            out[2 * r + 1] = p_ext[
                mirror_reference_indices(idx, kmer_count)].sum(axis=0)
    return out
