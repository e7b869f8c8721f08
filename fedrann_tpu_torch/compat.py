"""Imports of a reference run's library and projection (the port's copy of
the loaders in `fedrann_tpu/compat.py`), for `--import-library` and
`--import-projection`:

- a jellyfish-dump k-mer library FASTA: header `>count`, sequence = k-mer;
- a scipy sparse precompute matrix .npz (n_features, d).

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

import numpy as np
import torch

from fedrann_tpu_torch.io.fastx import read_fastx
from fedrann_tpu_torch.io.packing import encode_bases
from fedrann_tpu_torch.kmers.library import KmerLibrary

_INVALID_CODE = np.uint64(0xFFFFFFFFFFFFFFFF)


def kmer_code(seq_codes: np.ndarray, k: int) -> np.ndarray:
    """All k-length window codes of a base-code vector (uint64); a window
    holding an invalid base (code > 3) gives the sentinel 2**64 - 1."""
    n = len(seq_codes)
    if n < k:
        return np.zeros(0, dtype=np.uint64)
    valid = seq_codes < 4
    codes = np.zeros(n - k + 1, dtype=np.uint64)
    ok = np.ones(n - k + 1, dtype=bool)
    for j in range(k):
        window = seq_codes[j : j + n - k + 1].astype(np.uint64)
        codes = (codes << np.uint64(2)) | np.where(
            valid[j : j + n - k + 1], window, 0)
        ok &= valid[j : j + n - k + 1]
    codes[~ok] = _INVALID_CODE
    return codes


def revcomp_code(codes: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of 2-bit k-mer codes (complement = XOR 3 per
    base, base order reversed)."""
    codes = np.asarray(codes, dtype=np.uint64)
    out = np.zeros_like(codes)
    tmp = codes.copy()
    for _ in range(k):
        out = (out << np.uint64(2)) | ((tmp & np.uint64(3)) ^ np.uint64(3))
        tmp >>= np.uint64(2)
    return out


def canonical_code(codes: np.ndarray, k: int) -> np.ndarray:
    return np.minimum(codes, revcomp_code(codes, k))


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
    ok = codes != _INVALID_CODE
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
