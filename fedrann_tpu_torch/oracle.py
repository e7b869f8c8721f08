"""Numpy oracle: the pipeline's semantics, small-scale and readable (the
port's own copy of `fedrann_tpu/oracle.py`, numpy only).

- canonical k-mer coding: min(code, reverse complement);
- library sampling by a seeded hash threshold (order-free and
  deterministic);
- feature space: the sampled library of L canonical k-mers sorted by code;
  index f in [0, L) means the read-strand k-mer is the canonical form, f +
  L that it was the reverse complement;
- a read's reverse-complement row mirrors its indices i <-> i + L;
- binary presence; ICF = log(n_features / (count + 1e-12)) shared by both
  halves; SRP of density 1/sqrt(n_features), values +-1, scale
  sqrt(1/density)/sqrt(d);
- exact cosine k-NN; reads with no hit get zero rows and are never
  dropped.

Its KmerLibrary is the port's (`kmers/library.py`), codes as int64.
"""

from __future__ import annotations

import numpy as np
import torch

from fedrann_tpu_torch.io.packing import encode_bases
from fedrann_tpu_torch.kmers.library import KmerLibrary

INVALID_CODE = np.uint64(0xFFFFFFFFFFFFFFFF)

# --- 2-bit codec -----------------------------------------------------------


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
    codes[~ok] = INVALID_CODE
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


# --- sampling hash ---------------------------------------------------------


def splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's 64-bit mix (the SRP stream's hash)."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = x + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return z


def fmix32(x: np.ndarray) -> np.ndarray:
    """murmur3's 32-bit finalizer."""
    x = np.asarray(x, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x85EBCA6B)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(0xC2B2AE35)
        x = x ^ (x >> np.uint32(16))
    return x


def sample_hash32(codes: np.ndarray, seed: int) -> np.ndarray:
    """The library-sampling hash: uint32, over the (hi, lo) words of the
    canonical code."""
    codes = np.asarray(codes, dtype=np.uint64)
    lo = (codes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (codes >> np.uint64(32)).astype(np.uint32)
    s1 = fmix32(np.uint32(seed & 0xFFFFFFFF))
    s2 = fmix32(s1 ^ np.uint32(0x9E3779B9))
    h1 = fmix32(lo ^ s1)
    h2 = fmix32(hi ^ s2 ^ h1)
    return fmix32(h1 ^ h2)


def sample_mask(codes: np.ndarray, fraction: float, seed: int) -> np.ndarray:
    """Keep a canonical code iff sample_hash32(code) < fraction * 2**32."""
    if fraction >= 1.0:
        return np.ones(len(codes), dtype=bool)
    threshold = np.uint32(min(int(fraction * 2.0**32), 2**32 - 1))
    return sample_hash32(codes, seed) < threshold


# --- library construction --------------------------------------------------


def build_library(sequences: list[str], k: int, min_multiplicity: int,
                  sample_fraction: float, seed: int) -> KmerLibrary:
    """Canonical counting, then the multiplicity filter, then the
    hash-threshold sample."""
    all_codes = [np.zeros(0, dtype=np.uint64)]
    for seq in sequences:
        c = kmer_code(encode_bases(seq), k)
        all_codes.append(canonical_code(c[c != INVALID_CODE], k))
    uniq, counts = np.unique(np.concatenate(all_codes), return_counts=True)
    keep = counts >= min_multiplicity
    uniq, counts = uniq[keep], counts[keep]
    smask = sample_mask(uniq, sample_fraction, seed)
    return KmerLibrary(codes=torch.from_numpy(uniq[smask].astype(np.int64)),
                       counts=torch.from_numpy(counts[smask].astype(np.int64)))


# --- per-read feature rows -------------------------------------------------


def read_feature_indices(seq: str, k: int, library: KmerLibrary) -> np.ndarray:
    """Sorted unique feature indices of one read's forward scan: f in [0,
    L) where the window is the library's canonical code, f + L where it
    was the reverse complement. A palindromic window maps to the forward
    half only."""
    lib_codes = library.numpy()[0]
    codes = kmer_code(encode_bases(seq), k)
    codes = codes[codes != INVALID_CODE]
    if len(codes) == 0:
        return np.zeros(0, dtype=np.int64)
    rc = revcomp_code(codes, k)
    canon = np.minimum(codes, rc)
    pos = np.searchsorted(lib_codes, canon)
    pos = np.clip(pos, 0, max(library.size - 1, 0))
    hit = (library.size > 0) & (lib_codes[pos] == canon)
    feat = np.where(codes <= rc, pos, pos + library.size)
    return np.unique(feat[hit])


def mirror_indices(feat: np.ndarray, library_size: int) -> np.ndarray:
    """The reverse-complement row: indices mirrored i <-> i + L."""
    return np.sort(np.where(feat < library_size, feat + library_size,
                            feat - library_size))


def feature_rows(sequences: list[str], k: int,
                 library: KmerLibrary) -> list[np.ndarray]:
    """2R rows in (read0_fwd, read0_rev, read1_fwd, ...) order."""
    rows = []
    for seq in sequences:
        fwd = read_feature_indices(seq, k, library)
        rows.append(fwd)
        rows.append(mirror_indices(fwd, library.size))
    return rows


# --- projection ------------------------------------------------------------


def icf_weights(library: KmerLibrary) -> np.ndarray:
    """(2L,) float32; both halves share the canonical multiplicity."""
    counts = library.numpy()[1]
    counts = np.concatenate([counts, counts]).astype(np.float64)
    return np.log(library.n_features / (counts + 1e-12)).astype(np.float32)


def srp_matrix(n_features: int, n_components: int, seed: int,
               density: float | None = None) -> np.ndarray:
    """Dense (n_features, n_components) SRP: an entry is nonzero with
    probability density, +-sqrt(1/density)/sqrt(n_components), from a
    splitmix64 stream over (feature, component)."""
    if density is None:
        density = 1.0 / np.sqrt(n_features)
    f = np.arange(n_features, dtype=np.uint64)[:, None]
    c = np.arange(n_components, dtype=np.uint64)[None, :]
    with np.errstate(over="ignore"):
        h = splitmix64(f * np.uint64(0x9E3779B97F4A7C15) + c
                       + splitmix64(np.uint64(seed)))
    nonzero = (h >> np.uint64(1)) < np.uint64(int(density * 2.0**63))
    sign = np.where((h & np.uint64(1)) == 1, 1.0, -1.0)
    scale = np.sqrt(1.0 / density) / np.sqrt(n_components)
    return (nonzero * sign * scale).astype(np.float32)


def embed(rows: list[np.ndarray], library: KmerLibrary, n_components: int,
          seed: int, density: float | None = None) -> np.ndarray:
    """(2R, d) float32: E[r] = sum over f in hits(r) of icf[f] * SRP[f, :];
    zero-hit rows are zero vectors."""
    icf = icf_weights(library)
    srp = srp_matrix(library.n_features, n_components, seed, density)
    p = srp * icf[:, None]
    out = np.zeros((len(rows), n_components), dtype=np.float32)
    for r, feat in enumerate(rows):
        if len(feat):
            out[r] = p[feat].sum(axis=0)
    return out


# --- exact k-NN ------------------------------------------------------------


def knn_cosine(embeddings: np.ndarray, n_neighbors: int):
    """Exact cosine top-k over all rows in float64, self included (rank 0,
    distance 0); zero rows are at distance 1 from everything; ties go to
    the lower index."""
    e = embeddings.astype(np.float64)
    norms = np.linalg.norm(e, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    en = e / norms
    dist = 1.0 - en @ en.T
    k = min(n_neighbors, dist.shape[0])
    idx = np.argsort(dist, axis=1, kind="stable")[:, :k]
    d = np.take_along_axis(dist, idx, axis=1)
    return idx.astype(np.int64), d.astype(np.float32)


# --- full pipeline ---------------------------------------------------------


def run_oracle_pipeline(sequences: list[str], k: int, sample_fraction: float,
                        min_multiplicity: int, n_components: int,
                        n_neighbors: int, library_seed: int,
                        projection_seed: int, density: float | None = None):
    """End to end: (library, embeddings, indices, distances)."""
    library = build_library(sequences, k, min_multiplicity, sample_fraction,
                            library_seed)
    rows = feature_rows(sequences, k, library)
    emb = embed(rows, library, n_components, projection_seed, density)
    idx, dist = knn_cosine(emb, n_neighbors)
    return library, emb, idx, dist
