"""k-mer codec: 2-bit window codes, reverse complement, canonical form, the
sampling hash, and kernel A (`canonical_sample`).

Codes are ONE int64 per window for every k <= 31 (the JAX package's u32 word
tuples exist only for the TPU compiler). CPU torch has no uint32 shifts or
compares and its int64 `>>` is arithmetic, so 32-bit hashes are held in
int64 and masked with 0xFFFFFFFF after every multiply, and 64-bit mixing
uses explicit logical shifts. Every function is bitwise equal to its
counterpart in `fedrann_tpu/kmers/codec.py` and `fedrann_tpu/oracle.py`.

A staged slot is (canon << 1) | is_fwd for a sampled valid window and
PAD_SLOT (INT64_MAX) otherwise; sorted slots order by (code, strand).
"""

from __future__ import annotations

import torch

from fedrann_tpu_torch import _build

PAD_SLOT = (1 << 63) - 1
_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


def _i64(x: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    x &= _M64
    return x - (1 << 64) if x >= (1 << 63) else x


_GOLDEN = _i64(0x9E3779B97F4A7C15)
_MIX1 = _i64(0xBF58476D1CE4E5B9)
_MIX2 = _i64(0x94D049BB133111EB)


def fmix32(x):
    """murmur3 finalizer on uint32 values held in int64 tensors (or on a
    Python int)."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def seed_mix32(seed: int) -> tuple[int, int]:
    """(s1, s2) of sample_hash32 for a library seed (Python ints: a
    kernel launch computes them on the host each call)."""
    s1 = fmix32(seed & _M32)
    return s1, fmix32(s1 ^ 0x9E3779B9)


def sample_hash32(codes: torch.Tensor, seed: int) -> torch.Tensor:
    """The library-sampling hash of canonical int64 codes (as uint32 values
    in int64), over lo = code & 0xFFFFFFFF and hi = code >> 32. For k <= 16
    hi is 0, which is the JAX one-word case."""
    s1, s2 = seed_mix32(seed)
    h1 = fmix32((codes & _M32) ^ s1)
    h2 = fmix32((codes >> 32) ^ s2 ^ h1)
    return fmix32(h1 ^ h2)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 on int64 bit patterns (wrapping add/mul equal uint64's)."""
    z = x + _GOLDEN
    z = (z ^ _srl(z, 30)) * _MIX1
    z = (z ^ _srl(z, 27)) * _MIX2
    return z ^ _srl(z, 31)


def sample_threshold(fraction: float) -> int:
    """uint32 threshold: a code is sampled iff sample_hash32 < threshold."""
    return min(int(fraction * 2.0**32), 2**32 - 1)


def canonical_window_codes(bases: torch.Tensor, k: int):
    """Canonical codes of all k-windows of an (R, L) uint8 base batch.

    Returns (canon, is_fwd, valid), each (R, L-k+1): canon int64 with
    PAD_SLOT where the window holds a base >= 4; is_fwd = the read-strand
    code is the canonical form (a palindrome counts as forward)."""
    r, length = bases.shape
    if length < k:
        raise ValueError(f"bucket length {length} < k={k}")
    w = length - k + 1
    b = bases.to(torch.int64)
    code = torch.zeros((r, w), dtype=torch.int64, device=bases.device)
    rc = torch.zeros_like(code)
    valid = torch.ones((r, w), dtype=torch.bool, device=bases.device)
    for j in range(k):
        bj = b[:, j : j + w]
        valid &= bj < 4
        v = bj & 3
        code = (code << 2) | v
        rc |= (v ^ 3) << (2 * j)
    is_fwd = code <= rc
    canon = torch.where(valid, torch.minimum(code, rc), PAD_SLOT)
    return canon, is_fwd, valid


def _canonical_sample_plain(bases, k, seed, threshold, keep_all):
    canon, is_fwd, valid = canonical_window_codes(bases, k)
    keep = valid if keep_all else valid & (sample_hash32(canon, seed)
                                            < threshold)
    return torch.where(keep, (canon << 1) | is_fwd.to(torch.int64), PAD_SLOT)


def check_bases(bases: torch.Tensor, k: int) -> int:
    """Raise on what the window-code kernels do not take; returns the
    windows per row, L - k + 1."""
    if bases.dtype != torch.uint8 or bases.dim() != 2:
        raise ValueError("bases must be a 2-D uint8 tensor")
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31], got {k}")
    if bases.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {bases.device}")
    if bases.shape[1] < k:
        raise ValueError(f"bucket length {bases.shape[1]} < k={k}")
    return bases.shape[1] - k + 1


def canonical_sample(bases: torch.Tensor, k: int, seed: int, threshold: int,
                     keep_all: bool) -> torch.Tensor:
    """(R, L) uint8 bases -> (R, L-k+1) int64 staged slots: (canon << 1) |
    is_fwd where the window is valid and (keep_all or sample_hash32(canon,
    seed) < threshold), PAD_SLOT elsewhere.

    A CPU tensor takes the plain PyTorch version; a CUDA tensor launches
    kernel A (csrc/canonical_sample.cu). The staging stage launches it
    only for rows whose survivors kernel B must sort in device memory
    (membership.stage_candidates); the others never write this plane."""
    w = check_bases(bases, k)
    if bases.device.type == "cpu":
        return _canonical_sample_plain(bases, k, seed, threshold, keep_all)
    r, length = bases.shape
    bases = bases.contiguous()
    out = torch.empty((r, w), dtype=torch.int64, device=bases.device)
    s1, s2 = seed_mix32(seed)
    _build.launch("fk_canonical_sample", bases.data_ptr(), r, length, w, k,
                  s1, s2, int(threshold) & _M32, int(bool(keep_all)),
                  out.data_ptr(), _build.stream(bases.device))
    canonical_sample.launches += 1
    return out


canonical_sample.launches = 0
