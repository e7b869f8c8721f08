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

The window-code kernels read a bucket chunk in one of three forms (its
source): an (R, L) uint8 byte matrix, or a `PackedChunk`, the native
packer's 2-bit stream with per-row lengths ("packed": every row's valid
bases a prefix) or with its valid-bits plane ("bits": mid-read INVALID
bases). The plain version of a packed source is `unpack_bases_len` or
`unpack_bases`, then the byte plain version.
"""

from __future__ import annotations

import dataclasses

import torch

from fedrann_tpu_torch import _build

PAD_SLOT = (1 << 63) - 1
_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
INVALID = 4
# the `src` argument of the window-code kernels' C entry points
SOURCES = {"bytes": 0, "packed": 1, "bits": 2}


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


def _bits(x: torch.Tensor, width: int, length: int) -> torch.Tensor:
    """The first `length` fields of `width` bits of each row of (R, B)
    uint8 x, LSB-first within a byte: (R, length) uint8."""
    shifts = torch.arange(0, 8, width, dtype=torch.uint8, device=x.device)
    fields = (x[:, :, None] >> shifts) & ((1 << width) - 1)
    return fields.reshape(x.shape[0], -1)[:, :length]


def unpack_bases(packed: torch.Tensor, valid_bits: torch.Tensor,
                 length: int) -> torch.Tensor:
    """(R, ceil(L/4)) uint8 2-bit stream (base j at bits 2 (j % 4) of byte
    j / 4) and (R, ceil(L/8)) uint8 valid bits (bit j % 8 of byte j / 8)
    -> the (R, L) uint8 byte matrix, INVALID where a base is not valid;
    bitwise `fedrann_tpu/kmers/codec.py` `unpack_bases`."""
    return _bits(packed, 2, length).masked_fill(
        _bits(valid_bits, 1, length) == 0, INVALID)


def unpack_bases_len(packed: torch.Tensor, lengths: torch.Tensor,
                     length: int) -> torch.Tensor:
    """The 2-bit stream with (R,) int32 row lengths standing in for the
    valid bits (every row's valid bases a prefix) -> the (R, L) uint8 byte
    matrix, INVALID from min(lengths[r], L) on; bitwise
    `fedrann_tpu/kmers/codec.py` `unpack_bases_len`."""
    col = torch.arange(length, device=packed.device)
    return _bits(packed, 2, length).masked_fill(
        col[None, :] >= lengths.clamp(max=length)[:, None], INVALID)


@dataclasses.dataclass(frozen=True)
class PackedChunk:
    """Rows of a bucket in the native packer's 2-bit form, as the
    window-code kernels read them: `packed` with `lengths` (source
    "packed") or with `valid_bits` (source "bits"), one of the two."""

    packed: torch.Tensor                     # (R, ceil(L/4)) uint8
    length: int                              # L, bases per row
    lengths: torch.Tensor | None = None      # (R,) int32
    valid_bits: torch.Tensor | None = None   # (R, ceil(L/8)) uint8

    def __post_init__(self):
        p = self.packed
        if p.dtype != torch.uint8 or p.dim() != 2 \
                or p.shape[1] != -(-self.length // 4):
            raise ValueError(f"packed must be (R, {-(-self.length // 4)}) "
                             f"uint8, got {tuple(p.shape)} {p.dtype}")
        if (self.lengths is None) == (self.valid_bits is None):
            raise ValueError("a PackedChunk holds lengths or valid_bits")
        if self.lengths is not None and (
                self.lengths.dtype != torch.int32
                or tuple(self.lengths.shape) != (p.shape[0],)
                or self.lengths.device != p.device):
            raise ValueError(f"lengths must be ({p.shape[0]},) int32 on "
                             f"{p.device}")
        if self.valid_bits is not None and (
                self.valid_bits.dtype != torch.uint8
                or tuple(self.valid_bits.shape)
                != (p.shape[0], -(-self.length // 8))
                or self.valid_bits.device != p.device):
            raise ValueError(f"valid_bits must be ({p.shape[0]}, "
                             f"{-(-self.length // 8)}) uint8 on {p.device}")

    @property
    def source(self) -> str:
        return "packed" if self.lengths is not None else "bits"

    @property
    def aux(self) -> torch.Tensor:
        return self.lengths if self.lengths is not None else self.valid_bits

    @property
    def shape(self) -> tuple[int, int]:
        return (self.packed.shape[0], self.length)

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def __getitem__(self, rows: slice) -> "PackedChunk":
        return PackedChunk(
            self.packed[rows], self.length,
            None if self.lengths is None else self.lengths[rows],
            None if self.valid_bits is None else self.valid_bits[rows])

    def to(self, device: torch.device,
           non_blocking: bool = False) -> "PackedChunk":
        """The same rows on `device` (the same tensors where they already
        lie there)."""
        def move(t):
            return None if t is None else t.to(device,
                                               non_blocking=non_blocking)
        return PackedChunk(move(self.packed), self.length,
                           move(self.lengths), move(self.valid_bits))

    def unpack(self) -> torch.Tensor:
        """The (R, L) byte matrix: the plain version's input."""
        if self.lengths is not None:
            return unpack_bases_len(self.packed, self.lengths, self.length)
        return unpack_bases(self.packed, self.valid_bits, self.length)


def as_bytes(bases) -> torch.Tensor:
    """A window-code input as its (R, L) byte matrix."""
    return bases.unpack() if isinstance(bases, PackedChunk) else bases


def source_args(bases) -> tuple:
    """(contiguous bases or 2-bit stream, contiguous lengths or valid bits
    or None, source name) of a window-code input, for a kernel launch."""
    if isinstance(bases, PackedChunk):
        return (bases.packed.contiguous(), bases.aux.contiguous(),
                bases.source)
    return bases.contiguous(), None, "bytes"


def count_launch(fn, source: str) -> None:
    """One launch of a window-code kernel's wrapper `fn` on `source`: its
    total count `.launches` and its source's `.<source>_launches`."""
    fn.launches += 1
    name = f"{source}_launches"
    setattr(fn, name, getattr(fn, name) + 1)


def reset_counts(fn) -> None:
    """A window-code kernel's wrapper's counts to 0."""
    fn.launches = 0
    for source in SOURCES:
        setattr(fn, f"{source}_launches", 0)


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


def check_bases(bases, k: int) -> int:
    """Raise on what the window-code kernels do not take (a byte matrix or
    a PackedChunk); returns the windows per row, L - k + 1."""
    if not isinstance(bases, PackedChunk) and (
            bases.dtype != torch.uint8 or bases.dim() != 2):
        raise ValueError("bases must be a 2-D uint8 tensor or a PackedChunk")
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31], got {k}")
    if bases.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {bases.device}")
    if bases.shape[1] < k:
        raise ValueError(f"bucket length {bases.shape[1]} < k={k}")
    return bases.shape[1] - k + 1


def canonical_sample(bases, k: int, seed: int, threshold: int,
                     keep_all: bool) -> torch.Tensor:
    """(R, L) bases, a uint8 byte matrix or a PackedChunk -> (R, L-k+1)
    int64 staged slots: (canon << 1) | is_fwd where the window is valid and
    (keep_all or sample_hash32(canon, seed) < threshold), PAD_SLOT
    elsewhere.

    A CPU input takes the plain PyTorch version (a PackedChunk unpacked
    first); a CUDA one launches kernel A (csrc/canonical_sample.cu) on its
    source, counted in `.launches` and `.<source>_launches`. The staging
    stage launches it only for rows whose survivors kernel B must sort in
    device memory (membership.stage_candidates); the others never write
    this plane."""
    w = check_bases(bases, k)
    if bases.device.type == "cpu":
        return _canonical_sample_plain(as_bytes(bases), k, seed, threshold,
                                       keep_all)
    r, length = bases.shape
    data, aux, source = source_args(bases)
    out = torch.empty((r, w), dtype=torch.int64, device=bases.device)
    s1, s2 = seed_mix32(seed)
    _build.launch("fk_canonical_sample", data.data_ptr(),
                  None if aux is None else aux.data_ptr(), SOURCES[source],
                  r, length, w, k, s1, s2, int(threshold) & _M32,
                  int(bool(keep_all)), out.data_ptr(), device=bases.device)
    count_launch(canonical_sample, source)
    return out


reset_counts(canonical_sample)
