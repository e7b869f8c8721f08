"""Host-side read packing: strings -> per-bucket (R, L) uint8 base codes.

The port's copy of the numpy packer in `fedrann_tpu/io/packing.py`, in the
per-base layout (A=0 C=1 G=2 T=3, anything else INVALID=4, padding
INVALID). Reads are grouped into the smallest length bucket that fits. A
read longer than the largest bucket is split into segments that overlap by
k - 1 bases (`segment_spans`), whose hits the embed stage merges back into
one exact union (`pipeline.split_union_rows`), or, without a split overlap,
truncated and counted.

The pipeline loads through the native packer (`io/native.py`), which fills
each bucket's 2-bit form (`packed_bases`, `valid_bits`) instead of the
byte matrix; `pack_reads(read_fastx(path), ...)` here is its plain version,
and `bit_pack` gives a byte matrix's 2-bit form.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from fedrann_tpu_torch.io.fastx import FastxRecord
from fedrann_tpu_torch.logging_utils import logger

INVALID = np.uint8(4)

_BASE_LUT = np.full(256, INVALID, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _BASE_LUT[ord(_ch)] = _code
    _BASE_LUT[ord(_ch.lower())] = _code


def encode_bases(seq: str) -> np.ndarray:
    """ASCII sequence -> uint8 codes in {0,1,2,3,4}."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _BASE_LUT[raw]


@dataclasses.dataclass
class PackedBucket:
    """Reads padded to one bucket length: the byte matrix `bases`, or the
    2-bit form (`packed_bases` and `valid_bits`), as in
    `fedrann_tpu/io/packing.py`."""

    bases: np.ndarray | None  # (R_b, L) uint8, INVALID-padded
    lengths: np.ndarray       # (R_b,) int32 bases of each row (0: pad row)
    read_index: np.ndarray    # (R_b,) int32 global read index, -1 = pad row
    # (R_b, ceil(L/4)) uint8: base j at bits 2 (j % 4) of byte j / 4,
    # INVALID and padding bases as 0
    packed_bases: np.ndarray | None = None
    # (R_b, ceil(L/8)) uint8: bit j % 8 of byte j / 8 set for a valid base
    valid_bits: np.ndarray | None = None
    length: int = 0           # L, bases per row
    # True: each row's valid bases are a prefix of its `lengths` (no
    # mid-read INVALID base), so lengths stand in for valid_bits; None:
    # not known
    prefix_valid: bool | None = None


def bit_pack(bases: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(packed_bases, valid_bits) of an (R, L) byte matrix, in the layout
    the native packer fills (`fastx_fill_bucket_packed`)."""
    r, length = bases.shape
    valid = bases < INVALID
    codes = np.zeros((r, -(-length // 4) * 4), np.uint8)
    codes[:, :length] = np.where(valid, bases, 0)
    packed = np.bitwise_or.reduce(
        codes.reshape(r, -1, 4) << np.arange(0, 8, 2, dtype=np.uint8),
        axis=2).astype(np.uint8)
    return packed, np.packbits(valid, axis=1, bitorder="little")


@dataclasses.dataclass
class PackedReads:
    names: list[str]              # global read order = input file order
    buckets: list[PackedBucket]   # ascending bucket length
    n_truncated: int = 0
    # reads split into several bucket rows (segment_spans); their rows share
    # one read_index, and the embed stage merges their hits
    split_read_ids: np.ndarray | None = None

    @property
    def n_reads(self) -> int:
        return len(self.names)


def segment_spans(length: int, max_len: int,
                  overlap: int) -> list[tuple[int, int]]:
    """(start, len) spans splitting a read of `length` bases into segments
    of at most max_len bases, consecutive segments sharing `overlap` bases.
    With overlap = k - 1 every k-window of the read lies in exactly one
    segment (segment j owns the windows starting in [j * stride, (j + 1) *
    stride)), so k-mer counts over the segments equal the unsplit read's."""
    stride = max_len - overlap
    if stride <= 0:
        raise ValueError(f"overlap {overlap} >= segment length {max_len}")
    spans = []
    start = 0
    while True:
        seg = min(max_len, length - start)
        spans.append((start, seg))
        if start + seg >= length:
            return spans
        start += stride


def auto_length_buckets(
    lengths,
    floor: int = 1024,
    cap: int = 262144,
    min_frac: float = 0.02,
    max_buckets: int = 8,
) -> tuple[int, ...]:
    """Power-of-two bucket ladder from the read-length histogram: the pow2
    classes the reads occupy, classes holding < min_frac of the reads merged
    upward, clamped to [floor, cap], at most max_buckets of them. The same
    ladder as the JAX package, so both pad reads identically."""
    lengths = np.asarray(lengths, dtype=np.int64)
    lengths = lengths[lengths > 0]
    if lengths.size == 0:
        return (int(floor),)
    classes = np.maximum(
        floor, 1 << np.ceil(np.log2(lengths)).astype(np.int64)
    )
    classes = np.minimum(classes, cap)
    uniq, counts = np.unique(classes, return_counts=True)
    total = int(counts.sum())
    keep: list[int] = []
    mass: list[int] = []
    carried = 0
    for c, n in zip(uniq, counts):
        carried += int(n)
        if carried >= min_frac * total or c == uniq[-1]:
            keep.append(int(c))
            mass.append(carried)
            carried = 0
    while len(keep) > max_buckets:
        i = int(np.argmin(mass[:-1]))
        mass[i + 1] += mass[i]
        del keep[i], mass[i]
    return tuple(keep)


def pack_reads(
    records: Iterable[FastxRecord],
    length_buckets: Sequence[int] | None,
    pad_rows_to: int = 8,
    split_overlap: int | None = None,
) -> PackedReads:
    """Group reads into the smallest bucket that fits; length_buckets=None
    derives the ladder from the data. A read longer than the largest bucket
    is split into segments overlapping by split_overlap (= k - 1) bases,
    each in the smallest bucket that fits it, when split_overlap is given,
    else truncated to the largest bucket (counted and logged). Row counts
    per bucket are padded to a multiple of pad_rows_to with all-INVALID
    rows (read_index -1). Counted in `.calls`."""
    pack_reads.calls += 1
    if length_buckets is None:
        records = list(records)
        length_buckets = auto_length_buckets(
            [len(r.sequence) for r in records]
        )
        logger.info("auto length buckets: %s", length_buckets)
    buckets = sorted(length_buckets)
    names: list[str] = []
    per_bucket: list[list[np.ndarray]] = [[] for _ in buckets]
    per_bucket_idx: list[list[int]] = [[] for _ in buckets]
    n_truncated = 0
    split_ids: list[int] = []

    for i, rec in enumerate(records):
        names.append(rec.name)
        codes = encode_bases(rec.sequence)
        b = int(np.searchsorted(buckets, len(codes)))
        if b == len(buckets):
            b = len(buckets) - 1
            if split_overlap is not None:
                split_ids.append(i)
                for start, seg in segment_spans(len(codes), buckets[b],
                                                split_overlap):
                    sb = min(int(np.searchsorted(buckets, seg)), b)
                    per_bucket[sb].append(codes[start : start + seg])
                    per_bucket_idx[sb].append(i)
                continue
            codes = codes[: buckets[b]]
            n_truncated += 1
        per_bucket[b].append(codes)
        per_bucket_idx[b].append(i)

    if n_truncated:
        logger.warning(
            "%d reads longer than the largest length bucket (%d) were "
            "truncated", n_truncated, buckets[-1])
    if split_ids:
        logger.info("%d reads longer than the largest bucket (%d) were "
                    "split", len(split_ids), buckets[-1])

    out: list[PackedBucket] = []
    for b, rows in enumerate(per_bucket):
        if not rows:
            continue
        n_rows = len(rows)
        padded_rows = -(-n_rows // pad_rows_to) * pad_rows_to
        mat = np.full((padded_rows, buckets[b]), INVALID, np.uint8)
        lengths = np.zeros(padded_rows, np.int32)
        for r, codes in enumerate(rows):
            mat[r, : len(codes)] = codes
            lengths[r] = len(codes)
        read_index = np.full(padded_rows, -1, np.int32)
        read_index[:n_rows] = per_bucket_idx[b]
        # rows are INVALID past their lengths, so any INVALID base within
        # them is a mid-read one
        prefix_valid = int((mat < INVALID).sum()) == int(lengths.sum())
        out.append(PackedBucket(bases=mat, lengths=lengths,
                                read_index=read_index, length=buckets[b],
                                prefix_valid=prefix_valid))
    return PackedReads(
        names=names, buckets=out, n_truncated=n_truncated,
        split_read_ids=(np.asarray(split_ids, np.int32) if split_ids
                        else None))


pack_reads.calls = 0
