"""ctypes bindings for the native FASTX parser, bucket packer and TSV
writer (`native/fastxpack.cpp`, built by `_build.build_host`): the port's
own loader after `fedrann_tpu/io/native.py`.

The C++ library parses and 2-bit-encodes reads (zlib for .gz) and hands
numpy views back; `pack_reads_native` buckets them with vectorised numpy
and fills each bucket's planes in C. It gives the same PackedReads as
`packing.pack_reads(read_fastx(path), ...)`, the plain version the tests
hold it against. A failed parse raises ValueError. There is no fallback to
the Python reader: the library builds at first use or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from fedrann_tpu_torch import _build
from fedrann_tpu_torch.io.packing import (
    PackedBucket,
    PackedReads,
    auto_length_buckets,
    segment_spans,
)
from fedrann_tpu_torch.logging_utils import logger

_U8P = ctypes.POINTER(ctypes.c_uint8)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_I32P = ctypes.POINTER(ctypes.c_int32)


class _FastxParsed(ctypes.Structure):
    _fields_ = [
        ("codes", _U8P),
        ("offsets", _U64P),
        # POINTER(c_char), not c_char_p: the names are NUL-separated
        ("names", ctypes.POINTER(ctypes.c_char)),
        ("name_offsets", _U64P),
        ("n_reads", ctypes.c_uint64),
        ("total_bases", ctypes.c_uint64),
        ("names_bytes", ctypes.c_uint64),
    ]


class _FastxScan(ctypes.Structure):
    _fields_ = [
        ("rec_offsets", _U64P),
        ("names", ctypes.POINTER(ctypes.c_char)),
        ("name_offsets", _U64P),
        ("n_records", ctypes.c_uint64),
        ("names_bytes", ctypes.c_uint64),
    ]


@functools.cache
def load_native() -> ctypes.CDLL:
    """The host library, built from native/fastxpack.cpp on first call."""
    lib = ctypes.CDLL(str(_build.build_host()))
    lib.fastx_parse_threads.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(_FastxParsed)]
    lib.fastx_parse_threads.restype = ctypes.c_int
    lib.fastx_free.argtypes = [ctypes.POINTER(_FastxParsed)]
    lib.fastx_free.restype = None
    # path, lo, hi, threads, out: the records starting in file bytes
    # [lo, hi) of a plain FASTA (-6: not plain FASTA)
    lib.fastx_parse_range.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.POINTER(_FastxParsed)]
    lib.fastx_parse_range.restype = ctypes.c_int
    lib.fastx_scan_range.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(_FastxScan)]
    lib.fastx_scan_range.restype = ctypes.c_int
    lib.fastx_scan_free.argtypes = [ctypes.POINTER(_FastxScan)]
    lib.fastx_scan_free.restype = None
    lib.fastx_is_plain_fasta.argtypes = [ctypes.c_char_p]
    lib.fastx_is_plain_fasta.restype = ctypes.c_int
    # codes, offsets, rows, n_rows, bucket_len, out_packed, out_valid;
    # returns the invalid (non-ACGT) bases inside the filled rows
    lib.fastx_fill_bucket_packed.argtypes = [
        _U8P, _U64P, _I32P, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.fastx_fill_bucket_packed.restype = ctypes.c_int64
    # path (appended to), names blob, name offsets, n_names, idx (rows, k)
    # int32, dist (rows, k) float32, rows, k, row_offset
    lib.fastx_write_overlaps_matrix.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_char), _U64P,
        ctypes.c_uint64, _I32P, ctypes.POINTER(ctypes.c_float),
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64]
    lib.fastx_write_overlaps_matrix.restype = ctypes.c_int64
    return lib


def _names_blob(names) -> tuple[bytes, np.ndarray]:
    """NUL-separated latin-1 names (byte-preserving: a non-ASCII header
    byte round-trips) and each name's offset."""
    blob = b"\x00".join(n.encode("latin-1") for n in names) + b"\x00"
    lengths = np.fromiter((len(n) + 1 for n in names), np.uint64,
                          count=len(names))
    offsets = np.zeros(len(names), np.uint64)
    if len(names) > 1:
        offsets[1:] = np.cumsum(lengths[:-1])
    return blob, offsets


def write_overlaps_matrix_native(path: str, names, idx: np.ndarray,
                                 dist: np.ndarray, row_offset: int = 0) -> int:
    """Append the rows of the (rows, k) neighbor matrices to `path` with
    the C writer: self rows and negative targets are skipped in the C loop.
    Matrix row q is embedding row row_offset + q. Returns rows written."""
    lib = load_native()
    blob, offsets = _names_blob(names)
    i32 = np.ascontiguousarray(idx, dtype=np.int32)
    d32 = np.ascontiguousarray(dist, dtype=np.float32)
    rc = lib.fastx_write_overlaps_matrix(
        path.encode(),
        ctypes.cast(ctypes.create_string_buffer(blob, len(blob)),
                    ctypes.POINTER(ctypes.c_char)),
        offsets.ctypes.data_as(_U64P), len(names),
        i32.ctypes.data_as(_I32P),
        d32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        i32.shape[0], i32.shape[1], row_offset)
    if rc < 0:
        raise RuntimeError(f"fastx_write_overlaps_matrix failed: {rc}")
    return int(rc)


def is_plain_fasta(path: str) -> bool:
    """Whether the input is an uncompressed FASTA, the only input a byte
    range of can be parsed (gzip has no random access; a FASTQ '@' is
    ambiguous at a line start)."""
    return bool(load_native().fastx_is_plain_fasta(path.encode()))


def scan_records_native(path: str, lo: int, hi: int):
    """The records that START in file bytes [lo, hi) of a plain FASTA:
    (names, absolute byte offsets int64 of their '>'), with no base
    decoded. Raises ValueError on another input."""
    lib = load_native()
    scan = _FastxScan()
    rc = lib.fastx_scan_range(path.encode(), int(lo), int(hi),
                              ctypes.byref(scan))
    if rc != 0:
        raise ValueError(f"fastx_scan_range failed with code {rc} for {path}")
    try:
        n = int(scan.n_records)
        offsets = np.ctypeslib.as_array(
            scan.rec_offsets, shape=(max(n, 1),))[:n].astype(np.int64)
        names = ctypes.string_at(scan.names, scan.names_bytes).decode(
            "latin-1").split("\x00")[:n]
    finally:
        lib.fastx_scan_free(ctypes.byref(scan))
    return names, offsets


def parse_fastx_native(path: str, threads: int = 1,
                       byte_range: tuple[int, int] | None = None):
    """Parse with the C++ library: (names, codes uint8 (total bases,),
    offsets int64 (n + 1,)). threads > 1 parses a plain FASTA in parallel
    segments; gzip and FASTQ stream on one thread. byte_range (lo, hi),
    record starts from scan_records_native (hi may be the file size),
    parses only the records in those bytes of a plain FASTA. Raises
    ValueError on a parse error (a truncated gzip, a malformed record, an
    empty input, a byte range of another input)."""
    lib = load_native()
    parsed = _FastxParsed()
    if byte_range is not None:
        rc = lib.fastx_parse_range(path.encode(), int(byte_range[0]),
                                   int(byte_range[1]), int(max(1, threads)),
                                   ctypes.byref(parsed))
    else:
        rc = lib.fastx_parse_threads(path.encode(), int(max(1, threads)),
                                     ctypes.byref(parsed))
    if rc != 0:
        raise ValueError(f"fastx_parse failed with code {rc} for {path}")
    try:
        n = parsed.n_reads
        codes = np.ctypeslib.as_array(
            parsed.codes, shape=(parsed.total_bases,)).copy()
        # int64: uint64 mixed with signed ints promotes to float64
        offsets = np.ctypeslib.as_array(parsed.offsets,
                                        shape=(n + 1,)).astype(np.int64)
        names = ctypes.string_at(parsed.names, parsed.names_bytes).decode(
            "latin-1").split("\x00")[:n]
    finally:
        lib.fastx_free(ctypes.byref(parsed))
    return names, codes, offsets


_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int32): torch.int32}


def host_zeros(shape, dtype, pin_memory: bool) -> np.ndarray:
    """A zeroed host array; in page-locked memory when pin_memory (the
    array is a view of a pinned tensor, which it keeps alive), so a
    non_blocking upload of it is asynchronous."""
    if pin_memory:
        return torch.zeros(shape, dtype=_TORCH_DTYPES[np.dtype(dtype)],
                           pin_memory=True).numpy()
    return np.zeros(shape, dtype)


def pack_reads_native(path: str, length_buckets: Sequence[int] | None,
                      pad_rows_to: int = 8, threads: int = 1,
                      split_overlap: int | None = None,
                      pin_memory: bool = False,
                      byte_range: tuple[int, int] | None = None
                      ) -> PackedReads:
    """The native parse, then vectorised bucketing: the rows of
    pack_reads(read_fastx(path), ...) (length_buckets None: the auto
    ladder), each bucket in the 2-bit form the C packer fills
    (`packed_bases` 4 bases a byte, `valid_bits` 1 bit a base, and
    `prefix_valid`: no mid-read invalid base) and no byte matrix;
    pin_memory puts those planes and the row lengths in page-locked
    memory. split_overlap (= k - 1) splits a read past the largest bucket
    into segments instead of truncating it. byte_range packs only the
    records in those file bytes (parse_fastx_native), read indices from 0.
    Counted in `.calls`."""
    pack_reads_native.calls += 1
    names, codes, offsets = parse_fastx_native(path, threads, byte_range)
    lengths = np.diff(offsets).astype(np.int64)
    if length_buckets is None:
        length_buckets = auto_length_buckets(lengths)
        logger.info("auto length buckets: %s", length_buckets)
    buckets = sorted(length_buckets)
    over = np.flatnonzero(np.searchsorted(buckets, lengths) == len(buckets))
    split_ids = None
    n_truncated = 0
    # (read, start, length) of each bucket row; a read that fits is one span
    seg_read = np.arange(len(lengths), dtype=np.int64)
    seg_start = np.zeros(len(lengths), dtype=np.int64)
    seg_len = lengths.copy()
    if split_overlap is not None and len(over):
        split_ids = over.astype(np.int32)
        spans = [(r, start, seg) for r in over for start, seg in
                 segment_spans(int(lengths[r]), buckets[-1], split_overlap)]
        extra = np.asarray(spans, np.int64).reshape(-1, 3)
        keep = np.ones(len(lengths), dtype=bool)
        keep[over] = False
        seg_read = np.concatenate([seg_read[keep], extra[:, 0]])
        seg_start = np.concatenate([seg_start[keep], extra[:, 1]])
        seg_len = np.concatenate([seg_len[keep], extra[:, 2]])
        logger.info("%d reads longer than the largest bucket (%d) were "
                    "split", len(over), buckets[-1])
    else:
        n_truncated = len(over)
        if n_truncated:
            logger.warning("%d reads longer than the largest length bucket "
                           "(%d) were truncated", n_truncated, buckets[-1])
    bucket_of = np.minimum(np.searchsorted(buckets, seg_len),
                           len(buckets) - 1)
    # the C fill functions read row r's span as offsets[r], offsets[r + 1]:
    # segment i becomes the virtual row 2i of consecutive offset pairs
    virt = np.empty(2 * len(seg_read), dtype=np.uint64)
    virt[0::2] = offsets[seg_read] + seg_start
    virt[1::2] = offsets[seg_read] + seg_start + seg_len
    lib = load_native()
    codes_p, virt_p = codes.ctypes.data_as(_U8P), virt.ctypes.data_as(_U64P)
    out = []
    for b, bucket_len in enumerate(buckets):
        rows = np.flatnonzero(bucket_of == b)
        if len(rows) == 0:
            continue
        padded_rows = -(-len(rows) // pad_rows_to) * pad_rows_to
        rows32 = np.ascontiguousarray(2 * rows, dtype=np.int32)
        lens = host_zeros(padded_rows, np.int32, pin_memory)
        lens[: len(rows)] = np.minimum(seg_len[rows], bucket_len)
        read_index = np.full(padded_rows, -1, np.int32)
        read_index[: len(rows)] = seg_read[rows]
        pk = host_zeros((padded_rows, (bucket_len + 3) // 4), np.uint8,
                    pin_memory)
        vd = host_zeros((padded_rows, (bucket_len + 7) // 8), np.uint8,
                    pin_memory)
        n_invalid = lib.fastx_fill_bucket_packed(
            codes_p, virt_p, rows32.ctypes.data_as(_I32P), len(rows),
            bucket_len, pk.ctypes.data, vd.ctypes.data)
        out.append(PackedBucket(
            bases=None, lengths=lens, read_index=read_index,
            packed_bases=pk, valid_bits=vd, length=bucket_len,
            prefix_valid=bool(n_invalid == 0)))
    return PackedReads(names=names, buckets=out, n_truncated=n_truncated,
                       split_read_ids=split_ids)


pack_reads_native.calls = 0
