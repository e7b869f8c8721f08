"""Streaming FASTA/FASTQ input, plain or gzip (the port's copy of
`fedrann_tpu/io/fastx.py`). Format is sniffed from the first non-blank
character: '>' FASTA, '@' FASTQ."""

from __future__ import annotations

import dataclasses
import gzip
import io
from typing import IO, Iterator


@dataclasses.dataclass(frozen=True)
class FastxRecord:
    """One read."""

    name: str
    sequence: str


def open_maybe_gzipped(path: str) -> IO[bytes]:
    """Open a plain or gzip file as a binary stream."""
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.open(path, "rb"))  # type: ignore[arg-type]
    return open(path, "rb")


def sniff_format(stream: IO[bytes]) -> str:
    """Peek the first non-blank byte: '>' -> fasta, '@' -> fastq."""
    first = stream.peek(64) if hasattr(stream, "peek") else b""
    for ch in first:
        if ch in (0x0A, 0x0D, 0x20):
            continue
        if ch == ord(">"):
            return "fasta"
        if ch == ord("@"):
            return "fastq"
        break
    raise ValueError("input does not look like FASTA or FASTQ")


def _iter_fasta(stream: IO[bytes]) -> Iterator[FastxRecord]:
    name = None
    chunks: list[bytes] = []
    for raw in stream:
        line = raw.rstrip(b"\r\n")
        if not line:
            continue
        if line.startswith(b">"):
            if name is not None:
                yield FastxRecord(name, b"".join(chunks).decode("latin-1"))
            name = line[1:].split()[0].decode("latin-1") if len(line) > 1 else ""
            chunks = []
        else:
            chunks.append(line)
    if name is not None:
        yield FastxRecord(name, b"".join(chunks).decode("latin-1"))


def _iter_fastq(stream: IO[bytes]) -> Iterator[FastxRecord]:
    while True:
        header = stream.readline()
        if not header:
            return
        header = header.rstrip(b"\r\n")
        if not header:
            continue
        if not header.startswith(b"@"):
            raise ValueError(f"malformed FASTQ header: {header[:40]!r}")
        seq = stream.readline().rstrip(b"\r\n")
        stream.readline()  # '+' line
        qual = stream.readline()
        if not qual:
            raise ValueError("truncated FASTQ record")
        name = header[1:].split()[0].decode("latin-1") if len(header) > 1 else ""
        yield FastxRecord(name, seq.decode("latin-1"))


def read_fastx(path: str) -> Iterator[FastxRecord]:
    """Stream records from a (possibly gzipped) FASTA/FASTQ file. Each
    stream opened is counted in `.calls`."""
    read_fastx.calls += 1
    stream = open_maybe_gzipped(path)
    try:
        fmt = sniff_format(stream)
        it = _iter_fasta(stream) if fmt == "fasta" else _iter_fastq(stream)
        yield from it
    finally:
        stream.close()


read_fastx.calls = 0
