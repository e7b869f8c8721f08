"""Read-set simulator for tests and benchmarks (the port's copy of
`fedrann_tpu/sim.py`; the same seed gives the same reads).

A random genome, reads sampled at a target coverage with random strand and
optional substitution/indel noise, plus ground-truth overlap pairs (reads
whose genome intervals intersect by >= min_overlap bases).
"""

from __future__ import annotations

import dataclasses
import gzip

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP_TABLE = bytes.maketrans(b"ACGT", b"TGCA")


@dataclasses.dataclass
class SimulatedReads:
    names: list[str]
    sequences: list[str]
    starts: np.ndarray      # genome start per read
    ends: np.ndarray        # genome end per read
    strands: np.ndarray     # 0 = forward, 1 = reverse-complement
    genome: str

    def truth_overlaps(self, min_overlap: int = 500) -> set[tuple[int, int]]:
        """Unordered read-index pairs with genomic overlap >= min_overlap."""
        order = np.argsort(self.starts, kind="stable")
        pairs: set[tuple[int, int]] = set()
        starts, ends = self.starts, self.ends
        for ii, i in enumerate(order):
            for j in order[ii + 1 :]:
                if starts[j] > ends[i] - min_overlap:
                    break
                lo = max(starts[i], starts[j])
                hi = min(ends[i], ends[j])
                if hi - lo >= min_overlap:
                    pairs.add((min(int(i), int(j)), max(int(i), int(j))))
        return pairs


def _revcomp(seq: str) -> str:
    return seq.encode("ascii").translate(_COMP_TABLE)[::-1].decode("ascii")


def simulate_reads(
    genome_length: int = 50_000,
    coverage: float = 10.0,
    mean_read_length: int = 2000,
    error_rate: float = 0.0,
    seed: int = 0,
    circular: bool = False,
) -> SimulatedReads:
    rng = np.random.default_rng(seed)
    genome_codes = rng.integers(0, 4, size=genome_length)
    genome = bytes(_BASES[genome_codes]).decode("ascii")

    n_reads = max(2, int(round(coverage * genome_length / mean_read_length)))
    names, seqs = [], []
    starts = np.zeros(n_reads, dtype=np.int64)
    ends = np.zeros(n_reads, dtype=np.int64)
    strands = np.zeros(n_reads, dtype=np.int8)
    for i in range(n_reads):
        length = int(np.clip(rng.normal(mean_read_length, mean_read_length * 0.2),
                             mean_read_length // 4, genome_length))
        start = int(rng.integers(0, max(1, genome_length - length)))
        frag = genome[start : start + length]
        strand = int(rng.integers(0, 2))
        if strand:
            frag = _revcomp(frag)
        if error_rate > 0:
            frag = _mutate(frag, error_rate, rng)
        names.append(f"read_{i}")
        seqs.append(frag)
        starts[i], ends[i], strands[i] = start, start + length, strand
    return SimulatedReads(names, seqs, starts, ends, strands, genome)


def _mutate(seq: str, error_rate: float, rng: np.random.Generator) -> str:
    """Substitution/insertion/deletion noise (ONT-like mix 60/20/20),
    vectorized for benchmark-scale read sets."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8).copy()
    n = len(raw)
    r = rng.random(n)
    kind = rng.random(n)
    err = r < error_rate
    sub = err & (kind < 0.6)
    ins = err & (kind >= 0.6) & (kind < 0.8)
    dele = err & (kind >= 0.8)
    repeats = (1 + ins.astype(np.int64) - dele.astype(np.int64))
    out = np.repeat(raw, repeats)
    ends = np.cumsum(repeats)
    # substituted chars sit at ends-1 for kept positions; inserted random
    # chars occupy the second copy (also ends-1) of insertion positions
    rand_pos = np.concatenate([ends[sub] - 1, ends[ins] - 1])
    out[rand_pos] = _BASES[rng.integers(0, 4, size=len(rand_pos))]
    return out.tobytes().decode("ascii")


def write_fasta(path: str, names: list[str], sequences: list[str]) -> None:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        for name, seq in zip(names, sequences):
            f.write(f">{name}\n{seq}\n")
