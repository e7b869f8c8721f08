"""Sampled k-mer library built from the staged slots (the port of
`fedrann_tpu/kmers/library_device.py` as `pipeline._load_or_build_library`
drives it): sort the staged canonical codes, run-length count them, keep
codes seen at least min_multiplicity times whose sampling hash passes the
threshold. Sampling commutes with counting, so counts taken over the
already-sampled staged slots are exact."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fedrann_tpu_torch.kmers.codec import (
    PAD_SLOT,
    sample_hash32,
    sample_threshold,
)


@dataclasses.dataclass
class KmerLibrary:
    codes: torch.Tensor    # (L,) int64 canonical codes, sorted ascending
    counts: torch.Tensor   # (L,) int64 multiplicities

    @property
    def size(self) -> int:
        return int(self.codes.shape[0])

    @property
    def n_features(self) -> int:
        return 2 * self.size

    def numpy(self) -> tuple[np.ndarray, np.ndarray]:
        """(codes uint64, counts int64) host copies."""
        return (self.codes.cpu().numpy().astype(np.uint64),
                self.counts.cpu().numpy())


def build_library(staged: list[torch.Tensor], min_multiplicity: int,
                  sample_fraction: float, seed: int) -> KmerLibrary:
    """staged: slot tensors of any shape ((canon << 1) | is_fwd, PAD_SLOT
    padding), duplicates included. Returns the sorted unique sampled codes
    with their occurrence counts."""
    flat = torch.cat([s.reshape(-1) for s in staged])
    codes = torch.sort(flat[flat != PAD_SLOT] >> 1).values
    uniq, counts = torch.unique_consecutive(codes, return_counts=True)
    keep = counts >= min_multiplicity
    if sample_fraction < 1.0:
        keep &= (sample_hash32(uniq, seed)
                 < sample_threshold(sample_fraction))
    return KmerLibrary(codes=uniq[keep], counts=counts[keep].to(torch.int64))
