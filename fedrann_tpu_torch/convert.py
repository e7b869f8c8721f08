"""Converters from the JAX package's state (as numpy arrays; no JAX import)
to this port's, so a test can feed both packages the same state and
compare their outputs.

- staged u32 word planes (`fedrann_tpu.kmers.codec.pack_strand` layouts)
  -> int64 slots (canon << 1) | is_fwd, PAD_SLOT for the all-ones sentinel;
- library u32 word planes + counts -> int64 codes + int64 counts;
- (signs u32, mags) -> (signs int32 bit patterns, mags float32);
- a dense paired table (float32, or ml_dtypes bfloat16) -> a torch tensor
  of the same dtype, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

PAD_SLOT = np.int64((1 << 63) - 1)
_SENT = np.uint32(0xFFFFFFFF)


def staged_planes_to_slots(planes, k: int) -> np.ndarray:
    """pack_strand planes -> int64 slots, element for element:
      k <= 15:  ((code << 1) | is_fwd,)
      k == 16:  (code, is_fwd)
      k >= 17:  ((hi << 1) | is_fwd, lo)
    A slot is PAD_SLOT where every plane holds the all-ones sentinel. Rows
    keep the JAX order, which for k >= 17 is (hi, strand, lo) and so not
    the port's (code, strand) order."""
    planes = [np.asarray(p, dtype=np.uint32) for p in planes]
    sent = np.logical_and.reduce([p == _SENT for p in planes])
    if len(planes) == 1:
        slots = planes[0].astype(np.int64)
    elif k == 16:
        code, fwd = planes
        slots = (code.astype(np.int64) << 1) | (fwd.astype(np.int64) & 1)
    else:
        a, lo = planes
        a64 = a.astype(np.int64)
        canon = ((a64 >> 1) << 32) | lo.astype(np.int64)
        slots = (canon << 1) | (a64 & 1)
    return np.where(sent, PAD_SLOT, slots)


def library_words_to_codes(words, counts) -> tuple[np.ndarray, np.ndarray]:
    """((lo,) or (hi, lo)) u32 library planes + counts -> (int64 codes,
    int64 counts)."""
    words = [np.asarray(w, dtype=np.uint32).astype(np.int64) for w in words]
    codes = words[0] if len(words) == 1 else (words[0] << 32) | words[1]
    return codes, np.asarray(counts).astype(np.int64)


def signs_to_port(signs, mags) -> tuple[np.ndarray, np.ndarray]:
    """build_precompute_signs output (u32 words, f32 mags) -> the port's
    int32-bit-pattern signs and float32 mags."""
    return (np.array(signs, dtype=np.uint32).view(np.int32),
            np.array(mags, dtype=np.float32))


def paired_table_to_port(p_pair) -> torch.Tensor:
    """build_precompute_paired / pair_projection output -> a torch tensor
    of the same bits: float32 as is, bfloat16 through its uint16 bit
    pattern (torch.from_numpy takes no ml_dtypes.bfloat16)."""
    arr = np.asarray(p_pair)
    if arr.dtype == np.float32:
        return torch.from_numpy(arr.copy())
    if arr.dtype.name != "bfloat16":
        raise ValueError(f"a paired table is float32 or bfloat16, not "
                         f"{arr.dtype}")
    bits = np.array(arr).view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16)
