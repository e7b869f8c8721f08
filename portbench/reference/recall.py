"""Truth recall: the share of the true overlapping read pairs (a, b) that
either read lists the other among its neighbors, from either of its two
rows and in either orientation (row 2g or 2g + 1 names read g; a negative
entry names no read). The arithmetic of the port's eval.truth_recall,
copied and run on the device over every pair at once."""

from __future__ import annotations

import torch


def truth_found(indices, pairs: torch.Tensor, block: int = 1 << 20) -> int:
    """How many of `pairs` ((P, 2) int64 read indices, on the device the
    count runs on) the (2R, k) neighbor indices (numpy or torch) find."""
    dev = pairs.device
    idx = torch.as_tensor(indices).to(dev).long()
    reads = torch.div(idx, 2, rounding_mode="floor")  # -1 stays -1
    per_read = reads.view(-1, 2 * idx.shape[1])  # a read's two rows
    found = 0
    for p0 in range(0, pairs.shape[0], block):
        a, b = pairs[p0 : p0 + block, 0], pairs[p0 : p0 + block, 1]
        hit = (per_read[a] == b[:, None]).any(1)
        hit |= (per_read[b] == a[:, None]).any(1)
        found += int(hit.sum())
    return found
