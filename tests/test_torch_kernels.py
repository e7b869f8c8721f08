"""CUDA kernels of fedrann_tpu_torch against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. This file
imports no JAX, so on a machine with a GPU and no JAX it runs with
    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels.py
(--noconftest: tests/conftest.py sets up JAX for the other test files).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fedrann_tpu_torch.kmers.codec import (
    PAD_SLOT,
    _canonical_sample_plain,
    canonical_sample,
    sample_threshold,
)
from fedrann_tpu_torch.kmers.library import build_library
from fedrann_tpu_torch.kmers.membership import (
    _select_candidates_plain,
    select_candidates,
    selection_cap,
    staging_width,
)
from fedrann_tpu_torch.project.embed import (
    _membership_embed_plain,
    membership_embed,
)
from fedrann_tpu_torch.project.srp import build_precompute_signs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares a CUDA kernel with its "
                    "plain version")
    return torch.device("cuda")


def _bases(rng, r, length, n_frac=0.02):
    b = rng.integers(0, 4, size=(r, length)).astype(np.uint8)
    b[rng.random((r, length)) < n_frac] = 4
    return torch.from_numpy(b)


@pytest.mark.parametrize("k", [1, 5, 13, 15, 16, 17, 21, 31])
@pytest.mark.parametrize("keep_all", [False, True])
def test_canonical_sample_matches_plain(cuda, k, keep_all):
    rng = np.random.default_rng(k)
    bases = _bases(rng, 37, 777)
    thr = sample_threshold(0.3)
    want = _canonical_sample_plain(bases, k, 602, thr, keep_all)
    got = canonical_sample(bases.to(cuda), k, 602, thr, keep_all)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def _random_slots(rng, r, w, density):
    codes = rng.integers(0, 1 << 40, size=(r, w), dtype=np.int64)
    slots = np.where(rng.random((r, w)) < density, codes, PAD_SLOT)
    return torch.from_numpy(slots)


@pytest.mark.parametrize("w,hit_buffer,keep_all,fraction", [
    (1500, 512, False, 0.2),     # full-width sort (w <= 2 * SELECT_BLOCK)
    (4084, 1024, False, 0.2),    # blocked, ragged last block
    (16370, 1024, False, 0.05),  # blocked, the bench.py workload bucket shape
    (5000, 5000, True, 1.0),     # keep_all: full-width sort of a long row
    (4096, 8, False, 0.05),      # tiny buffer: most candidates dropped
])
def test_select_candidates_matches_plain(cuda, w, hit_buffer, keep_all,
                                         fraction):
    rng = np.random.default_rng(w)
    slots = _random_slots(rng, 33, w, fraction)
    # duplicates and one row whose first block overflows its cap
    slots[1, : w // 2] = slots[1, 0] if slots[1, 0] != PAD_SLOT else 7
    slots[2, :1024] = 12345
    cap = None if keep_all else selection_cap(fraction)
    want = _select_candidates_plain(slots, hit_buffer, keep_all, cap)
    got = select_candidates(slots.to(cuda), hit_buffer, keep_all, cap)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_select_candidates_rejects_rows_past_shared_memory(cuda):
    slots = torch.full((2, 40000), PAD_SLOT, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        select_candidates(slots, 40000, True, None)


@pytest.mark.parametrize("k,d", [(13, 100), (15, 512), (21, 1500)])
def test_membership_embed_matches_plain(cuda, k, d):
    rng = np.random.default_rng(d)
    # reads drawn from a short genome so k-mers repeat across reads
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    starts = rng.integers(0, 3000 - 1200, 48)
    bases = torch.from_numpy(np.stack([genome[s : s + 1200] for s in starts]))
    fraction = 0.2
    slots = _canonical_sample_plain(bases, k, 9, sample_threshold(fraction),
                                    False)
    staged, _ = _select_candidates_plain(
        slots, staging_width(slots.shape[1], fraction), False,
        selection_cap(fraction))
    library = build_library([staged], 2, fraction, 9)
    assert library.size > 0
    signs, mags = build_precompute_signs(library.counts, d, 2094)
    targets = torch.stack([2 * torch.arange(48), 2 * torch.arange(48) + 1],
                          dim=1)
    targets[5] = -1  # a padding row writes nothing
    out_p = torch.zeros((96, d))
    n_p = _membership_embed_plain(staged, library.codes, signs, mags,
                                  targets, out_p)
    out = torch.zeros((96, d), device=cuda)
    n = membership_embed(staged.to(cuda), library.codes.to(cuda),
                         signs.to(cuda), mags.to(cuda), targets.to(cuda), out)
    torch.cuda.synchronize()
    assert torch.equal(n.cpu(), n_p)
    atol = 1e-6 * float(mags.abs().max()) * int(n_p.max())
    torch.testing.assert_close(out.cpu(), out_p, rtol=1e-5, atol=atol)
    assert torch.all(out[10:12] == 0)


def test_membership_embed_empty_library(cuda):
    staged = torch.tensor([[4, 9, PAD_SLOT]], device=cuda)
    lib = torch.zeros((0,), dtype=torch.int64, device=cuda)
    signs = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    mags = torch.zeros((1,), device=cuda)
    out = torch.full((2, 32), 5.0, device=cuda)
    n = membership_embed(staged, lib, signs, mags,
                         torch.tensor([[0, 1]], device=cuda), out)
    assert int(n[0]) == 0 and torch.all(out == 0)


def test_wrappers_count_launches(cuda):
    bases = _bases(np.random.default_rng(1), 8, 64).to(cuda)
    before = (canonical_sample.launches, select_candidates.launches)
    slots = canonical_sample(bases, 5, 1, sample_threshold(0.5), False)
    select_candidates(slots, 16, False, None)
    assert (canonical_sample.launches, select_candidates.launches) == (
        before[0] + 1, before[1] + 1)
