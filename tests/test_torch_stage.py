"""fedrann_tpu_torch staging (the plain version of kernel B) against the JAX
`stage_candidates` through convert.py, and its row sort against the Pallas
bitonic sort in interpret mode.

Rows are compared bitwise for k <= 16, where the JAX planes order slots by
(code, strand) as the port does; for k >= 17 the JAX order is (hi, strand,
lo), so rows are compared as sorted multisets. Dropped counts are exact in
every case."""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench"))

from fedrann_tpu import oracle  # noqa: E402
from fedrann_tpu.kmers import membership as jmem  # noqa: E402
from fedrann_tpu_torch.convert import staged_planes_to_slots  # noqa: E402
from fedrann_tpu_torch.io.fastx import FastxRecord  # noqa: E402
from fedrann_tpu_torch.io.packing import pack_reads  # noqa: E402
from fedrann_tpu_torch.kmers import membership  # noqa: E402
from fedrann_tpu_torch.kmers.codec import PAD_SLOT, sample_threshold  # noqa: E402
from fedrann_tpu_torch.sim import simulate_reads  # noqa: E402
from pallas_sort import sort_rows_pallas  # noqa: E402

SEED = 602


def _bucket(length, seed=21):
    sim = simulate_reads(genome_length=30000, coverage=3,
                         mean_read_length=length // 2, error_rate=0.02,
                         seed=seed)
    packed = pack_reads(
        [FastxRecord(n, s) for n, s in zip(sim.names, sim.sequences)],
        length_buckets=(length,))
    return packed.buckets[0].bases


def _stage_both(bases, k, fraction, blocked, seed=SEED):
    w = bases.shape[1] - k + 1
    hb = membership.staging_width(w, fraction)
    cap = membership.selection_cap(fraction) if blocked else None
    thr = sample_threshold(fraction)
    planes, dropped_j = jmem.stage_candidates(
        jnp.asarray(bases), k, hb, False, jnp.uint32(seed), jnp.uint32(thr),
        block_cap=cap)
    staged, dropped = membership.stage_candidates(
        torch.from_numpy(bases), k, hb, False, seed, thr, cap)
    want = staged_planes_to_slots(tuple(np.asarray(p) for p in planes), k)
    return staged.numpy(), dropped.numpy(), want, np.asarray(dropped_j)


def _assert_rows(got, want, k):
    assert got.shape == want.shape
    if k <= 16:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got, np.sort(want, axis=1))


@pytest.mark.parametrize("k", [13, 15, 16, 21, 31])
@pytest.mark.parametrize("blocked", [False, True])
def test_stage_matches_jax(k, blocked):
    # full-width: 2048-base bucket (W <= 2 * SELECT_BLOCK); blocked: 4096
    bases = _bucket(4096 if blocked else 2048)
    fraction = 0.05 if blocked else 0.2
    got, dropped, want, dropped_j = _stage_both(bases, k, fraction, blocked)
    _assert_rows(got, want, k)
    np.testing.assert_array_equal(dropped, dropped_j)


def _sampled_seed(k, fraction):
    """A seed under which the all-A k-mer (code 0) is sampled."""
    thr = np.uint32(sample_threshold(fraction))
    return next(s for s in range(1000)
                if oracle.sample_hash32(np.zeros(1, np.uint64), s)[0] < thr)


@pytest.mark.parametrize("k", [13, 16, 21])
def test_stage_overflowing_block_drop_count_exact(k):
    """Homopolymer runs fill whole 1024-window blocks with one sampled
    code: each block overflows its cap and the staged buffer overflows;
    the dropped counts must equal the JAX stage's exactly."""
    fraction = 0.05
    bases = _bucket(4096, seed=3)[:16].copy()
    bases[1, :] = 0                 # every window overflows
    bases[2, : 2048 + k - 1] = 0    # the first two blocks overflow
    got, dropped, want, dropped_j = _stage_both(
        bases, k, fraction, True, seed=_sampled_seed(k, fraction))
    assert dropped[1] > 0 and dropped[2] > 0
    np.testing.assert_array_equal(dropped, dropped_j)
    _assert_rows(got, want, k)


@pytest.mark.parametrize("k", [13, 16])
def test_row_sort_matches_pallas_bitonic(k):
    """The full-width selection sorts a row as the Pallas bitonic row sort
    does (pack_strand planes, power-of-two width, sentinel padding)."""
    rng = np.random.default_rng(k)
    r, w = 8, 256
    codes = rng.integers(0, 1 << (2 * k - 4), size=(r, w), dtype=np.uint64)
    codes[:, :40] = codes[:, 40:80]  # duplicates
    fwd = rng.integers(0, 2, size=(r, w)).astype(np.uint32)
    pad = rng.random((r, w)) < 0.3
    if k <= 15:
        planes = (np.where(pad, 0xFFFFFFFF, (codes.astype(np.uint32) << 1)
                           | fwd).astype(np.uint32),)
    else:
        planes = (np.where(pad, 0xFFFFFFFF, codes).astype(np.uint32),
                  np.where(pad, 0xFFFFFFFF, fwd).astype(np.uint32))
    sorted_j = sort_rows_pallas(tuple(jnp.asarray(p) for p in planes),
                                interpret=True)
    want = staged_planes_to_slots(tuple(np.asarray(p) for p in sorted_j), k)
    slots = torch.from_numpy(staged_planes_to_slots(planes, k))
    got, dropped = membership.select_candidates(slots, w, True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not dropped.any()
    assert np.all(np.diff(got.numpy(), axis=1) >= 0)
    assert (got.numpy() == PAD_SLOT).sum() == pad.sum()
