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
from fedrann_tpu_torch.io.packing import bit_pack, pack_reads  # noqa: E402
from fedrann_tpu_torch.config import PipelineConfig  # noqa: E402
from fedrann_tpu_torch.device import SM90_SMEM_OPTIN  # noqa: E402
from fedrann_tpu_torch.kmers import membership  # noqa: E402
from fedrann_tpu_torch.kmers.codec import (  # noqa: E402
    PAD_SLOT,
    PackedChunk,
    sample_threshold,
)
from fedrann_tpu_torch.pipeline import staging_params  # noqa: E402
from fedrann_tpu_torch.sim import simulate_reads  # noqa: E402
from pallas_sort import sort_rows_pallas  # noqa: E402
from test_torch_codec import edge_bases, emulate_window_slots  # noqa: E402

SEED = 602


def _bucket(length, seed=21):
    sim = simulate_reads(genome_length=30000, coverage=3,
                         mean_read_length=length // 2, error_rate=0.02,
                         seed=seed)
    packed = pack_reads(
        [FastxRecord(n, s) for n, s in zip(sim.names, sim.sequences)],
        length_buckets=(length,))
    return packed.buckets[0].bases


def _stage_both(bases, k, fraction, blocked, seed=SEED, keep_all=False):
    w = bases.shape[1] - k + 1
    hb = w if keep_all else membership.staging_width(w, fraction)
    cap = membership.selection_cap(fraction) if blocked else None
    thr = sample_threshold(fraction)
    planes, dropped_j = jmem.stage_candidates(
        jnp.asarray(bases), k, hb, keep_all, jnp.uint32(seed),
        jnp.uint32(thr), block_cap=cap)
    staged, dropped = membership.stage_candidates(
        torch.from_numpy(bases), k, hb, keep_all, seed, thr, cap)
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


def _long_bucket(length, mean_read_length, genome_length, rows=4):
    """The first `rows` reads of one `length` bucket of simulated reads."""
    sim = simulate_reads(genome_length=genome_length, coverage=3,
                         mean_read_length=mean_read_length, error_rate=0.05,
                         seed=5)
    keep = [i for i, s in enumerate(sim.sequences)
            if length // 2 < len(s) <= length][:rows]
    assert len(keep) == rows
    packed = pack_reads([FastxRecord(sim.names[i], sim.sequences[i])
                         for i in keep], length_buckets=(length,))
    return packed.buckets[0].bases[:rows]


def test_stage_long_rows_match_jax():
    """The longest rows, as the pipeline stages them: the 262,144-base
    bucket at 5% sampling (blocked, up to 24,320 survivors, which one
    block's shared memory holds on the card) and a keep_all 32,768-base
    bucket (past one block: kernel B's device-memory path)."""
    k = 15
    bases = _long_bucket(1 << 18, 150_000, 600_000)
    config = PipelineConfig(kmer_size=k, kmer_sample_fraction=0.05)
    hb, keep_all, cap = staging_params(1 << 18, config)
    assert not membership.stage_launch_plan(bases.shape[1] - k + 1, hb,
                                            keep_all, cap).long
    assert membership.stage_launch_plan((1 << 15) - k + 1, (1 << 15) - k + 1,
                                        True, None).long
    got, dropped, want, dropped_j = _stage_both(bases, k, 0.05, True)
    _assert_rows(got, want, k)
    np.testing.assert_array_equal(dropped, dropped_j)
    # reads of 131,072+ bases: 5% of their windows, ~6,500+ candidates
    assert got.shape == (4, hb) and (got != PAD_SLOT).sum(axis=1).min() > 5000

    bases = _long_bucket(1 << 15, 20_000, 120_000)
    got, dropped, want, dropped_j = _stage_both(bases, k, 1.0, False,
                                                keep_all=True)
    _assert_rows(got, want, k)
    np.testing.assert_array_equal(dropped, dropped_j)
    assert not dropped.any()


def _merge_by_rank(a, b, m2):
    """Kernel B's merge: a[i] -> i + #(b < a[i]), b[j] -> j + #(a <= b[j]),
    first m2 kept; one row at a time."""
    out = np.empty((a.shape[0], a.shape[1] + b.shape[1]), a.dtype)
    for r in range(a.shape[0]):
        out[r, np.arange(a.shape[1]) + np.searchsorted(b[r], a[r], "left")] \
            = a[r]
        out[r, np.arange(b.shape[1]) + np.searchsorted(a[r], b[r], "right")] \
            = b[r]
    return out[:, :m2]


def _block_survivors(block, cap):
    """Kernel B's selection of one 1024-slot block: its candidates in
    window order when they fit the cap, else the first cap of them sorted
    (the compaction, then the sort only past the cap)."""
    cand = block[block != PAD_SLOT]
    return cand if len(cand) <= cap else np.sort(cand)[:cap]


def _emulate_one_block(slots, plan):
    """Kernel B's one-block-per-row kernel in numpy, as it runs for each
    row: each 1024-slot block's candidates appended to the survivor buffer
    (sorted and cut only past the cap; full-width rows take cap = 1024,
    so every candidate survives), one sort of the survivors, the width
    cut with padding after it, dropped = candidates - min(survivors,
    width). Asserts that the buffer never holds more slots than the plan's
    shared memory."""
    s = slots.numpy()
    r, w = s.shape
    block = membership.SELECT_BLOCK
    cap = plan.cap if plan.blocked else block
    width = plan.width
    staged = np.full((r, width), PAD_SLOT)
    dropped = np.zeros(r, np.int32)
    for i in range(r):
        surv, n_cand = [], 0
        for b in range(0, w, block):
            count = int((s[i, b : b + block] != PAD_SLOT).sum())
            assert sum(map(len, surv)) + count <= plan.smem // 8
            n_cand += count
            surv.append(_block_survivors(s[i, b : b + block], cap))
        row = np.sort(np.concatenate(surv))
        staged[i, : min(width, len(row))] = row[:width]
        dropped[i] = n_cand - min(len(row), width)
    return staged, dropped


@pytest.mark.parametrize("case", [
    "main",          # the main path's 16,370-window rows at 5% sampling
    "ragged",        # a ragged last block, survivors above the width
    "narrow",        # a width of 8: nearly every survivor dropped
    "full",          # w <= 2 * SELECT_BLOCK: one sort of the whole row
    "keep_all",      # keep_all: every candidate of the row survives
    "262144",        # the 262,144-base bucket at 5%: one block per row now
])
def test_one_block_schedule_matches_plain(case):
    """The one-block kernel's schedule (compaction in window order, a sort
    only for blocks past the cap, one survivor sort) reproduces the plain
    version bitwise on overflowing blocks, a block with exactly cap
    candidates, all-padding rows, dense duplicates and survivors below and
    above the width."""
    w, fraction, keep_all, hb = {
        "main": (16370, 0.05, False, None),
        "ragged": (4084, 0.3, False, 512),
        "narrow": (4096, 0.05, False, 8),
        "full": (1500, 0.2, False, None),
        "keep_all": (5000, 1.0, True, 5000),
        "262144": (262130, 0.05, False, None),
    }[case]
    rng = np.random.default_rng(w)
    r = 8 if w < 100_000 else 5
    codes = rng.integers(0, 1 << 20, size=(r, w), dtype=np.int64)
    slots = np.where(rng.random((r, w)) < fraction, codes, PAD_SLOT)
    cap = None if keep_all else membership.selection_cap(fraction)
    slots[1, : w // 2] = 77                 # overflowing blocks, duplicates
    slots[2, :] = PAD_SLOT                  # an all-padding row
    slots[3, :] = rng.integers(0, 50, size=w)  # dense duplicates
    if cap is not None and w > 2 * membership.SELECT_BLOCK:
        slots[4, :1024] = PAD_SLOT          # block 0: exactly cap candidates
        slots[4, rng.choice(1024, cap, replace=False)] = rng.integers(
            0, 1 << 20, cap)
        slots[4, 1024:2048] = np.where(np.arange(1024) < cap + 1, 5,
                                       PAD_SLOT)  # block 1: cap + 1
    hb = hb or membership.staging_width(w, fraction)
    plan = membership.stage_launch_plan(w, hb, keep_all, cap)
    assert not plan.long
    slots = torch.from_numpy(slots)
    staged, dropped = _emulate_one_block(slots, plan)
    want, want_dropped = membership._select_candidates_plain(
        slots, hb, keep_all, cap)
    np.testing.assert_array_equal(staged, want.numpy())
    np.testing.assert_array_equal(dropped, want_dropped.numpy())
    if case == "narrow":
        assert (want_dropped.numpy()[[0, 1, 3]] > 0).all()
    if case == "ragged":  # survivors past the width in the duplicate row
        assert want_dropped[1] > 0


@pytest.mark.parametrize("k", [13, 15, 16, 17, 21, 31])
@pytest.mark.parametrize("case", ["blocked", "full", "keep_all", "wide"])
def test_fused_schedule_matches_jax(k, case):
    """Kernels A and B fused (`fk_stage_rows`), end to end in numpy: the
    emulated window codes (per 1024-window block, as the kernel computes
    them from the bases) feed the one-block schedule, against the JAX
    `stage_candidates`; rows bitwise for k <= 16, as multisets above, the
    dropped counts exact. Simulated reads in a 4,096-base bucket (blocked,
    5%), a 2,048 bucket (full width, 20%) and keep_all; `wide` is the
    1,024-thread layout, whose survivor buffer passes 114 KB (keep_all
    rows of 16,384 bases), on the window-code edge rows."""
    length, fraction, keep_all = {
        "blocked": (4096, 0.05, False), "full": (2048, 0.2, False),
        "keep_all": (2048, 1.0, True), "wide": (16384, 1.0, True)}[case]
    if case == "wide":
        bases = np.full((9, length), 4, np.uint8)
        bases[:, :3055] = edge_bases(k)
        bases[0, 3055:] = np.random.default_rng(k).integers(
            0, 4, length - 3055)
    else:
        bases = _bucket(length)[:12].copy()
        bases[1] = 4
        bases[2, [1023, 1024, 2047, 2048 - k // 2]] = 4
    _, _, want, dropped_j = _stage_both(bases, k, fraction, not keep_all,
                                        keep_all=keep_all)
    w = length - k + 1
    hb = w if keep_all else membership.staging_width(w, fraction)
    cap = None if keep_all else membership.selection_cap(fraction)
    plan = membership.stage_launch_plan(w, hb, keep_all, cap)
    assert not plan.long
    threads = 1024 if plan.smem > 114 * 1024 else 256
    assert (threads == 1024) == (case == "wide")
    slots = emulate_window_slots(bases, k, SEED, sample_threshold(fraction),
                                 keep_all, threads)
    got, dropped = _emulate_one_block(torch.from_numpy(slots), plan)
    _assert_rows(got, want, k)
    np.testing.assert_array_equal(dropped, dropped_j)
    assert (got[1] == PAD_SLOT).all() and (got != PAD_SLOT).sum() > 0


def _emulate_long_path(slots, plan):
    """Kernel B's long path pass by pass in numpy, as the plan lays it
    out: blocked selection (each block's candidates, sorted and cut only
    past the cap, then padding to cap), chunk sorts, pairwise merges of
    runs cut at width, dropped from the pass-1 (or chunk) counts."""
    s = slots.numpy()
    r, w = s.shape
    if plan.blocked:
        g, c = plan.n_blocks, plan.cap
        block = membership.SELECT_BLOCK
        src = np.full((r, g * c), PAD_SLOT)
        cand = np.zeros((r, g), np.int64)
        for i in range(r):
            for b in range(g):
                piece = s[i, b * block : (b + 1) * block]
                kept_b = _block_survivors(piece, c)
                src[i, b * c : b * c + len(kept_b)] = kept_b
                cand[i, b] = (piece != PAD_SLOT).sum()
        kept = np.minimum(cand, c)
    else:
        src = s
    buf = np.full((r, plan.chunk * plan.n_chunks), PAD_SLOT)
    buf[:, : plan.n_surv] = src
    chunks = np.sort(buf.reshape(r, plan.n_chunks, plan.chunk), axis=2)
    if not plan.blocked:
        cand = kept = (chunks != PAD_SLOT).sum(axis=2)
    runs = [chunks[:, i, : min(plan.chunk, plan.width)]
            for i in range(plan.n_chunks)]
    run = plan.chunk
    while len(runs) > 1:
        m2 = min(2 * run, plan.width)
        runs = [_merge_by_rank(runs[i], runs[i + 1], m2)
                for i in range(0, len(runs), 2)]
        run *= 2
    assert len(plan.passes) == (2 if plan.blocked else 1) + 1 + int(
        np.log2(plan.n_chunks))
    dropped = cand.sum(axis=1) - np.minimum(kept.sum(axis=1), plan.width)
    return runs[0][:, : plan.width], dropped.astype(np.int32)


@pytest.mark.parametrize("w,fraction,keep_all,cap,smem_limit", [
    (262130, 0.05, False, None, 150_000),  # 262,144 bucket, less smem
    (131058, 0.2, False, None, SM90_SMEM_OPTIN),  # 131,072 bucket at 20%
    (20000, 0.2, False, None, 8 * 2048),  # 4 chunks of 2048: two merges
    (9000, 1.0, True, None, 8 * 1024),    # keep_all, 16 chunks of 1024
    (8000, 0.2, False, 256, 8 * 2560),    # survivors fill exactly one chunk
])
def test_long_path_schedule_matches_plain(w, fraction, keep_all, cap,
                                          smem_limit):
    """The long path's schedule (chunk sizes, merge ranks with duplicate
    and padding slots, the width cut, the counts) reproduces the plain
    version bitwise."""
    rng = np.random.default_rng(w)
    r = 6
    codes = rng.integers(0, 1 << 20, size=(r, w), dtype=np.int64)
    slots = np.where(rng.random((r, w)) < fraction, codes, PAD_SLOT)
    slots[1, : w // 2] = 77          # duplicates overflowing their blocks
    slots[2, :] = PAD_SLOT           # an all-padding row
    slots[3, :] = rng.integers(0, 50, size=w)  # dense duplicates
    slots = torch.from_numpy(slots)
    hb = w if keep_all else membership.staging_width(w, fraction)
    if not keep_all and cap is None:
        cap = membership.selection_cap(fraction)
    plan = membership.stage_launch_plan(w, hb, keep_all, cap, smem_limit)
    assert plan.long
    staged, dropped = _emulate_long_path(slots, plan)
    want, want_dropped = membership._select_candidates_plain(
        slots, hb, keep_all, cap)
    np.testing.assert_array_equal(staged, want.numpy())
    np.testing.assert_array_equal(dropped, want_dropped.numpy())


def _jax_fused(arrs, rows, length, mode, k, hb, keep_all, fraction, cap):
    """JAX's `_stage_chunk_fused` on one chunk of `rows` rows from row 0,
    in `mode` ("packed": the uint32 view of the stream with the lengths;
    "bits": the stream with the valid bits), as slots."""
    from fedrann_tpu.pipeline import _stage_chunk_fused

    planes, dropped = _stage_chunk_fused(
        tuple(jnp.asarray(a) for a in arrs), 0, rows, length, mode, k, hb,
        keep_all, jnp.uint32(SEED), jnp.uint32(sample_threshold(fraction)),
        cap)
    return (staged_planes_to_slots(tuple(np.asarray(p) for p in planes), k),
            np.asarray(dropped))


@pytest.mark.parametrize("k", [13, 16, 21, 31])
@pytest.mark.parametrize("mode", ["packed", "bits"])
@pytest.mark.parametrize("blocked", [False, True])
def test_packed_sources_stage_as_jax_fused(k, mode, blocked):
    """stage_candidates on a PackedChunk (plain path: unpack_bases[_len],
    then the plain composition) against JAX's `_stage_chunk_fused` in mode
    "packed" (prefix-valid rows, the uint32 view of the stream and the
    lengths) and "bits" (mid-read N, the valid bits); rows bitwise for k
    <= 16, as multisets above, dropped counts exact."""
    length = 4096 if blocked else 2048
    fraction = 0.05 if blocked else 0.2
    bases = _bucket(length)[:16].copy()
    lengths = (bases < 4).sum(axis=1).astype(np.int32)  # prefix rows
    if mode == "bits":
        bases[2, [1023, 1024, 2047, 2048 - k // 2]] = 4
        bases[3, 100:140] = 4
    packed, valid = bit_pack(bases)
    chunk = (PackedChunk(torch.from_numpy(packed), length,
                         lengths=torch.from_numpy(lengths))
             if mode == "packed" else
             PackedChunk(torch.from_numpy(packed), length,
                         valid_bits=torch.from_numpy(valid)))
    assert torch.equal(chunk.unpack(), torch.from_numpy(bases))
    w = length - k + 1
    hb = membership.staging_width(w, fraction)
    cap = membership.selection_cap(fraction) if blocked else None
    staged, dropped = membership.stage_candidates(
        chunk, k, hb, False, SEED, sample_threshold(fraction), cap)
    arrs = ((packed.view("<u4"), lengths) if mode == "packed"
            else (packed, valid))
    want, dropped_j = _jax_fused(arrs, 16, length, mode, k, hb, False,
                                 fraction, cap)
    _assert_rows(staged.numpy(), want, k)
    np.testing.assert_array_equal(dropped.numpy(), dropped_j)
    assert (staged != PAD_SLOT).sum() > 0
