"""CUDA kernels of fedrann_tpu_torch against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. This file
imports no JAX, so on a machine with a GPU and no JAX it runs with
    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels.py
(--noconftest: tests/conftest.py sets up JAX for the other test files).
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from fedrann_tpu_torch import _build, probes
from fedrann_tpu_torch.device import shared_memory_limit
from fedrann_tpu_torch.io.packing import bit_pack
from fedrann_tpu_torch.kmers.codec import (
    PAD_SLOT,
    PackedChunk,
    _canonical_sample_plain,
    canonical_sample,
    sample_threshold,
)
from fedrann_tpu_torch.kmers.library import build_library
from fedrann_tpu_torch.kmers.membership import (
    STATIC_SMEM,
    _select_candidates_plain,
    _select_on_card,
    read_hits_staged,
    select_candidates,
    selection_cap,
    stage_candidates,
    stage_launch_plan,
    staging_width,
)
from fedrann_tpu_torch.project.embed import (
    _membership_embed_dense_plain,
    _membership_embed_plain,
    dense_plan,
    embed_staged,
    membership_embed,
    membership_embed_dense,
)
from fedrann_tpu_torch.knn import ivf, topk
from fedrann_tpu_torch.knn.ivf import (
    _segment_sum,
    _segments,
    segment_buckets,
    segment_sum_plain,
    segment_sum_rows,
)
from fedrann_tpu_torch.knn.topk import (
    EMPTY_KEY,
    _decode_keys,
    _order_keys,
    keys_to_host,
    keys_to_host_plain,
    merge_block,
    merge_block_plain,
    normalize_rows,
    result_wire,
)
from fedrann_tpu_torch.project.srp import (
    _stream,
    build_precompute_paired,
    build_precompute_signs,
    paired_table,
    paired_table_plain,
    seed_mix_of,
    sign_table,
    sign_table_plain,
)

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


def _edge_bases(k, rows, length, seed=0):
    """Random reads with 2% INVALID bases, and rows that cross the window
    code's cases: a read ending mid-block, an all-INVALID row, INVALID
    bases on block edges and in a block's halo, even-k palindromes across
    a block edge, a block INVALID but for its halo, a read ending at a
    block edge (its last block all INVALID)."""
    rng = np.random.default_rng(seed + k)
    b = rng.integers(0, 4, size=(rows, length)).astype(np.uint8)
    b[rng.random((rows, length)) < 0.02] = 4
    b[0, length // 2 + 7 :] = 4
    b[1] = 4
    b[2, [i for i in (1023, 1024, 2047, 2048, 1024 + max(k - 2, 0) // 2)
          if i < length]] = 4
    if k % 2 == 0:
        half = rng.integers(0, 4, k // 2).astype(np.uint8)
        b[3, 1024 - k // 2 : 1024 + k // 2] = np.concatenate(
            [half, (3 - half)[::-1]])
    b[4, 1024:2048] = 4
    b[5, 2048:] = 4
    return torch.from_numpy(b)


def _on_card_at(bases, cuda, offset):
    """bases copied to the card `offset` bytes past a fresh allocation's
    start (which is 16-byte aligned): every row then starts off a 16-byte
    boundary when offset % 16 != 0, though the tensor is contiguous."""
    flat = torch.zeros(bases.numel() + offset, dtype=torch.uint8,
                       device=cuda)
    out = flat[offset:].view(bases.shape)
    out.copy_(bases)
    return out


@pytest.mark.parametrize("k", [1, 2, 13, 16, 17, 31])
@pytest.mark.parametrize("length,offset", [(4096, 0), (3055, 0),
                                           (4096, 8)])
def test_canonical_sample_edge_rows_match_plain(cuda, k, length, offset):
    """Kernel A over several 1024-window blocks on the window code's edge
    rows, with 16-byte aligned rows (4,096 bases), rows of an odd length,
    and rows of 4,096 bases that start 8 bytes off a 16-byte boundary
    (byte loads)."""
    bases = _edge_bases(k, 12, length)
    thr = sample_threshold(0.3)
    for keep_all in (False, True):
        want = _canonical_sample_plain(bases, k, 602, thr, keep_all)
        got = canonical_sample(_on_card_at(bases, cuda, offset), k, 602,
                               thr, keep_all)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


def _stage_case(case):
    """(bases, k, hit_buffer, keep_all, block_cap, threshold, threads) of a
    fused staging case; threads is the one-block kernel the plan gives."""
    k, length, fraction = {
        "main": (15, 16384, 0.05),    # the main path's chunk shape
        "k21": (21, 8192, 0.05),      # two-word codes
        "k31_odd": (31, 3055, 0.3),   # L % 16 != 0: byte loads
        "k1_full": (1, 2000, 0.2),    # full width (w <= 2 * SELECT_BLOCK)
        "keep_all": (16, 16384, 1.0),  # 131 KB buffer: 1,024 threads
        "262144": (15, 1 << 18, 0.05),  # 1,024 threads, one block a row
        "unaligned": (15, 4096, 0.05),  # rows 8 bytes off 16: byte loads
        # keep_all at the one-block limit (28,928 windows, L not a power of
        # two): the survivor buffer and the static arrays fill the opt-in
        "keep_all_edge": (15, 28942, 1.0),
    }[case]
    rows = 6 if length > 20_000 else 24
    bases = _edge_bases(k, rows, length)
    if case == "main":  # a read of 9 kb in its 16,384-base row
        bases[6:, 9000:] = 4
    keep_all = fraction >= 1.0
    w = length - k + 1
    hb = w if keep_all else staging_width(w, fraction)
    cap = None if keep_all else selection_cap(fraction)
    plan = stage_launch_plan(w, hb, keep_all, cap)
    assert not plan.long
    return (bases, k, hb, keep_all, cap, sample_threshold(fraction),
            1024 if plan.smem > 114 * 1024 else 256)


@pytest.mark.parametrize("case", ["main", "k21", "k31_odd", "k1_full",
                                  "keep_all", "262144", "unaligned",
                                  "keep_all_edge"])
def test_stage_rows_matches_plain(cuda, case):
    """Kernels A and B fused (`fk_stage_rows`) against the plain
    composition (kernel A's plain version, then kernel B's), bitwise,
    dropped counts included, at both thread counts; it counts one fused
    launch and no launch of A or B alone."""
    bases, k, hb, keep_all, cap, thr, threads = _stage_case(case)
    assert threads == (1024 if case in ("keep_all", "262144",
                                        "keep_all_edge") else 256)
    want = _select_candidates_plain(
        _canonical_sample_plain(bases, k, 602, thr, keep_all), hb,
        keep_all, cap)
    before = (stage_candidates.launches, canonical_sample.launches,
              select_candidates.long_launches)
    got = stage_candidates(
        _on_card_at(bases, cuda, 8 if case == "unaligned" else 0), k, hb,
        keep_all, 602, thr, cap)
    torch.cuda.synchronize()
    assert (stage_candidates.launches, canonical_sample.launches,
            select_candidates.long_launches) == (before[0] + 1, *before[1:])
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert (want[0][1] == PAD_SLOT).all() and (want[0] != PAD_SLOT).any()


def test_one_block_kernels_fit_the_static_allowance(cuda):
    """The static shared memory of every one-block kernel (both sources,
    both thread counts) fits the STATIC_SMEM that stage_launch_plan keeps
    beside the survivor buffer."""
    most = ctypes.c_int32(0)
    _build.launch("fk_stage_rows_static_smem", ctypes.addressof(most))
    assert 0 < most.value <= STATIC_SMEM


def test_stage_candidates_long_rows_take_kernel_a(cuda):
    """keep_all rows past one block's shared memory: stage_candidates
    launches kernel A, then kernel B's device-memory path, not the fused
    kernel; bitwise against the plain composition."""
    bases = _edge_bases(15, 6, 1 << 15)
    w = bases.shape[1] - 15 + 1
    assert stage_launch_plan(w, w, True, None,
                             shared_memory_limit(cuda)).long
    want = _select_candidates_plain(
        _canonical_sample_plain(bases, 15, 602, 0, True), w, True, None)
    before = (stage_candidates.launches, canonical_sample.launches,
              select_candidates.long_launches)
    got = stage_candidates(bases.to(cuda), 15, w, True, 602, 0, None)
    torch.cuda.synchronize()
    assert (stage_candidates.launches, canonical_sample.launches,
            select_candidates.long_launches) == (
        before[0], before[1] + 1, before[2] + 1)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def _prefix_bases(k, rows, length, seed=0):
    """Rows whose valid bases are a prefix (reads as the packed source
    takes them): random bases up to each row's length, INVALID after it;
    lengths of the whole row, one base less, mid-block, a block edge, 0, 1,
    k - 1, k, then random."""
    rng = np.random.default_rng(seed + k)
    lengths = rng.integers(0, length + 1, rows)
    edges = [length, length - 1, length // 2 + 7, min(2048, length), 0, 1,
             k - 1, k]
    lengths[: min(rows, 8)] = edges[:rows]
    b = rng.integers(0, 4, size=(rows, length)).astype(np.uint8)
    b[np.arange(length)[None, :] >= lengths[:, None]] = 4
    return torch.from_numpy(b), torch.from_numpy(lengths.astype(np.int32))


def _source_case(case, source):
    """(chunk on the CPU, k, hit_buffer, keep_all, block_cap, threshold,
    long) of a packed-source staging case at chip_smoke.py 3c's shapes: a
    PackedChunk of the packed source (prefix rows with their lengths) or
    of the bits source (the edge rows, mid-read INVALID bases on block
    edges, in a halo and at a block start, with their valid bits)."""
    k, length, fraction = {
        "main": (15, 16384, 0.05),     # the main path's chunk shape
        "k21": (21, 8192, 0.05),       # two-word codes
        "262144": (15, 1 << 18, 0.05),  # 1,024 threads, one block a row
        "keep_all_32768": (15, 1 << 15, 1.0),  # kernel A + B's long path
        "keep_all_65536": (15, 1 << 16, 1.0),
        "len10000": (15, 10000, 0.05),  # a stride of 2,500 bytes: off 16
        "len10002": (15, 10002, 0.05),  # a stride of 2,501 bytes: off 4
        "k31_full": (31, 2000, 0.2),   # full width (w <= 2 * SELECT_BLOCK)
    }[case]
    rows = 6 if length > 20_000 else 24
    if source == "packed":
        bases, lengths = _prefix_bases(k, rows, length)
    else:
        bases = _edge_bases(k, rows, length)
    packed, valid = (torch.from_numpy(a) for a in bit_pack(bases.numpy()))
    chunk = (PackedChunk(packed, length, lengths=lengths)
             if source == "packed" else
             PackedChunk(packed, length, valid_bits=valid))
    assert torch.equal(chunk.unpack(), bases)
    keep_all = fraction >= 1.0
    w = length - k + 1
    hb = w if keep_all else staging_width(w, fraction)
    cap = None if keep_all else selection_cap(fraction)
    return (chunk, k, hb, keep_all, cap, sample_threshold(fraction),
            stage_launch_plan(w, hb, keep_all, cap).long)


def _chunk_on_card(chunk, cuda, offset=0):
    """The chunk on the card, its stream `offset` bytes past an allocation's
    start (every row off a 4-byte boundary when offset % 4 != 0)."""
    aux = chunk.aux.to(cuda)
    packed = _on_card_at(chunk.packed, cuda, offset)
    if chunk.source == "packed":
        return PackedChunk(packed, chunk.length, lengths=aux)
    return PackedChunk(packed, chunk.length, valid_bits=aux)


def _counts(source):
    return (stage_candidates.launches,
            getattr(stage_candidates, f"{source}_launches"),
            canonical_sample.launches,
            getattr(canonical_sample, f"{source}_launches"),
            select_candidates.long_launches, stage_candidates.bytes_launches,
            canonical_sample.bytes_launches)


@pytest.mark.parametrize("source", ["packed", "bits"])
@pytest.mark.parametrize("case", ["main", "k21", "262144", "keep_all_32768",
                                  "keep_all_65536", "len10000", "len10002",
                                  "k31_full"])
def test_packed_sources_match_plain(cuda, case, source):
    """Kernel A and the fused kernel on the packed and bits sources against
    unpack_bases[_len] + the plain composition, bitwise, dropped counts
    included, each launch counted on its source and none on the byte
    source: the fused kernel where the plan keeps the rows in one block,
    kernel A then B's device-memory path for keep_all rows past it."""
    chunk, k, hb, keep_all, cap, thr, long = _source_case(case, source)
    assert long == case.startswith("keep_all")
    bases = chunk.unpack()
    want = _select_candidates_plain(
        _canonical_sample_plain(bases, k, 602, thr, keep_all), hb, keep_all,
        cap)
    on_card = _chunk_on_card(chunk, cuda)
    before = _counts(source)
    got = stage_candidates(on_card, k, hb, keep_all, 602, thr, cap)
    torch.cuda.synchronize()
    fused = (0, 0, 1, 1, 1, 0, 0) if long else (1, 1, 0, 0, 0, 0, 0)
    assert _counts(source) == tuple(a + d for a, d in zip(before, fused))
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert (want[0] != PAD_SLOT).any()
    slots = canonical_sample(on_card, k, 602, thr, keep_all)
    torch.cuda.synchronize()
    assert torch.equal(slots.cpu(), _canonical_sample_plain(
        bases, k, 602, thr, keep_all))


@pytest.mark.parametrize("source", ["packed", "bits"])
@pytest.mark.parametrize("k", [1, 2, 13, 16, 17, 31])
@pytest.mark.parametrize("length,offset", [(4096, 0), (3055, 0), (4096, 1),
                                           (3055, 2)])
def test_packed_sources_edge_rows_match_plain(cuda, source, k, length,
                                              offset):
    """Kernel A and the fused kernel on the packed sources at every k
    class, rows whose stride is a multiple of 4 bytes (4,096 bases) or not
    (3,055 bases: 764 bytes a row, every other row off 4), and streams off
    a 4-byte boundary (word loads byte by byte)."""
    if source == "packed":
        bases, lengths = _prefix_bases(k, 12, length, seed=3)
    else:
        bases = _edge_bases(k, 12, length)
    packed, valid = (torch.from_numpy(a) for a in bit_pack(bases.numpy()))
    chunk = (PackedChunk(packed, length, lengths=lengths)
             if source == "packed" else
             PackedChunk(packed, length, valid_bits=valid))
    on_card = _chunk_on_card(chunk, cuda, offset)
    thr = sample_threshold(0.3)
    for keep_all in (False, True):
        want = _canonical_sample_plain(bases, k, 602, thr, keep_all)
        got = canonical_sample(on_card, k, 602, thr, keep_all)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        w = length - k + 1
        hb = w if keep_all else staging_width(w, 0.3)
        cap = None if keep_all else selection_cap(0.3)
        staged = stage_candidates(on_card, k, hb, keep_all, 602, thr, cap)
        torch.cuda.synchronize()
        plain = _select_candidates_plain(want, hb, keep_all, cap)
        assert torch.equal(staged[0].cpu(), plain[0])
        assert torch.equal(staged[1].cpu(), plain[1])


def _random_slots(rng, r, w, density):
    codes = rng.integers(0, 1 << 40, size=(r, w), dtype=np.int64)
    slots = np.where(rng.random((r, w)) < density, codes, PAD_SLOT)
    return torch.from_numpy(slots)


def _block_counts(slots):
    """Candidates in each 1024-slot block of each row, (R, n_blocks)."""
    r, w = slots.shape
    g = -(-w // 1024)
    cand = torch.zeros((r, g * 1024), dtype=torch.int64)
    cand[:, :w] = slots != PAD_SLOT
    return cand.reshape(r, g, 1024).sum(dim=2)


def _repeat_unit(bases, row, length, rng, period):
    """Row `row`'s first `length` bases become one random unit repeated,
    so its sampled windows repeat: duplicate slots."""
    unit = torch.from_numpy(rng.integers(0, 4, period).astype(np.uint8))
    bases[row, :length] = unit.repeat(length // period + 1)[:length]


def _stage_against_plain(cuda, bases, k, hb, keep_all, thr, cap):
    """stage_candidates on the card (one fused launch) against the plain
    composition, bitwise, dropped counts included; select_candidates
    refuses the same rows' slots. Returns the plain (staged, dropped)."""
    slots = _canonical_sample_plain(bases, k, 602, thr, keep_all)
    want = _select_candidates_plain(slots, hb, keep_all, cap)
    before = (stage_candidates.launches, canonical_sample.launches,
              select_candidates.long_launches)
    got = stage_candidates(bases.to(cuda), k, hb, keep_all, 602, thr, cap)
    torch.cuda.synchronize()
    assert (stage_candidates.launches, canonical_sample.launches,
            select_candidates.long_launches) == (before[0] + 1, *before[1:])
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    with pytest.raises(ValueError, match="stage_candidates"):
        select_candidates(slots.to(cuda), hb, keep_all, cap)
    return want


@pytest.mark.parametrize("w,hit_buffer,keep_all,fraction", [
    (1500, 512, False, 0.2),     # full-width sort (w <= 2 * SELECT_BLOCK)
    (4084, 1024, False, 0.2),    # blocked, ragged last block
    (16370, 1024, False, 0.05),  # blocked, the bench.py workload bucket shape
    (5000, 5000, True, 1.0),     # keep_all: full-width sort of a long row
    (16370, 16370, True, 1.0),   # keep_all, 131 KB: the 1,024-thread block
    (4096, 8, False, 0.05),      # tiny buffer: most candidates dropped
])
def test_select_candidates_matches_plain(cuda, w, hit_buffer, keep_all,
                                         fraction):
    """Kernel B's one-block selection, on the path the pipeline takes
    (fused: the slots come from the bases), bitwise against the plain
    composition; a row of one repeated unit over half its length gives
    duplicate slots, and blocked rows take a cap at the 75th percentile
    of their blocks' candidate counts, so a quarter of the blocks overflow
    it (sorted and cut)."""
    k = 15
    rng = np.random.default_rng(w)
    bases = _bases(rng, 33, w + k - 1)
    _repeat_unit(bases, 1, (w + k - 1) // 2, rng, 211)
    thr = sample_threshold(fraction)
    cap = None
    if not keep_all:
        counts = _block_counts(_canonical_sample_plain(bases, k, 602, thr,
                                                       False))
        cap = max(1, int(np.percentile(counts.numpy(), 75)))
    assert not stage_launch_plan(w, hit_buffer, keep_all, cap).long
    want = _stage_against_plain(cuda, bases, k, hit_buffer, keep_all, thr,
                                cap)
    assert (want[0][1] != PAD_SLOT).any()


@pytest.mark.parametrize("w,hit_buffer,keep_all,cap,long", [
    # the 262,144 bucket at 5%: its survivors fit one block
    (262130, 13824, False, selection_cap(0.05), False),
    (32754, 32754, True, None, True),   # keep_all at the 32,768 bucket
    (65522, 65522, True, None, True),   # keep_all at the 65,536 bucket
    (262130, 13824, False, 128, True),  # survivors fill their chunks exactly
])
def test_select_candidates_long_rows_match_plain(cuda, w, hit_buffer,
                                                 keep_all, cap, long):
    """Long rows on kernel B's device-memory path, bitwise against the
    plain version, dropped counts included, counting one launch of that
    path: where the plan picks it, through select_candidates; where the
    plan keeps the rows in one block (they stage fused), select_candidates
    refuses the slots and the path runs forced (the plan for less shared
    memory)."""
    plan = stage_launch_plan(w, hit_buffer, keep_all, cap,
                             shared_memory_limit(cuda))
    assert plan.long == long
    if cap == 128:
        assert plan.n_surv == plan.chunk * plan.n_chunks
    rng = np.random.default_rng(w + (cap or 0))
    slots = _random_slots(rng, 8, w, 1.0 if keep_all else 0.05)
    slots[1, : 3 * 1024] = 4242    # the first blocks overflow their cap
    slots[2, :] = PAD_SLOT         # an all-padding row
    slots[3, 5:9000] = slots[3, 0]  # a long run of one slot
    want = _select_candidates_plain(slots, hit_buffer, keep_all, cap)
    on_card = slots.to(cuda)
    if not long:
        with pytest.raises(ValueError, match="stage_candidates"):
            select_candidates(on_card, hit_buffer, keep_all, cap)
        plan = stage_launch_plan(w, hit_buffer, keep_all, cap, plan.smem - 8)
        assert plan.long
    before = select_candidates.long_launches
    got = (select_candidates(on_card, hit_buffer, keep_all, cap) if long
           else _select_on_card(on_card, hit_buffer, plan))
    torch.cuda.synchronize()
    assert select_candidates.long_launches == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert int(want[1][1]) > 0 or keep_all


@pytest.mark.parametrize("case", ["exactly_cap", "every_block_over_cap",
                                  "cap_plus_one"])
def test_select_candidates_block_edges(cuda, case):
    """The one-block kernel sorts a block only past its cap. On the fused
    path at the main path's 16,370-window rows, with the cap chosen from
    the blocks' candidate counts on the same bases: the largest count
    (blocks holding exactly cap, kept unsorted, and none over), one below
    the smallest (every block over the cap, each sorted and cut), and one
    below the median (blocks of cap + 1); a row of one repeated unit gives
    duplicates. Bitwise against the plain composition."""
    rng = np.random.default_rng(7)
    k, w, fraction = 15, 16370, 0.05
    bases = _bases(rng, 16, w + k - 1, n_frac=0.0)
    _repeat_unit(bases, 3, w + k - 1, rng, 211)
    thr = sample_threshold(fraction)
    counts = _block_counts(_canonical_sample_plain(bases, k, 602, thr, False))
    cap = {"exactly_cap": int(counts.max()),
           "every_block_over_cap": int(counts.min()) - 1,
           "cap_plus_one": int(counts.median()) - 1}[case]
    assert cap >= 1
    if case == "exactly_cap":
        assert (counts == cap).any() and (counts <= cap).all()
    elif case == "every_block_over_cap":
        assert (counts > cap).all()
    else:
        assert (counts == cap + 1).any() and (counts > cap + 1).any()
    want = _stage_against_plain(cuda, bases, k, staging_width(w, fraction),
                                False, thr, cap)
    if case == "every_block_over_cap":  # every row drops
        assert int(want[1].min()) > 0
    elif case == "cap_plus_one":
        assert int(want[1].max()) > 0


@pytest.mark.parametrize("k,d", [(13, 40), (13, 100), (15, 512),
                                 (21, 1500), (15, 4100)])
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


def _embed_both(cuda, staged, codes, counts, d, density=None):
    """Kernel C and its plain version on the same inputs: (n_hits, out) of
    the kernel (on the host) and of the plain version, and the atol."""
    signs, mags = build_precompute_signs(counts, d, 2094, density)
    r = staged.shape[0]
    targets = torch.stack([2 * torch.arange(r), 2 * torch.arange(r) + 1],
                          dim=1)
    out_p = torch.zeros((2 * r, d))
    n_p = _membership_embed_plain(staged, codes, signs, mags, targets, out_p)
    out = torch.zeros((2 * r, d), device=cuda)
    n = membership_embed(staged.to(cuda), codes.to(cuda), signs.to(cuda),
                         mags.to(cuda), targets.to(cuda), out)
    torch.cuda.synchronize()
    atol = 1e-6 * float(mags.abs().max()) * max(int(n_p.max()), 1)
    return n.cpu(), out.cpu(), n_p, out_p, atol


@pytest.mark.parametrize("case", ["every_slot_a_hit", "repeated_runs",
                                  "one_code"])
def test_membership_embed_edge_rows(cuda, case):
    """Rows where every slot is a distinct library hit (past one tile of
    slots), runs of one repeated slot (only the first counts), and a
    library of one code; hit counts bitwise, sums within tolerance."""
    rng = np.random.default_rng(3)
    r, h = 6, 2500
    if case == "one_code":
        codes = torch.tensor([12345], dtype=torch.int64)
        slots = np.full((r, h), PAD_SLOT, dtype=np.int64)
        slots[:, :7] = (12345 << 1) | 1
        slots[1, :3] = 12345 << 1      # the reverse strand first
        slots[2, :7] = (12344 << 1) | 1  # a code just below the library
    else:
        base = np.sort(rng.choice(1 << 40, size=(r, h), replace=False),
                       axis=1)
        slots = (base << 1) | rng.integers(0, 2, size=(r, h))
        if case == "repeated_runs":
            slots[:, 100:700] = slots[:, 100:101]
            slots[2, :] = slots[2, 0]
        codes = torch.from_numpy(np.unique(base))
    counts = torch.from_numpy(rng.integers(2, 40, codes.shape[0]))
    staged = torch.from_numpy(np.sort(slots, axis=1))
    for d, density in ((512, None), (40, 0.5)):
        n, out, n_p, out_p, atol = _embed_both(cuda, staged, codes, counts,
                                               d, density)
        assert torch.equal(n, n_p)
        torch.testing.assert_close(out, out_p, rtol=1e-5, atol=atol)
    if case == "every_slot_a_hit":
        assert torch.all(n == h)


def test_membership_embed_two_launches_same_bytes(cuda):
    """No atomics: two launches on the same inputs give the same bytes."""
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 20000).astype(np.uint8)
    starts = rng.integers(0, 20000 - 4000, 64)
    bases = torch.from_numpy(np.stack([genome[s : s + 4000] for s in starts]))
    slots = _canonical_sample_plain(bases, 15, 9, sample_threshold(0.3),
                                    False)
    staged, _ = _select_candidates_plain(slots, 1536, False, None)
    library = build_library([staged], 2, 0.3, 9)
    signs, mags = build_precompute_signs(library.counts, 512, 2094, 0.2)
    targets = torch.stack([2 * torch.arange(64), 2 * torch.arange(64) + 1],
                          dim=1).to(cuda)
    outs = []
    for _ in range(2):
        out = torch.zeros((128, 512), device=cuda)
        membership_embed(staged.to(cuda), library.codes.to(cuda),
                         signs.to(cuda), mags.to(cuda), targets, out)
        outs.append(out.cpu())
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    assert outs[0].abs().sum() > 0


def test_membership_embed_empty_library(cuda):
    staged = torch.tensor([[4, 9, PAD_SLOT]], device=cuda)
    lib = torch.zeros((0,), dtype=torch.int64, device=cuda)
    signs = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    mags = torch.zeros((1,), device=cuda)
    out = torch.full((2, 32), 5.0, device=cuda)
    n = membership_embed(staged, lib, signs, mags,
                         torch.tensor([[0, 1]], device=cuda), out)
    assert int(n[0]) == 0 and torch.all(out == 0)


def _dense_inputs(k, rows=48, length=1200, fraction=0.2, seed=0):
    """Staged rows of reads drawn from a short genome (k-mers repeat across
    reads) and their library."""
    rng = np.random.default_rng(seed + k)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    starts = rng.integers(0, 3000 - length, rows)
    bases = torch.from_numpy(np.stack([genome[s : s + length]
                                       for s in starts]))
    slots = _canonical_sample_plain(bases, k, 9, sample_threshold(fraction),
                                    False)
    staged, _ = _select_candidates_plain(
        slots, staging_width(slots.shape[1], fraction), False,
        selection_cap(fraction))
    return staged, build_library([staged], 2, fraction, 9)


def _dense_both(cuda, staged, codes, p_pair, targets):
    """Kernel C's dense form and its plain version on the same inputs:
    (n_hits, out) of each, the kernel's on the host."""
    d = p_pair.shape[1] // 2
    out_p = torch.zeros((targets.shape[0] * 2, d))
    n_p = _membership_embed_dense_plain(staged, codes, p_pair, targets, out_p)
    out = torch.zeros((targets.shape[0] * 2, d), device=cuda)
    before = (membership_embed_dense.launches, membership_embed.launches)
    n = membership_embed_dense(staged.to(cuda), codes.to(cuda),
                               p_pair.to(cuda), targets.to(cuda), out)
    torch.cuda.synchronize()
    assert (membership_embed_dense.launches, membership_embed.launches) == (
        before[0] + 1, before[1])
    return n.cpu(), out.cpu(), n_p, out_p


@pytest.mark.parametrize("k,d,dtype", [
    (13, 40, torch.float32),     # d % 4 = 0: 16-byte loads, 10 lanes
    (13, 100, torch.bfloat16),   # d % 8 = 4: 8-byte loads
    (15, 512, torch.float32),    # the main path's width: 16-byte loads
    (15, 512, torch.bfloat16),
    (21, 256, torch.float32),    # the golden runs' width: half a chunk
    (15, 1100, torch.bfloat16),  # 8-byte loads, three column chunks
    (15, 2100, torch.float32),   # five column chunks
])
def test_membership_embed_dense_matches_plain(cuda, k, d, dtype):
    """The dense form against its plain version on tables
    build_precompute_paired builds: hit counts bitwise, sums to rtol 1e-5,
    atol 1e-6 * max|P| * hits (float32 sums in another order; a row's two
    halves share one magnitude, so the plain version's sum and difference
    are exact in bfloat16 too); padding rows write nothing."""
    staged, library = _dense_inputs(k)
    p_pair = build_precompute_paired(library.counts, d, 2094, None,
                                     dtype=dtype)
    targets = torch.stack([2 * torch.arange(48), 2 * torch.arange(48) + 1],
                          dim=1)
    targets[5] = -1
    n, out, n_p, out_p = _dense_both(cuda, staged, library.codes, p_pair,
                                     targets)
    assert torch.equal(n, n_p) and int(n.min()) > 0
    atol = 1e-6 * float(p_pair.float().abs().max()) * int(n_p.max())
    torch.testing.assert_close(out, out_p, rtol=1e-5, atol=atol)
    assert torch.all(out[10:12] == 0)


@pytest.mark.parametrize("offset", [0, 1])
def test_membership_embed_dense_generic_tables(cuda, offset):
    """Dense tables with no sign structure (normal entries, both halves
    nonzero everywhere), float32 and bfloat16, with the table aligned and
    one entry off 16 bytes (entry-by-entry loads). float32: rtol 1e-5,
    atol 1e-6 * max|P| * hits. bfloat16: the plain version rounds gl + gr
    and gl - gr to bfloat16, at most half an ulp of 2 max|P| each, so fwd
    and rev may differ by 2^-8 * max|P| per hit from the kernel's float32
    sums of the halves."""
    staged, library = _dense_inputs(15, rows=16, length=2500, seed=3)
    rng = np.random.default_rng(offset)
    d = 96
    targets = torch.stack([2 * torch.arange(16), 2 * torch.arange(16) + 1],
                          dim=1)
    for dtype, rel in ((torch.float32, 1e-6), (torch.bfloat16, 2.0**-8)):
        table = torch.from_numpy(rng.standard_normal(
            (library.size + 1, 2 * d)).astype(np.float32)).to(dtype)
        table[-1] = 0
        flat = torch.zeros(table.numel() + offset, dtype=dtype)
        p_pair = flat[offset:].view(table.shape)
        p_pair.copy_(table)
        n, out, n_p, out_p = _dense_both(cuda, staged, library.codes, p_pair,
                                         targets)
        assert torch.equal(n, n_p)
        atol = rel * float(table.float().abs().max()) * int(n_p.max())
        torch.testing.assert_close(out, out_p, rtol=1e-5, atol=atol)


def test_membership_embed_dense_two_launches_same_bytes(cuda):
    """No atomics: two launches of the dense form give the same bytes."""
    staged, library = _dense_inputs(15, rows=64, length=2500, seed=5)
    p_pair = build_precompute_paired(library.counts, 512, 2094, 0.2).to(cuda)
    targets = torch.stack([2 * torch.arange(64), 2 * torch.arange(64) + 1],
                          dim=1).to(cuda)
    outs = []
    for _ in range(2):
        out = torch.zeros((128, 512), device=cuda)
        membership_embed_dense(staged.to(cuda), library.codes.to(cuda),
                               p_pair, targets, out)
        outs.append(out.cpu())
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    assert outs[0].abs().sum() > 0


def _dense_in_part_order(staged, codes, p_pair, targets, d, parts):
    """Kernel C's dense sums as its sweep takes them, on the host: each
    row's hits (read_hits_staged) in slot order, hit e added in float32 to
    part e % parts of its fwd and rev rows (halves swapped for a
    reverse-strand window), the parts then added in part order; row r's to
    targets[r] (-1: not written)."""
    hits, _ = read_hits_staged(staged, codes)
    size = codes.shape[0]
    tab = p_pair.float().numpy()
    out = np.zeros((2 * staged.shape[0], d), np.float32)
    for r, row in enumerate(hits.tolist()):
        acc = np.zeros((parts, 2, d), np.float32)
        for e, x in enumerate(x for x in row if x < 2 * size):
            j = x - size if x >= size else x
            halves = [tab[j, :d], tab[j, d:]]
            if x >= size:
                halves.reverse()
            acc[e % parts, 0] += halves[0]
            acc[e % parts, 1] += halves[1]
        sums = acc[0]
        for part in range(1, parts):
            sums = sums + acc[part]
        for t, v in zip(targets[r].tolist(), sums):
            if t >= 0:
                out[t] = v
    return torch.from_numpy(out)


@pytest.mark.parametrize("d,dtype,rows,window,lag", [
    (512, torch.float32, 48, None, None),   # the card's own plan: 4 parts
    (512, torch.bfloat16, 48, None, None),
    (64, torch.float32, 48, 7, 1),      # windows of 7 library rows; 1 part
    (64, torch.float32, 48, 7, 10**6),  # the same, unpaced
    (32, torch.bfloat16, 7, 2, 2),      # windows with no hit; 2 + .. + 1
    (1100, torch.float32, 7, 40, 3),    # three column chunks, 2 parts
    (100, torch.bfloat16, 3, 7, 3),     # 4-entry loads, 4 parts
])
def test_membership_embed_dense_sweep_sums_in_part_order(
        cuda, d, dtype, rows, window, lag):
    """The dense form's sweep on plans forced through dense_plan (windows
    that cut every row's hits, windows with no hit, a block that ends
    early, column chunks, rows of 1, 2 and 4 parts, a lag of 1 and none at
    all) writes bitwise the sums of each part's hits (every parts-th hit
    of a row) taken one by one in slot order, the parts added in part
    order; hit counts bitwise the plain version's, the same bytes in two
    launches."""
    staged, library = _dense_inputs(15, rows=rows, length=2500, seed=7)
    p_pair = build_precompute_paired(library.counts, d, 2094, 0.3,
                                     dtype=dtype)
    targets = torch.stack([2 * torch.arange(rows), 2 * torch.arange(rows) + 1],
                          dim=1)
    targets[rows // 2, 1] = -1
    plan = dense_plan(rows, d, p_pair.element_size(), library.size,
                      torch.cuda.get_device_properties(0).multi_processor_count
                      if window is None else 1, window=window, lag=lag)
    want = _dense_in_part_order(staged, library.codes, p_pair, targets, d,
                                plan.parts)
    outs = []
    for _ in range(2):
        out = torch.zeros((2 * rows, d), device=cuda)
        n = membership_embed_dense(staged.to(cuda), library.codes.to(cuda),
                                   p_pair.to(cuda), targets.to(cuda), out,
                                   plan=plan)
        outs.append(out.cpu())
    torch.cuda.synchronize()
    _, n_p = read_hits_staged(staged, library.codes)
    assert torch.equal(n.cpu(), n_p) and int(n_p.min()) > 0
    assert torch.equal(outs[0].view(torch.int32), want.view(torch.int32))
    assert torch.equal(outs[1].view(torch.int32), want.view(torch.int32))
    if window is not None:
        assert plan.windows > 10


def test_membership_embed_dense_empty_library(cuda):
    staged = torch.tensor([[4, 9, PAD_SLOT]], device=cuda)
    lib = torch.zeros((0,), dtype=torch.int64, device=cuda)
    out = torch.full((2, 32), 5.0, device=cuda)
    n = membership_embed_dense(staged, lib,
                               torch.zeros((1, 64), device=cuda),
                               torch.tensor([[0, 1]], device=cuda), out)
    assert int(n[0]) == 0 and torch.all(out == 0)


@pytest.mark.parametrize("dense", [False, True])
def test_split_union_matches_plain(cuda, dense):
    """Split reads on the card: the merged segment rows (split_union_rows)
    equal the CPU's bitwise, and kernel C on them (sign or dense form)
    equals the plain union (per-segment read_hits_staged, unique, embed)
    to rtol 1e-5, atol 1e-6 * max|P| * hits."""
    from fedrann_tpu_torch import pipeline
    from fedrann_tpu_torch.config import PipelineConfig
    from fedrann_tpu_torch.io.fastx import FastxRecord
    from fedrann_tpu_torch.io.packing import pack_reads

    rng = np.random.default_rng(11)
    genome = "".join("ACGT"[b] for b in rng.integers(0, 4, 60_000))
    seqs = [genome[s : s + 3000] for s in rng.integers(0, 57_000, 30)]
    seqs += [genome[1000:41_000], genome[20_000:29_000]]
    packed = pack_reads([FastxRecord(f"r{i}", q) for i, q in
                         enumerate(seqs)], (4096, 8192), split_overlap=14)
    assert list(packed.split_read_ids) == [30, 31]
    config = PipelineConfig(kmer_size=15, kmer_sample_fraction=0.3)
    split = torch.tensor([30, 31])
    staged = {dev: pipeline.stage_reads(packed, config, dev)
              for dev in (torch.device("cpu"), cuda)}
    rows = pipeline.split_union_rows(staged[cuda], split.to(cuda))
    assert torch.equal(rows.cpu(), pipeline.split_union_rows(
        staged[torch.device("cpu")], split))
    library = build_library([b.staged for b in staged[cuda]], 2, 0.3,
                            config.seed)
    proj = (build_precompute_paired(library.counts, 256, 2094) if dense
            else build_precompute_signs(library.counts, 256, 2094))
    out = torch.zeros((64, 256), device=cuda)
    before = (membership_embed_dense.launches, membership_embed.launches)
    n = embed_staged(rows, library.codes, proj,
                     torch.stack([2 * split, 2 * split + 1], dim=1).to(cuda),
                     out)
    torch.cuda.synchronize()
    assert (membership_embed_dense.launches - before[0],
            membership_embed.launches - before[1]) == (
        (1, 0) if dense else (0, 1))
    fwd, rev = pipeline._split_union_plain(
        staged[cuda], split.to(cuda), library.codes, proj, 256)
    scale = (proj.abs().max() if dense else proj[1].abs().max())
    atol = 1e-6 * float(scale) * int(n.max())
    torch.testing.assert_close(out[60::2], fwd, rtol=1e-5, atol=atol)
    torch.testing.assert_close(out[61::2], rev, rtol=1e-5, atol=atol)
    assert int(n.min()) > 0


def test_wrappers_count_launches(cuda):
    bases = _bases(np.random.default_rng(1), 8, 64).to(cuda)
    before = (canonical_sample.launches, stage_candidates.launches,
              select_candidates.long_launches)
    slots = canonical_sample(bases, 5, 1, sample_threshold(0.5), False)
    stage_candidates(bases, 5, 16, False, 1, sample_threshold(0.5), None)
    with pytest.raises(ValueError, match="stage_candidates"):
        select_candidates(slots, 16, False, None)
    assert (canonical_sample.launches, stage_candidates.launches,
            select_candidates.long_launches) == (
        before[0] + 1, before[1] + 1, before[2])


@pytest.fixture
def probe_tensors(cuda):
    return {k: torch.from_numpy(v) for k, v in probes.probe_inputs().items()}


def test_probe_smem_scratch_accepts_exactly_the_opt_in_limit(cuda):
    steps = probes.probe_smem_scratch(cuda)
    assert probes.scratch_ladder_problems(
        steps, shared_memory_limit(cuda)) == []


def test_probe_smem_scratch_second_ladder(cuda):
    """The opt-in granted by the first ladder is cached: a second ladder in
    the same process still accepts every size within the limit, refuses the
    first past it, and the 16 KB size returns n after each refusal."""
    limit = shared_memory_limit(cuda)
    for _ in range(2):
        assert probes.scratch_ladder_problems(
            probes.probe_smem_scratch(cuda), limit) == []
        n = probes.SCRATCH_SIZES[0]
        assert int(probes.smem_scratch(n, cuda)[0, 0]) == n
    largest = max(n for n in probes.SCRATCH_SIZES if 4 * n <= limit)
    assert int(probes.smem_scratch(largest, cuda)[0, 0]) == largest
    with pytest.raises(RuntimeError, match="fk_probe_smem_scratch"):
        probes.smem_scratch(limit // 4 + 1, cuda)


def test_probe_smem_input_matches_plain(cuda, probe_tensors):
    x = probe_tensors["x"]
    got = probes.smem_input(x.to(cuda))
    assert torch.equal(got.cpu(), probes._smem_input_plain(x))
    assert int(got[0]) == 1818744


def _check_dyn_rows(cuda, q, idx, row, mode):
    """The kernel equals the hit-order replay bitwise and the plain
    index_add_ version within the sum-order tolerance (mode B bitwise)."""
    want = probes._dyn_rows_plain(q, idx, row, mode)
    before = probes.dyn_rows.launches
    got = probes.dyn_rows(q.to(cuda), idx.to(cuda), row.to(cuda),
                          mode).cpu()
    assert probes.dyn_rows.launches == before + 1
    assert torch.equal(got, probes._dyn_rows_replay(q, idx, row, mode))
    if mode == "B":
        assert torch.equal(got, want)
        return
    lists = probes.dyn_rows_order(row, mode)
    terms = probes.DYN_MODES[mode][3] * max(len(h) for h in lists)
    atol = 1e-6 * terms * float(q.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("mode", sorted(probes.DYN_MODES))
def test_probe_dyn_rows_matches_plain(cuda, probe_tensors, mode):
    _check_dyn_rows(cuda, *(probe_tensors[k] for k in ("q", "idx", "row")),
                    mode)


@pytest.mark.parametrize("kind", ["eight_rows", "one_row", "wide",
                                  "ragged"])
@pytest.mark.parametrize("mode", sorted(probes.DYN_MODES))
def test_probe_dyn_rows_long_lists(cuda, mode, kind):
    """Hit lists far longer than the probe inputs' ~16: 8 rows of ~512
    hits and every hit in one row; then 10,000 hits (past one shared-memory
    chunk of either kernel) over 1,500 columns (past one block's columns,
    ragged tile), and 5,000 hits over 1,001 columns (q rows off 16-byte
    boundaries: mode A copies single floats)."""
    rng = np.random.default_rng(11)
    nh, d = {"wide": (10000, 1500), "ragged": (5000, 1001)}.get(
        kind, (4096, 1024))
    q = torch.from_numpy(rng.normal(size=(512, d)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 512, nh, dtype=np.int32))
    if kind == "eight_rows":
        row = rng.choice(np.arange(3, probes.E_ROWS, 31)[:8], nh)
    elif kind == "one_row":
        row = np.full(nh, 200)
    else:
        row = rng.integers(0, probes.E_ROWS, nh)
    _check_dyn_rows(cuda, q, idx, torch.from_numpy(row.astype(np.int32)),
                    mode)


def test_probe_bsearch_matches_plain(cuda, probe_tensors):
    t, qs = probe_tensors["table"], probe_tensors["queries"]
    got = probes.bsearch(t.to(cuda), qs.to(cuda))
    assert torch.equal(got.cpu(), probes._bsearch_plain(t, qs))


def _smem_input_every_step(x):
    """Every step's sum from fk_probe_smem_input (n_sums = steps), launched
    through its C entry: the wrapper asks for the last step's only."""
    steps = x.shape[0] // probes.INPUT_ROWS
    sums = torch.empty(steps, dtype=torch.int32, device=x.device)
    _build.launch("fk_probe_smem_input", x.data_ptr(), steps,
                  probes.INPUT_ROWS, x.shape[1], sums.data_ptr(), steps,
                  _build.stream(x.device))
    return sums.cpu()


def _smem_input_plain_every_step(x):
    return torch.cat([probes._smem_input_plain(blk)
                      for blk in x.split(probes.INPUT_ROWS)])


def test_probe_smem_input_every_step_full_range(cuda, probe_tensors):
    """Every step's sum, bitwise, at the probe inputs and at full-range
    random int32 blocks (sums that wrap); each wrapper call counts one
    launch and returns the last step's sum."""
    info = np.iinfo(np.int32)
    xr = torch.from_numpy(np.random.default_rng(0).integers(
        info.min, info.max, (64, 2048), dtype=np.int32, endpoint=True))
    for x in (probe_tensors["x"], xr):
        want = _smem_input_plain_every_step(x)
        assert torch.equal(_smem_input_every_step(x.to(cuda)), want)
        before = probes.smem_input.launches
        last = probes.smem_input(x.to(cuda))
        assert probes.smem_input.launches == before + 1
        assert torch.equal(last.cpu(), want[-1:])


@pytest.mark.parametrize("shape,offset", [((64, 2048), 1), ((48, 1030), 0),
                                          ((16, 512), 0), ((32, 16), 3)])
def test_probe_smem_input_other_blocks(cuda, shape, offset):
    """Blocks off 16 bytes (4-byte loads), other widths, one 32 KB step and
    the narrowest block (hb = INPUT_ROWS): every step's sum bitwise."""
    info = np.iinfo(np.int32)
    x = torch.from_numpy(np.random.default_rng(shape[1]).integers(
        info.min, info.max, shape, dtype=np.int32, endpoint=True))
    flat = torch.zeros(x.numel() + offset, dtype=torch.int32, device=cuda)
    flat[offset:].copy_(x.view(-1))
    got = _smem_input_every_step(flat[offset:].view(shape))
    assert torch.equal(got, _smem_input_plain_every_step(x))


@pytest.mark.parametrize("case", range(len(probes.BSEARCH_EDGE_SIZES)))
def test_probe_bsearch_edge_tables(cuda, case):
    """Each edge query launched alone (nq = 1) gives torch.searchsorted's
    position (side="left"); all of them together with random queries,
    on the table and on a copy off 16 bytes, give the plain sum."""
    table, queries = (torch.from_numpy(a)
                      for a in probes.bsearch_edge_cases()[case])
    want = torch.searchsorted(table, queries, side="left")
    t, q = table.to(cuda), queries.to(cuda)
    got = [int(probes.bsearch(t, q[j : j + 1])[0])
           for j in range(q.shape[0])]
    assert got == want.tolist()
    extra = torch.from_numpy(np.random.default_rng(case).integers(
        int(table[0]) - 9, int(table[-1]) + 9, 1021).astype(np.int32))
    qs = torch.cat([queries, extra])
    flat = torch.zeros(table.shape[0] + 1, dtype=torch.int32, device=cuda)
    flat[1:].copy_(t)
    for on_card in (t, flat[1:]):
        assert torch.equal(probes.bsearch(on_card, qs.to(cuda)).cpu(),
                           probes._bsearch_plain(table, qs))


def test_probe_bsearch_many_blocks_and_empty(cuda, probe_tensors):
    """Past one round of one block per SM (a grid-stride loop); no
    queries, and an empty table, give 0."""
    table = probe_tensors["table"]
    queries = torch.from_numpy(np.random.default_rng(5).integers(
        0, 1 << 30, 132 * 512 * 2 + 7).astype(np.int32))
    assert torch.equal(probes.bsearch(table.to(cuda), queries.to(cuda)).cpu(),
                       probes._bsearch_plain(table, queries))
    none = torch.zeros(0, dtype=torch.int32, device=cuda)
    assert int(probes.bsearch(table.to(cuda), none)[0]) == 0
    assert int(probes.bsearch(none, queries.to(cuda))[0]) == 0


@pytest.mark.parametrize("precision,transfer", [("bf16", "u16"),
                                                ("bf16", "f32"),
                                                ("fp32", "f32")])
def test_ooc_double_buffered_matches_sync_uploads(cuda, monkeypatch,
                                                  precision, transfer):
    """The out-of-core search with each candidate block copied on a side
    stream under the search of the block before it (_blocks_streamed)
    against the same loop with synchronous uploads (_blocks_sync),
    bitwise, over several query slabs and candidate blocks."""
    from fedrann_tpu_torch.knn import ooc

    rng = np.random.default_rng(3)
    e = (rng.standard_normal((6000, 16)) @ rng.standard_normal((16, 128))
         + 0.25 * rng.standard_normal((6000, 128))).astype(np.float32)
    e[17] = 0
    args = (e, 10, 2_500_000)
    kw = dict(query_tile=256, block_rows=1024, precision=precision,
              transfer=transfer, device=cuda)
    before = (ooc.knn_exact_ooc.slabs, ooc.knn_exact_ooc.blocks_uploaded)
    got = ooc.knn_exact_ooc(*args, **kw)
    slabs = ooc.knn_exact_ooc.slabs - before[0]
    blocks = ooc.knn_exact_ooc.blocks_uploaded - before[1]
    assert slabs >= 2 and blocks >= 3 * slabs
    monkeypatch.setattr(ooc, "_blocks_streamed", ooc._blocks_sync)
    want = ooc.knn_exact_ooc(*args, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[0][:, 0] == np.arange(6000)).mean() > 0.99


def _blobs(n_rows, d, n_centers, rng, spread=0.04):
    """Rows around random unit centers (tests/test_knn_ivf.py's
    _clustered_embeddings, which this file cannot import: that module
    imports the JAX package)."""
    centers = rng.normal(size=(n_centers, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    who = rng.integers(0, n_centers, size=n_rows)
    return (centers[who] + spread * rng.normal(size=(n_rows, d))).astype(
        np.float32)


def test_ivf_ooc_streamed_block_list_matches_sync(cuda, monkeypatch):
    """knn_ivf_ooc over several slabs that each upload a selected list of
    blocks (consecutive needed blocks can share a parity, so the double
    buffer is slotted by list position): the streamed uploads against
    synchronous ones, bitwise."""
    from fedrann_tpu_torch.knn import ooc

    e = _blobs(8000, 64, 40, np.random.default_rng(11))
    kw = dict(n_clusters=256, n_probes=4, spill=2, block_rows=256,
              query_tile=128, transfer="u16", device=cuda)
    got = ooc.knn_ivf_ooc(e, 10, int(1.3 * (1 << 20)), **kw)
    last = ooc.knn_ivf_ooc.last
    assert last["slabs"] >= 2 and last["uploads"] < last["exact_uploads"]
    monkeypatch.setattr(ooc, "_blocks_streamed", ooc._blocks_sync)
    want = ooc.knn_ivf_ooc(e, 10, int(1.3 * (1 << 20)), **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("spill", [1, 2])
def test_knn_ivf_on_the_card_is_repeatable_and_matches_cpu(cuda, spill):
    """knn_ivf on the card twice (bitwise the same: the k-means sums in a
    fixed order) against the plain run on the CPU: the same tables up to
    float32 sums in another order (a row near a k-means boundary may land
    in another cluster, and near-equal scores may swap places), so
    neighbor agreement >= 0.999, and the rows with the same neighbor sets
    (> 90% of them) at sorted distances within 1e-5; zero rows
    included."""
    from fedrann_tpu_torch.knn.ivf import knn_ivf

    e = _blobs(6000, 64, 40, np.random.default_rng(11))
    e[::53] = 0
    # float32 rows: at bf16 a last-bit difference in the normalized rows
    # can move a rounded element by a bf16 step (~1e-4 in a distance)
    kw = dict(n_clusters=64, n_probes=8, spill=spill, precision="fp32",
              transfer="f32")
    one = knn_ivf(torch.from_numpy(e).to(cuda), 20, **kw)
    two = knn_ivf(torch.from_numpy(e).to(cuda), 20, **kw)
    np.testing.assert_array_equal(one[0], two[0])
    np.testing.assert_array_equal(one[1], two[1])
    ref = knn_ivf(torch.from_numpy(e), 20, **kw)
    agree = np.mean([len(set(a) & set(b)) / 20 for a, b in
                     zip(one[0], ref[0])])
    assert agree >= 0.999, agree
    same = (np.sort(one[0], axis=1) == np.sort(ref[0], axis=1)).all(axis=1)
    assert same.mean() > 0.9, same.mean()
    np.testing.assert_allclose(np.sort(one[1][same], axis=1),
                               np.sort(ref[1][same], axis=1), rtol=0,
                               atol=1e-5)


def test_ooc_search_inside_the_profiler_matches(cuda):
    """--profile with --knn-hbm-budget: the out-of-core search (each query
    slab and candidate block one launch of the merge kernel K4) inside a
    torch.profiler session with CUDA activity gives the search's result
    outside it, bitwise."""
    from torch.profiler import ProfilerActivity, profile

    from fedrann_tpu_torch.knn import ooc

    rng = np.random.default_rng(5)
    e = (rng.standard_normal((4000, 16)) @ rng.standard_normal((16, 128))
         ).astype(np.float32)
    kw = dict(query_tile=256, block_rows=1024, device=cuda)
    want = ooc.knn_exact_ooc(e, 10, 2_500_000, **kw)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]):
        got = ooc.knn_exact_ooc(e, 10, 2_500_000, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture
def last_card(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices: launches each kernel on the "
                    "last card while cuda:0 is current")
    torch.cuda.set_device(0)
    return torch.device("cuda", n - 1)


def test_kernels_launch_on_their_tensors_card(last_card):
    """With cuda:0 current, each hand kernel on tensors of the last card
    launches there (its shared-memory opt-in granted on that card, its
    stream that card's) and matches its plain version: the fused staging
    kernel at 1,024 threads and 131 KB of shared memory, kernel A and B's
    device-memory path, and kernel C's sign and dense forms."""
    card = last_card
    bases, k, hb, keep_all, cap, thr, _ = _stage_case("keep_all")
    want = _select_candidates_plain(
        _canonical_sample_plain(bases, k, 602, thr, keep_all), hb, keep_all,
        cap)
    got = stage_candidates(bases.to(card), k, hb, keep_all, 602, thr, cap)
    assert got[0].device == card
    long_bases = _edge_bases(15, 6, 1 << 15)
    w = long_bases.shape[1] - 15 + 1
    long_want = _select_candidates_plain(
        _canonical_sample_plain(long_bases, 15, 602, 0, True), w, True, None)
    before = (canonical_sample.launches, select_candidates.long_launches)
    long_got = stage_candidates(long_bases.to(card), 15, w, True, 602, 0,
                                None)
    assert (canonical_sample.launches, select_candidates.long_launches) == (
        before[0] + 1, before[1] + 1)
    staged, library = _dense_inputs(15)
    signs, mags = build_precompute_signs(library.counts, 512, 2094)
    p_pair = build_precompute_paired(library.counts, 512, 2094, None,
                                     dtype=torch.bfloat16)
    targets = torch.stack([2 * torch.arange(48), 2 * torch.arange(48) + 1],
                          dim=1)
    on = [t.to(card) for t in (staged, library.codes, targets)]
    out_s = torch.zeros((96, 512), device=card)
    n_s = membership_embed(on[0], on[1], signs.to(card), mags.to(card),
                           on[2], out_s)
    out_d = torch.zeros((96, 512), device=card)
    n_d = membership_embed_dense(on[0], on[1], p_pair.to(card), on[2], out_d)
    torch.cuda.synchronize(card)
    assert torch.cuda.current_device() == 0
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(long_got[0].cpu(), long_want[0])
    assert torch.equal(long_got[1].cpu(), long_want[1])
    for n, out, plain, table in (
            (n_s, out_s, _membership_embed_plain, (signs, mags)),
            (n_d, out_d, _membership_embed_dense_plain, (p_pair,))):
        out_p = torch.zeros((96, 512))
        n_p = plain(staged, library.codes, *table, targets, out_p)
        assert torch.equal(n.cpu(), n_p)
        scale = max(float(t.float().abs().max()) for t in table)
        torch.testing.assert_close(
            out.cpu(), out_p, rtol=1e-5, atol=1e-6 * scale * int(n_p.max()))


@pytest.mark.parametrize("strategy,n_hosts", [("ring", 0),
                                              ("allgather", 0),
                                              ("ring2d", 2)])
def test_sharded_knn_on_one_card_matches_knn_exact(cuda, strategy, n_hosts):
    """The sharded search over a mesh of one card repeated four times (the
    real schedule, each copy the same tensor) equals knn_exact on the card
    where distances resolve the k-th neighbor, and leaves its input as it
    was."""
    from fedrann_tpu_torch.knn.ring import knn_exact_sharded
    from fedrann_tpu_torch.knn.topk import knn_exact
    from fedrann_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    rng = np.random.default_rng(4)
    e = (rng.standard_normal((3001, 16)) @ rng.standard_normal((16, 128))
         + 0.25 * rng.standard_normal((3001, 128))).astype(np.float32)
    e[17] = 0
    rows = torch.from_numpy(e).to(cuda)
    kept = rows.clone()
    mesh = (make_mesh_2d(n_hosts, [cuda] * 4) if n_hosts
            else make_mesh(devices=[cuda] * 4))
    idx, dist = knn_exact_sharded(rows, 10, mesh=mesh, strategy=strategy,
                                  candidate_tile=512)
    want_i, want_d = knn_exact(rows, 11)
    assert torch.equal(rows, kept)
    resolved = want_d[:, 10] - want_d[:, 9] > 1e-6
    np.testing.assert_array_equal(idx[resolved], want_i[resolved, :10])
    np.testing.assert_allclose(dist, want_d[:, :10], atol=1e-5)


@pytest.mark.parametrize("strategy", ["ring", "allgather", "ring2d"])
def test_multihost_search_on_two_local_cards_matches_knn_exact(cuda,
                                                               strategy):
    """knn_exact_sharded_multihost in one process whose local mesh is two
    cards: each shard lies on its own card (the allgather copies them to
    the transport's hop card before the gather) and the result is
    knn_exact's where distances resolve the k-th neighbor."""
    from fedrann_tpu_torch.knn.ring import knn_exact_sharded_multihost
    from fedrann_tpu_torch.knn.topk import knn_exact
    from fedrann_tpu_torch.parallel import dist
    from fedrann_tpu_torch.parallel.mesh import make_mesh
    from fedrann_tpu_torch.parallel.runtime import process_quota

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: one shard on each card")
    rng = np.random.default_rng(5)
    n_reads = 1001
    e = (rng.standard_normal((2 * n_reads, 16)) @ rng.standard_normal(
        (16, 128)) + 0.25 * rng.standard_normal((2 * n_reads, 128))
         ).astype(np.float32)
    rows = torch.from_numpy(e).to(cuda)
    mesh = make_mesh(devices=[torch.device("cuda", 0),
                              torch.device("cuda", 1)])
    transport = dist.DeviceTransport(dist.ProcessGroup(), mesh.devices)
    idx, dist_ = knn_exact_sharded_multihost(
        rows, n_reads, process_quota(n_reads, 1, mesh.size), 10,
        strategy=strategy, candidate_tile=512, mesh=mesh,
        transport=transport)
    want_i, want_d = knn_exact(rows, 11)
    resolved = want_d[:, 10] - want_d[:, 9] > 1e-6
    np.testing.assert_array_equal(idx[resolved], want_i[resolved, :10])
    np.testing.assert_allclose(dist_, want_d[:, :10], atol=1e-5)
    assert transport.blocks == 0


# K4 cases: name -> (m, n, d, k, carry width, ids form); every case has
# zero query and candidate rows
MERGE_CASES = {
    "main": (300, 1000, 64, 10, 0, False),
    "ragged_d40": (67, 257, 40, 16, 0, False),  # d % 8: element loads
    "m_below_block": (5, 300, 32, 8, 0, False),
    "k_over_n": (70, 20, 32, 50, 0, False),
    "ids_carry": (130, 300, 64, 12, 12, True),
    "empty_slots_k_over_n": (40, 7, 16, 20, 10, True),
    "d_13": (33, 129, 13, 5, 0, False),
    "k_past_a_tile": (20, 500, 32, 200, 0, False),
}


def _merge_inputs(case, dtype, precision):
    """(run, q, c, index, k) of a K4 case on the CPU: unit rows (zero rows
    at query 0 and 3, candidates 1 and n - 1), the candidates' indices as
    an int or a permutation, and a carry from a merge of 60 other
    candidates (indices 5,000..), its last slots EMPTY_KEY in every other
    row where the case says."""
    m, n, d, k, w, ids = MERGE_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, c, other = (normalize_rows(torch.from_numpy(
        rng.standard_normal((rows, d)).astype(np.float32)))
        for rows in (m, n, 60))
    q[[0, 3 % m]] = 0
    c[[1 % n, n - 1]] = 0
    index = (torch.from_numpy(rng.permutation(4 * n)[:n].astype(np.int64))
             if ids else 17)
    run = None
    if w:
        run = merge_block_plain(None, q, other, 5000, w, precision)
        if case.startswith("empty_slots"):
            run[::2, w // 2 :] = EMPTY_KEY
    return run, q.to(dtype), c.to(dtype), index, k


def _check_merge(got, run, q, c, index, k, precision, tol=1e-5):
    """K4's keys (on the CPU) against merge_block_plain: the plain width;
    EMPTY_KEY slots where the plain version has them; strictly descending
    real keys; every score within tol of the plain score of the same pair;
    each row's neighbor set the plain one's but where the plain W-th and
    (W+1)-th scores are within tol. Returns the share of agreeing
    neighbors."""
    w = 0 if run is None else run.shape[1]
    width = min(k, w + c.shape[0])
    full = merge_block_plain(None if run is None else run.clone(), q, c,
                             index, w + c.shape[0], precision)
    assert got.shape == (q.shape[0], width)
    empty = got == EMPTY_KEY
    assert torch.equal(empty, full[:, :width] == EMPTY_KEY)
    real = got.masked_fill(empty, torch.iinfo(torch.int64).min)
    assert bool((real[:, 1:] < real[:, :-1])[~empty[:, 1:]].all())
    g_s, g_i = _decode_keys(got)
    f_s, f_i = _decode_keys(full)
    agree = 0
    for r in range(got.shape[0]):
        plain = {int(i): float(s) for s, i, e in zip(
            f_s[r], f_i[r], full[r] == EMPTY_KEY) if not e}
        mine = [int(i) for i, e in zip(g_i[r], empty[r]) if not e]
        for s, i in zip(g_s[r][~empty[r]], mine):
            assert abs(float(s) - plain[i]) <= tol, (r, i)
        want = [int(i) for i, e in zip(f_i[r, :width], empty[r]) if not e]
        agree += len(set(mine) & set(want))
        if width < full.shape[1] and full[r, width] != EMPTY_KEY and (
                float(f_s[r, width - 1]) - float(f_s[r, width]) <= tol):
            continue
        assert set(mine) == set(want), r
    return agree / max(int((~empty).sum()), 1)


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_knn_merge_matches_plain(cuda, case, dtype, precision):
    """K4 against merge_block_plain over both precisions and row types:
    ragged m, n and d, fewer query rows than a block, k past n and past a
    tile, the ids form, a carry (with EMPTY_KEY slots), zero rows (whose
    ties keep the lowest indices). One launch a call, counted."""
    run, q, c, index, k = _merge_inputs(case, dtype, precision)
    before = merge_block.kernel_launches
    got = merge_block(
        None if run is None else run.to(cuda), q.to(cuda), c.to(cuda),
        index.to(cuda) if isinstance(index, torch.Tensor) else index, k,
        precision)
    torch.cuda.synchronize()
    assert merge_block.kernel_launches == before + 1
    assert _check_merge(got.cpu(), run, q, c, index, k, precision) >= 0.99
    zero = got[0].cpu()
    if run is None:  # a zero query row ties at +0.0: the lowest indices
        first = (index if isinstance(index, int)
                 else int(torch.sort(index).values[0]))
        order = (torch.arange(min(k, c.shape[0])) + index
                 if isinstance(index, int)
                 else torch.sort(index).values[: min(k, c.shape[0])])
        assert torch.equal(_decode_keys(zero)[1], order), first
        assert bool((_decode_keys(zero)[0] == 0).all())


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_knn_merge_two_launches_same_keys(cuda, precision):
    """Two launches of K4 on the same rows give the same keys, bitwise
    (every score is one fixed sequence of operations)."""
    run, q, c, index, k = _merge_inputs("ids_carry", torch.bfloat16,
                                        precision)
    args = [t.to(cuda) for t in (q, c, index)]
    one = merge_block(run.to(cuda), args[0], args[1], args[2], k, precision)
    two = merge_block(run.to(cuda), args[0], args[1], args[2], k, precision)
    assert torch.equal(one, two)


def test_knn_merge_scores_do_not_depend_on_the_tile(cuda):
    """The same candidates merged in one launch, or split into blocks that
    start off a tile's edge, give the same keys bitwise: a pair's score
    does not depend on where it falls in a tile or a launch."""
    run, q, c, _, k = _merge_inputs("main", torch.bfloat16, "bf16")
    q, c = q.to(cuda), c.to(cuda)
    one = merge_block(None, q, c, 0, k)
    split = None
    for lo, hi in ((0, 77), (77, 600), (600, 1000)):
        split = merge_block(split, q[5:], c[lo:hi], lo, k)
    assert torch.equal(one[5:], split)


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_knn_merge_splits_are_bitwise_equal(cuda, case, dtype, precision):
    """K4 with each query block's candidates forced into 1, 2 and 7 units
    (clamped to the candidate tiles; 2 and 7 merge through the scratch and
    the combine kernel): the same keys bitwise, held to merge_block_plain,
    one launch counted a call."""
    run, q, c, index, k = _merge_inputs(case, dtype, precision)
    args = [t.to(cuda) if isinstance(t, torch.Tensor) else t
            for t in (q, c, index)]
    keys = []
    for units in (1, 2, 7):
        before = merge_block.kernel_launches
        got = merge_block(None if run is None else run.to(cuda), *args, k,
                          precision, units=units)
        torch.cuda.synchronize()
        assert merge_block.kernel_launches == before + 1
        assert merge_block.last_units == min(units, -(-c.shape[0] // 128))
        keys.append(got.cpu())
    assert all(torch.equal(keys[0], other) for other in keys[1:])
    assert _check_merge(keys[0], run, q, c, index, k, precision) >= 0.99


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
@pytest.mark.parametrize("units", [1, 3])
def test_knn_merge_zero_row_over_negative_candidates(cuda, precision, units):
    """A zero query row over candidates negative in every component: each
    product is -0.0, and the row's scores must still be +0.0 (the
    accumulators start at +0.0; a first step that overwrote them could
    leave -0.0, which orders below +0.0), so its keys are the plain
    version's bitwise: the lowest indices at +0.0."""
    rng = np.random.default_rng(5)
    q = normalize_rows(torch.from_numpy(
        rng.random((9, 64)).astype(np.float32)))
    q[[0, 4]] = 0
    c = -normalize_rows(torch.from_numpy(
        rng.random((1100, 64)).astype(np.float32)))
    got = merge_block(None, q.to(cuda), c.to(cuda), 3, 20, precision,
                      units=units).cpu()
    want = merge_block_plain(None, q, c, 3, 20, precision)
    assert torch.equal(got[[0, 4]], want[[0, 4]])
    assert torch.equal(_decode_keys(got[0])[1], torch.arange(3, 23))
    assert _check_merge(got, None, q, c, 3, 20, precision) >= 0.99


@pytest.mark.parametrize("d", [13, 40, 640])
def test_knn_merge_unaligned_and_wide_rows(cuda, d):
    """bf16 rows K4 cannot read by TMA as they are (d % 8 != 0, or a base
    off 16 bytes) go through the zero-padded copy, and rows past the
    resident query tile (d = 640) stream it with the candidates: the same
    keys bitwise as aligned rows, and held to merge_block_plain."""
    rng = np.random.default_rng(d)
    q, c = (normalize_rows(torch.from_numpy(
        rng.standard_normal((rows, d)).astype(np.float32))).to(torch.bfloat16)
        for rows in (150, 1300))
    q[2] = 0
    aligned = merge_block(None, q.to(cuda), c.to(cuda), 0, 30, units=2)
    flat = torch.zeros(c.numel() + 1, dtype=torch.bfloat16, device=cuda)
    off = flat[1:].view(c.shape)
    off.copy_(c.to(cuda))
    assert off.data_ptr() % 16 != 0
    shifted = merge_block(None, q.to(cuda), off, 0, 30, units=2)
    torch.cuda.synchronize()
    assert torch.equal(aligned, shifted)
    assert _check_merge(aligned.cpu(), None, q, c, 0, 30, "bf16") >= 0.99


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [13, 40, 640])
def test_knn_merge_fp32_unaligned_and_wide_rows(cuda, d, dtype):
    """The fp32 form on rows K4 cannot read by TMA as they are (d * itemsize
    not a multiple of 16, or a base off 16 bytes: the zero-padded copy) and
    on wide rows (d = 640: 20 or 10 chunks a tile): the same keys bitwise
    as aligned rows and as rows padded with zeros by hand (zero products
    change no bits), held to merge_block_plain."""
    rng = np.random.default_rng(d + 1)
    q, c = (normalize_rows(torch.from_numpy(
        rng.standard_normal((rows, d)).astype(np.float32))).to(dtype)
        for rows in (150, 1300))
    q[2] = 0
    aligned = merge_block(None, q.to(cuda), c.to(cuda), 0, 30, "fp32",
                          units=2)
    flat = torch.zeros(c.numel() + 1, dtype=dtype, device=cuda)
    off = flat[1:].view(c.shape)
    off.copy_(c.to(cuda))
    assert off.data_ptr() % 16 != 0
    shifted = merge_block(None, q.to(cuda), off, 0, 30, "fp32", units=2)
    pad = -(-d // 8) * 8 + 8
    wide = [torch.nn.functional.pad(x, (0, pad - d)).to(cuda) for x in (q, c)]
    padded = merge_block(None, wide[0], wide[1], 0, 30, "fp32", units=2)
    torch.cuda.synchronize()
    assert torch.equal(aligned, shifted) and torch.equal(aligned, padded)
    assert _check_merge(aligned.cpu(), None, q, c, 0, 30, "fp32") >= 0.99


def test_merge_block_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((4, 16), device=cuda)
    with pytest.raises(ValueError, match="both float32 or both"):
        merge_block(None, q, q.to(torch.bfloat16), 0, 3)
    with pytest.raises(ValueError, match="one CUDA device"):
        merge_block(None, q, q.cpu(), 0, 3)
    with pytest.raises(ValueError, match="contiguous"):
        merge_block(None, q, torch.zeros((16, 4), device=cuda).T, 0, 3)
    with pytest.raises(ValueError, match="precision"):
        merge_block(None, q, q, 0, 3, "fp16")


SIGN_CASES = [(11, 8, None), (37, 20, 0.5), (37, 512, 1.0), (5000, 512, None),
              (4097, 20, 1e-30), (3, 1, 0.5)]


@pytest.mark.parametrize("lib_size,d,density", SIGN_CASES)
def test_srp_signs_matches_plain(cuda, lib_size, d, density):
    """K5 against sign_table_plain, bitwise: d = 20 has a word across the
    halves' seam and a word past 2d; density 1e-30 draws no nonzero; one
    launch a call, counted. build_precompute_signs on counts on the card
    gives the CPU's table."""
    density = density or 1.0 / (2 * lib_size) ** 0.5
    mix = seed_mix_of(2094)
    want = sign_table_plain(lib_size, d, mix, density, torch.device("cpu"))
    before = sign_table.kernel_launches
    got = sign_table(lib_size, d, mix, density, cuda)
    torch.cuda.synchronize()
    assert sign_table.kernel_launches == before + 1
    assert torch.equal(got.cpu(), want)
    counts = torch.from_numpy(np.random.default_rng(lib_size).integers(
        2, 50, lib_size).astype(np.int64))
    signs, mags = build_precompute_signs(counts.to(cuda), d, 2094)
    signs_c, mags_c = build_precompute_signs(counts, d, 2094)
    assert torch.equal(signs.cpu(), signs_c)
    torch.testing.assert_close(mags.cpu(), mags_c, rtol=1e-6, atol=0)


def test_knn_merge_and_srp_signs_launch_on_their_tensors_card(last_card):
    """With cuda:0 current, K4 and K5 on the last card's tensors launch
    there (K4's shared-memory opt-in granted on that card) and match
    their plain versions."""
    run, q, c, index, k = _merge_inputs("ids_carry", torch.bfloat16, "bf16")
    got = merge_block(run.to(last_card), q.to(last_card), c.to(last_card),
                      index.to(last_card), k)
    mix = seed_mix_of(2094)
    signs = sign_table(300, 512, mix, 0.05, last_card)
    torch.cuda.synchronize(last_card)
    assert torch.cuda.current_device() == 0
    assert got.device == last_card and signs.device == last_card
    assert _check_merge(got.cpu(), run, q, c, index, k, "bf16") >= 0.99
    assert torch.equal(signs.cpu(), sign_table_plain(
        300, 512, mix, 0.05, torch.device("cpu")))


# (L, d, density, counts): "random" counts in [2, 50), "2L" with counts
# equal to 2L among them
PAIRED_CASES = [(0, 16, None, "random"), (1, 20, None, "random"),
                (37, 1, 0.5, "random"), (37, 100, None, "random"),
                (29, 16, 1e-30, "random"), (300, 512, 1.0, "random"),
                (40, 96, None, "2L"), (5000, 512, None, "random"),
                (37, 260, None, "random"), (61, 1000, None, "random")]


def _seeds():
    """A seed whose splitmix64 key has its top bit set and one whose has
    not (the key crosses into C as a uint64)."""
    return (next(s for s in range(100) if int(seed_mix_of(s)) < 0),
            next(s for s in range(100) if int(seed_mix_of(s)) >= 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lib_size,d,density,counts", PAIRED_CASES)
def test_srp_paired_matches_plain(cuda, lib_size, d, density, counts,
                                  dtype):
    """K8 against paired_table_plain on the same ICF weights, bitwise (as
    integer views, so +0.0 is held apart from -0.0): L = 0 (only the zero
    row), L = 1, d = 1 and d = 100 (a ragged vector, bfloat16's on the
    scalar path), density 1e-30 (a negative bound: no entry), density 1.0,
    counts equal to 2L (an ICF of ~1e-14), keys with and without the top
    bit; d = 260 and 1,000, whose rows' vectors run past a block's 128
    (d = 1,000: a block across the halves' seam) at L + 1 not a multiple
    of the band's 8 rows; one launch a call, counted.
    build_precompute_paired on counts on the card is one K8 launch."""
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    rng = np.random.default_rng(lib_size + d)
    c = rng.integers(2, 50, lib_size)
    if counts == "2L":
        c[::3] = 2 * lib_size
    c = torch.from_numpy(c.astype(np.int64))
    for seed in _seeds():
        icf, dens, mix, scale = _stream(c, d, seed, density)
        want = paired_table_plain(icf, d, mix, dens, scale, dtype)
        before = paired_table.kernel_launches
        got = paired_table(icf.to(cuda), d, mix, dens, scale.to(cuda),
                           dtype)
        torch.cuda.synchronize()
        assert paired_table.kernel_launches == before + 1
        assert got.shape == (lib_size + 1, 2 * d) and got.dtype == dtype
        assert torch.equal(got.cpu().view(view), want.view(view))
    before = paired_table.kernel_launches
    table = build_precompute_paired(c.to(cuda), d, 2094, density,
                                    dtype=dtype)
    assert paired_table.kernel_launches == before + 1
    torch.testing.assert_close(table.cpu().float(), build_precompute_paired(
        c, d, 2094, density, dtype=dtype).float(), rtol=1e-6, atol=0)


# (N, d, C, assignment): "random" ids; "even" (every odd cluster empty);
# "one" (every row in cluster 0); "single" (cluster 3 holds one row)
SEGMENT_CASES = [(20000, 512, 256, "random"), (5000, 64, 37, "random"),
                 (300, 100, 64, "even"), (3000, 16, 1, "one"),
                 (400, 32, 8, "single"), (1, 8, 8, "random"),
                 (2000, 6, 8, "random"), (0, 16, 8, "random"),
                 (3000, 512, 65536, "random"), (2100, 264, 3, "random")]


def _segment_inputs(n, d, c, kind, dtype, zero_rows=False):
    rng = np.random.default_rng(n + d + c)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    if zero_rows:
        x[::5] = 0.0
    a = rng.integers(0, c, n)
    if kind == "even":
        a = a - a % 2
    elif kind == "one":
        a[:] = 0
    elif kind == "single":
        a = np.where(a == 3, 4, a)
        a[n // 2] = 3
    return x.to(dtype), torch.from_numpy(a.astype(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,c,kind", SEGMENT_CASES)
def test_ivf_segment_sum_matches_plain(cuda, n, d, c, kind, dtype):
    """K9 against segment_sum_plain, bitwise (int32 views): random
    assignments at phase 4's width, empty clusters, one cluster holding
    every row, a one-row cluster, N = 1, N = 0, d = 6 and d = 100 (not
    multiples of 128; d = 6 on the scalar path), zero rows, C = 65,536
    over 3,000 rows (the counts in device memory), d = 264 (a unit's
    lanes past d on the ring); two launches byte-identical; into `out`,
    chunks carried on to the whole pass's bits; one launch a call,
    counted."""
    x, a = _segment_inputs(n, d, c, kind, dtype, zero_rows=d == 100)
    want = segment_sum_plain(x, a, c)
    before = segment_sum_rows.kernel_launches
    got = _segment_sum(x.to(cuda), a.to(cuda), c)
    again = _segment_sum(x.to(cuda), a.to(cuda), c)
    torch.cuda.synchronize()
    assert segment_sum_rows.kernel_launches == before + 2
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))
    out = torch.zeros((c, d), device=cuda)
    for r0 in range(0, n, 777):
        _segment_sum(x[r0 : r0 + 777].to(cuda), a[r0 : r0 + 777].to(cuda),
                     c, out)
    assert torch.equal(out.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ivf_segment_sum_unaligned_rows(cuda, dtype):
    """Rows whose base is off the vector alignment (a view one element
    into its storage) take K9's scalar loads and keep the bits."""
    x, a = _segment_inputs(3000, 64, 16, "random", dtype)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    rows = buf[1:].view(x.shape)
    rows.copy_(x.to(cuda))
    got = segment_sum_rows(rows, a.to(cuda), 16)
    assert torch.equal(got.cpu().view(torch.int32),
                       segment_sum_plain(x, a, 16).view(torch.int32))


# (N, C, kind): the bucketing's cases ("tiles": runs of one cluster across
# each tile boundary; "one", "even" as SEGMENT_CASES')
BUCKET_CASES = [(0, 8, "random"), (1, 8, "random"), (3000, 16, "one"),
                (3000, 64, "even"), (3000, 65536, "random"),
                (4 * ivf.K9_TILE + 77, 12, "tiles"),
                (262_144, 1024, "random"), (262_144, 16384, "random"),
                (20_000, 12288, "random"), (20_000, 12289, "random")]


@pytest.mark.parametrize("n,c,kind", BUCKET_CASES)
def test_ivf_segment_buckets_match_segments(cuda, n, c, kind):
    """K9's bucketing (segment_buckets: the counting sort alone) against
    _segments, equal as values (its int32 against their int64): N = 0,
    N = 1, one cluster holding every row, empty clusters, C = 65,536 over
    3,000 rows, runs of one cluster across each tile boundary, 11b's
    shape (256 tiles), C = 16,384 at 256 tiles (the counts in device
    memory), and C on either side of the shared-memory counts' limit;
    two calls equal; one launch a call, counted."""
    rng = np.random.default_rng(n + c)
    a = rng.integers(0, c, n)
    if kind == "one":
        a[:] = 0
    elif kind == "even":
        a = a - a % 2
    elif kind == "tiles":
        for t in range(1, 5):
            a[t * ivf.K9_TILE - 150 : t * ivf.K9_TILE + 150] = t % 3
    a = torch.from_numpy(a.astype(np.int32))
    want_order, want_bounds = _segments(a, c)
    before = segment_buckets.kernel_launches
    order, bounds = segment_buckets(a.to(cuda), c)
    order2, bounds2 = segment_buckets(a.to(cuda), c)
    torch.cuda.synchronize()
    assert segment_buckets.kernel_launches == before + 2
    assert order.dtype == torch.int32 and bounds.dtype == torch.int32
    assert torch.equal(order.cpu().long(), want_order)
    assert torch.equal(bounds.cpu().long(), want_bounds)
    assert torch.equal(order, order2) and torch.equal(bounds, bounds2)


def test_ivf_segment_sum_runs_no_torch_sort(cuda, monkeypatch):
    """segment_sum_rows on the card runs no torch sort or search: with
    torch.sort, argsort and searchsorted made to raise, its sums are
    still segment_sum_plain's bits."""
    x, a = _segment_inputs(5000, 512, 64, "random", torch.float32)
    want = segment_sum_plain(x, a, 64)
    rows, assign = x.to(cuda), a.to(cuda)

    def refuse(*args, **kwargs):
        raise AssertionError("a torch sort on K9's path")

    for name in ("sort", "argsort", "searchsorted"):
        monkeypatch.setattr(torch, name, refuse)
    got = segment_sum_rows(rows, assign, 64)
    out = torch.zeros((64, 512), device=cuda)
    _segment_sum(rows, assign, 64, out)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(out.cpu().view(torch.int32), want.view(torch.int32))


def test_ivf_segment_sum_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((10, 8), device=cuda)
    a = torch.zeros(10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="segment_sum_rows"):
        segment_sum_rows(x.half(), a, 4)
    with pytest.raises(ValueError, match="segment_sum_rows"):
        segment_sum_rows(x.T, a, 4)
    with pytest.raises(ValueError, match="segment_sum_rows"):
        segment_sum_rows(x, a.cpu(), 4)
    with pytest.raises(ValueError, match="out must be"):
        segment_sum_rows(x, a, 4, torch.zeros((4, 8), dtype=torch.float64,
                                              device=cuda))
    with pytest.raises(ValueError, match="int32 assignments"):
        segment_sum_rows(x, a.long(), 4)
    with pytest.raises(ValueError, match="segment_buckets"):
        segment_buckets(a.cpu(), 4)


def _wire_keys(rows, k, n_rows, seed, empty_share=0.0):
    """(rows, k) int64 keys of seeded scores in [-1, 1] (the wire's edge
    scores in row 0 where k allows) and indices below n_rows, a share of
    them EMPTY_KEY (row 1 wholly where there is one)."""
    rng = np.random.default_rng(seed)
    scores = rng.uniform(-1.0, 1.0, (rows, k)).astype(np.float32)
    edges = np.array([-0.0, 0.0, 1.0, -1.0,
                      np.nextafter(np.float32(1), np.float32(2)),
                      np.nextafter(np.float32(-1), np.float32(-2))],
                     np.float32)
    if rows:
        scores[0, : min(k, 6)] = edges[: min(k, 6)]
    keys = _order_keys(torch.from_numpy(scores),
                       torch.from_numpy(rng.integers(0, n_rows, (rows, k))))
    if empty_share:
        keys[torch.from_numpy(rng.random((rows, k)) < empty_share)] = EMPTY_KEY
        if rows > 1:
            keys[1] = EMPTY_KEY
    return keys


def _hold_wire(got, want):
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32),
                                  want[1].view(np.int32))


# (rows, k, n_rows, share of EMPTY_KEY slots): phase 4's shape (uint16
# indices under u16), 11b's (int32), with unset slots, k = 1, rows = 0, and
# an entry count that is not a multiple of a thread's four
WIRE_CASES = [(15_000, 50, 15_000, 0.0), (15_000, 50, 15_000, 0.1),
              (262_144, 50, 262_144, 0.0), (2_000, 50, 70_000, 0.3),
              (777, 1, 65_536, 0.2), (0, 50, 100, 0.0), (5, 3, 9, 0.2)]


@pytest.mark.parametrize("transfer", ["f32", "u16"])
@pytest.mark.parametrize("rows,k,n_rows,empty", WIRE_CASES)
def test_result_wire_matches_plain(cuda, rows, k, n_rows, empty, transfer):
    """K10 (keys_to_host on CUDA keys) against keys_to_host_plain on the
    same keys, byte-identical, on both wires: int32 and uint16-carried
    indices, with and without EMPTY_KEY slots, the edge scores (-0.0,
    1.0, -1.0, just past either), k = 1, rows = 0 and 15 entries; one
    launch a call with entries, counted, and numpy arrays of pinned host
    memory."""
    keys = _wire_keys(rows, k, n_rows, rows + k, empty).to(cuda)
    want = keys_to_host_plain(keys, transfer, n_rows)
    before = result_wire.kernel_launches
    got = keys_to_host(keys, transfer, n_rows)
    assert result_wire.kernel_launches == before + (rows * k > 0)
    assert got[0].shape == got[1].shape == (rows, k)
    _hold_wire(got, want)


def test_result_wire_results_stay_their_own(cuda):
    """Two results held at once (as the sharded searches hold one a
    mesh entry) stay intact: the second call writes into its own pinned
    block, and freeing the first lets a third reuse it without touching
    the second."""
    a = _wire_keys(3000, 50, 3000, 1).to(cuda)
    b = _wire_keys(3000, 50, 3000, 2).to(cuda)
    first = keys_to_host(a, "u16", 3000)
    kept = (first[0].copy(), first[1].copy())
    second = keys_to_host(b, "u16", 3000)
    _hold_wire(first, kept)
    _hold_wire(second, keys_to_host_plain(b, "u16", 3000))
    del first
    third = keys_to_host(a, "f32", 3000)
    _hold_wire(second, keys_to_host_plain(b, "u16", 3000))
    _hold_wire(third, keys_to_host_plain(a, "f32", 3000))


def test_result_wire_large_results_in_blocks_of_their_own(cuda,
                                                          monkeypatch):
    """Past topk.PIN_CACHE_BYTES (set to 0 here) K10 writes each result
    into a page-locked block of its own (topk.HostBlock): the bytes are the
    plain version's on both wires, two results held at once stay intact,
    and each block is freed with the last array that views it."""
    monkeypatch.setattr(topk, "PIN_CACHE_BYTES", 0)
    a = _wire_keys(3000, 50, 3000, 6, 0.1).to(cuda)
    b = _wire_keys(3000, 50, 3000, 7).to(cuda)
    live = topk.HostBlock.live
    for transfer in ("f32", "u16"):
        first = keys_to_host(a, transfer, 3000)
        second = keys_to_host(b, transfer, 3000)
        assert topk.HostBlock.live == live + 2
        _hold_wire(first, keys_to_host_plain(a, transfer, 3000))
        _hold_wire(second, keys_to_host_plain(b, transfer, 3000))
        assert not np.shares_memory(first[0], second[0])
        dist = first[1]
        del first, second
        assert topk.HostBlock.live == live + 1  # dist keeps its block
        del dist
        assert topk.HostBlock.live == live


def test_result_wire_unaligned_keys(cuda):
    """Keys whose base is off 16 bytes (a view one key into its storage)
    take the kernel's one-key-a-step path and keep the bytes."""
    keys = _wire_keys(400, 50, 400, 3, 0.1)
    buf = torch.empty(keys.numel() + 1, dtype=torch.int64, device=cuda)
    view = buf[1:].view(keys.shape)
    view.copy_(keys.to(cuda))
    for transfer in ("f32", "u16"):
        _hold_wire(keys_to_host(view, transfer, 400),
                   keys_to_host_plain(keys, transfer, 400))


def test_result_wire_refuses_what_it_does_not_take(cuda):
    keys = _wire_keys(20, 8, 20, 4).to(cuda)
    for bad in (keys.T, keys.int(), keys.reshape(-1)):
        with pytest.raises(ValueError, match="result_wire"):
            result_wire(bad, "f32", 20)
    with pytest.raises(ValueError, match="result_wire"):
        result_wire(keys.cpu(), "f32", 20)


# (N, C, p or spill, kind): phase 4's member side (spill 2) and probe side
# (p = 8) at C = 256, 11b's at C = 1,024, empty clusters, C = 1, N not a
# multiple of a tile, p = C, C whose counts fill all 48 KB of shared memory
# (auto_clusters' 2,048 and 4,096, and 12,288), and C past the
# shared-memory counts
TABLE_CASES = [(15_000, 256, 2, "random"), (15_000, 256, 8, "random"),
               (262_144, 1024, 1, "random"), (262_144, 1024, 2, "random"),
               (262_144, 1024, 8, "random"), (3_000, 64, 2, "even"),
               (700, 1, 1, "one"), (4 * ivf.K9_TILE + 77, 37, 2, "random"),
               (500, 8, 8, "all"), (100_000, 2048, 8, "random"),
               (200_000, 4096, 2, "random"), (50_000, 12_288, 2, "random"),
               (20_000, 16_384, 2, "random")]


def _table_inputs(n, c, per, kind):
    """(N, per) int32 cluster ids: per distinct ids a row (a row's own
    order of clusters, as the spill and probe lists give them)."""
    rng = np.random.default_rng(n + c + per)
    x = np.stack([rng.choice(c, min(per, c), replace=False)
                  for _ in range(min(n, 2000))])
    x = x[rng.integers(0, x.shape[0], n)] if n > x.shape[0] else x
    if kind == "even":
        x = x - x % 2
    elif kind == "one":
        x[:] = 0
    return torch.from_numpy(x.astype(np.int32))


def _same_buckets(got, want):
    """K11's Buckets against bucket_clusters_plain's: vals, bounds and
    slots bitwise; the work list (its first n_units rows) as a set of
    rows, ordered longest member count (bit length) first."""
    assert torch.equal(got.vals.cpu(), want.vals.cpu())
    assert torch.equal(got.bounds.cpu(), want.bounds.cpu())
    if want.slots is None:
        assert got.slots is None and got.units is None
        return
    assert torch.equal(got.slots.cpu(), want.slots.cpu())
    n_units = int(got.n_units[0])
    assert n_units == want.units.shape[0] <= got.units.shape[0]
    rows = [tuple(r) for r in got.units[:n_units].tolist()]
    assert sorted(rows) == sorted(tuple(r) for r in want.units.tolist())
    length = [int(m).bit_length() for *_, m in rows]
    assert length == sorted(length, reverse=True)


@pytest.mark.parametrize("n,c,per,kind", TABLE_CASES)
def test_ivf_tables_match_plain(cuda, n, c, per, kind):
    """K11 (bucket_clusters: one launch a side) against
    bucket_clusters_plain: the member side of the flat (N * per,) ids at
    div = per, and the probe side of the (N, per) probe lists at div = per
    with the member side's bounds (its slots and K6's work list), bitwise
    (the work list as a set of rows); both expanded to tables as wide as
    their largest cluster rounded up to 128 bitwise member_table_plain
    and probe_tables_plain after torch.bincount; two calls equal; each
    launch counted."""
    x = _table_inputs(n, c, per, kind)
    a = x.reshape(-1)
    counts = torch.bincount(a, minlength=c)
    m = int(-(-int(counts.max()) // 128) * 128)
    a_d = a.to(cuda)
    before = (ivf.bucket_clusters.kernel_launches,
              ivf.bucket_clusters.probe_launches)
    members = ivf.bucket_clusters(a_d, c, per)
    again = ivf.bucket_clusters(a_d, c, per)
    queries = ivf.bucket_clusters(a_d, c, per, members.bounds)
    torch.cuda.synchronize()
    assert (ivf.bucket_clusters.kernel_launches,
            ivf.bucket_clusters.probe_launches) == (before[0] + 3,
                                                    before[1] + 1)
    want = ivf.bucket_clusters_plain(a, c, per)
    _same_buckets(members, want)
    _same_buckets(again, want)
    _same_buckets(queries, ivf.bucket_clusters_plain(a, c, per,
                                                     want.bounds))
    assert torch.equal(ivf.expand_buckets(members.vals, members.bounds, m,
                                          n).cpu(),
                       ivf.member_table_plain(a, counts, c, m, per))
    want_q, want_s = ivf.probe_tables_plain(x, counts, c, m)
    assert torch.equal(ivf.expand_buckets(queries.vals, queries.bounds, m,
                                          n).cpu(), want_q)
    assert torch.equal(ivf.expand_buckets(queries.slots, queries.bounds, m,
                                          0).cpu(), want_s)


def test_ivf_tables_run_no_torch_sort(cuda, monkeypatch):
    """K11 on the card runs no torch sort, count, scatter or fill and
    reads nothing back: with torch.sort, argsort, bincount, full, zeros,
    index_put_, item assignment and every host copy made to raise, the
    member side (_member_side) and the probe side still give the plain
    versions' buckets."""
    x = _table_inputs(15_000, 256, 8, "random")
    a = x[:, :2].reshape(-1)
    want = ivf.bucket_clusters_plain(a, 256, 2)
    want_q = ivf.bucket_clusters_plain(x.reshape(-1), 256, 8, want.bounds)
    a_d, x_d = a.to(cuda), x.to(cuda)

    def refuse(*args, **kwargs):
        raise AssertionError("a torch sort, count, scatter or host copy on "
                             "K11's path")

    for name in ("sort", "argsort", "bincount", "full", "zeros"):
        monkeypatch.setattr(torch, name, refuse)
    for name in ("index_put_", "__setitem__", "cpu", "item", "tolist",
                 "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    members = ivf._member_side(a_d, 256, 2)
    queries = ivf.bucket_clusters(x_d.reshape(-1), 256, 8, members.bounds)
    torch.cuda.synchronize()
    monkeypatch.undo()
    _same_buckets(members, want)
    _same_buckets(queries, want_q)


def test_ivf_tables_refuse_what_they_do_not_take(cuda):
    a = torch.zeros(10, dtype=torch.int32, device=cuda)
    bounds = ivf.bucket_clusters(a, 4, 1).bounds
    for bad, c, div, mb in ((a.long(), 4, 1, None), (a, 0, 1, None),
                            (a.cpu(), 4, 1, None), (a, 4, 0, None),
                            (a[::2], 4, 1, None), (a, 4, 2, bounds[:4]),
                            (a, 4, 2, bounds.long()), (a, 4, 2, bounds.cpu())):
        with pytest.raises(ValueError, match="bucket_clusters"):
            ivf.bucket_clusters(bad, c, div, mb)


def test_result_wire_and_tables_launch_on_their_tensors_card(last_card):
    """With cuda:0 current, K10 (into a cached page-locked block and into
    a block of its own) and K11 (both sides) on the last card's tensors
    launch there and match their plain versions."""
    keys = _wire_keys(2000, 50, 2000, 5, 0.1)
    _hold_wire(keys_to_host(keys.to(last_card), "u16", 2000),
               keys_to_host_plain(keys, "u16", 2000))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(topk, "PIN_CACHE_BYTES", 0)
        _hold_wire(keys_to_host(keys.to(last_card), "f32", 2000),
                   keys_to_host_plain(keys, "f32", 2000))
    x = _table_inputs(5000, 64, 2, "random")
    a = x.reshape(-1)
    a_d = a.to(last_card)
    members = ivf.bucket_clusters(a_d, 64, 2)
    queries = ivf.bucket_clusters(a_d, 64, 2, members.bounds)
    torch.cuda.synchronize(last_card)
    assert torch.cuda.current_device() == 0
    assert members.vals.device == last_card == queries.units.device
    want = ivf.bucket_clusters_plain(a, 64, 2)
    _same_buckets(members, want)
    _same_buckets(queries, ivf.bucket_clusters_plain(a, 64, 2, want.bounds))


def test_srp_paired_and_segment_sum_launch_on_their_tensors_card(last_card):
    """With cuda:0 current, K8 and K9 on the last card's tensors launch
    there and match their plain versions."""
    c = torch.from_numpy(np.random.default_rng(3).integers(
        2, 50, 300).astype(np.int64))
    icf, dens, mix, scale = _stream(c, 512, 2094, None)
    table = paired_table(icf.to(last_card), 512, mix, dens,
                         scale.to(last_card), torch.bfloat16)
    x, a = _segment_inputs(5000, 512, 64, "random", torch.float32)
    sums = _segment_sum(x.to(last_card), a.to(last_card), 64)
    torch.cuda.synchronize(last_card)
    assert torch.cuda.current_device() == 0
    assert table.device == last_card and sums.device == last_card
    assert torch.equal(table.cpu().view(torch.int16), paired_table_plain(
        icf, 512, mix, dens, scale, torch.bfloat16).view(torch.int16))
    assert torch.equal(sums.cpu(), segment_sum_plain(x, a, 64))
